"""Operator base classes: an untyped operator indexes to typed operators,
one per DataType, built on demand and cached (graphblas_tpu/core/operator/
base.py, reduced to what the SpMV slice uses)."""

from ..dtypes import lookup_dtype


class OpBase:
    opclass = None
    _positional = None

    def __init__(self, name):
        self.name = name
        self._typed_ops = {}

    def __getitem__(self, dtype):
        dt = lookup_dtype(dtype)
        typed = self._typed_ops.get(dt)
        if typed is None:
            typed = self._build_typed(dt)
            if typed is None:
                raise KeyError(f"{self.opclass} {self.name} does not work "
                               f"on {dt.name} in the PyTorch port")
            self._typed_ops[dt] = typed
        return typed

    def _build_typed(self, dt):
        raise NotImplementedError

    def __repr__(self):
        return f"{self.opclass}.{self.name}"


class TypedOpBase:
    opclass = None
    _positional = None

    def __init__(self, parent, name, type_, return_type, type2=None):
        self.parent = parent
        self.name = name
        self.type = type_
        self.type2 = type_ if type2 is None else type2
        self.return_type = return_type

    def __repr__(self):
        return f"{self.opclass}.{self.name}[{self.type.name}]"


def not_ported(what, item):
    """The error for a part of the JAX package's surface that the port
    lacks, naming its ROADMAP.md queue-1 item."""
    return NotImplementedError(
        f"{what} is not in the PyTorch port yet (ROADMAP.md queue 1, item "
        f"{item})")


def missing(namespace, name, reference_names):
    """The error for an attribute an operator namespace lacks: the JAX
    package's operators that are not ported raise NotImplementedError,
    other names AttributeError."""
    if name in reference_names:
        return not_ported(f"{namespace}.{name}", 12)
    return AttributeError(
        f"module 'graphblas_tpu_torch.{namespace}' has no attribute {name!r}")


def typed(op, dtype, opclass):
    """Resolve op (typed, untyped or an operator string, parsed as the
    JAX package parses it) to a typed op of `opclass` for `dtype`."""
    if isinstance(op, str):
        from .utils import op_from_string

        op = op_from_string(op, opclass)
    if isinstance(op, TypedOpBase):
        if op.opclass != opclass:
            raise TypeError(f"expected a {opclass}; got {op!r}")
        return op
    if not isinstance(op, OpBase) or op.opclass != opclass:
        raise TypeError(f"expected a {opclass}; got {op!r}")
    return op[dtype]
