"""Operator base classes (graphblas_tpu/core/operator/base.py): an untyped
operator holds its typed operators, one per DataType.  A builtin's table
is filled when it is made (the types its domain allows, and the aliases
of core/operator/coercions.py); a positional operator, a user function
and an aggregator build a typed operator on demand (``_build_typed``)."""

import inspect

from ..dtypes import lookup_dtype, unify


class OpBase:
    opclass = None
    _positional = None
    _modname = "op"
    # what a lookup of a type the operator refuses raises: KeyError, and
    # for a user function (or a numpy one) UdfParseError, as the JAX
    # package's failed trace does
    _refusal = KeyError

    def __init__(self, name, *, anonymous=False):
        self.name = name
        self._typed_ops = {}
        self._anonymous = anonymous

    @property
    def types(self):
        """Input type -> return type, over the types it takes."""
        return {t: op.return_type for t, op in self._typed_ops.items()}

    @property
    def is_positional(self):
        return self._positional is not None

    def __getitem__(self, dtype):
        if type(dtype) is tuple:
            d1, d2 = (lookup_dtype(t) for t in dtype)
            return self[unify(d1, d2)]
        dt = lookup_dtype(dtype)
        typed = self._typed_ops.get(dt)
        if typed is None:
            typed = self._build_typed(dt)
            if typed is None:
                raise self._refusal(f"{self.name} does not work with "
                                    f"{dt.name}")
            self._typed_ops[dt] = typed
        return typed

    def __contains__(self, dtype):
        try:
            self[dtype]
        except (TypeError, KeyError, ValueError):
            return False
        return True

    def _build_typed(self, dt):
        return None

    def __call__(self, *args, **kwargs):
        """The operator on collections or infix expressions (see
        utils.call_expr)."""
        from .utils import call_expr

        return call_expr(self, *args, **kwargs)

    def __repr__(self):
        return f"{self._modname}.{self.name}"

    def __reduce__(self):
        """Pickled by namespace and name, as in the JAX package."""
        if self._anonymous:
            raise TypeError(f"Anonymous op {self.name} is not picklable by "
                            f"name")
        return (_op_from_namespace, (self._modname, self.name))


def _op_from_namespace(modname, name):
    import importlib

    obj = importlib.import_module(f"graphblas_tpu_torch.{modname}")
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _deserialize_typed(parent, typename):
    return parent[typename]


class TypedOpBase:
    opclass = None
    _positional = None

    def __init__(self, parent, name, type_, return_type, type2=None):
        self.parent = parent
        self.name = name
        self.type = type_
        self.type2 = type_ if type2 is None else type2
        self.return_type = return_type

    @property
    def is_positional(self):
        return self._positional is not None

    def __call__(self, *args, **kwargs):
        from .utils import call_expr

        return call_expr(self, *args, **kwargs)

    def __repr__(self):
        return f"{self.parent._modname}.{self.name}[{self.type.name}]"

    def __reduce__(self):
        return (_deserialize_typed, (self.parent, self.type.name))


class ParameterizedUdf:
    """A callable that makes an operator from its parameters
    (graphblas_tpu/core/operator/base.py ParameterizedUdf)."""

    def __init__(self, name, anonymous):
        self.name = name
        self._anonymous = anonymous


def unparameterized(op):
    """A parameterized operator stands for its instance with the default
    parameters (the JAX package's find_opclass)."""
    return op() if isinstance(op, ParameterizedUdf) else op


def find_opclass(op):
    """(op, its opclass name) of any operator-like object; a
    parameterized operator stands for its default instance, and anything
    else is of "UnknownOpClass" (the JAX package's find_opclass)."""
    op = unparameterized(op)
    return op, getattr(op, "opclass", None) or "UnknownOpClass"


def check_arity(func, nargs, what):
    """TypeError unless func takes nargs positional arguments (a function
    with *args passes)."""
    try:
        sig = inspect.signature(func)
    except (TypeError, ValueError):
        return
    params = sig.parameters.values()
    if any(p.kind == p.VAR_POSITIONAL for p in params):
        return
    n = sum(p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            for p in params)
    if n != nargs:
        raise TypeError(f"{what} function must take exactly {nargs} "
                        f"positional arguments; got {n}")


def not_ported(what, item):
    """The error for a part of the JAX package's surface that the port
    lacks, naming its ROADMAP.md queue-1 item."""
    return NotImplementedError(
        f"{what} is not in the PyTorch port yet (ROADMAP.md queue 1, item "
        f"{item})")


def missing(namespace, name):
    """The error for an attribute an operator namespace lacks."""
    return AttributeError(
        f"module 'graphblas_tpu_torch.{namespace}' has no attribute {name!r}")


def typed(op, dtype, opclass):
    """Resolve op (typed, untyped, parameterized or an operator string,
    parsed as the JAX package parses it) to a typed op of `opclass` for
    `dtype`."""
    if isinstance(op, str):
        from .utils import op_from_string

        op = op_from_string(op, opclass)
    op = unparameterized(op)
    if isinstance(op, TypedOpBase):
        if op.opclass != opclass:
            raise TypeError(f"expected a {opclass}; got {op!r}")
        return op
    if not isinstance(op, OpBase) or op.opclass != opclass:
        raise TypeError(f"expected a {opclass}; got {op!r}")
    return op[dtype]
