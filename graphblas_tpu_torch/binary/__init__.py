"""``graphblas_tpu_torch.binary``: the binary operators of the port.  The
eight positional ones (``firsti``, ``firsti1``, ... ``secondj1``) live
under ``binary.ss``, as in the JAX package, and the numpy ufuncs under
``binary.numpy``."""

import importlib

from ..core.operator import utils as _utils
from ..core.operator.base import missing
from ..core.operator.binary import BUILTINS as _B, BinaryOp, TypedBinaryOp
from ..core.ss.jit import jit_register


register_new = BinaryOp.register_new
register_anonymous = BinaryOp.register_anonymous
_plain = {k: v for k, v in _B.items() if not getattr(v, "_positional", None)}
globals().update(_plain)


class _SSNamespace:
    """``binary.ss``: the positional binary operators, and
    ``register_new`` for a function given as Python source or a callable
    (the JAX package's engine-JIT registration)."""

    def __init__(self, ops):
        self.__dict__.update(ops)

    @staticmethod
    def register_new(name, jit_definition, left_type=None, right_type=None,
                     ret_type=None):
        return jit_register("binary", name, jit_definition,
                                   left_type, right_type, ret_type)

    def __getattr__(self, name):
        raise missing("binary.ss", name)


ss = _SSNamespace({k: v for k, v in _B.items()
                   if getattr(v, "_positional", None)})


def from_string(string):
    return _utils.binary_from_string(string)


def __dir__():
    return sorted(set(globals()) | {"numpy"})


def __getattr__(name):
    if name == "numpy":
        return importlib.import_module(".numpy", __name__)
    if name in vars(ss):
        mod = __name__.rsplit(".", 1)[1]
        raise AttributeError(f"gb.{mod}.{name} is available as "
                             f"gb.{mod}.ss.{name}")
    raise missing("binary", name)


__all__ = ["BinaryOp", "TypedBinaryOp", "register_new", "register_anonymous",
           "from_string", "ss", *_plain]
