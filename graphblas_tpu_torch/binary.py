"""``graphblas_tpu_torch.binary``: the builtin binary operators of the port.
The eight positional ones (``firsti``, ``firsti1``, ... ``secondj1``) live
under ``binary.ss``, as in the JAX package.  An operator of the JAX
package that the port lacks raises NotImplementedError."""

from .core.operator.base import missing
from .core.operator.binary import BUILTINS as _B, BinaryOp, TypedBinaryOp

# the names of graphblas_tpu.binary and graphblas_tpu.binary.ss
REFERENCE_NAMES = frozenset((
    "absfirst", "abssecond", "any", "atan2", "band", "bclr", "bget", "binom",
    "bor", "bset", "bshift", "bxnor", "bxor", "cdiv", "cmplx", "copysign",
    "eq", "first", "floordiv", "fmod", "ge", "gt", "hypot", "iseq", "isge",
    "isgt", "isle", "islt", "isne", "land", "ldexp", "le", "lor", "lt",
    "lxnor", "lxor", "max", "min", "minus", "ne", "oneb", "pair", "plus",
    "pow", "rdiv", "remainder", "rfloordiv", "rminus", "rpow", "rtruediv",
    "second", "times", "truediv", "numpy"))
REFERENCE_SS_NAMES = frozenset((
    "firsti", "firsti1", "firstj", "firstj1", "secondi", "secondi1",
    "secondj", "secondj1", "register_new"))

_plain = {k: v for k, v in _B.items() if v._positional is None}
globals().update(_plain)


class _SSNamespace:
    """``binary.ss``: the positional binary operators."""

    def __init__(self, ops):
        self.__dict__.update(ops)

    def __getattr__(self, name):
        raise missing("binary.ss", name, REFERENCE_SS_NAMES)


ss = _SSNamespace({k: v for k, v in _B.items() if v._positional is not None})


def __getattr__(name):
    raise missing("binary", name, REFERENCE_NAMES)


__all__ = ["BinaryOp", "TypedBinaryOp", "ss", *_plain]
