"""``graphblas_tpu_torch.monoid.numpy``: the numpy monoids
(graphblas_tpu/monoid/numpy.py, with its identity tables).  A monoid that
a builtin computes exactly is that builtin; ``logaddexp``,
``logaddexp2``, ``gcd`` and ``hypot`` are made from the numpy binary
operators."""

import numpy as np

from ..core.operator.monoid import Monoid

_FLOATS = ("FP32", "FP64")
_INTS = ("INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32",
         "UINT64")

_IDENTITIES = {
    "add": 0, "multiply": 1,
    "logaddexp": dict.fromkeys(_FLOATS, -np.inf),
    "logaddexp2": dict.fromkeys(_FLOATS, -np.inf),
    "gcd": dict.fromkeys(_INTS, 0),
    "hypot": dict.fromkeys(_FLOATS, 0.0),
    "bitwise_and": None, "bitwise_or": None, "bitwise_xor": None,
    "equal": None, "logical_and": None, "logical_or": None,
    "logical_xor": None, "maximum": None, "minimum": None, "fmax": None,
    "fmin": None}

TO_GRAPHBLAS = {
    "add": "plus", "multiply": "times", "bitwise_and": "band",
    "bitwise_or": "bor", "bitwise_xor": "bxor", "equal": "eq",
    "logical_and": "land", "logical_or": "lor", "logical_xor": "lxor",
    "maximum": "max", "minimum": "min", "fmax": "max", "fmin": "min"}

__all__ = sorted(_IDENTITIES)


def __dir__():
    return sorted(set(globals()) | set(_IDENTITIES))


def __getattr__(name):
    if name not in _IDENTITIES:
        raise AttributeError(
            f"module 'graphblas_tpu_torch.monoid.numpy' has no attribute "
            f"{name!r}")
    if name in TO_GRAPHBLAS:
        from .. import monoid

        mono = getattr(monoid, TO_GRAPHBLAS[name])
    else:
        from ..binary import numpy as binary_numpy

        mono = Monoid.register_anonymous(getattr(binary_numpy, name),
                                         _IDENTITIES[name], f"numpy.{name}")
        mono._anonymous = False
    globals()[name] = mono
    return mono
