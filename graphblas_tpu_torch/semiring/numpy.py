"""``graphblas_tpu_torch.semiring.numpy``: the numpy semirings
(graphblas_tpu/semiring/numpy.py), ``<numpy monoid>_<numpy binary op>``
composed on first use (``semiring.numpy.add_multiply``)."""

import itertools

from ..monoid import numpy as _monoid_numpy
from ..binary import numpy as _binary_numpy

_MONOIDS = frozenset(_monoid_numpy.__all__)


def names():
    """The JAX package's name set: monoid x binary op, less the families
    whose types do not meet."""
    out = {f"{mo}_{mu}" for mo, mu in itertools.product(
        _MONOIDS, _binary_numpy.__all__)}
    for mos, mus in (
            ({"equal", "hypot", "logaddexp", "logaddexp2"},
             {"gcd", "lcm", "left_shift", "right_shift"}),
            ({"bitwise_and", "bitwise_or", "bitwise_xor", "equal", "gcd"},
             {"arctan2", "copysign", "divide", "float_power", "hypot",
              "ldexp", "logaddexp2", "logaddexp", "nextafter",
              "true_divide"}),
            ({"hypot", "logaddexp", "logaddexp2"},
             {"bitwise_and", "bitwise_or", "bitwise_xor"}),
            ({"equal"}, {"floor_divide", "fmod", "mod", "power",
                         "remainder", "subtract"})):
        out -= {f"{mo}_{mu}" for mo, mu in itertools.product(mos, mus)}
    return frozenset(out)


def __dir__():
    return sorted(set(globals()) | names())


def __getattr__(name):
    from ..core.operator.semiring import get_semiring

    for mono in sorted(_MONOIDS, key=len, reverse=True):
        if name.startswith(mono + "_"):
            try:
                ring = get_semiring(getattr(_monoid_numpy, mono),
                                    getattr(_binary_numpy,
                                            name[len(mono) + 1:]),
                                    f"numpy.{name}")
            except AttributeError:
                continue
            globals()[name] = ring
            return ring
    raise AttributeError(
        f"module 'graphblas_tpu_torch.semiring.numpy' has no attribute "
        f"{name!r}")
