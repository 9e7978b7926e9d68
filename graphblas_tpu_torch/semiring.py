"""``graphblas_tpu_torch.semiring``: semirings by name, e.g.
``semiring.plus_times["FP32"]`` or ``semiring.lor_land["BOOL"]``."""

from .core.operator.semiring import Semiring, TypedSemiring, from_name

_cache = {}


def __getattr__(name):
    if name not in _cache:
        ring = from_name(name)
        if ring is None:
            raise AttributeError(f"no semiring {name!r} in the PyTorch port")
        _cache[name] = ring
    return _cache[name]


__all__ = ["Semiring", "TypedSemiring"]
