"""``graphblas_tpu_torch.semiring``: semirings by name, e.g.
``semiring.plus_times["FP32"]`` or ``semiring.lor_land["BOOL"]``.  The
positional ones (``min_secondi``, ``any_firstj``) live under
``semiring.ss``, as in the JAX package."""

from .core.operator.semiring import Semiring, TypedSemiring, from_name

_cache = {}


def _lookup(name, positional):
    key = (name, positional)
    if key not in _cache:
        ring = from_name(name)
        if ring is None or (ring.binaryop._positional is not None) != positional:
            where = "semiring.ss" if positional else "semiring"
            raise AttributeError(f"no {where}.{name} in the PyTorch port")
        _cache[key] = ring
    return _cache[key]


def __getattr__(name):
    return _lookup(name, False)


class _SSNamespace:
    """``semiring.ss``: the positional semirings."""

    def __getattr__(self, name):
        return _lookup(name, True)


ss = _SSNamespace()

__all__ = ["Semiring", "TypedSemiring", "ss"]
