"""``graphblas_tpu_torch.semiring``: semirings by name, e.g.
``semiring.plus_times["FP32"]`` or ``semiring.lor_land["BOOL"]``.  The
positional ones (``min_secondi``, ``any_firstj``) live under
``semiring.ss``, as in the JAX package.  A name the JAX package composes
from operators the port lacks (``plus_minus``) raises
NotImplementedError."""

from .binary import REFERENCE_NAMES as _REF_BINARY
from .binary import REFERENCE_SS_NAMES as _REF_POSITIONAL
from .core.operator.base import missing
from .core.operator.semiring import Semiring, TypedSemiring, from_name
from .monoid import REFERENCE_NAMES as _REF_MONOID

_cache = {}


def _reference_has(name, positional):
    """Does graphblas_tpu.semiring (or its ss) compose this name?  It takes
    ``<monoid>_<binary op>``, ``div`` for ``cdiv``, and the suffixes
    ``_select1st``/``_select2nd`` for ``_first``/``_second``."""
    if name == "numpy":
        return not positional
    head, _, tail = name.partition("_")
    tail = {"div": "cdiv", "select1st": "first",
            "select2nd": "second"}.get(tail, tail)
    mults = _REF_POSITIONAL - {"register_new"} if positional else \
        _REF_BINARY - {"numpy"}
    return head in _REF_MONOID and tail in mults


def _lookup(name, positional):
    key = (name, positional)
    if key not in _cache:
        ring = from_name(name)
        if ring is None or (ring.binaryop._positional is not None) != positional:
            where = "semiring.ss" if positional else "semiring"
            known = {name} if _reference_has(name, positional) else ()
            raise missing(where, name, known)
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
