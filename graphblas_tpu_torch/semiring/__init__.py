"""``graphblas_tpu_torch.semiring``: semirings by name, e.g.
``semiring.plus_times["FP32"]`` or ``semiring.lor_land["BOOL"]``, composed
on first use from a builtin monoid and a binary op as the JAX package's
grammar does (``<monoid>_<binary op>``, ``div`` for ``cdiv``,
``_select1st``/``_select2nd`` for ``_first``/``_second``, a numpy multiply
where no builtin has the name).  The positional ones (``min_secondi``,
``any_firstj``) live under ``semiring.ss``, and the numpy ones under
``semiring.numpy``."""

import importlib

from .. import binary as _binary
from .. import monoid as _monoid
from ..core.operator import utils as _utils
from ..core.operator.semiring import Semiring, TypedSemiring
from ..core.operator.semiring import get_semiring  # noqa: F401

register_new = Semiring.register_new
register_anonymous = Semiring.register_anonymous

MONOID_NAMES = ("min", "max", "plus", "times", "any", "lor", "land", "lxor",
                "lxnor", "eq", "band", "bor", "bxor", "bxnor")


def from_string(string):
    return _utils.semiring_from_string(string)


def _build(key, positional):
    head, sep, tail = key.partition("_")
    if not sep or head not in MONOID_NAMES:
        raise AttributeError(key)
    tail = "cdiv" if tail == "div" else tail
    is_pos = tail in vars(_binary.ss)
    if is_pos and not positional:
        raise AttributeError(f"gb.semiring.{key} is available as "
                             f"gb.semiring.ss.{key}")
    if is_pos:
        mult = getattr(_binary.ss, tail)
    else:
        mult = vars(_binary).get(tail)
        if mult is None:
            mult = getattr(_binary.numpy, tail, None)
        if mult is None:
            raise AttributeError(key)
    ring = get_semiring(getattr(_monoid, head), mult, key)
    if not is_pos and not ring.types:
        raise AttributeError(f"No valid dtypes for semiring {key}")
    return ring


class _SSNamespace:
    """``semiring.ss``: the positional semirings (and, as in the JAX
    package, the others too)."""

    def __getattr__(self, key):
        ring = _build(key, True)
        setattr(self, key, ring)
        return ring


ss = _SSNamespace()


def grammar_names():
    """The builtin semiring names of the JAX package's dir(): arithmetic
    monoid x ring multiply, the BOOL monoids' comparison families, and the
    bitwise square."""
    arith = ("min", "max", "plus", "times", "any")
    mults = ("first", "second", "pair", "oneb", "min", "max", "plus", "minus",
             "rminus", "times", "div", "rdiv", "iseq", "isne", "isgt", "islt",
             "isge", "isle", "lor", "land", "lxor")
    bool_monoids = ("lor", "land", "lxor", "lxnor", "eq", "any")
    bool_mults = ("eq", "ne", "gt", "lt", "ge", "le", "first", "second",
                  "pair", "oneb", "lor", "land", "lxor")
    bits = ("band", "bor", "bxor", "bxnor")
    return ({f"{m}_{b}" for m in arith for b in mults}
            | {f"{m}_{b}" for m in bool_monoids for b in bool_mults}
            | {f"{m}_{b}" for m in bits for b in bits})


# the JAX package's list of common semirings, which its dir() adds
_COMMON = (
    "plus_times", "plus_plus", "plus_min", "plus_max", "plus_first",
    "plus_second", "plus_pair", "plus_land", "plus_lor", "min_plus",
    "min_times", "min_first", "min_second", "min_max", "min_min", "min_pair",
    "max_plus", "max_times", "max_first", "max_second", "max_min", "max_max",
    "any_pair", "any_first", "any_second", "any_plus", "any_times", "any_min",
    "any_max", "lor_land", "land_lor", "lxor_land", "lxnor_lor", "eq_eq",
    "lor_first", "lor_second", "lor_pair", "times_times", "times_plus",
    "band_bor", "bor_band", "bxor_band", "bxnor_band", "plus_cdiv",
    "plus_minus", "plus_rminus")


def __dir__():
    return sorted(set(globals()) | grammar_names() | set(_COMMON)
                  | {"ss", "numpy"})


def __getattr__(key):
    if key == "numpy":
        return importlib.import_module(".numpy", __name__)
    if key.startswith("__"):
        raise AttributeError(key)
    lookup = key
    for alias, name in (("_select1st", "_first"), ("_select2nd", "_second")):
        if lookup.endswith(alias):
            lookup = lookup[:-len(alias)] + name
    ring = _build(lookup, False)
    globals()[key] = ring
    return ring


__all__ = ["Semiring", "TypedSemiring", "register_new", "register_anonymous",
           "from_string", "get_semiring", "ss"]
