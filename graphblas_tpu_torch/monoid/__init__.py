"""``graphblas_tpu_torch.monoid``: the builtin monoids of the port, and
the numpy ones under ``monoid.numpy``."""

import importlib

from ..core.operator import utils as _utils
from ..core.operator.base import missing
from ..core.operator.monoid import BUILTINS as _B, Monoid, TypedMonoid

register_new = Monoid.register_new
register_anonymous = Monoid.register_anonymous
globals().update(_B)


def from_string(string):
    return _utils.monoid_from_string(string)


def __dir__():
    return sorted(set(globals()) | {"numpy"})


def __getattr__(name):
    if name == "numpy":
        return importlib.import_module(".numpy", __name__)
    raise missing("monoid", name)


__all__ = ["Monoid", "TypedMonoid", "register_new", "register_anonymous",
           "from_string", *_B]
