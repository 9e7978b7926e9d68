"""``graphblas_tpu_torch.unary``: the unary operators of the port.  The
SuiteSparse ones (``erf``, ``erfc``, ``lgamma``, ``tgamma``, ``frexpx``,
``frexpe`` and the positional ``positioni`` ... ``positionj1``) live under
``unary.ss``, as in the JAX package, and the numpy ufuncs under
``unary.numpy``."""

import importlib

from ..core.operator import utils as _utils
from ..core.operator.base import missing
from ..core.operator.unary import BUILTINS as _B, TypedUnaryOp, UnaryOp
from ..core.ss.jit import jit_register

SS_NAMES = frozenset(("erf", "erfc", "frexpe", "frexpx", "lgamma", "tgamma",
                      "positioni", "positioni1", "positionj", "positionj1"))

register_new = UnaryOp.register_new
register_anonymous = UnaryOp.register_anonymous
_plain = {k: v for k, v in _B.items() if k not in SS_NAMES}
globals().update(_plain)


class _SSNamespace:
    """``unary.ss``: the SuiteSparse unary operators, and ``register_new``
    for a function given as Python source or a callable (the JAX
    package's engine-JIT registration)."""

    def __init__(self, ops):
        self.__dict__.update(ops)

    @staticmethod
    def register_new(name, jit_definition, input_type=None, ret_type=None):
        return jit_register("unary", name, jit_definition,
                                   input_type, ret_type)

    def __getattr__(self, name):
        raise missing("unary.ss", name)


ss = _SSNamespace({k: v for k, v in _B.items() if k in SS_NAMES})


def from_string(string):
    return _utils.unary_from_string(string)


def __dir__():
    return sorted(set(globals()) | {"numpy"})


def __getattr__(name):
    if name == "numpy":
        return importlib.import_module(".numpy", __name__)
    if name in vars(ss):
        mod = __name__.rsplit(".", 1)[1]
        raise AttributeError(f"gb.{mod}.{name} is available as "
                             f"gb.{mod}.ss.{name}")
    raise missing("unary", name)


__all__ = ["UnaryOp", "TypedUnaryOp", "register_new", "register_anonymous",
           "from_string", "ss", *_plain]
