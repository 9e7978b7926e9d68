"""Collections and expressions: ``<<``, ``.new()``,
``c(mask=, accum=, replace=)`` (graphblas_tpu/core/base.py, reduced to
what the SpMV slice calls)."""

import torch

from . import execute
from .mask import Mask


def _split_call_args(optional, mask, accum):
    """``c(M)``, ``c(accum)`` and ``c(M, accum)`` positional forms."""
    for arg in optional:
        if isinstance(arg, Mask):
            if mask is not None:
                raise TypeError("Got multiple values for argument 'mask'")
            mask = arg
        else:
            if accum is not None:
                raise TypeError("Got multiple values for argument 'accum'")
            accum = arg
    return mask, accum


class BaseType:
    """A Vector or Scalar with a dense (values, valid) store on its device."""

    _vals = None
    _valid = None

    def _set_store(self, vals, valid):
        self._vals = vals
        self._valid = valid

    @property
    def device(self):
        return self._valid.device

    @property
    def nvals(self):
        return int(self._valid.sum())

    def __call__(self, *optional, mask=None, accum=None, replace=False):
        from .expr import Updater

        mask, accum = _split_call_args(optional, mask, accum)
        if mask is not None and not isinstance(mask, Mask):
            raise TypeError(f"mask must be a Mask (v.S, v.V, ~v.S); got "
                            f"{type(mask).__name__}")
        return Updater(self, mask=mask, accum=accum, replace=replace)

    def __lshift__(self, expr):
        return self.update(expr)

    def update(self, expr):
        execute.update_into(self, execute.as_expr(expr))

    def wait(self, how="materialize"):
        if how not in ("materialize", "complete"):
            raise ValueError(f"how must be 'materialize' or 'complete'; "
                             f"got {how!r}")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class BaseExpression:
    """A deferred operation; ``.new()`` or ``c << expr`` computes it."""

    def __init__(self, method_name, op, args, dtype, shape, output_type,
                 statics=()):
        self.method_name = method_name
        self.op = op
        self.args = args
        self.dtype = dtype
        self.shape = shape
        self.output_type = output_type
        self._statics = statics

    def new(self, dtype=None, *, mask=None, name=None):
        from .dtypes import lookup_dtype

        out_dtype = self.dtype if dtype is None else lookup_dtype(dtype)
        return execute.materialize(self, out_dtype, mask=mask, name=name)

    def __repr__(self):
        return f"<{self.output_type.__name__} expression {self.method_name}>"
