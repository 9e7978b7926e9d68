"""Scalar: a 0-d (value, valid) store (graphblas_tpu/core/scalar.py: its
construction, ``value`` (a numpy scalar of the dtype), ``get`` and
``clear``).  What the JAX package's
Scalar has and the port lacks raises NotImplementedError naming its
ROADMAP.md item."""

import numpy as np
import torch

from . import config as _config
from .base import BaseType, NotPorted
from .dtypes import FP64, lookup_dtype, storage_scalar, to_numpy


class Scalar(BaseType):
    shape = ()
    ndim = 0

    def __init__(self, dtype=FP64, *, is_cscalar=False, name=None):
        self.dtype = lookup_dtype(dtype)
        self.name = name
        dev = _config.device()
        self._set_store(torch.zeros((), dtype=self.dtype.torch_type, device=dev),
                        torch.zeros((), dtype=torch.bool, device=dev))

    @classmethod
    def _empty(cls, dtype, shape=(), name=None):
        return cls(dtype, name=name)

    @classmethod
    def _from_store(cls, dtype, vals, valid, name=None):
        s = cls.__new__(cls)
        s.dtype = lookup_dtype(dtype)
        s.name = name
        s._set_store(vals, valid)
        return s

    @classmethod
    def from_value(cls, value, dtype=None, *, is_cscalar=False, name=None):
        if dtype is None:
            dtype = lookup_dtype(np.asarray(value).dtype)
        s = cls(dtype, name=name)
        if value is not None:
            dt = s.dtype
            v = storage_scalar(np.asarray(value).astype(dt.np_type).item(),
                               dt)
            s._set_store(torch.tensor(v, dtype=dt.torch_type, device=s.device),
                         torch.ones((), dtype=torch.bool, device=s.device))
        return s

    @property
    def is_empty(self):
        return not bool(self._valid)

    @property
    def value(self):
        """The value as a numpy scalar of the dtype (``np.float32(0.1)``),
        as in the JAX package; None when empty."""
        if self.is_empty:
            return None
        return to_numpy(self._vals, self.dtype)[()]

    def __repr__(self):
        return f"Scalar({self.value!s}, dtype={self.dtype.name})"

    def get(self, default=None):
        return default if self.is_empty else self.value

    # the JAX package's Scalar surface that is not ported yet
    apply = NotPorted(12)
    select = NotPorted(12)
    ewise_add = NotPorted(12)
    ewise_mult = NotPorted(12)
    ewise_union = NotPorted(12)
    dup = NotPorted(12)
    isequal = NotPorted(12)
    isclose = NotPorted(12)
    is_cscalar = NotPorted(12)
    is_grbscalar = NotPorted(12)
