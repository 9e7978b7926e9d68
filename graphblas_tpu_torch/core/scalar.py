"""Scalar: a 0-d (value, valid) store (graphblas_tpu/core/scalar.py).

``value`` is a numpy scalar of the dtype (``np.float32(0.1)``) and may be
set; ``s << x`` and ``s(accum=op) << x`` update it; the element-wise
methods, ``apply`` and ``select`` make Scalar expressions that run on the
dense engine's 0-d stores.  ``is_cscalar`` is kept for the JAX package's
surface: both kinds share one store.  A Scalar compares by value
(``s == 3`` is an expression whose truth is the comparison's), so it is
unhashable, and converts with ``bool``, ``int``, ``float``, ``complex``,
``operator.index`` and ``np.asarray``."""

import numpy as np
import torch

from . import config as _config
from ..exceptions import EmptyObject
from .base import BaseExpression, BaseType, is_scalar_like
from .dtypes import (FP64, host_np_type, lookup_dtype, storage_scalar,
                     to_numpy, to_tensor, unify)
from .engine import store as st
from .mask import Mask
from .operator.base import find_opclass, typed, unparameterized


def _value_dtype(value):
    """The DataType of a Python or numpy scalar (int INT64, float FP64)."""
    if isinstance(value, np.generic):
        return lookup_dtype(value.dtype)
    return lookup_dtype(type(value))


class Scalar(BaseType):
    shape = ()
    ndim = 0
    _is_scalar = True
    _is_cscalar = False

    def __init__(self, dtype=FP64, *, is_cscalar=False, name=None):
        self.dtype = lookup_dtype(dtype)
        self.name = name
        self._is_cscalar = bool(is_cscalar)
        dev = _config.device()
        self._set_store(st.zeros_values((), self.dtype, dev),
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
        if isinstance(value, BaseExpression):
            value = value.new()
        if isinstance(value, Scalar):
            if dtype is None:
                dtype = value.dtype
            value = value.value
        if dtype is None:
            if not is_scalar_like(value):
                raise TypeError(f"Bad value for Scalar: {type(value)}")
            dtype = _value_dtype(value)
        s = cls(dtype, is_cscalar=is_cscalar, name=name)
        s.value = value
        return s

    def __call__(self, *optional, mask=None, accum=None, replace=False,
                 input_mask=None, **opts):
        from .. import replace as replace_singleton

        if replace or any(a is replace_singleton for a in optional):
            raise TypeError("'replace' argument may not be True for Scalar")
        if mask is not None or any(isinstance(a, Mask) for a in optional):
            raise TypeError("Mask not allowed for Scalars")
        if input_mask is not None:
            raise TypeError("input_mask not allowed for Scalars")
        return super().__call__(*optional, accum=accum, **opts)

    # ------------------------------------------------------------------ #
    @property
    def is_cscalar(self):
        return self._is_cscalar

    @property
    def is_grbscalar(self):
        return not self._is_cscalar

    @property
    def is_empty(self):
        return not bool(self._valid)

    @property
    def nvals(self):
        return 0 if self.is_empty else 1

    @property
    def value(self):
        """The value as a numpy scalar of the dtype (a 0-d struct array,
        or the subarray, of a user-defined type); None when empty."""
        if self.is_empty:
            return None
        host = to_numpy(self._vals, self.dtype)
        return host if self.dtype._is_udt else host[()]

    @value.setter
    def value(self, val):
        if isinstance(val, BaseExpression):
            val = val.new()
        if isinstance(val, Scalar):
            val = val.value
        if val is None:
            self.clear()
            return
        dt = self.dtype
        dev = self.device
        if dt._is_udt:
            vals = to_tensor(np.array(val, host_np_type(dt)), dt, dev)
        else:
            v = storage_scalar(np.asarray(val).astype(dt.np_type).item(), dt)
            vals = torch.tensor(v, dtype=dt.torch_type, device=dev)
        self._set_store(vals, torch.ones((), dtype=torch.bool, device=dev))

    def _update_from_value(self, value, accum=None):
        """``s << x`` and ``s(accum=op) << x`` for a Python scalar, a
        Scalar or None."""
        if accum is None or self.is_empty:
            self.value = value
            return
        if isinstance(value, Scalar):
            if value.is_empty:
                return  # nothing to accumulate
            vdt, value = self.dtype, value.value
        elif value is None:
            return
        else:
            vdt = _value_dtype(value)
        from .engine import dense
        from .engine import store as st

        if getattr(accum, "opclass", None) == "Monoid":
            accum = accum.binaryop
        op = typed(accum, unify(self.dtype, vdt), "BinaryOp")
        y = torch.tensor(storage_scalar(
            np.asarray(value).astype(vdt.np_type).item(), vdt),
            dtype=vdt.torch_type, device=self.device)
        z = dense.apply_binop(op, self._vals, self.dtype, y, vdt)
        self._set_store(st.cast_values(z, op.return_type, self.dtype),
                        self._valid)

    def clear(self):
        dev = self.device
        self._set_store(st.zeros_values((), self.dtype, dev),
                        torch.zeros((), dtype=torch.bool, device=dev))

    def dup(self, dtype=None, *, clear=False, is_cscalar=None, name=None,
            **opts):
        dt = self.dtype if dtype is None else lookup_dtype(dtype)
        s = Scalar(dt, is_cscalar=self._is_cscalar if is_cscalar is None
                   else is_cscalar, name=name)
        if not clear and not self.is_empty:
            s.value = self.value
        return s

    def get(self, default=None):
        return default if self.is_empty else self.value

    def _as_other(self, other, within):
        if other is None:
            return None
        if isinstance(other, Scalar):
            return other
        if not is_scalar_like(other):
            raise TypeError(f"Bad type for {within}: {type(other)}")
        return Scalar.from_value(other)

    def isequal(self, other, *, check_dtype=False):
        """Same emptiness and value (and dtype, with check_dtype; a Python
        value's inferred dtype is not checked)."""
        if not isinstance(other, Scalar):
            check_dtype = False
        other = self._as_other(other, "isequal")
        if other is None:
            return self.is_empty
        if check_dtype and self.dtype != other.dtype:
            return False
        if self.is_empty or other.is_empty:
            return self.is_empty and other.is_empty
        if self.dtype._is_udt:
            return bool(np.array_equal(self.value, other.value))
        return bool(self.value == other.value)

    def isclose(self, other, *, rel_tol=1e-7, abs_tol=0.0, check_dtype=False):
        if not isinstance(other, Scalar):
            check_dtype = False
        other = self._as_other(other, "isclose")
        if other is None:
            return self.is_empty
        if check_dtype and self.dtype != other.dtype:
            return False
        if self.is_empty or other.is_empty:
            return self.is_empty and other.is_empty
        return bool(np.isclose(self.value, other.value, rtol=rel_tol,
                               atol=abs_tol))

    # ------------------------------------------------------------------ #
    # expressions over 0-d stores
    def _ewise(self, variant, other, op, ldef=None, rdef=None):
        if isinstance(other, BaseExpression):
            other = other.new()
        if not isinstance(other, Scalar):
            if not is_scalar_like(other):
                raise TypeError(f"Bad type for argument `other` in "
                                f"ewise_{variant}: {type(other)}")
            other = Scalar.from_value(other)
        op = unparameterized(op)
        if getattr(op, "opclass", None) == "Monoid":
            op = op.binaryop
        bop = typed(op, unify(self.dtype, other.dtype), "BinaryOp")
        lv = rv = None
        if variant == "union":
            for d in (ldef, rdef):
                if isinstance(d, Scalar) and d.is_empty:
                    raise EmptyObject("Empty Scalar is not allowed as an "
                                      "ewise_union default")
            lv, rv = (Scalar.from_value(d, t)
                      for d, t in ((ldef, bop.type), (rdef, bop.type2)))
        return BaseExpression(f"ewise_{variant}", bop, [self, other],
                              bop.return_type, (), Scalar,
                              (variant, False, False, False, False, lv, rv))

    def ewise_add(self, other, op="plus"):
        return self._ewise("add", other, op)

    def ewise_mult(self, other, op="times"):
        return self._ewise("mult", other, op)

    def ewise_union(self, other, op, left_default, right_default):
        return self._ewise("union", other, op, left_default, right_default)

    def apply(self, op, right=None, *, left=None):
        """A unary op, or a binary op with a bound scalar."""
        from .collection import apply_expr

        return apply_expr(self, op, right, left)

    def select(self, op, thunk=None):
        """The value if a value select operator holds on it, else empty;
        ``s.select(s < 10)`` is read as ``valuelt`` with thunk 10."""
        from .collection import select_expr

        if isinstance(op, BaseExpression):
            from ..select import match_expr

            match = match_expr(self, op)
            if match is None:
                raise TypeError("Unable to interpret select expression; "
                                "use a SelectOp")
            op, thunk = match
        op = unparameterized(op)
        if find_opclass(op)[1] in ("SelectOp", "IndexUnaryOp") and \
                op._positional is not None:
            raise TypeError("positional select ops are not defined for "
                            "Scalar")
        return select_expr(self, op, thunk)

    # ------------------------------------------------------------------ #
    def __repr__(self):
        from . import formatting

        return formatting.format_scalar(self)

    def _repr_html_(self):
        from . import formatting

        return formatting.format_scalar_html(self)

    def __reduce__(self):
        dt = self.dtype if self.dtype._is_udt else self.dtype.name
        return (_deserialize_scalar, (dt, self.value, self._is_cscalar,
                                      self._name))

    def __invert__(self):
        from ..unary import lnot

        if not self.dtype.is_bool:
            raise TypeError(f"The invert operator, `~x`, is only supported "
                            f"for BOOL dtype, not {self.dtype.name}")
        return self.apply(lnot)

    def __bool__(self):
        return False if self.is_empty else bool(self.value)

    def _nonempty_value(self):
        if self.is_empty:
            raise TypeError("Scalar is empty")
        return self.value

    def __int__(self):
        return int(self._nonempty_value())

    def __float__(self):
        return float(self._nonempty_value())

    def __complex__(self):
        return complex(self._nonempty_value())

    def __index__(self):
        if not (self.dtype.is_int or self.dtype.is_bool):
            raise TypeError("Scalar object cannot be interpreted as an "
                            "integer")
        return int(self.value)

    def __array__(self, dtype=None, **kwargs):
        return np.array(self.value,
                        self.dtype.np_type if dtype is None else dtype)


def _deserialize_scalar(dtype, value, is_cscalar, name):
    s = Scalar(dtype, is_cscalar=is_cscalar, name=name)
    if value is not None:
        s.value = value
    return s
