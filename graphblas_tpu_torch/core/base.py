"""Collections and expressions: ``<<``, ``.new()``,
``c(mask=, accum=, replace=)`` (graphblas_tpu/core/base.py).

A collection has one of two backings.  The dense one is a (values, valid)
pair of tensors on its device.  A Matrix with more than
``auto_sparse_limit`` elements is sparse-backed instead (a SparseStore of
COO tensors on its device); reading ``_vals``/``_valid`` of such a matrix
densifies it, under the ``dense_limit`` guard, which is what an operation
without a sparse path does."""

import numpy as np
import torch

from . import config as _config
from . import execute
from ..exceptions import DimensionMismatch, OutOfMemory
from .mask import Mask


def _split_call_args(optional, mask, accum, replace):
    """``c(M)``, ``c(accum)``, ``c(M, accum)`` and ``c(M, replace)``
    positional forms (``replace`` is ``graphblas_tpu_torch.replace``)."""
    from .. import replace as replace_singleton

    for arg in optional:
        if arg is replace_singleton:
            replace = True
        elif isinstance(arg, Mask):
            if mask is not None:
                raise TypeError("Got multiple values for argument 'mask'")
            mask = arg
        else:
            if accum is not None:
                raise TypeError("Got multiple values for argument 'accum'")
            accum = arg
    return mask, accum, replace


def check_mask(mask, output=None):
    """A Mask (``M.S``, ``M.V``, ``~M.S``, ...), and of output's shape
    where it has output's rank (a Vector mask on a Matrix is checked where
    a row or column assignment takes it)."""
    if not isinstance(mask, Mask):
        if isinstance(mask, BaseType):
            raise TypeError("Mask must indicate values (M.V) or structure "
                            "(M.S); got a bare collection.  Use `M.S` or "
                            "`M.V`.")
        raise TypeError(f"mask must be a Mask (v.S, v.V, ~v.S); got "
                        f"{type(mask).__name__}")
    if (output is not None and mask.parent.ndim == output.ndim
            and tuple(output.shape) != tuple(mask.parent.shape)):
        raise DimensionMismatch(
            f"mask shape {mask.parent.shape} does not match output shape "
            f"{output.shape}")
    return mask


def is_scalar_like(value):
    """A Python or numpy scalar (what the JAX package's
    ``_is_scalar_like`` takes)."""
    return isinstance(value, (int, float, bool, complex, np.number,
                              np.bool_))


class BaseType:
    """A Matrix, Vector or Scalar."""

    _d_vals = None
    _d_valid = None
    _sparse = None
    _device = None

    def _set_store(self, vals, valid):
        self._d_vals = vals
        self._d_valid = valid
        self._sparse = None
        self._device = valid.device

    def _set_sparse_store(self, sp):
        """Adopt a SparseStore (engine/sparse.py) as the backing."""
        self._sparse = sp
        self._d_vals = None
        self._d_valid = None
        self._device = sp.device

    @property
    def _vals(self):
        if self._sparse is not None:
            self._densify()
        return self._d_vals

    @property
    def _valid(self):
        if self._sparse is not None:
            self._densify()
        return self._d_valid

    def _densify(self):
        """Convert the sparse backing to the bitmap store, guarded by the
        ``dense_limit`` config so that an O(nrows*ncols) allocation on a
        graph-scale matrix raises instead of exhausting device memory."""
        self._set_store(*self._dense_planes())

    def _dense_planes(self):
        """The sparse backing as (values, valid) planes, under the
        ``dense_limit`` guard; the backing itself is kept."""
        sp = self._sparse
        limit = int(_config.config.get("dense_limit", 1 << 26))
        total = sp.nrows * max(sp.ncols, 1)
        if total > limit:
            raise OutOfMemory(
                f"operation requires densifying a {sp.nrows}x{sp.ncols} "
                f"sparse {type(self).__name__} ({total} > dense_limit="
                f"{limit}).  This operation has no sparse path in the "
                f"PyTorch port yet; raise config[\"dense_limit\"] to force "
                f"it on a small matrix.")
        from .engine import sparse as spx

        return spx.densify(sp, self.dtype, self._device)

    @property
    def device(self):
        return self._device

    @property
    def nvals(self):
        if self._sparse is not None:
            return self._sparse.nvals()
        return int(self._d_valid.sum())

    def _host_arrays(self):
        """(values ndarray, valid ndarray) on the host."""
        from . import dtypes as _dt

        return (_dt.to_numpy(self._vals, self.dtype),
                self._valid.cpu().numpy())

    def __call__(self, *optional, mask=None, accum=None, replace=False,
                 input_mask=None, _mask_shape=None, **opts):
        """``C(mask, accum, replace=, input_mask=)``.  ``_mask_shape`` is
        the region's shape for a submask (``C[idx](mask)``), whose mask is
        shaped like the region and not like C."""
        from .expr import Updater

        mask, accum, replace = _split_call_args(optional, mask, accum,
                                                replace)
        if mask is not None:
            if _mask_shape is None:
                mask = check_mask(mask, self)
            else:
                mask = check_mask(mask)
                region = tuple(_mask_shape)
                if mask.parent.ndim != len(region):
                    kind = "Vector" if len(region) == 1 else "Matrix"
                    got = "Matrix" if mask.parent.ndim == 2 else "Vector"
                    raise TypeError(f"Indices for subassign imply {kind} "
                                    f"submask, but got {got} mask instead")
                if tuple(mask.parent.shape) != region:
                    raise DimensionMismatch(
                        f"mask shape {mask.parent.shape} does not match "
                        f"region shape {region}")
        if input_mask is not None:
            if mask is not None:
                raise TypeError("mask and input_mask arguments cannot both "
                                "be given")
            input_mask = check_mask(input_mask)
        return Updater(self, mask=mask, accum=accum, replace=replace,
                       input_mask=input_mask, opts=opts)

    def __lshift__(self, expr):
        return self.update(expr)

    def update(self, expr, **opts):
        self._update(expr, opts=opts)

    def _update(self, expr, *, mask=None, accum=None, replace=False,
                input_mask=None, opts=None):
        """``C(mask, accum, replace, input_mask) << expr``: an expression,
        a collection to copy, an extract (``A[idx]``, where input_mask
        filters A first) or a scalar, which is assigned to every element."""
        from .expr import AmbiguousAssignOrExtract, IndexerResolver

        if isinstance(expr, AmbiguousAssignOrExtract):
            expr = expr._as_extract_expr(input_mask)
        elif input_mask is not None:
            raise TypeError("`input_mask` argument may only be used for "
                            "extract")
        if self.ndim and (is_scalar_like(expr) or (
                isinstance(expr, BaseType) and expr.ndim == 0)):
            keys = (slice(None),) * self.ndim
            self._assign_at(IndexerResolver(self, keys), expr, mask=mask,
                            accum=accum, replace=replace, is_submask=False)
            return
        execute.update_into(self, execute.as_expr(expr), mask=mask,
                            accum=accum, replace=replace, opts=opts)

    def clear(self):
        """Remove every element (the shape, type and backing stay)."""
        if self._sparse is not None:
            from .engine import sparse as spx

            self._set_sparse_store(spx.empty_store(
                *self.shape, self.dtype, self._device))
            return
        self._set_store(torch.zeros_like(self._d_vals),
                        torch.zeros_like(self._d_valid))

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

    def new(self, dtype=None, *, mask=None, name=None, **opts):
        from .dtypes import lookup_dtype

        out_dtype = self.dtype if dtype is None else lookup_dtype(dtype)
        return execute.materialize(self, out_dtype, mask=mask, name=name,
                                   opts=opts)

    def __repr__(self):
        return f"<{self.output_type.__name__} expression {self.method_name}>"

    def __getattr__(self, attr):
        """Autocompute: an attribute the expression lacks is read from its
        computed value (``A.apply(op).reduce(...)``), computed once."""
        if attr.startswith("_") or attr in ("method_name", "op", "args",
                                            "dtype", "shape", "output_type"):
            raise AttributeError(attr)
        value = self.__dict__.get("_value")
        if value is None:
            value = self._value = self.new()
        return getattr(value, attr)


class NotPorted:
    """A name of the JAX package's surface that the port lacks: reading it
    (on the class or an instance) raises NotImplementedError naming its
    ROADMAP.md queue-1 item."""

    def __init__(self, item):
        self.item = item
        self.name = None

    def __set_name__(self, owner, name):
        self.name = f"{owner.__name__}.{name}"

    def __get__(self, obj, objtype=None):
        from .operator.base import not_ported

        raise not_ported(self.name, self.item)


def infix_not_ported(symbol):
    """An infix operator (``A @ B``, ``A | B``, ``A & B``) of the JAX
    package: it raises NotImplementedError (not ``NotImplemented``, which
    Python would turn into a TypeError)."""
    def method(self, other):
        from .operator.base import not_ported

        raise not_ported(f"the infix operator {symbol}", 12)

    method.__name__ = f"infix {symbol}"
    return method


class InfixStubs:
    """The JAX package's infix expressions (core/infix.py), not ported."""

    __matmul__ = __rmatmul__ = infix_not_ported("@")
    __or__ = __ror__ = infix_not_ported("|")
    __and__ = __rand__ = infix_not_ported("&")
