"""Collections and expressions: ``<<``, ``.new()``,
``c(mask=, accum=, replace=)`` (graphblas_tpu/core/base.py).

A collection has one of two backings.  The dense one is a (values, valid)
pair of tensors on its device.  A Matrix with more than
``auto_sparse_limit`` elements is sparse-backed instead (a SparseStore of
COO tensors on its device); reading ``_vals``/``_valid`` of such a matrix
densifies it, under the ``dense_limit`` guard, which is what an operation
without a sparse path does."""

import torch

from . import config as _config
from . import execute
from ..exceptions import OutOfMemory
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
                 **opts):
        from .expr import Updater

        mask, accum = _split_call_args(optional, mask, accum)
        if mask is not None and not isinstance(mask, Mask):
            raise TypeError(f"mask must be a Mask (v.S, v.V, ~v.S); got "
                            f"{type(mask).__name__}")
        return Updater(self, mask=mask, accum=accum, replace=replace,
                       opts=opts)

    def __lshift__(self, expr):
        return self.update(expr)

    def update(self, expr, **opts):
        execute.update_into(self, execute.as_expr(expr), opts=opts)

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
