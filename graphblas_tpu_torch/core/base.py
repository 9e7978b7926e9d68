"""Collections and expressions: ``<<``, ``.new()``,
``c(mask=, accum=, replace=)`` (graphblas_tpu/core/base.py), with the
type checks ``_expect_type``/``_expect_op``, autocompute (an expression
used where a value is needed is computed once) and the JAX package's
``TypeError`` for ``bool(A)`` and ``np.asarray(A)``.

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
from . import trace as _trace
from ..exceptions import DimensionMismatch, OutOfMemory
from .mask import Mask
from .operator.base import find_opclass
from .opts import validate_opts


def _expect_type(self, x, types, *, within=None, argname=None,
                 extra_message=""):
    """x itself if it is one of types; an expression whose output type is
    one of them, computed (autocompute); else TypeError."""
    if isinstance(x, types):
        return x
    tt = types if isinstance(types, tuple) else (types,)
    out_t = getattr(x, "output_type", None)
    if (isinstance(out_t, type) and hasattr(x, "new")
            and any(issubclass(out_t, t) for t in tt)
            and _config.config.get("autocompute", True)):
        return x.new()
    names = ", ".join(t.__name__ for t in tt)
    where = f" (in {within!r})" if within else ""
    arg = f" for argument {argname!r}" if argname else ""
    raise TypeError(f"Bad type{arg}{where}: expected {names}, got "
                    f"{type(x).__name__}."
                    + (f"  {extra_message}" if extra_message else ""))


def _expect_op(self, op, opclasses, *, within=None, argname=None):
    op, opclass = find_opclass(op)
    if isinstance(opclasses, str):
        opclasses = (opclasses,)
    if opclass not in opclasses:
        raise TypeError(f"Bad operator type for {within or 'operation'}: "
                        f"expected {' or '.join(opclasses)}, got {opclass} "
                        f"({op!r})")
    return op


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
        elif isinstance(arg, BaseType) or hasattr(arg, "output_type"):
            raise TypeError("Mask must indicate values (M.V) or structure "
                            "(M.S)")
        else:
            opclass = find_opclass(arg)[1]
            if opclass == "UnknownOpClass":
                raise TypeError(f"Invalid item found in output params: "
                                f"{type(arg)}")
            if opclass not in ("BinaryOp", "Monoid"):
                raise TypeError(f"accum must be a BinaryOp, not {opclass}")
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
                              np.bool_, np.void))


class BaseType:
    """A Matrix, Vector or Scalar."""

    _d_vals = None
    _d_valid = None
    _sparse = None
    _dist = None  # row blocks from parallel.shard_matrix (a BlockedCSR)
    _device = None
    _name = None
    _is_scalar = False

    _expect_type = _expect_type
    _expect_op = _expect_op

    @property
    def name(self):
        return self._name

    @name.setter
    def name(self, value):
        self._name = value

    def __bool__(self):
        raise TypeError(f"__bool__ not defined for objects of type "
                        f"{type(self).__name__}.  Perhaps use .nvals "
                        f"attribute instead.")

    def __array__(self, dtype=None, **kwargs):
        raise TypeError(f"{type(self).__name__} can't be directly converted "
                        f"to a numpy array; perhaps use `.to_coo()` or "
                        f"`.to_dense()`")

    def _set_store(self, vals, valid):
        self._d_vals = vals
        self._d_valid = valid
        self._sparse = None
        self._dist = None
        self._device = valid.device

    def _set_sparse_store(self, sp):
        """Adopt a SparseStore (engine/sparse.py) as the backing."""
        self._sparse = sp
        self._d_vals = None
        self._d_valid = None
        self._dist = None
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
        graph-scale matrix raises instead of exhausting device memory.  A
        change of representation only: the row blocks stay."""
        dist = self._dist
        self._set_store(*self._dense_planes())
        self._dist = dist

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
        with _trace.span("gb.op:nvals"):
            return _trace.read("base.nvals", int, self._d_valid.sum())

    def _host_arrays(self):
        """(values ndarray, valid ndarray) on the host."""
        from . import dtypes as _dt

        return (_dt.to_numpy(self._vals, self.dtype),
                _trace.to_host("base.valid", self._valid))

    def __call__(self, *optional, mask=None, accum=None, replace=False,
                 input_mask=None, _mask_shape=None, **opts):
        """``C(mask, accum, replace=, input_mask=)``.  ``_mask_shape`` is
        the region's shape for a submask (``C[idx](mask)``), whose mask is
        shaped like the region and not like C."""
        from .expr import Updater

        mask, accum, replace = _split_call_args(optional, mask, accum,
                                                replace)
        if replace and mask is None:
            raise TypeError("'replace' argument may only be True if a mask "
                            "is provided")
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
        self._update(expr, opts=validate_opts(opts))

    def _update(self, expr, *, mask=None, accum=None, replace=False,
                input_mask=None, opts=None):
        """``C(mask, accum, replace, input_mask) << expr``: an expression,
        a collection to copy, an extract (``A[idx]``, where input_mask
        filters A first) or a scalar, which is assigned to every element."""
        from .expr import (AmbiguousAssignOrExtract, IndexerResolver,
                           InfixExprBase)

        if isinstance(expr, InfixExprBase):
            expr = expr._to_expr()
        if isinstance(expr, AmbiguousAssignOrExtract):
            expr = expr._as_extract_expr(input_mask)
        elif input_mask is not None:
            raise TypeError("`input_mask` argument may only be used for "
                            "extract")
        if self._is_scalar and (is_scalar_like(expr) or expr is None or (
                isinstance(expr, BaseType) and expr._is_scalar)):
            self._update_from_value(expr, accum=accum)
            return
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
            _trace.read("base.wait", torch.cuda.synchronize, self.device)
        return self


class BaseExpression:
    """A deferred operation; ``.new()`` or ``c << expr`` computes it.  An
    attribute the expression lacks is read from its computed value
    (autocompute), computed once."""

    def __init__(self, method_name, op, args, dtype, shape, output_type,
                 statics=(), public_name=None):
        self._kind = method_name  # what execute dispatches on
        self.method_name = public_name or method_name  # the JAX package's
        self.op = op
        self.args = args
        self.dtype = dtype
        self.shape = shape
        self.output_type = output_type
        self._statics = statics
        self._value = None
        self._name = None

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def name(self):
        if self._name is not None:
            return self._name
        opname = getattr(self.op, "name", self.op)
        return f"{type(self).__name__.lower()}.{self.method_name}({opname})"

    @name.setter
    def name(self, value):
        self._name = value

    def new(self, dtype=None, *, mask=None, name=None, is_cscalar=None,
            **opts):
        from .dtypes import lookup_dtype

        opts = validate_opts(opts)
        out_dtype = self.dtype if dtype is None else lookup_dtype(dtype)
        rv = self._value
        if mask is None and rv is not None and rv.dtype == out_dtype:
            # the autocomputed value, handed over once
            self._value = None
            if name is not None:
                rv.name = name
            return rv
        if mask is not None:
            mask = check_mask(mask)
        out = execute.materialize(self, out_dtype, mask=mask, name=name,
                                  opts=opts)
        if is_cscalar is not None and out._is_scalar:
            out._is_cscalar = bool(is_cscalar)
        return out

    dup = new

    def _get_value(self, attr=None, default=None):
        if not _config.config.get("autocompute", True):
            if default is not None:
                return default
            raise TypeError(f"{type(self).__name__} is not computed "
                            f"automatically because "
                            f"`gb.config['autocompute']` is False.  Call "
                            f"`.new()` to compute.")
        if self._value is None:
            self._value = self.new()
        return self._value if attr is None else getattr(self._value, attr)

    def __repr__(self):
        from . import formatting

        return formatting.format_expression(self)

    def _repr_html_(self):
        return f"<pre>{self!r}</pre>"

    def __getattr__(self, attr):
        if attr.startswith("_") or attr in ("method_name", "op", "args",
                                            "dtype", "shape", "output_type"):
            raise AttributeError(attr)
        return self._get_value(attr)


class SSDescriptor:
    """``x.ss``: the object's ss extension (made once and kept, with its
    per-object config); on the class, the extension class itself (whose
    importers are classmethods)."""

    def __init__(self, loader):
        self._loader = loader

    def __get__(self, obj, objtype=None):
        cls = self._loader()
        if obj is None:
            return cls
        ss = obj.__dict__.get("_ss")
        if ss is None:
            ss = obj.__dict__["_ss"] = cls(obj)
        return ss
