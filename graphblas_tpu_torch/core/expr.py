"""Indexing and the updater protocol (graphblas_tpu/core/expr.py).

``IndexerResolver`` parses int, negative int, slice, list, array and
Scalar indices; ``AmbiguousAssignOrExtract`` (``C[idx]``) extracts when
used as a value and assigns when used as a target; ``C[idx](mask)`` is a
submask assigner (GxB_subassign: mask and replace scoped to the region);
``Updater`` (``C(mask, accum, replace, input_mask)``) carries its
arguments into ``<<``, ``[idx] =`` and ``del [idx]``."""

import numpy as np

from ..exceptions import IndexOutOfBound


class AxisIndex:
    """One resolved axis: a single int (the axis collapses) or an int64
    array (the axis stays).  A slice keeps its range and makes the array
    only when it is read, so a whole-axis slice costs nothing; the order
    of an array is found once."""

    __slots__ = ("size", "dimsize", "_index", "_range", "_increasing")

    def __init__(self, size, index, dimsize, rng=None):
        self.size = size  # None: a scalar axis
        self.dimsize = dimsize
        self._index = index
        self._range = rng
        self._increasing = None

    @property
    def is_scalar(self):
        return self.size is None

    @property
    def index(self):
        if self._index is None:
            self._index = np.arange(*self._range, dtype=np.int64)
        return self._index

    def array(self):
        """The axis as an int64 array (a scalar axis as one element)."""
        if self.is_scalar:
            return np.array([self.index], np.int64)
        return self.index

    @property
    def is_full(self):
        """Does the axis list 0 .. dimsize-1 in order?"""
        n = self.dimsize
        if self.is_scalar:
            return n == 1
        if self._range is not None:
            r = range(*self._range)
            return len(r) == n and n > 0 and r.start == 0 and \
                (n == 1 or r.step == 1)
        a = self._index
        return (len(a) == n and n > 0 and int(a[0]) == 0
                and int(a[-1]) == n - 1
                and (n < 2 or bool((np.diff(a) == 1).all())))

    @property
    def is_increasing(self):
        """Strictly increasing (duplicate-free and in order)?"""
        if self.is_scalar:
            return True
        if self._range is not None:
            return self._range[2] > 0
        if self._increasing is None:
            a = self._index
            self._increasing = len(a) < 2 or bool((a[1:] > a[:-1]).all())
        return self._increasing

    @property
    def is_unique(self):
        if self.is_scalar or self._range is not None or self.is_increasing:
            return True
        return len(np.unique(self._index)) == len(self._index)


def _normalize_one(idx, dimsize):
    idx = int(idx)
    if idx < 0:
        idx += dimsize
    if idx < 0 or idx >= dimsize:
        raise IndexOutOfBound(f"index={idx} is out of bounds for size "
                              f"{dimsize}")
    return idx


def resolve_axis(index, dimsize):
    from .scalar import Scalar

    if isinstance(index, Scalar):
        if index.dtype.name.startswith("F"):
            raise TypeError("An integer is required for indexing")
        v = index.value
        if v is None:
            raise TypeError("A value is required for indexing; got an empty "
                            "Scalar")
        return AxisIndex(None, _normalize_one(v, dimsize), dimsize)
    if isinstance(index, (int, np.integer)):
        return AxisIndex(None, _normalize_one(index, dimsize), dimsize)
    if isinstance(index, slice):
        rng = index.indices(dimsize)
        return AxisIndex(len(range(*rng)), None, dimsize, rng)
    if isinstance(index, (list, tuple, np.ndarray)) or \
            hasattr(index, "__array__"):
        arr = np.asarray(index)
        if arr.dtype == bool:
            raise TypeError("Boolean mask indexing is not supported; use "
                            "masks (M.S/M.V)")
        if not np.issubdtype(arr.dtype, np.integer):
            raise TypeError(f"Indices must be integers; got {arr.dtype}")
        arr = arr.astype(np.int64, copy=True)
        if arr.ndim != 1:
            raise TypeError(f"Index array must be 1-dimensional; got "
                            f"{arr.ndim}")
        arr[arr < 0] += dimsize
        if arr.size and ((arr < 0).any() or (arr >= dimsize).any()):
            raise IndexOutOfBound(f"index out of bounds for size {dimsize}")
        return AxisIndex(len(arr), arr, dimsize)
    raise TypeError(f"Invalid index type: {type(index)}")


class IndexerResolver:
    __slots__ = ("obj", "indices")

    def __init__(self, obj, keys):
        self.obj = obj
        if keys is Ellipsis:  # v[...] / A[...]: the whole collection
            keys = slice(None) if obj.ndim == 1 else (slice(None),) * 2
        if obj.ndim == 1:
            if isinstance(keys, tuple):
                if len(keys) != 1:
                    raise TypeError(f"Vector is indexed with 1 index; got "
                                    f"{len(keys)}")
                keys = keys[0]
            self.indices = [resolve_axis(keys, obj.shape[0])]
        else:
            if not isinstance(keys, tuple):
                if isinstance(keys, (int, np.integer, slice, list,
                                     np.ndarray)):
                    raise TypeError("Matrix requires 2 indices: row and "
                                    "column, e.g. A[3, 5]")
                raise TypeError(f"Invalid index: {keys!r}")
            if len(keys) != 2:
                raise TypeError(f"Matrix is indexed with 2 indices; got "
                                f"{len(keys)}")
            self.indices = [resolve_axis(keys[0], obj.shape[0]),
                            resolve_axis(keys[1], obj.shape[1])]

    @property
    def is_single_element(self):
        return all(ix.is_scalar for ix in self.indices)

    @property
    def out_shape(self):
        return tuple(ix.size for ix in self.indices if not ix.is_scalar)


class Updater:
    """``C(mask=, accum=, replace=, input_mask=)``."""

    def __init__(self, parent, *, mask=None, accum=None, replace=False,
                 input_mask=None, opts=None):
        if replace and mask is None:
            raise ValueError("replace=True requires a mask")
        self.parent = parent
        self.mask = mask
        self.accum = accum
        self.replace = replace
        self.input_mask = input_mask
        self.opts = opts

    def __lshift__(self, expr):
        return self.update(expr)

    def update(self, expr):
        self.parent._update(expr, mask=self.mask, accum=self.accum,
                            replace=self.replace, input_mask=self.input_mask,
                            opts=self.opts)

    def __getitem__(self, keys):
        return Assigner(self, IndexerResolver(self.parent, keys))

    def __setitem__(self, keys, value):
        Assigner(self, IndexerResolver(self.parent, keys)).update(value)

    def __delitem__(self, keys):
        self.parent._delete_at(IndexerResolver(self.parent, keys),
                               mask=self.mask)


class Assigner:
    """``C(mask)[idx] << value`` (is_submask: ``C[idx](mask) << value``)."""

    def __init__(self, updater, resolver, *, is_submask=False):
        self.updater = updater
        self.resolver = resolver
        self.is_submask = is_submask

    def __lshift__(self, value):
        self.update(value)

    def update(self, value):
        u = self.updater
        if u.input_mask is not None:
            raise TypeError("`input_mask` argument may only be used for "
                            "extract")
        u.parent._assign_at(self.resolver, value, mask=u.mask,
                            accum=u.accum, replace=u.replace,
                            is_submask=self.is_submask)


class AmbiguousAssignOrExtract:
    """``C[idx]``: an extract when used as a value, an assign when used as
    a target."""

    def __init__(self, parent, resolver):
        self.parent = parent
        self.resolver = resolver
        self._value = None

    @property
    def shape(self):
        return self.resolver.out_shape

    @property
    def ndim(self):
        return len(self.resolver.out_shape)

    @property
    def dtype(self):
        return self.parent.dtype

    @property
    def output_type(self):
        from .matrix import Matrix
        from .scalar import Scalar
        from .vector import Vector

        return (Scalar, Vector, Matrix)[self.ndim]

    def __call__(self, *args, **kwargs):
        """``C[idx](mask)``: a mask shaped like the region (GxB_subassign
        semantics), where ``C(mask)[idx]`` takes one shaped like C."""
        updater = self.parent(*args, _mask_shape=self.resolver.out_shape,
                              **kwargs)
        return Assigner(updater, self.resolver, is_submask=True)

    def _as_extract_expr(self, input_mask=None):
        return self.parent._extract_expr(self.resolver, input_mask=input_mask)

    def new(self, dtype=None, *, mask=None, input_mask=None, name=None,
            **opts):
        if input_mask is not None:
            if mask is not None:
                raise TypeError("mask and input_mask arguments cannot both "
                                "be given")
            from .base import check_mask

            expr = self._as_extract_expr(check_mask(input_mask))
            return expr.new(dtype, name=name, **opts)
        return self._as_extract_expr().new(dtype, mask=mask, name=name,
                                           **opts)

    dup = new

    def update(self, value):
        self.parent._assign_at(self.resolver, value, mask=None, accum=None,
                               replace=False, is_submask=False)

    def __lshift__(self, value):
        self.update(value)

    def _get_value(self, attr=None):
        if self._value is None:
            self._value = self.new()
        return self._value if attr is None else getattr(self._value, attr)

    @property
    def value(self):
        if self.ndim != 0:
            raise AttributeError("only Scalar elements have `.value`")
        return self._get_value("value")

    def __getattr__(self, attr):
        """Autocompute: an attribute the expression lacks is read from the
        extracted value, computed once."""
        if attr.startswith("_"):
            raise AttributeError(attr)
        return self._get_value(attr)

    def __repr__(self):
        return (f"{type(self.parent).__name__}[...] (ambiguous "
                f"assign-or-extract)")

    def _scalar_value(self):
        if self.ndim != 0:
            raise TypeError("only a single element converts to a Python "
                            "value")
        return self._get_value("value")

    def __eq__(self, other):
        return self._scalar_value() == other

    def __ne__(self, other):
        return self._scalar_value() != other

    __hash__ = None

    def __bool__(self):
        return bool(self._scalar_value())

    def __int__(self):
        return int(self._scalar_value())

    def __float__(self):
        return float(self._scalar_value())

    def __index__(self):
        return int(self._scalar_value())
