"""Vector: a dense (values, valid) store on the configured device
(graphblas_tpu/core/vector.py): construction (``from_coo``, ``from_pairs``,
``from_dict``, ``build``) and export, ``resize``, extract, assign and
delete by index (core/collection.py), membership and iteration, the
products, ``outer``, element-wise operations, apply, select, reduce (by a
monoid or an aggregator) and reposition.  ``Vector.ss`` is
core/ss/vector.py; the reprs are core/formatting.py's; a pickle holds the
COO, as the JAX package's."""

import numpy as np
import torch

from . import config as _config
from . import dtypes as _dt
from ..exceptions import (DimensionMismatch, EmptyObject, IndexOutOfBound,
                          OutputNotEmpty)
from .base import BaseExpression, SSDescriptor
from .collection import Collection, apply_expr, ewise_expr, select_expr
from .engine import store as st
from .mask import StructuralMask, ValueMask
from .operator.base import typed
from .utils import ints_to_numpy_buffer


def _values_dtype(values, dtype):
    """numpy values and their DataType (inferred when dtype is None); with a
    dtype, Python numbers convert to it exactly, as in the JAX package
    (values_to_numpy_buffer), so that 2**64 - 1 stays a UINT64."""
    if dtype is None:
        values = np.asarray(values)
        return values, _dt.lookup_dtype(values.dtype)
    dt = _dt.lookup_dtype(dtype)
    return np.array(values, _dt.host_np_type(dt), copy=None), dt


def _broadcast_values(values, shape, dt):
    """values, or one value broadcast to every index of shape."""
    sub = _dt.value_shape(dt)
    if values.ndim == len(sub):
        return np.broadcast_to(values, tuple(shape) + sub)
    return values


class Vector(Collection):
    ndim = 1

    def __init__(self, dtype=_dt.FP64, size=0, *, name=None):
        self.dtype = _dt.lookup_dtype(dtype)
        size = int(size)
        if size < 0:
            raise ValueError("size must be non-negative")
        self.name = name
        dev = _config.device()
        self._set_store(st.zeros_values((size,), self.dtype, dev),
                        torch.zeros(size, dtype=torch.bool, device=dev))

    @classmethod
    def _empty(cls, dtype, shape, name=None):
        return cls(dtype, shape[0], name=name)

    @classmethod
    def _from_store(cls, dtype, vals, valid, name=None):
        v = cls.__new__(cls)
        v.dtype = _dt.lookup_dtype(dtype)
        v.name = name
        v._set_store(vals, valid)
        return v

    @property
    def size(self):
        return int(self._valid.shape[0])

    @property
    def shape(self):
        return (self.size,)

    @property
    def S(self):
        return StructuralMask(self)

    @property
    def V(self):
        return ValueMask(self)

    def __repr__(self):
        from . import formatting

        return formatting.format_vector(self)

    def _repr_html_(self, mask=None):
        from . import formatting

        return formatting.format_vector_html(self, mask=mask)

    def __reduce__(self):
        """Pickled as the JAX package pickles a Vector: its COO."""
        idx, vals = self.to_coo()
        dt = self.dtype if self.dtype._is_udt else self.dtype.name
        return (Vector._deserialize, (dt, self.size, idx, vals, self._name))

    @staticmethod
    def _deserialize(dtype, size, idx, vals, name):
        v = Vector(dtype, size, name=name)
        if len(idx):
            v.build(idx.astype(np.int64), vals)
        return v

    # ------------------------------------------------------------------ #
    # constructors and exports
    @classmethod
    def from_coo(cls, indices, values=1.0, dtype=None, *, size=None,
                 dup_op=None, name=None):
        indices = np.asarray(indices, np.int64).reshape(-1)
        values, dt = _values_dtype(values, dtype)
        values = np.broadcast_to(values,
                                 indices.shape + _dt.value_shape(dt))
        if size is None:
            if len(indices) == 0:
                raise ValueError("No indices provided. Unable to infer size.")
            size = int(indices.max()) + 1
        if len(indices) and (indices.min() < 0 or indices.max() >= size):
            raise IndexError(f"index out of bounds for size {size}")
        v = cls(dt, size, name=name)
        v.build(indices, values, dup_op=dup_op)
        return v

    @classmethod
    def from_pairs(cls, pairs, dtype=None, *, size=None, name=None):
        """From (index, value) pairs."""
        pairs = list(pairs)
        if any(len(p) != 2 for p in pairs):
            raise ValueError("All pairs must be length 2")
        return cls.from_coo(np.array([p[0] for p in pairs], np.int64),
                            [p[1] for p in pairs], dtype, size=size,
                            name=name)

    @classmethod
    def from_dict(cls, d, dtype=None, *, size=None, name=None):
        """From {index: value}."""
        if size is None and len(d) == 0:
            raise ValueError("Unable to infer size from an empty dict")
        values = list(d.values())
        return cls.from_coo(np.fromiter(d.keys(), np.int64, len(d)),
                            values if values else np.array([], np.float64),
                            dtype, size=size, name=name)

    def build(self, indices, values, *, dup_op=None, clear=False,
              size=None):
        """Set the elements from indices and values (duplicates combine
        with dup_op) into an empty vector, or, with clear, after removing
        its elements."""
        if size is not None:
            raise TypeError("`size` keyword arg is not supported (resize "
                            "first)")
        if not clear and self.nvals > 0:
            raise OutputNotEmpty("Vector already contains values; use "
                                 "clear=True")
        indices = ints_to_numpy_buffer(indices, np.int64, name="indices")
        values = _broadcast_values(_values_dtype(values, self.dtype)[0],
                                   indices.shape, self.dtype)
        if len(indices) != len(values):
            raise ValueError(f"`indices` and `values` lengths must match: "
                             f"{len(indices)}, {len(values)}")
        n = self.size
        if len(indices) and (indices.min() < 0 or indices.max() >= n):
            raise IndexOutOfBound(f"index out of bounds for size {n}")
        idx, vals = indices, values
        if len(idx) > 1 and not (np.diff(idx) > 0).all():
            from .engine.sparse import sorted_dedup_coo

            idx, _, vals = sorted_dedup_coo(idx, np.zeros_like(idx), vals, n,
                                            1, self.dtype, dup_op)
        dev, dt = self.device, self.dtype
        t_idx = torch.from_numpy(np.ascontiguousarray(idx)).to(dev)
        new_vals = st.zeros_values((n,), dt, dev)
        new_valid = torch.zeros(n, dtype=torch.bool, device=dev)
        new_vals[t_idx] = _dt.to_tensor(vals, dt, dev)
        new_valid[t_idx] = True
        self._set_store(new_vals, new_valid)

    def resize(self, size):
        """Change the size in place; elements past it are dropped."""
        size = int(size)
        if size < 0:
            raise ValueError("size must be non-negative")
        keep = min(size, self.size)
        vals = st.zeros_values((size,), self.dtype, self.device)
        valid = torch.zeros(size, dtype=torch.bool, device=self.device)
        vals[:keep] = self._vals[:keep]
        valid[:keep] = self._valid[:keep]
        self._set_store(vals, valid)

    def _as_matrix(self, *, name=None):
        """The vector as an (n, 1) column Matrix over the same store."""
        from .matrix import Matrix

        return Matrix._from_planes(self.dtype, self._vals[:, None],
                                   self._valid[:, None],
                                   name=self.name if name is None else name)

    @classmethod
    def from_scalar(cls, value, size, dtype=None, *, name=None):
        """Every element stored and equal to value."""
        from .scalar import Scalar

        if isinstance(value, Scalar):
            if value.is_empty:
                raise EmptyObject("Scalar is empty; cannot create Vector "
                                  "from it")
            dtype = value.dtype if dtype is None else dtype
            value = value.value
        dt = _values_dtype(value, dtype)[1]
        v = cls(dt, size, name=name)
        dev = v.device
        v._set_store(_dt.to_tensor(np.asarray(value), dt, dev).expand(
            int(size)).clone(), torch.ones(int(size), dtype=torch.bool,
                                           device=dev))
        return v

    @classmethod
    def from_dense(cls, values, missing_value=None, dtype=None, *, name=None):
        values, dt = _values_dtype(values, dtype)
        if values.ndim != 1:
            raise TypeError("values must be 1-dimensional for "
                            "Vector.from_dense")
        v = cls(dt, values.shape[0], name=name)
        vals = _dt.to_tensor(values, dt, v.device)
        if missing_value is None:
            valid = torch.ones(values.shape[0], dtype=torch.bool,
                               device=v.device)
        else:
            valid = torch.from_numpy(values != missing_value).to(v.device)
        v._set_store(vals, valid)
        return v

    def to_dict(self):
        """{index: value}, as the JAX package's to_dict."""
        idx, vals = self.to_coo()
        return {int(i): v for i, v in zip(idx.tolist(), vals.tolist())}

    def to_coo(self, dtype=None, *, indices=True, values=True, sort=True):
        ok = self._valid.cpu().numpy()
        idx = np.nonzero(ok)[0]
        out_vals = None
        if values:
            out_vals = _dt.to_numpy(self._vals, self.dtype)[idx]
            if dtype is not None:
                out_vals = out_vals.astype(_dt.lookup_dtype(dtype).np_type)
        return (idx.astype(np.uint64) if indices else None), out_vals

    def to_dense(self, fill_value=None, dtype=None):
        ok = self._valid.cpu().numpy()
        dt = self.dtype if dtype is None else _dt.lookup_dtype(dtype)
        out = _dt.to_numpy(self._vals, self.dtype).astype(dt.np_type)
        if not ok.all():
            if fill_value is None:
                raise TypeError("fill_value must be given in to_dense when "
                                "there are missing values")
            out[~ok] = fill_value
        return out

    def isclose(self, other, *, rel_tol=1e-7, abs_tol=0.0, check_dtype=False):
        other = self._expect_type(other, Vector, within="isclose",
                                  argname="other")
        if check_dtype and self.dtype != other.dtype:
            return False
        if self.shape != other.shape:
            return False
        ai, av = self.to_coo()
        bi, bv = other.to_coo()
        if not np.array_equal(ai, bi):
            return False
        return bool(np.all(np.isclose(av, bv, rtol=rel_tol, atol=abs_tol)))

    def isequal(self, other, *, check_dtype=False):
        """Exact equality: same size, same structure, same values (compared
        on the device; one read of the verdict)."""
        other = self._expect_type(other, Vector, within="isequal",
                                  argname="other")
        if check_dtype and self.dtype != other.dtype:
            return False
        if self.shape != other.shape:
            return False
        common = self.dtype if check_dtype else _dt.unify(self.dtype, other.dtype)
        if common._is_udt:
            ai, av = self.to_coo()
            bi, bv = other.to_coo()
            return bool(np.array_equal(ai, bi) and np.array_equal(av, bv))
        ok = self._valid
        av = _dt.normalize(self._vals, common)
        bv = _dt.normalize(other._vals.to(self.device), common)
        same = (ok == other._valid.to(self.device)) & ((av == bv) | ~ok)
        return bool(same.all())

    def dup(self, dtype=None, *, clear=False, mask=None, name=None):
        """A copy, optionally cast, masked or cleared."""
        from . import execute

        dt = self.dtype if dtype is None else _dt.lookup_dtype(dtype)
        out = Vector(dt, self.size, name=name)
        if not clear:
            execute.update_into(out, execute.as_expr(self), mask=mask)
        return out

    # ------------------------------------------------------------------ #
    # operations
    def _extract_expr(self, resolver, input_mask=None):
        """v[i] (a Scalar) or v[idx] (a Vector; idx may repeat)."""
        from . import execute
        from .scalar import Scalar

        (ix,) = resolver.indices
        if input_mask is not None and \
                tuple(input_mask.parent.shape) != self.shape:
            raise DimensionMismatch("input_mask shape must match the "
                                    "collection")
        if ix.is_scalar:  # the JAX package reads no input mask here
            return BaseExpression("extract_element", None, [self],
                                  self.dtype, (), Scalar, (ix.index,))
        vec_axis = None if input_mask is None else \
            execute.input_mask_axis("vec", self, input_mask)
        return BaseExpression("extract", None, [self], self.dtype,
                              (ix.size,), Vector,
                              ("vec", [ix], input_mask, vec_axis))

    def __iter__(self):
        """The indices of the stored elements, in order."""
        return iter(np.nonzero(self._valid.cpu().numpy())[0].tolist())

    def vxm(self, other, op="plus_times"):
        """Row vector times matrix (graphblas_tpu vector.py vxm)."""
        from .matrix import Matrix, TransposedMatrix

        other = self._expect_type(other, (Matrix, TransposedMatrix),
                                  within="vxm", argname="other")
        bt = isinstance(other, TransposedMatrix)
        b = other._matrix if bt else other
        if not isinstance(b, Matrix):
            raise TypeError(f"vxm expects a Matrix; got {type(b).__name__}")
        ring = typed(op, _dt.unify(self.dtype, b.dtype), "Semiring")
        bshape = (b.ncols, b.nrows) if bt else (b.nrows, b.ncols)
        if self.size != bshape[0]:
            raise DimensionMismatch(f"Dimensions not compatible for vxm: "
                                    f"{self.size} vs {bshape}")
        return BaseExpression("vxm", ring, [self, b], ring.return_type,
                              (bshape[1],), Vector, (bt,))

    def inner(self, other, op="plus_times"):
        """Inner product with another Vector, a Scalar expression."""
        from .scalar import Scalar

        other = self._expect_type(other, Vector, within="inner",
                                  argname="other")
        ring = typed(op, _dt.unify(self.dtype, other.dtype), "Semiring")
        if self.size != other.size:
            raise DimensionMismatch(f"Dimensions not compatible for inner: "
                                    f"{self.size} vs {other.size}")
        return BaseExpression("inner", ring, [self, other], ring.return_type,
                              (), Scalar)

    def apply(self, op, right=None, *, left=None):
        """A unary op, a binary op with a bound scalar, or an index-unary
        op with its thunk (``right=``)."""
        return apply_expr(self, op, right, left)

    def select(self, op, thunk=None):
        return select_expr(self, op, thunk)

    def ewise_add(self, other, op="plus"):
        return ewise_expr(self, other, op, "add")

    def ewise_mult(self, other, op="times"):
        return ewise_expr(self, other, op, "mult")

    def ewise_union(self, other, op, left_default, right_default):
        return ewise_expr(self, other, op, "union", left_default,
                          right_default)

    def diag(self, k=0, *, name=None):
        """The diagonal Matrix with this vector on diagonal k: sparse-backed
        over ``auto_sparse_limit`` elements (only the stored entries), else
        dense."""
        from .engine import sparse as spx
        from .matrix import Matrix

        k = int(k)
        n = self.size + abs(k)
        if n * n > int(_config.config.get("auto_sparse_limit", 1 << 22)):
            return Matrix._from_sparse(self.dtype, spx.diag_sparse_store(
                self._vals, self._valid, self.dtype, k, n), name=name)
        return BaseExpression("diag_build", None, [self], self.dtype, (n, n),
                              Matrix, (k, n)).new(name=name)

    def reduce(self, op="plus", *, allow_empty=True):
        """To a Scalar, by a monoid, a BinaryOp's monoid or an
        aggregator."""
        from .operator.utils import reduce_op
        from .scalar import Scalar

        red = reduce_op(op, self.dtype)
        if red.opclass == "Aggregator":
            return BaseExpression("reduce_agg", red, [self], red.return_type,
                                  (), Scalar, (None, False))
        return BaseExpression("reduce", red, [self], red.return_type, (),
                              Scalar, (bool(allow_empty),))

    def reposition(self, offset, *, size=None):
        """Every element moved by offset (out of range: dropped), in a
        vector of size (by default this one's)."""
        out_size = self.size if size is None else int(size)
        return BaseExpression("reposition", None, [self], self.dtype,
                              (out_size,), Vector, ((int(offset),),))

    def outer(self, other, op="times"):
        """The outer product by a BinaryOp (or a Monoid's op): element
        (i, j) is op(self[i], other[j]), stored where both are.  Over
        ``auto_sparse_limit`` elements the result is sparse-backed, with
        the product of the two structures."""
        from .matrix import Matrix

        other = self._expect_type(other, Vector, within="outer",
                                  argname="other")
        if getattr(op, "opclass", None) == "Monoid":
            op = op.binaryop
        bop = typed(op, _dt.unify(self.dtype, other.dtype), "BinaryOp")
        return BaseExpression("outer", bop, [self, other], bop.return_type,
                              (self.size, other.size), Matrix)

    ss = SSDescriptor(lambda: _ss_vector().VectorSS)


def _ss_vector():
    from .ss import vector

    return vector
