"""Vector: a dense (values, valid) store on the configured device
(graphblas_tpu/core/vector.py): construction and export, extract, assign
and delete by index (core/collection.py), membership and iteration, the
products, element-wise operations, apply, select, reduce (by a monoid or
an aggregator) and reposition.  What the JAX
package's Vector has and the port lacks raises NotImplementedError naming
its ROADMAP.md item."""

import numpy as np
import torch

from . import config as _config
from . import dtypes as _dt
from ..exceptions import DimensionMismatch, EmptyObject
from .base import BaseExpression, InfixStubs, NotPorted
from .collection import Collection, apply_expr, ewise_expr, select_expr
from .mask import StructuralMask, ValueMask
from .operator.base import typed


def _values_dtype(values, dtype):
    """numpy values and their DataType (inferred when dtype is None)."""
    values = np.asarray(values)
    if dtype is None:
        dt = _dt.lookup_dtype(values.dtype)
    else:
        dt = _dt.lookup_dtype(dtype)
    return values, dt


def _unify(a, b):
    return a if a == b else _dt.lookup_dtype(np.result_type(a.np_type,
                                                            b.np_type))


class Vector(InfixStubs, Collection):
    ndim = 1

    def __init__(self, dtype=_dt.FP64, size=0, *, name=None):
        self.dtype = _dt.lookup_dtype(dtype)
        size = int(size)
        if size < 0:
            raise ValueError("size must be non-negative")
        self.name = name
        dev = _config.device()
        self._set_store(torch.zeros(size, dtype=self.dtype.torch_type,
                                    device=dev),
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
        return (f"Vector(dtype={self.dtype.name}, size={self.size}, "
                f"nvals={self.nvals})")

    # ------------------------------------------------------------------ #
    # constructors and exports
    @classmethod
    def from_coo(cls, indices, values=1.0, dtype=None, *, size=None,
                 dup_op=None, name=None):
        indices = np.asarray(indices, np.int64).reshape(-1)
        values, dt = _values_dtype(values, dtype)
        values = np.broadcast_to(values, indices.shape)
        if size is None:
            if len(indices) == 0:
                raise ValueError("No indices provided. Unable to infer size.")
            size = int(indices.max()) + 1
        if len(indices) and (indices.min() < 0 or indices.max() >= size):
            raise IndexError(f"index out of bounds for size {size}")
        order = np.argsort(indices, kind="stable")
        idx, vals = indices[order], values[order]
        if len(idx) > 1 and (np.diff(idx) == 0).any():
            from .engine.sparse import sorted_dedup_coo

            idx, _, vals = sorted_dedup_coo(idx, np.zeros_like(idx), vals,
                                            size, 1, dup_op)
        v = cls(dt, size, name=name)
        dev = v.device
        t_idx = torch.from_numpy(idx).to(dev)
        v._vals[t_idx] = _dt.to_tensor(vals, dt, dev)
        v._valid[t_idx] = True
        return v

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
        if not isinstance(other, Vector):
            raise TypeError(f"isclose expects a Vector; got "
                            f"{type(other).__name__}")
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
        if not isinstance(other, Vector):
            raise TypeError(f"isequal expects a Vector; got "
                            f"{type(other).__name__}")
        if check_dtype and self.dtype != other.dtype:
            return False
        if self.shape != other.shape:
            return False
        common = self.dtype if check_dtype else _unify(self.dtype, other.dtype)
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

        bt = isinstance(other, TransposedMatrix)
        b = other._matrix if bt else other
        if not isinstance(b, Matrix):
            raise TypeError(f"vxm expects a Matrix; got {type(b).__name__}")
        ring = typed(op, _unify(self.dtype, b.dtype), "Semiring")
        bshape = (b.ncols, b.nrows) if bt else (b.nrows, b.ncols)
        if self.size != bshape[0]:
            raise DimensionMismatch(f"Dimensions not compatible for vxm: "
                                    f"{self.size} vs {bshape}")
        return BaseExpression("vxm", ring, [self, b], ring.return_type,
                              (bshape[1],), Vector, (bt,))

    def inner(self, other, op="plus_times"):
        """Inner product with another Vector, a Scalar expression."""
        from .scalar import Scalar

        if not isinstance(other, Vector):
            raise TypeError(f"inner expects a Vector; got "
                            f"{type(other).__name__}")
        ring = typed(op, _unify(self.dtype, other.dtype), "Semiring")
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

    # the JAX package's Vector surface that is not ported yet
    build = NotPorted(12)
    from_dict = NotPorted(12)
    to_dict = NotPorted(12)
    from_pairs = NotPorted(12)
    resize = NotPorted(12)
    outer = NotPorted(12)
    ss = NotPorted(12)
