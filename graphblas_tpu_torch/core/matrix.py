"""Matrix and TransposedMatrix (graphblas_tpu/core/matrix.py).

Extract, assign and delete by index lists come from core/collection.py;
``A[rows, cols]`` with lists that do not repeat, ``A[i, :]``/``A[:, j]``,
assign and delete keep a sparse matrix sparse (core/execute.py
``_format_plan`` and ``assign_update``), and so do the constructors from
CSR, CSC, DCSR, DCSC, edge lists and dicts, ``build``, the exports and
``resize``.  ``Matrix.ss`` is core/ss/matrix.py; the reprs are
core/formatting.py's; a pickle holds the COO, as the JAX package's.

Two backings, as in the JAX package: a Matrix with at most
``auto_sparse_limit`` elements is a dense (values, valid) store on its
device; a larger one is sparse-backed (a SparseStore of COO tensors on its
device; a lanepipe or sort-pipeline plan is built at the first mxv/vxm or
reduce of each direction that takes one).  ``apply``, ``select``, ``A.T``,
casts, element-wise operations of two sparse operands (and ``ewise_mult``
with any), monoid reduces, ``mxm`` (SpGEMM, or a scaling by a diagonal)
and the masked write-back keep a sparse matrix sparse; ``power``,
``diag``, aggregator reduces, ``kronecker``, ``reposition`` and an
element-wise add or union with a dense operand densify it under the
``dense_limit`` guard, as in the JAX package."""

import numpy as np
import torch

from . import config as _config
from . import dtypes as _dt
from ..exceptions import (DimensionMismatch, EmptyObject, IndexOutOfBound,
                          OutputNotEmpty)
from .base import BaseExpression, SSDescriptor
from .collection import Collection, apply_expr, ewise_expr, select_expr
from .collection import untranspose as _untranspose
from .engine import sparse as spx
from .engine import store as st
from .mask import StructuralMask, ValueMask
from .operator.base import typed
from .operator.utils import reduce_op
from .scalar import Scalar
from .utils import get_order, ints_to_numpy_buffer
from .vector import Vector, _broadcast_values, _values_dtype


def _shape_of(mat, transposed):
    return (mat.ncols, mat.nrows) if transposed else (mat.nrows, mat.ncols)


class Matrix(Collection):
    ndim = 2

    def __init__(self, dtype=_dt.FP64, nrows=0, ncols=0, *, name=None):
        self.dtype = _dt.lookup_dtype(dtype)
        nrows, ncols = int(nrows), int(ncols)
        if nrows < 0 or ncols < 0:
            raise ValueError("nrows and ncols must be non-negative")
        self._nrows, self._ncols = nrows, ncols
        self.name = name
        self._device = _config.device()
        if nrows * ncols > int(_config.config.get("auto_sparse_limit",
                                                  1 << 22)):
            self._set_sparse_store(spx.empty_store(nrows, ncols, self.dtype,
                                                   self._device))
        else:
            self._set_store(
                st.zeros_values((nrows, ncols), self.dtype, self._device),
                torch.zeros((nrows, ncols), dtype=torch.bool,
                            device=self._device))

    @classmethod
    def _empty(cls, dtype, shape, name=None):
        return cls(dtype, shape[0], shape[1], name=name)

    @classmethod
    def _from_planes(cls, dtype, vals, valid, name=None):
        """A dense-backed Matrix over (values, valid) planes."""
        m = cls.__new__(cls)
        m.dtype, m.name = _dt.lookup_dtype(dtype), name
        m._nrows, m._ncols = valid.shape
        m._set_store(vals, valid)
        return m

    @classmethod
    def _from_sparse(cls, dtype, sp, name=None):
        m = cls.__new__(cls)
        m.dtype, m.name = _dt.lookup_dtype(dtype), name
        m._nrows, m._ncols = sp.nrows, sp.ncols
        m._set_sparse_store(sp)
        return m

    # ------------------------------------------------------------------ #
    # constructors and exports
    @classmethod
    def from_coo(cls, rows, columns, values=1.0, dtype=None, *, nrows=None,
                 ncols=None, dup_op=None, name=None):
        rows = np.asarray(rows, np.int64).reshape(-1)
        columns = np.asarray(columns, np.int64).reshape(-1)
        values, dt = _values_dtype(values, dtype)
        values = np.broadcast_to(values, rows.shape + _dt.value_shape(dt))
        if len(rows) != len(columns):
            raise ValueError("`rows` and `columns` lengths must match")
        if nrows is None:
            nrows = int(rows.max()) + 1 if len(rows) else 0
        if ncols is None:
            ncols = int(columns.max()) + 1 if len(columns) else 0
        if len(rows) and (rows.min() < 0 or rows.max() >= nrows
                          or columns.min() < 0 or columns.max() >= ncols):
            raise IndexError("index out of bounds")
        m = cls(dt, nrows, ncols, name=name)
        sp = spx.build_sparse_store(rows, columns, values, nrows, ncols, dt,
                                    m._device, dup_op)
        dense = m._sparse is None
        m._set_sparse_store(sp)
        if dense:
            m._densify()
        return m

    @classmethod
    def from_dense(cls, values, missing_value=None, dtype=None, *, name=None):
        values, dt = _values_dtype(values, dtype)
        if values.ndim != 2:
            raise TypeError("values must be 2-dimensional for "
                            "Matrix.from_dense")
        m = cls(dt, 0, 0, name=name)
        m._nrows, m._ncols = values.shape
        dev = m._device
        if missing_value is None:
            valid = torch.ones(values.shape, dtype=torch.bool, device=dev)
        else:
            valid = torch.from_numpy(values != missing_value).to(dev)
        m._set_store(_dt.to_tensor(values, dt, dev), valid)
        return m

    @classmethod
    def from_scalar(cls, value, nrows, ncols, dtype=None, *, name=None):
        """Dense matrix with every element stored and equal to value."""
        if isinstance(value, Scalar):
            if value.is_empty:
                raise EmptyObject("Scalar is empty; cannot create Matrix "
                                  "from it")
            dtype = value.dtype if dtype is None else dtype
            value = value.value
        return cls.from_dense(np.full((int(nrows), int(ncols)), value),
                              dtype=dtype, name=name)

    @classmethod
    def from_edgelist(cls, edgelist, values=None, dtype=None, *, nrows=None,
                      ncols=None, dup_op=None, name=None):
        """From (row, col) or (row, col, value) rows."""
        edges = np.asarray(edgelist if isinstance(edgelist, np.ndarray)
                           else list(edgelist))
        if edges.ndim != 2 or edges.shape[1] not in (2, 3):
            raise ValueError("edgelist must be an iterable of (row, col) or "
                             "(row, col, value)")
        if edges.shape[1] == 3:
            if values is not None:
                raise TypeError("Too many sources of values: edgelist "
                                "values and `values=`")
            values = edges[:, 2]
        elif values is None:
            values = 1.0
        return cls.from_coo(edges[:, 0].astype(np.int64),
                            edges[:, 1].astype(np.int64), values, dtype,
                            nrows=nrows, ncols=ncols, dup_op=dup_op,
                            name=name)

    @classmethod
    def from_csr(cls, indptr, col_indices, values=1.0, dtype=None, *,
                 nrows=None, ncols=None, name=None):
        """From compressed rows; a matrix over ``auto_sparse_limit``
        elements is sparse-backed, as from_coo makes it."""
        indptr = ints_to_numpy_buffer(indptr, np.int64, name="indptr")
        cols = ints_to_numpy_buffer(col_indices, np.int64,
                                    name="col_indices")
        if nrows is None:
            nrows = len(indptr) - 1
        rows = np.repeat(np.arange(nrows, dtype=np.int64), np.diff(indptr))
        return cls.from_coo(rows, cols, values, dtype, nrows=nrows,
                            ncols=_infer(ncols, cols), name=name)

    @classmethod
    def from_csc(cls, indptr, row_indices, values=1.0, dtype=None, *,
                 nrows=None, ncols=None, name=None):
        indptr = ints_to_numpy_buffer(indptr, np.int64, name="indptr")
        rows = ints_to_numpy_buffer(row_indices, np.int64,
                                    name="row_indices")
        if ncols is None:
            ncols = len(indptr) - 1
        cols = np.repeat(np.arange(ncols, dtype=np.int64), np.diff(indptr))
        return cls.from_coo(rows, cols, values, dtype,
                            nrows=_infer(nrows, rows), ncols=ncols,
                            name=name)

    @classmethod
    def from_dcsr(cls, compressed_rows, indptr, col_indices, values=1.0,
                  dtype=None, *, nrows=None, ncols=None, name=None):
        """From doubly compressed rows (the nonempty rows and their
        pointers)."""
        crows = ints_to_numpy_buffer(compressed_rows, np.int64,
                                     name="compressed_rows")
        indptr = ints_to_numpy_buffer(indptr, np.int64, name="indptr")
        cols = ints_to_numpy_buffer(col_indices, np.int64,
                                    name="col_indices")
        return cls.from_coo(np.repeat(crows, np.diff(indptr)), cols, values,
                            dtype, nrows=_infer(nrows, crows),
                            ncols=_infer(ncols, cols), name=name)

    @classmethod
    def from_dcsc(cls, compressed_cols, indptr, row_indices, values=1.0,
                  dtype=None, *, nrows=None, ncols=None, name=None):
        ccols = ints_to_numpy_buffer(compressed_cols, np.int64,
                                     name="compressed_cols")
        indptr = ints_to_numpy_buffer(indptr, np.int64, name="indptr")
        rows = ints_to_numpy_buffer(row_indices, np.int64,
                                    name="row_indices")
        return cls.from_coo(rows, np.repeat(ccols, np.diff(indptr)), values,
                            dtype, nrows=_infer(nrows, rows),
                            ncols=_infer(ncols, ccols), name=name)

    @classmethod
    def from_dicts(cls, nested_dicts, dtype=None, *, order="rowwise",
                   nrows=None, ncols=None, name=None):
        """From {row: {col: value}} (or a list of dicts, one a row;
        ``order="columnwise"`` reads them as columns)."""
        order = get_order(order)
        items = nested_dicts.items() if isinstance(nested_dicts, dict) \
            else enumerate(nested_dicts)
        rows, cols, vals = [], [], []
        for outer, inner in items:
            for k, v in inner.items():
                rows.append(outer)
                cols.append(k)
                vals.append(v)
        if order == "columnwise":
            rows, cols = cols, rows
        if not rows and (nrows is None or ncols is None):
            raise ValueError("Unable to infer nrows/ncols from empty dicts")
        return cls.from_coo(np.array(rows, np.int64),
                            np.array(cols, np.int64),
                            vals if vals else np.array([], np.float64),
                            dtype, nrows=nrows, ncols=ncols, name=name)

    def build(self, rows, columns, values, *, dup_op=None, clear=False,
              nrows=None, ncols=None):
        """Set the elements from COO (duplicates combine with dup_op) into
        an empty matrix, or, with clear, after removing its elements; the
        backing stays as it was."""
        if nrows is not None or ncols is not None:
            raise TypeError("nrows/ncols keyword args not supported (resize "
                            "first)")
        if not clear and self.nvals > 0:
            raise OutputNotEmpty("Matrix already contains values; use "
                                 "clear=True")
        rows = ints_to_numpy_buffer(rows, np.int64, name="row indices")
        cols = ints_to_numpy_buffer(columns, np.int64, name="column indices")
        values = _broadcast_values(_values_dtype(values, self.dtype)[0],
                                   rows.shape, self.dtype)
        if not len(rows) == len(cols) == len(values):
            raise ValueError(f"The lengths of `rows`, `columns`, and "
                             f"`values` must match: {len(rows)}, "
                             f"{len(cols)}, {len(values)}")
        if len(rows):
            if rows.min() < 0 or rows.max() >= self._nrows:
                raise IndexOutOfBound(f"row index out of bounds for nrows "
                                      f"{self._nrows}")
            if cols.min() < 0 or cols.max() >= self._ncols:
                raise IndexOutOfBound(f"column index out of bounds for "
                                      f"ncols {self._ncols}")
        dense = self._sparse is None
        self._set_sparse_store(spx.build_sparse_store(
            rows, cols, values, self._nrows, self._ncols, self.dtype,
            self._device, dup_op))
        if dense:
            self._densify()

    def to_edgelist(self, dtype=None, *, values=True, sort=True):
        """((nvals, 2) array of (row, col), values or None)."""
        r, c, v = self.to_coo(dtype, values=values, sort=sort)
        return np.column_stack([r, c]), v

    def _compressed(self, dtype, by_col):
        """(indptr, minor indices, values) in row-major (CSR) or
        column-major (CSC) order, read from the device once."""
        r, c, v = self.to_coo(dtype)
        if by_col:
            if self._sparse is not None:
                perm = self._sparse.csc_perm().cpu().numpy()
            else:
                perm = np.argsort(c, kind="stable")
            r, c, v = c[perm], r[perm], v[perm]
        n = self._ncols if by_col else self._nrows
        indptr = np.zeros(n + 1, np.uint64)
        indptr[1:] = np.cumsum(np.bincount(r.astype(np.int64), minlength=n))
        return indptr, c, v

    def to_csr(self, dtype=None, *, sort=True):
        return self._compressed(dtype, False)

    def to_csc(self, dtype=None, *, sort=True):
        return self._compressed(dtype, True)

    def to_dcsr(self, dtype=None, *, sort=True):
        """(compressed rows, indptr, col indices, values)."""
        return _doubly(*self._compressed(dtype, False))

    def to_dcsc(self, dtype=None, *, sort=True):
        return _doubly(*self._compressed(dtype, True))

    def resize(self, nrows, ncols):
        """Change the shape in place; elements outside it are dropped.  A
        sparse-backed matrix stays sparse."""
        nrows, ncols = int(nrows), int(ncols)
        if nrows < 0 or ncols < 0:
            raise ValueError("nrows and ncols must be non-negative")
        if self._sparse is not None:
            self._set_sparse_store(spx.resized(self._sparse, nrows, ncols))
        else:
            vals = st.zeros_values((nrows, ncols), self.dtype,
                                   self._device)
            valid = torch.zeros((nrows, ncols), dtype=torch.bool,
                                device=self._device)
            r, c = min(nrows, self._nrows), min(ncols, self._ncols)
            vals[:r, :c] = self._d_vals[:r, :c]
            valid[:r, :c] = self._d_valid[:r, :c]
            self._set_store(vals, valid)
        self._nrows, self._ncols = nrows, ncols

    def to_dicts(self, order="rowwise"):
        """{row: {column: value}} (``order="columnwise"``: {column: {row:
        value}}), as the JAX package's to_dicts."""
        r, c, v = self.to_coo()
        if get_order(order) == "columnwise":
            r, c = c, r
        out = {}
        for i, j, val in zip(r.tolist(), c.tolist(), v.tolist()):
            out.setdefault(int(i), {})[int(j)] = val
        return out

    def to_coo(self, dtype=None, *, rows=True, columns=True, values=True,
               sort=True):
        if self._sparse is not None:
            r, c, v = self._sparse.host_coo()
        else:
            host_vals, host_ok = self._host_arrays()
            r, c = np.nonzero(host_ok)
            v = host_vals[r, c]
        if dtype is not None:
            v = v.astype(_dt.lookup_dtype(dtype).np_type)
        return (r.astype(np.uint64) if rows else None,
                c.astype(np.uint64) if columns else None,
                v if values else None)

    def to_dense(self, fill_value=None, dtype=None):
        host_vals, host_ok = self._host_arrays()
        dt = self.dtype if dtype is None else _dt.lookup_dtype(dtype)
        out = host_vals.astype(dt.np_type, copy=True)
        if not host_ok.all():
            if fill_value is None:
                raise TypeError("fill_value must be given in to_dense when "
                                "there are missing values")
            out[~host_ok] = fill_value
        return out

    # ------------------------------------------------------------------ #
    @property
    def nrows(self):
        return self._nrows

    @property
    def ncols(self):
        return self._ncols

    @property
    def shape(self):
        return (self._nrows, self._ncols)

    @property
    def T(self):
        return TransposedMatrix(self)

    @property
    def S(self):
        return StructuralMask(self)

    @property
    def V(self):
        return ValueMask(self)

    def __repr__(self):
        from . import formatting

        return formatting.format_matrix(self)

    def _repr_html_(self, mask=None):
        from . import formatting

        return formatting.format_matrix_html(self, mask=mask)

    def __reduce__(self):
        """Pickled as the JAX package pickles a Matrix: its COO, shape,
        type and name (the backing follows the shape when loaded)."""
        r, c, v = self.to_coo()
        dt = self.dtype if self.dtype._is_udt else self.dtype.name
        return (Matrix._deserialize, (dt, self._nrows, self._ncols, r, c, v,
                                      self._name))

    @staticmethod
    def _deserialize(dtype, nrows, ncols, r, c, v, name):
        m = Matrix(dtype, nrows, ncols, name=name)
        if len(r):
            m.build(r.astype(np.int64), c.astype(np.int64), v)
        return m

    def dup(self, dtype=None, *, clear=False, mask=None, name=None):
        """A copy, optionally cast, masked or cleared."""
        from . import execute

        dt = self.dtype if dtype is None else _dt.lookup_dtype(dtype)
        if self._sparse is not None and not clear and mask is None \
                and dt == self.dtype:
            # stores are never mutated
            return Matrix._from_sparse(dt, self._sparse, name=name)
        out = Matrix(dt, self._nrows, self._ncols, name=name)
        if not clear:
            execute.update_into(out, execute.as_expr(self), mask=mask)
        return out

    def isequal(self, other, *, check_dtype=False):
        """Exact equality: same shape, structure and values (compared on
        the device; one read of the verdict)."""
        other = _as_matrix(other, "isequal")
        if check_dtype and self.dtype != other.dtype:
            return False
        if self.shape != other.shape:
            return False
        common = self.dtype if check_dtype else _dt.unify(self.dtype, other.dtype)
        if (self._sparse is not None or other._sparse is not None
                or common._is_udt):
            return _coo_equal(self, other, common)
        ok = self._valid
        av = _dt.normalize(self._vals, common)
        bv = _dt.normalize(other._vals.to(self.device), common)
        same = (ok == other._valid.to(self.device)) & ((av == bv) | ~ok)
        return bool(same.all())

    def isclose(self, other, *, rel_tol=1e-7, abs_tol=0.0, check_dtype=False):
        other = _as_matrix(other, "isclose")
        if check_dtype and self.dtype != other.dtype:
            return False
        if self.shape != other.shape:
            return False
        ar, ac, av = self.to_coo()
        br, bc, bv = other.to_coo()
        if not (np.array_equal(ar, br) and np.array_equal(ac, bc)):
            return False
        return bool(np.all(np.isclose(av, bv, rtol=rel_tol, atol=abs_tol)))

    def _extract_expr(self, resolver, input_mask=None):
        """A[i, j] (a Scalar), A[i, cols] and A[rows, j] (Vectors) and
        A[rows, cols] (a Matrix).  Index lists that do not repeat keep a
        sparse matrix sparse."""
        from . import execute

        rix, cix = resolver.indices
        if rix.is_scalar and cix.is_scalar:
            if input_mask is not None:
                execute.input_mask_axis("element", self, input_mask)
            return BaseExpression("extract_element", None, [self], self.dtype,
                                  (), Scalar, ((rix.index, cix.index),))
        if rix.is_scalar or cix.is_scalar:
            pattern = "row" if rix.is_scalar else "col"
            shape, out = ((cix if rix.is_scalar else rix).size,), Vector
        else:
            pattern, shape, out = "mat", (rix.size, cix.size), Matrix
        vec_axis = None if input_mask is None else \
            execute.input_mask_axis(pattern, self, input_mask)
        return BaseExpression("extract", None, [self], self.dtype, shape, out,
                              (pattern, [rix, cix], input_mask, vec_axis))

    def _as_vector(self, *, name=None):
        """An (n, 1) matrix as a Vector of its one column."""
        if self._ncols != 1:
            raise ValueError(f"Matrix must have a single column (not "
                             f"{self._ncols}) to be cast to a Vector")
        return Vector._from_store(self.dtype, self._vals[:, 0],
                                  self._valid[:, 0],
                                  name=self.name if name is None else name)

    def __iter__(self):
        """The (row, col) of each stored element, in row-major order."""
        r, c, _ = self.to_coo(values=False)
        return iter(zip(r.astype(np.int64).tolist(),
                        c.astype(np.int64).tolist()))

    def diag(self, k=0, *, name=None):
        """Diagonal k as a Vector."""
        k = int(k)
        if k >= 0:
            size = max(0, min(self._nrows, self._ncols - k))
        else:
            size = max(0, min(self._nrows + k, self._ncols))
        return BaseExpression("diag", None, [self], self.dtype, (size,),
                              Vector, (k, False)).new(name=name)

    # ------------------------------------------------------------------ #
    # linear algebra
    def _matmul_expr(self, kind, other, op):
        other = self._expect_type(
            other, Vector if kind == "mxv" else (Matrix, TransposedMatrix),
            within=kind, argname="other")
        a, at = _untranspose(self)
        b, bt = _untranspose(other)
        ring = typed(op, _dt.unify(a.dtype, b.dtype), "Semiring")
        sa = _shape_of(a, at)
        if kind == "mxv":
            if sa[1] != b.size:
                raise DimensionMismatch(
                    f"Dimensions not compatible for mxv: {sa} x {b.size}")
            return BaseExpression("mxv", ring, [a, b], ring.return_type,
                                  (sa[0],), Vector, (at,))
        sb = _shape_of(b, bt)
        if sa[1] != sb[0]:
            raise DimensionMismatch(
                f"Dimensions not compatible for mxm: {sa} x {sb}")
        return BaseExpression("mxm", ring, [a, b], ring.return_type,
                              (sa[0], sb[1]), Matrix, (at, bt))

    def mxv(self, other, op="plus_times"):
        return self._matmul_expr("mxv", other, op)

    def mxm(self, other, op="plus_times"):
        return self._matmul_expr("mxm", other, op)

    def power(self, n, op="plus_times"):
        """Matrix power by repeated squaring."""
        if not isinstance(n, (int, np.integer)) or isinstance(n, bool):
            raise TypeError(f"n must be a positive integer; got {type(n)}")
        n = int(n)
        if n < 1:
            raise ValueError(f"n must be a positive integer; got {n}")
        if self._nrows != self._ncols:
            raise DimensionMismatch("power requires a square Matrix")
        ring = typed(op, self.dtype, "Semiring")
        return BaseExpression("power", ring, [self], ring.return_type,
                              self.shape, Matrix, (n,))

    def ewise_add(self, other, op="plus"):
        return ewise_expr(self, other, op, "add")

    def ewise_mult(self, other, op="times"):
        return ewise_expr(self, other, op, "mult")

    def ewise_union(self, other, op, left_default, right_default):
        return ewise_expr(self, other, op, "union", left_default,
                          right_default)

    def apply(self, op, right=None, *, left=None):
        """A unary op, a binary op with a bound scalar, or an index-unary
        op with its thunk (``right=``)."""
        return apply_expr(self, op, right, left)

    def select(self, op, thunk=None):
        """The entries where a select operator holds (``A.select("tril",
        -1)``, ``A.select(select.valuegt, 0)``)."""
        return select_expr(self, op, thunk)

    def kronecker(self, other, op="times"):
        """The Kronecker product by a BinaryOp (or a Monoid's op): block
        (i, j) is op(A[i, j], B); either operand may be transposed."""
        other = self._expect_type(other, (Matrix, TransposedMatrix),
                                  within="kronecker", argname="other")
        a, at = _untranspose(self)
        b, bt = _untranspose(other)
        if getattr(op, "opclass", None) == "Monoid":
            op = op.binaryop
        bop = typed(op, _dt.unify(a.dtype, b.dtype), "BinaryOp")
        sa, sb = _shape_of(a, at), _shape_of(b, bt)
        return BaseExpression("kronecker", bop, [a, b], bop.return_type,
                              (sa[0] * sb[0], sa[1] * sb[1]), Matrix,
                              (at, bt))

    def _reduce_axis_expr(self, op, axis, method):
        """Reduce along an axis of the stored matrix (axis 1 folds each
        row) by a monoid, a BinaryOp's monoid or an aggregator; for ``A.T``
        the caller has already swapped the axis."""
        mat, _ = _untranspose(self)
        red = reduce_op(op, mat.dtype)
        size = mat.nrows if axis == 1 else mat.ncols
        if red.opclass == "Aggregator":
            method = "reduce_agg"
        return BaseExpression(method, red, [mat], red.return_type, (size,),
                              Vector, (axis, False))

    def reduce_rowwise(self, op="plus"):
        return self._reduce_axis_expr(op, 1, "reduce_rowwise")

    def reduce_columnwise(self, op="plus"):
        return self._reduce_axis_expr(op, 0, "reduce_columnwise")

    def reduce_scalar(self, op="plus", *, allow_empty=True):
        mat, _ = _untranspose(self)
        red = reduce_op(op, mat.dtype)
        if red.opclass == "Aggregator":
            if red.name in ("argmin", "argmax", "first_index", "last_index"):
                raise ValueError(f"Aggregator {red.name} may not be used "
                                 f"with Matrix.reduce_scalar")
            return BaseExpression("reduce_agg", red, [mat], red.return_type,
                                  (), Scalar, (None, False))
        return BaseExpression("reduce", red, [mat], red.return_type, (),
                              Scalar, (bool(allow_empty),),
                              public_name="reduce_scalar")

    def reposition(self, row_offset, column_offset, *, nrows=None,
                   ncols=None):
        """Every element moved by the offsets (out of range: dropped), in a
        matrix of nrows x ncols (by default this one's shape)."""
        out_nrows = self._nrows if nrows is None else int(nrows)
        out_ncols = self._ncols if ncols is None else int(ncols)
        return BaseExpression("reposition", None, [self], self.dtype,
                              (out_nrows, out_ncols), Matrix,
                              ((int(row_offset), int(column_offset)),))

    ss = SSDescriptor(lambda: _ss_matrix().MatrixSS)


def _ss_matrix():
    from .ss import matrix

    return matrix


def _infer(n, indices):
    """A dimension given, or one past the largest index."""
    if n is not None:
        return n
    return int(indices.max()) + 1 if len(indices) else 0


def _doubly(indptr, minor, v):
    counts = np.diff(indptr.astype(np.int64))
    nonempty = np.flatnonzero(counts)
    new_indptr = np.zeros(len(nonempty) + 1, np.uint64)
    new_indptr[1:] = np.cumsum(counts[nonempty])
    return nonempty.astype(np.uint64), new_indptr, minor, v


def _coo_equal(a, b, common):
    """Structure and values equal, compared through the COO export (the
    sparse path: no dense plane)."""
    ar, ac, av = a.to_coo()
    br, bc, bv = b.to_coo()
    nt = _dt.host_np_type(common)
    return (np.array_equal(ar, br) and np.array_equal(ac, bc)
            and np.array_equal(av.astype(nt), bv.astype(nt)))


def _as_matrix(other, within):
    if isinstance(other, TransposedMatrix):
        return other.new()
    if not isinstance(other, Matrix):
        if isinstance(getattr(other, "output_type", None), type) and \
                issubclass(other.output_type, Matrix):
            return other.new()  # an expression: computed
        raise TypeError(f"{within} expects a Matrix; got "
                        f"{type(other).__name__}")
    return other


class TransposedMatrix:
    """``A.T``: a view that every operation reads in the other direction."""

    ndim = 2
    _is_scalar = False
    _expect_type = Collection._expect_type

    def __init__(self, matrix):
        self._matrix = matrix

    def __repr__(self):
        from .formatting import format_transposed

        return format_transposed(self)

    def _repr_html_(self):
        from .formatting import format_transposed

        return f"<pre>{format_transposed(self)}</pre>"

    @property
    def dtype(self):
        return self._matrix.dtype

    @property
    def nrows(self):
        return self._matrix.ncols

    @property
    def ncols(self):
        return self._matrix.nrows

    @property
    def shape(self):
        return (self._matrix.ncols, self._matrix.nrows)

    @property
    def nvals(self):
        return self._matrix.nvals

    @property
    def T(self):
        return self._matrix

    def new(self, dtype=None, *, mask=None, name=None):
        out_dt = self.dtype if dtype is None else _dt.lookup_dtype(dtype)
        return BaseExpression("transpose", None, [self._matrix], self.dtype,
                              self.shape, Matrix).new(out_dt, mask=mask,
                                                      name=name)

    dup = new

    mxv = Matrix.mxv
    mxm = Matrix.mxm
    kronecker = Matrix.kronecker
    _matmul_expr = Matrix._matmul_expr
    ewise_add = Matrix.ewise_add
    ewise_mult = Matrix.ewise_mult
    ewise_union = Matrix.ewise_union
    apply = Matrix.apply
    select = Matrix.select
    _reduce_axis_expr = Matrix._reduce_axis_expr
    reduce_scalar = Matrix.reduce_scalar

    def reduce_rowwise(self, op="plus"):
        return self._reduce_axis_expr(op, 0, "reduce_rowwise")

    def reduce_columnwise(self, op="plus"):
        return self._reduce_axis_expr(op, 1, "reduce_columnwise")

    def power(self, n, op="plus_times"):
        return self.new().power(n, op)

    def reposition(self, row_offset, column_offset, *, nrows=None,
                   ncols=None):
        """Reposition of the materialized transpose."""
        return self.new().reposition(row_offset, column_offset, nrows=nrows,
                                     ncols=ncols)

    @property
    def name(self):
        return f"{self._matrix.name or 'M'}.T"

    def to_coo(self, dtype=None, *, rows=True, columns=True, values=True,
               sort=True):
        c, r, v = self._matrix.to_coo(dtype, sort=sort)
        order = np.lexsort((r, c)) if sort else slice(None)
        return (c[order] if rows else None, r[order] if columns else None,
                v[order] if values else None)

    def to_dense(self, fill_value=None, dtype=None):
        return self._matrix.to_dense(fill_value, dtype).T.copy()

    def __getitem__(self, keys):
        """An extract from the materialized transpose."""
        return self.new()[keys]

    def isequal(self, other, *, check_dtype=False):
        return self.new().isequal(other, check_dtype=check_dtype)

    def isclose(self, other, *, rel_tol=1e-7, abs_tol=0.0, check_dtype=False):
        return self.new().isclose(other, rel_tol=rel_tol, abs_tol=abs_tol,
                                  check_dtype=check_dtype)

    @property
    def S(self):
        return StructuralMask(self.new())

    @property
    def V(self):
        return ValueMask(self.new())
