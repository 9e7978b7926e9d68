"""Matrix: always sparse-backed in the port (graphblas_tpu/core/matrix.py,
the methods PageRank, BFS, SSSP and the row/column reduces call).
``from_coo`` builds the host store; the lanepipe or sort-pipeline plan and
its device tensors are built at the first mxv/vxm or reduce of each
direction."""

import numpy as np
import torch

from . import config as _config
from . import dtypes as _dt
from .base import BaseExpression
from .engine.sparse import SparseStore, build_sparse_store
from .operator.base import typed
from .vector import Vector, _unify, _values_dtype


class Matrix:
    ndim = 2

    def __init__(self, dtype=_dt.FP64, nrows=0, ncols=0, *, name=None):
        self.dtype = _dt.lookup_dtype(dtype)
        self.name = name
        self._device = _config.device()
        e = np.zeros(0, np.int64)
        self._sparse = SparseStore(e, e, np.zeros(0, self.dtype.np_type),
                                   nrows, ncols, self.dtype)

    @classmethod
    def from_coo(cls, rows, columns, values=1.0, dtype=None, *, nrows=None,
                 ncols=None, dup_op=None, name=None):
        rows = np.asarray(rows, np.int64).reshape(-1)
        columns = np.asarray(columns, np.int64).reshape(-1)
        values, dt = _values_dtype(values, dtype)
        values = np.broadcast_to(values, rows.shape)
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
        m._sparse = build_sparse_store(rows, columns, values, nrows, ncols,
                                       dt, dup_op)
        return m

    @property
    def nrows(self):
        return self._sparse.nrows

    @property
    def ncols(self):
        return self._sparse.ncols

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def nvals(self):
        return self._sparse.nvals()

    @property
    def T(self):
        return TransposedMatrix(self)

    def __repr__(self):
        return (f"Matrix(dtype={self.dtype.name}, shape={self.shape}, "
                f"nvals={self.nvals})")

    def mxv(self, other, op="plus_times"):
        return _mxv(self, False, other, op)

    def reduce_rowwise(self, op="plus"):
        return _reduce_axis(self, op, 1, "reduce_rowwise")

    def reduce_columnwise(self, op="plus"):
        return _reduce_axis(self, op, 0, "reduce_columnwise")

    def mxm(self, other, op="plus_times"):
        raise NotImplementedError(
            "SpGEMM is not in the PyTorch port yet (ROADMAP.md queue 1, "
            "item 10)")

    def wait(self, how="materialize"):
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)


class TransposedMatrix:
    """``A.T``: a view that mxv/vxm read in the other direction."""

    def __init__(self, matrix):
        self._matrix = matrix

    @property
    def shape(self):
        return (self._matrix.ncols, self._matrix.nrows)

    def mxv(self, other, op="plus_times"):
        return _mxv(self._matrix, True, other, op)

    def reduce_rowwise(self, op="plus"):
        return _reduce_axis(self._matrix, op, 0, "reduce_rowwise")

    def reduce_columnwise(self, op="plus"):
        return _reduce_axis(self._matrix, op, 1, "reduce_columnwise")


def _reduce_axis(mat, op, axis, method):
    """Monoid reduce along an axis of the stored matrix (axis 1 folds each
    row); for ``A.T`` the caller has already swapped the axis."""
    mono = typed(op, mat.dtype, "Monoid")
    size = mat.nrows if axis == 1 else mat.ncols
    return BaseExpression(method, mono, [mat], mono.return_type, (size,),
                          Vector, (axis, False))


def _mxv(mat, at, vec, op):
    if not isinstance(vec, Vector):
        raise TypeError(f"mxv expects a Vector; got {type(vec).__name__}")
    ring = typed(op, _unify(mat.dtype, vec.dtype), "Semiring")
    shape = (mat.ncols, mat.nrows) if at else (mat.nrows, mat.ncols)
    if vec.size != shape[1]:
        raise ValueError(f"Dimensions not compatible for mxv: {shape} vs "
                         f"{vec.size}")
    return BaseExpression("mxv", ring, [mat, vec], ring.return_type,
                          (shape[0],), Vector, (at,))
