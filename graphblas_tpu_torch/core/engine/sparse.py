"""SparseStore: the storage of every Matrix over ``auto_sparse_limit``
elements (graphblas_tpu/core/engine/sparse.py:54-200, reduced to what the
SpMV slice and ``densify`` need).

The store keeps the matrix as host COO arrays sorted by (row, col) with
duplicates combined.  The lanepipe builds its plan from these arrays and
caches the plan's device tensors on the store, once per direction and
device (``_lanepipe_plans``), so no device-to-host read happens per call;
the sort pipeline keeps its plans the same way (``_sortpipe_plans``).
"""

import numpy as np
import torch

from ... import native
from .. import dtypes as _dt

_DUP_REDUCE = {"plus": np.add, "times": np.multiply, "min": np.minimum,
               "max": np.maximum}


class SparseStore:
    __slots__ = ("rows", "cols", "vals", "nrows", "ncols", "dtype",
                 "_lanepipe_plans", "_sortpipe_plans", "_bool_twins")

    def __init__(self, rows, cols, vals, nrows, ncols, dtype):
        self.rows = rows
        self.cols = cols
        self.vals = vals
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.dtype = dtype
        self._lanepipe_plans = {}
        self._sortpipe_plans = {}
        self._bool_twins = {}

    def nvals(self):
        return len(self.rows)

    def bool_twin(self, dtype):
        """The store of this matrix's truth values after a cast to dtype,
        as BOOL (cached, with plans of its own: for a 64-bit matrix, which
        no pipeline takes itself; see execute._plan)."""
        twin = self._bool_twins.get(dtype)
        if twin is None:
            vals = self.vals.astype(dtype.np_type) != 0
            twin = SparseStore(self.rows, self.cols, vals, self.nrows,
                               self.ncols, _dt.BOOL)
            self._bool_twins[dtype] = twin
        return twin


def sorted_dedup_coo(rows, cols, values, nrows, ncols, dup_op):
    """Sort COO by (row, col) with the native radix argsort and combine
    duplicates with dup_op (plus, times, min, max, first, second, any)."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    perm = native.coo_argsort(rows, cols, nrows, ncols)
    r, c, v = rows[perm], cols[perm], np.asarray(values)[perm]
    flags, uniq = native.coo_mark_unique(r, c)
    if uniq != len(r):
        if dup_op is None:
            raise ValueError("duplicate indices found; use dup_op to combine")
        name = dup_op if isinstance(dup_op, str) else dup_op.name
        starts = np.flatnonzero(flags)
        if name in _DUP_REDUCE:
            v = _DUP_REDUCE[name].reduceat(v, starts)
        elif name in ("first", "any"):
            v = v[starts]
        elif name == "second":
            v = v[np.r_[starts[1:], len(v)] - 1]
        else:
            raise NotImplementedError(
                f"dup_op {name} is not in the PyTorch port yet "
                f"(ROADMAP.md queue 1, item 12)")
        keep = flags.astype(bool)
        r, c = r[keep], c[keep]
    return r, c, v


def build_sparse_store(rows, cols, values, nrows, ncols, dtype, dup_op=None):
    """Matrix COO (host arrays) -> SparseStore."""
    r, c, v = sorted_dedup_coo(rows, cols, values, nrows, ncols, dup_op)
    v = np.asarray(v).astype(dtype.np_type, copy=False)
    return SparseStore(r, c, v, nrows, ncols, dtype)


def densify(sp, dtype, device):
    """SparseStore -> (vals, valid) bitmap store on device.  The store holds
    each coordinate once, so the scatter has no ties."""
    vals = torch.zeros((sp.nrows, sp.ncols), dtype=dtype.torch_type,
                       device=device)
    valid = torch.zeros((sp.nrows, sp.ncols), dtype=torch.bool, device=device)
    if sp.nvals():
        lin = torch.from_numpy(sp.rows * sp.ncols + sp.cols).to(device)
        vals.view(-1)[lin] = _dt.to_tensor(sp.vals, dtype, device)
        valid.view(-1)[lin] = True
    return vals, valid
