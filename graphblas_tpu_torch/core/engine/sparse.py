"""SparseStore and the generic sparse engine: the storage of every Matrix
over ``auto_sparse_limit`` elements, and the operations that keep it
sparse on its device (graphblas_tpu/core/engine/sparse.py).

A store holds ``rows``, ``cols`` (int64) and ``vals`` (the dtype's storage
type) as tensors on the matrix's device, sorted by (row, col), with no
duplicates and exactly one slot per stored entry.  The JAX package pads
its arrays to a power-of-two capacity and carries an ``ok`` plane,
because ``jit`` needs static shapes; every operation here returns the
compacted result instead, so what the two packages share is ``to_coo``.

Stores are never mutated.  A result with the structure of its source
(``apply``, a cast, ``mxm`` by a diagonal that drops nothing, an
element-wise operation of two stores of one structure) shares the
source's :class:`Structure`: its coordinates, its (col, row) permutation
and its host copy.  Plans (``_lanepipe_plans``, ``_sortpipe_plans``, the
BOOL twins) carry values, so every store has caches of its own.

The work is plain torch ops on the store's device (``searchsorted``,
``cumsum``, stable sorts, ``index_select``, ``segment_reduce`` and
``scatter_reduce_``): the generic SpMV and reduces for every monoid and
type the lanepipe and the sort pipeline decline, apply/select/transpose,
element-wise merges, the masked write-back, SpGEMM by Gustavson's
expansion or by the masked dot, and extract, assign and delete by index
lists.  A positional operator reads the effective coordinates of each
entry (after ``A.T`` swaps them), built only for the one index it names
(:func:`_pos`).
"""

import numpy as np
import torch

from ... import native
from ...exceptions import InvalidValue
from .. import dtypes as _dt
from . import dense
from . import store as st
from ..operator.base import typed

_I64 = torch.int64

_DUP_REDUCE = {"plus": np.add, "times": np.multiply, "min": np.minimum,
               "max": np.maximum}


class Structure:
    """The coordinates of one or more stores: rows and cols sorted by
    (row, col), the permutation to (col, row) order and the host copy of
    both, each made once when first needed.  Two stores share a structure
    exactly when they are the same object."""

    __slots__ = ("rows", "cols", "nrows", "ncols", "_csc", "_host")

    def __init__(self, rows, cols, nrows, ncols, *, host=None, csc=None):
        self.rows = rows
        self.cols = cols
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self._csc = csc
        self._host = host

    def csc_perm(self):
        """Permutation to (col, row) order, on the device (csc_perm_of)."""
        if self._csc is None:
            self._csc = csc_perm_of(self.cols)
        return self._csc

    def host(self):
        if self._host is None:
            self._host = (self.rows.cpu().numpy(), self.cols.cpu().numpy())
        return self._host

    def keys(self):
        return self.rows * max(self.ncols, 1) + self.cols


class SparseStore:
    __slots__ = ("struct", "vals", "dtype", "is_diag", "_host_vals",
                 "_lanepipe_plans", "_sortpipe_plans", "_bool_twins")

    def __init__(self, struct, vals, dtype, *, is_diag=False, host_vals=None):
        self.struct = struct
        self.vals = vals
        self.dtype = dtype
        self.is_diag = bool(is_diag)
        self._host_vals = host_vals
        self._lanepipe_plans = {}
        self._sortpipe_plans = {}
        self._bool_twins = {}

    rows = property(lambda self: self.struct.rows)
    cols = property(lambda self: self.struct.cols)
    nrows = property(lambda self: self.struct.nrows)
    ncols = property(lambda self: self.struct.ncols)
    device = property(lambda self: self.vals.device)

    def nvals(self):
        return int(self.struct.rows.numel())

    def csc_perm(self):
        return self.struct.csc_perm()

    def with_values(self, vals, dtype, *, is_diag=None):
        """A store of the same structure with other values (plans and
        twins start empty: they carry values)."""
        return SparseStore(self.struct, vals, dtype,
                           is_diag=self.is_diag if is_diag is None else is_diag)

    def host_coo(self):
        """(rows, cols, values) numpy arrays of the stored entries, read
        from the device once and cached; the native plan builders and
        ``to_coo`` read these."""
        if self._host_vals is None:
            self._host_vals = _dt.to_numpy(self.vals, self.dtype)
        r, c = self.struct.host()
        return r, c, self._host_vals

    def bool_twin(self, dtype):
        """The store of this matrix's truth values after a cast to dtype,
        as BOOL (cached, with plans of its own: for a 64-bit matrix, which
        no pipeline takes itself; see execute._plan)."""
        twin = self._bool_twins.get(dtype)
        if twin is None:
            truth = dense.truthy(st.cast_values(self.vals, self.dtype, dtype),
                                 dtype)
            twin = self.with_values(truth, _dt.BOOL)
            if self._host_vals is not None:
                twin._host_vals = self._host_vals.astype(dtype.np_type) != 0
            self._bool_twins[dtype] = twin
        return twin


# --------------------------------------------------------------------- #
# construction
def sorted_dedup_coo(rows, cols, values, nrows, ncols, dtype, dup_op):
    """Sort COO by (row, col) with the native radix argsort, cast the
    values to dtype and combine duplicates with dup_op, any builtin or user
    BinaryOp (or a Monoid's): each run of duplicates folds left to right,
    as in the JAX package."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    perm = native.coo_argsort(rows, cols, nrows, ncols)
    r, c = rows[perm], cols[perm]
    v = np.asarray(values)[perm].astype(_dt.host_np_type(dtype), copy=False)
    flags, uniq = native.coo_mark_unique(r, c)
    if uniq != len(r):
        if dup_op is None:
            raise InvalidValue("duplicate indices found; use dup_op to "
                               "combine")
        if getattr(dup_op, "opclass", None) == "Monoid":
            dup_op = dup_op.binaryop
        op = typed(dup_op, dtype, "BinaryOp")
        starts = np.flatnonzero(flags)
        if op.name in _DUP_REDUCE and op.type == dtype:
            v = _DUP_REDUCE[op.name].reduceat(v, starts)
        elif op.name in ("first", "any"):
            v = v[starts]
        elif op.name == "second":
            v = v[np.r_[starts[1:], len(v)] - 1]
        else:
            v = _fold_runs(v, starts, op, dtype)
        keep = flags.astype(bool)
        r, c = r[keep], c[keep]
    return r, c, v


def _fold_runs(v, starts, op, dtype):
    """acc = op(acc, next) along each run of duplicates (host tensors; one
    step per duplicate of the longest run)."""
    vals = _dt.to_tensor(v, dtype, "cpu")
    lens = np.diff(np.r_[starts, len(v)])
    acc = st.cast_values(vals[starts], dtype, op.type)
    for k in range(1, int(lens.max())):
        g = torch.from_numpy(np.flatnonzero(lens > k))
        x = st.cast_values(vals[torch.from_numpy(starts)[g] + k], dtype,
                           op.type2)
        acc[g] = st.cast_values(op(acc[g], x), op.return_type, op.type)
    return _dt.to_numpy(st.cast_values(acc, op.type, dtype), dtype)


def build_sparse_store(rows, cols, values, nrows, ncols, dtype, device,
                       dup_op=None):
    """Host COO -> SparseStore on device: sorted and deduplicated on the
    host (native), uploaded once; the host arrays stay as its host copy."""
    r, c, v = sorted_dedup_coo(rows, cols, values, nrows, ncols, dtype,
                               dup_op)
    struct = Structure(torch.from_numpy(r).to(device),
                       torch.from_numpy(c).to(device), nrows, ncols,
                       host=(r, c))
    return SparseStore(struct, _dt.to_tensor(v, dtype, device), dtype,
                       host_vals=v)


def empty_store(nrows, ncols, dtype, device):
    e = torch.zeros(0, dtype=_I64, device=device)
    return SparseStore(Structure(e, e, nrows, ncols),
                       st.zeros_values((0,), dtype, device),
                       dtype)


def store_from_parts(rows, cols, vals, nrows, ncols, dtype):
    """Device tensors already sorted by (row, col) without duplicates."""
    return SparseStore(Structure(rows, cols, nrows, ncols), vals, dtype)


def _filtered(sp, keep, vals, dtype):
    """sp's entries where keep, with vals; sp's structure when keep holds
    everywhere (one device read of the count)."""
    idx = keep.nonzero().reshape(-1)
    if idx.numel() == sp.nvals():
        return sp.with_values(vals, dtype)
    return SparseStore(Structure(sp.rows[idx], sp.cols[idx], sp.nrows,
                                 sp.ncols), vals[idx], dtype,
                       is_diag=sp.is_diag)


def resized(sp, nrows, ncols):
    """sp's entries inside nrows x ncols, in a store of that shape (the
    (row, col) order holds)."""
    keep = (sp.rows < nrows) & (sp.cols < ncols)
    idx = keep.nonzero().reshape(-1)
    return SparseStore(Structure(sp.rows[idx], sp.cols[idx], nrows, ncols),
                       sp.vals[idx], sp.dtype)


def diag_sparse_store(v_vals, v_valid, dtype, k, n):
    """Sparse k-offset diagonal (n x n) of a dense vector store; is_diag
    for k == 0, which is what the mxm scaling path keys on."""
    idx = v_valid.nonzero().reshape(-1)
    rows = idx + (0 if k >= 0 else -k)
    cols = idx + (k if k >= 0 else 0)
    return SparseStore(Structure(rows, cols, n, n), v_vals[idx], dtype,
                       is_diag=k == 0)


def densify(sp, dtype, device):
    """SparseStore -> (vals, valid) bitmap store on device.  The store holds
    each coordinate once, so the scatter has no ties."""
    vals = st.zeros_values((sp.nrows, sp.ncols), dtype, device)
    valid = torch.zeros((sp.nrows, sp.ncols), dtype=torch.bool, device=device)
    if sp.nvals():
        lin = sp.struct.keys().to(device)
        vals.view(-1)[lin] = st.cast_values(sp.vals, sp.dtype, dtype).to(device)
        valid.view(-1)[lin] = True
    return vals, valid


def from_dense(vals, valid, dtype):
    """Bitmap store -> SparseStore on the same device."""
    nrows, ncols = valid.shape
    r, c = valid.nonzero(as_tuple=True)
    return store_from_parts(r, c, vals[r, c], nrows, ncols, dtype)


def csc_perm_of(cols):
    """Permutation of (row, col)-sorted entries to (col, row) order: a
    stable sort by column."""
    return torch.sort(cols, stable=True)[1]


# --------------------------------------------------------------------- #
# segmented monoid reduction
def _wide_acc(dt):
    """Accumulator of the plus reduce (the JAX package's exact cumsum
    type): float64 for floats, complex128 for the complex types, int64
    for the integers."""
    if dt.is_complex:
        return torch.complex128
    return torch.float64 if dt.is_float else torch.int64


def _iota(n, device):
    return torch.arange(n, dtype=_I64, device=device)


def _before(cs, i):
    """The running sum before position i, from the inclusive running sum
    cs (0 before the first)."""
    return torch.where(i > 0, _take(cs, i - 1), 0)


def _segment_sums(x, start, end):
    """x's sum over [start, end) of every segment: a difference of one
    running sum (exact for integers; a float's error would follow the
    running total)."""
    cs = torch.cumsum(x, 0)
    return _before(cs, end) - _before(cs, start)


def _segment_fold(seg, x, combine, n, ident, start, end):
    """Fold x (sorted by seg) per segment with combine, by a segmented
    Hillis-Steele scan: log2(len) passes of torch ops.  Empty segments get
    ident."""
    v = x
    m = x.numel()
    d = 1
    while d < m:
        same = seg[d:] == seg[:-d]
        v = torch.cat([v[:d], torch.where(same, combine(v[:-d], v[d:]),
                                          v[d:])])
        d <<= 1
    return torch.where(end > start, _take(v, end - 1), ident)


_RUN = 256  # the most atomics _scatter_minmax sends to one address
# the two levels pay when the longest segment holds over 1/_SHARE of the
# slots: its atomics, one after another, outweigh their passes over all
_SHARE = 32


def _hub_runs(seg, start, end, n):
    """None where the longest segment of the sorted seg holds at most
    max(_RUN, slots / _SHARE) slots (one device read); else the flags that
    start each run of at most _RUN consecutive slots of one segment."""
    m = seg.numel()
    longest = int((end - start).max()) if n else 0
    if longest <= max(_RUN, m // _SHARE):
        return None
    brk = torch.ones(m, dtype=torch.bool, device=seg.device)
    brk[1:] = (seg[1:] != seg[:-1]) | (_iota(m, seg.device)[1:] % _RUN == 0)
    return brk


def _scatter_minmax(seg, x, red, ident, n, start, end):
    """``ident.expand(n).clone().scatter_reduce_(0, seg, x, red)`` for a
    sorted seg whose segments span [start, end).  A scatter straight into
    a hub destination serializes on its atomics, so where the longest
    segment holds over max(_RUN, slots / _SHARE) slots (one device read),
    runs of up to _RUN consecutive slots of one segment reduce first,
    then the runs into the n slots: no address takes more than _RUN
    atomics.  The probe of commit 25bd9b5 (scripts/segment_minmax_probe.py)
    timed the ways on the zipf graph's hub of 499,786 in-edges."""
    out = ident.expand(n).clone()
    brk = _hub_runs(seg, start, end, n)
    if brk is None:
        return out.scatter_reduce_(0, seg, x, red)
    m, dev = seg.numel(), seg.device
    run = torch.cumsum(brk, 0) - 1
    n_runs = min(m, n + m // _RUN + 1)  # at least the runs made
    run_vals = ident.expand(n_runs).clone().scatter_reduce_(0, run, x, red)
    run_seg = torch.zeros(n_runs, dtype=_I64, device=dev).scatter_(0, run,
                                                                   seg)
    return out.scatter_reduce_(0, run_seg, run_vals, red)


def _complex_sums(seg, x, bounds, start, end, n):
    """The complex128 sum of each segment of x (sorted by seg), as the
    real and imaginary parts in float64.  torch.segment_reduce has no
    complex kernel; on the (slots, 2) view its CUDA kernel sums each
    segment in one thread (65 ms for the zipf graph's hub, of 499,786
    slots), and as two 1-d reduces it takes CUB's segmented reduce (1.28
    ms against 0.043 over the zipf graph's rows;
    scripts/complex_sum_probe.py).  So where one segment is long
    (_hub_runs), its runs of at most _RUN slots add first, then the
    runs."""
    parts = torch.view_as_real(x)
    brk = _hub_runs(seg, start, end, n)
    if brk is not None:
        first = brk.nonzero().reshape(-1)
        parts = torch.segment_reduce(
            parts, "sum", offsets=torch.cat([first, first.new_tensor(
                [seg.numel()])]), unsafe=True, initial=0.0)
        bounds = torch.searchsorted(seg[first], _iota(n + 1, seg.device))
    sums = torch.segment_reduce(parts, "sum", offsets=bounds, unsafe=True,
                                initial=0.0)
    return torch.view_as_complex(sums.contiguous())


def _minmax(seg, x, name, n, ident, mono, start, end):
    """min/max per segment with the fmin/fmax semantics of the JAX
    package's combine: a NaN loses to any number and survives only where
    every slot of its segment is NaN."""
    red = "amin" if name == "min" else "amax"
    if mono.type is _dt.UINT64:  # unsigned: flip the sign bit around it
        s = -(1 << 63)
        return _scatter_minmax(seg, x ^ s, red, ident ^ s, n, start, end) ^ s
    if not mono.type.is_float:
        return _scatter_minmax(seg, x, red, ident, n, start, end)
    nan = torch.isnan(x)
    out = _scatter_minmax(seg, torch.where(nan, ident, x), red, ident, n,
                          start, end)
    all_nan = (_segment_sums((~nan).to(_I64), start, end) == 0) & \
        (end > start)
    return torch.where(all_nan, torch.full_like(out, float("nan")), out)


def segment_reduce_sorted(seg, vals, ok, mono, n, in_dt):
    """Monoid-reduce ``vals[ok]`` grouped by the sorted ``seg`` into n dense
    slots: (values in mono.type, valid).  As in the JAX package, the
    segments' bounds come from a binary search, with no scatter where many
    entries meet one destination; slots where ``ok`` is False take the
    identity, and ``any`` keeps the first valid element.  Integer sums are
    differences of one running sum (exact in int64); float sums add each
    segment on its own in float64 (complex ones their real and imaginary
    parts so), since a difference of running sums would carry the
    rounding of every earlier segment.  A user-defined monoid folds by
    the segmented scan, its values a Tree (store.py).  min and max
    scatter, in two levels where one segment is long (_scatter_minmax);
    times, band and bor fold by a segmented scan."""
    dev = vals.device
    x = st.cast_values(vals, in_dt, mono.type)
    name = mono.parent.name
    bounds = torch.searchsorted(seg, _iota(n + 1, dev))
    start, end = bounds[:-1], bounds[1:]
    okc = torch.cumsum(ok.to(_I64), 0)
    ok_before = _before(okc, start)
    out_valid = _before(okc, end) > ok_before
    if name == "any":
        # the first slot whose running count of valid slots passes start's
        got = _take(x, torch.searchsorted(okc, ok_before + 1))
        return torch.where(out_valid, got, torch.zeros_like(got)), out_valid
    ident = st.identity_value_array(mono, mono.type, dev)
    xi = torch.where(ok, x, ident)
    if name == "plus":
        acc = _wide_acc(mono.type)
        if acc.is_complex:
            sums = _complex_sums(seg, xi.to(acc), bounds, start, end, n)
        elif acc.is_floating_point:
            sums = torch.segment_reduce(xi.to(acc), "sum", offsets=bounds,
                                        unsafe=True, initial=0.0)
        else:
            sums = _segment_sums(xi.to(acc), start, end)
        return _dt.normalize(sums, mono.type), out_valid
    if name in ("lor", "land"):
        t = _segment_sums(xi.to(_I64), start, end)
        out = t > 0 if name == "lor" else t == end - start
        return out, out_valid
    if name in ("min", "max"):
        return _minmax(seg, xi, name, n, ident, mono, start, end), out_valid
    out = _segment_fold(seg, xi, mono.binaryop, n, ident, start, end)
    return _dt.normalize(out, mono.type), out_valid


def _pos(op, context_map=dense.EWISE_MAP, **where):
    """The position a positional op reads, as dense.apply_binop takes it,
    from the callables in `where` (by index name: i, j, k); only the one
    it names is computed.  None for any other op."""
    if op._positional is None:
        return None
    name = context_map[op._positional[0]]
    return {name: where[name]()}


def _at(sp):
    """Callables of the i and j of sp's entries, for _pos."""
    return {"i": lambda: sp.rows, "j": lambda: sp.cols}


# --------------------------------------------------------------------- #
# semiring matvec and reduces
def spmv(sp, at, kind, u_vals, u_valid, ring, a_dt, u_dt):
    """w = A u (kind 'mxv') or w = u A ('vxm') over any semiring and type:
    gather u at the contraction index, multiply entry by entry, and
    reduce by destination.  `at` swaps the coordinate roles (A.T).
    Returns a dense vector store of the output size."""
    mult, mono = ring.binaryop, ring.monoid
    rows, cols = sp.rows, sp.cols
    eff_rows, eff_cols = (cols, rows) if at else (rows, cols)
    if kind == "mxv":
        k_ids, dest = eff_cols, eff_rows
    else:
        k_ids, dest = eff_rows, eff_cols
    out_size = (sp.ncols if at else sp.nrows) if kind == "mxv" else \
        (sp.nrows if at else sp.ncols)
    x_ok = u_valid[k_ids]
    if mult._positional is not None:
        # u is a row (vxm: u(0, k) A(k, j)) or a column (mxv: A(i, k) u(k, 0))
        zero = torch.zeros((), dtype=_I64, device=rows.device)
        pos = _pos(mult, dense.MATMUL_MAP, k=lambda: k_ids,
                   i=lambda: zero if kind == "vxm" else eff_rows,
                   j=lambda: eff_cols if kind == "vxm" else zero)
        prods = dense.positional_value(mult, pos, k_ids.shape,
                                       dense.MATMUL_MAP)
    elif kind == "vxm":
        prods = dense.apply_binop(mult, u_vals[k_ids], u_dt, sp.vals, a_dt)
    else:
        prods = dense.apply_binop(mult, sp.vals, a_dt, u_vals[k_ids], u_dt)
    seg = dest
    if dest is not rows:
        perm = sp.csc_perm()  # destination-sorted order, k ascending
        seg, prods, x_ok = seg[perm], prods[perm], x_ok[perm]
    return segment_reduce_sorted(seg, prods, x_ok, mono, out_size,
                                 mult.return_type)


def reduce_axis(sp, at, axis, mono, in_dt):
    """Monoid-reduce rows (axis=1) or columns (axis=0) -> dense vector
    store."""
    rows, cols = sp.rows, sp.cols
    eff_rows, eff_cols = (cols, rows) if at else (rows, cols)
    n_r, n_c = (sp.ncols, sp.nrows) if at else (sp.nrows, sp.ncols)
    dest, out_size = (eff_rows, n_r) if axis == 1 else (eff_cols, n_c)
    vals = sp.vals
    if dest is not rows:
        perm = sp.csc_perm()
        dest, vals = dest[perm], vals[perm]
    ok = torch.ones(dest.numel(), dtype=torch.bool, device=vals.device)
    return segment_reduce_sorted(dest, vals, ok, mono, out_size, in_dt)


def extract_element(sp, at, i, j):
    """A[i, j] by a binary search over the (row, col) keys; no device
    read."""
    if at:
        i, j = j, i
    dev = sp.device
    if sp.nvals() == 0:
        return (sp.vals.new_zeros(()),
                torch.zeros((), dtype=torch.bool, device=dev))
    key = sp.struct.keys()
    target = torch.tensor([i * max(sp.ncols, 1) + j], dtype=_I64, device=dev)
    pos = torch.searchsorted(key, target).clamp(max=key.numel() - 1)
    return sp.vals[pos][0], (key[pos] == target)[0]


# --------------------------------------------------------------------- #
# structure-preserving operations (sparse in -> sparse out)
def apply_unary(sp, op, a_dt):
    vals = dense.apply_unop(op, sp.vals, a_dt, pos=_pos(op, **_at(sp)))
    return sp.with_values(vals, op.return_type)


def apply_bound(sp, op, a_dt, scalar_val, scalar_dt, left):
    vals = dense.bound_vals(sp.vals, op, a_dt, scalar_val, scalar_dt, left,
                            pos=_pos(op, **_at(sp)))
    return sp.with_values(vals, op.return_type)


def _indexunary_vals(sp, op, a_dt, thunk_val):
    return dense.indexunary_vals(sp.vals, sp.rows, sp.cols, op, a_dt,
                                 thunk_val)


def apply_indexunary(sp, op, a_dt, thunk_val):
    return sp.with_values(_indexunary_vals(sp, op, a_dt, thunk_val),
                          op.return_type)


def select_op(sp, op, a_dt, thunk_val, out_dt):
    pred = _indexunary_vals(sp, op, a_dt, thunk_val)
    return _filtered(sp, pred, st.cast_values(sp.vals, a_dt, out_dt), out_dt)


def cast_copy(sp, in_dt, out_dt):
    if in_dt == out_dt:
        return sp
    return sp.with_values(st.cast_values(sp.vals, in_dt, out_dt), out_dt)


def transpose(sp):
    """Materialized transpose: entries in (col, row) order; its own (col,
    row) permutation is the inverse of the source's."""
    perm = sp.csc_perm()
    inv = torch.empty_like(perm)
    inv[perm] = _iota(perm.numel(), perm.device)
    struct = Structure(sp.cols[perm], sp.rows[perm], sp.ncols, sp.nrows,
                       csc=inv)
    return SparseStore(struct, sp.vals[perm], sp.dtype, is_diag=sp.is_diag)


def mxm_diag(sp, d, left_diag, ring, a_dt, d_dt):
    """D @ A (left_diag) or A @ D for a diagonal D: each entry scaled by the
    semiring's multiply; the monoid never fires (one k term an output).
    An entry whose diagonal element is missing is dropped."""
    mult = ring.binaryop
    n = d.nrows
    dev = sp.device
    dv = d.vals.new_zeros((n,)).to(dev)
    dok = torch.zeros(n, dtype=torch.bool, device=dev)
    dv[d.rows] = d.vals
    dok[d.rows] = True
    ids = sp.rows if left_diag else sp.cols
    x = dv[ids]
    # one k an entry: the diagonal's index
    pos = _pos(mult, dense.MATMUL_MAP, k=lambda: ids, **_at(sp))
    if left_diag:
        out = dense.apply_binop(mult, x, d_dt, sp.vals, a_dt, pos=pos,
                                context_map=dense.MATMUL_MAP)
    else:
        out = dense.apply_binop(mult, sp.vals, a_dt, x, d_dt, pos=pos,
                                context_map=dense.MATMUL_MAP)
    out = st.cast_values(out, mult.return_type, ring.monoid.type)
    return _filtered(sp, dok[ids], out, ring.monoid.type)


def ewise_mult_vector_bcast(sp, op, a_dt, v_vals, v_valid, v_dt, *,
                            vector_left=False):
    """A .* broadcast(v along rows): out[i, j] = op(A[i, j], v[j]) (or
    with the vector as the left operand), where v[j] is stored."""
    x = v_vals[sp.cols]
    pos = _pos(op, **_at(sp))
    if vector_left:
        out = dense.apply_binop(op, x, v_dt, sp.vals, a_dt, pos=pos)
    else:
        out = dense.apply_binop(op, sp.vals, a_dt, x, v_dt, pos=pos)
    return _filtered(sp, v_valid[sp.cols], out, op.return_type)


def outer(a_vals, a_valid, b_vals, b_valid, op, a_dt, b_dt):
    """The outer product of two dense vector stores as a SparseStore in
    op's return type: op(a[i], b[j]) at every (i, j) both store, in
    (row, col) order."""
    ia = a_valid.nonzero().reshape(-1)
    ib = b_valid.nonzero().reshape(-1)
    rows = ia.repeat_interleave(ib.numel())
    cols = ib.repeat(ia.numel())
    z = dense.apply_binop(op, a_vals[rows], a_dt, b_vals[cols], b_dt,
                          pos=_pos(op, i=lambda: rows, j=lambda: cols))
    return store_from_parts(rows, cols, z, a_valid.numel(), b_valid.numel(),
                            op.return_type)


def ewise_same_structure(a, b, op, a_dt, b_dt, out_dt, transposed=False):
    """Element-wise op (mult, add or union alike) over two stores of one
    structure: every entry is in both, so the op applies everywhere and the
    structure is kept.  transposed: both operands are read as ``.T`` (the
    caller transposes the result), which a positional op must know."""
    where = _at(a)
    if transposed:
        where = {"i": where["j"], "j": where["i"]}
    z = dense.apply_binop(op, a.vals, a_dt, b.vals, b_dt,
                          pos=_pos(op, **where))
    return a.with_values(st.cast_values(z, op.return_type, out_dt), out_dt,
                         is_diag=a.is_diag and b.is_diag)


def ewise_mult_sparse_dense(sp, op, sp_dt, d_vals, d_valid, d_dt,
                            sparse_left=True):
    """Sparse .* dense bitmap: the dense plane gathered at the sparse
    coordinates (the result's structure is a subset of the sparse one)."""
    lin = sp.rows * d_valid.shape[1] + sp.cols
    dv = d_vals.reshape(-1)[lin]
    pos = _pos(op, **_at(sp))
    if sparse_left:
        out = dense.apply_binop(op, sp.vals, sp_dt, dv, d_dt, pos=pos)
    else:
        out = dense.apply_binop(op, dv, d_dt, sp.vals, sp_dt, pos=pos)
    return _filtered(sp, d_valid.reshape(-1)[lin], out, op.return_type)


# --------------------------------------------------------------------- #
# merges of two stores of one shape
def _take(vals, idx):
    """vals[idx] with idx clamped into range; zeros where vals is empty."""
    if vals.numel() == 0:
        return vals.new_zeros(idx.shape).to(idx.device)
    return vals[idx.clamp(0, vals.numel() - 1)]


def _find(keys, targets):
    """(position, found) of each target in the sorted unique keys."""
    q = torch.searchsorted(keys, targets)
    return q, (q < keys.numel()) & (_take(keys, q) == targets)


def merge_slots(a, b):
    """Align two stores on the union of their coordinates, in (row, col)
    order, without a sort: each side's rank in the other comes from a
    binary search.  Returns (rows, cols, a_idx, b_idx, has_a, has_b) over
    the union's slots (one device read: the union's size)."""
    ka, kb = a.struct.keys(), b.struct.keys()
    dev = ka.device
    na, nb = ka.numel(), kb.numel()
    qa, a_in_b = _find(kb, ka)
    qb, b_in_a = _find(ka, kb)
    matched = a_in_b.to(_I64)
    before_a = torch.cumsum(matched, 0) - matched  # matches before a's slot
    pos_a = _iota(na, dev) + qa - before_a
    b_only = (~b_in_a).to(_I64)
    pos_b_only = qb + torch.cumsum(b_only, 0) - b_only
    pos_b = torch.where(b_in_a, _take(pos_a, qb), pos_b_only)
    u = na + nb - int(matched.sum())
    a_idx = torch.full((u,), -1, dtype=_I64, device=dev)
    b_idx = torch.full((u,), -1, dtype=_I64, device=dev)
    a_idx[pos_a] = _iota(na, dev)
    b_idx[pos_b] = _iota(nb, dev)
    has_a, has_b = a_idx >= 0, b_idx >= 0
    rows = torch.where(has_a, _take(a.rows, a_idx), _take(b.rows, b_idx))
    cols = torch.where(has_a, _take(a.cols, a_idx), _take(b.cols, b_idx))
    return rows, cols, a_idx, b_idx, has_a, has_b


def merge_ewise(a, b, variant, op, a_dt, b_dt, out_dt, lr=None):
    """ewise mult/add/union of two sparse stores with different
    structures.  lr = (ldef, rdef): 0-d tensors of op.type and op.type2
    (union)."""
    if variant == "mult":
        qa, a_in_b = _find(b.struct.keys(), a.struct.keys())
        z = dense.apply_binop(op, a.vals, a_dt, _take(b.vals, qa), b_dt,
                              pos=_pos(op, **_at(a)))
        return _filtered(a, a_in_b, st.cast_values(z, op.return_type, out_dt),
                         out_dt)
    rows, cols, a_idx, b_idx, has_a, has_b = merge_slots(a, b)
    av, bv = _take(a.vals, a_idx), _take(b.vals, b_idx)
    both = has_a & has_b
    pos = _pos(op, i=lambda: rows, j=lambda: cols)
    comb = st.cast_values(dense.apply_binop(op, av, a_dt, bv, b_dt, pos=pos),
                          op.return_type, out_dt)
    if variant == "add":
        a_pass = st.cast_values(av, a_dt, out_dt)
        b_pass = st.cast_values(bv, b_dt, out_dt)
    else:
        ldef, rdef = lr
        a_pass = st.cast_values(
            dense.apply_binop(op, av, a_dt, rdef.expand(av.shape), op.type2,
                              pos=pos),
            op.return_type, out_dt)
        b_pass = st.cast_values(
            dense.apply_binop(op, ldef.expand(bv.shape), op.type, bv, b_dt,
                              pos=pos),
            op.return_type, out_dt)
    vals = torch.where(both, comb, torch.where(has_a, a_pass, b_pass))
    return store_from_parts(rows, cols, vals, a.nrows, a.ncols, out_dt)


# --------------------------------------------------------------------- #
# masks at sparse coordinates
def mask_at(msp, m_dt, structure, complement, rows, cols):
    """A mask whose parent is sparse-backed, evaluated at the given
    coordinates by a binary search over its keys."""
    q, hit = _find(msp.struct.keys(), rows * max(msp.ncols, 1) + cols)
    if not structure:
        hit = hit & dense.truthy(_take(msp.vals, q), m_dt)
    return ~hit if complement else hit


def dense_mask_at(mask_arr, rows, cols):
    """A dense (complement-resolved) mask plane gathered at coordinates."""
    return mask_arr.reshape(-1)[rows * mask_arr.shape[1] + cols]


def write_back_sparse(c, z, c_dt, z_dt, accum, replace, mask_fn):
    """The GraphBLAS update of sparse C by sparse Z under (mask, accum,
    replace), on the union of their coordinates.  mask_fn(rows, cols) ->
    bool per slot, or None."""
    rows, cols, c_idx, z_idx, has_c, has_z = merge_slots(c, z)
    c_val, z_val = _take(c.vals, c_idx), _take(z.vals, z_idx)
    msk = torch.ones_like(has_c) if mask_fn is None else mask_fn(rows, cols)
    z_cast = st.cast_values(z_val, z_dt, c_dt)
    keep_c = has_c & (not replace)
    if accum is None:
        out_ok = torch.where(msk, has_z, keep_c)
        vals = torch.where(msk & has_z, z_cast, c_val)
    else:
        both = st.cast_values(
            dense.apply_binop(accum, c_val, c_dt, z_val, z_dt,
                              pos=_pos(accum, i=lambda: rows,
                                       j=lambda: cols)),
            accum.return_type, c_dt)
        out_ok = torch.where(msk, has_c | has_z, keep_c)
        vals = torch.where(msk & has_c & has_z, both,
                           torch.where(msk & has_z & ~has_c, z_cast, c_val))
    idx = out_ok.nonzero().reshape(-1)
    return store_from_parts(rows[idx], cols[idx], vals[idx], c.nrows,
                            c.ncols, c_dt)


# --------------------------------------------------------------------- #
# SpGEMM by Gustavson's expansion (the JAX package's two-phase SpGEMM:
# a total, then expand, a stable sort by output coordinate, and combine)
def _b_ksorted(b, bt):
    """B's entries in contraction-index (effective-row) order:
    (k, j, vals)."""
    if not bt:
        return b.rows, b.cols, b.vals
    perm = b.csc_perm()
    return b.cols[perm], b.rows[perm], b.vals[perm]


def _a_sides(a, at):
    """(i, k) of A's entries: output row and contraction index."""
    return (a.cols, a.rows) if at else (a.rows, a.cols)


def spgemm_total(a, b, at, bt, k_dim):
    """Number of products Gustavson's expansion makes (a device scalar)."""
    _, a_k = _a_sides(a, at)
    b_k = b.cols if bt else b.rows
    rowlen = torch.bincount(b_k, minlength=k_dim)
    return rowlen[a_k].sum()


def _expand(counts, total):
    """(owner, rank) of each of `total` expanded terms: the term's
    position in the owner's run of counts[owner] terms."""
    dev = counts.device
    owner = torch.repeat_interleave(_iota(counts.numel(), dev), counts,
                                    output_size=total)
    start = torch.cumsum(counts, 0) - counts
    return owner, _iota(total, dev) - start[owner]


def spgemm(a, b, at, bt, ring, a_dt, b_dt, out_nrows, out_ncols, k_dim,
           total, mask_fn=None):
    """C = A (ring) B: each A entry times B's row at its contraction index,
    the products filtered by mask_fn(i, j) (mask pushdown), sorted by
    output coordinate (stable) and combined with the monoid."""
    mult, mono = ring.binaryop, ring.monoid
    dev = a.device
    a_i, a_k = _a_sides(a, at)
    b_k, b_j, b_vals = _b_ksorted(b, bt)
    indptr_b = torch.searchsorted(b_k, _iota(k_dim + 1, dev))
    counts = (indptr_b[1:] - indptr_b[:-1])[a_k]
    e, t = _expand(counts, total)
    b_slot = indptr_b[a_k[e]] + t
    i, j = a_i[e], b_j[b_slot]
    if mask_fn is not None:
        keep = mask_fn(i, j).nonzero().reshape(-1)
        e, b_slot, i, j = e[keep], b_slot[keep], i[keep], j[keep]
    if mult._positional is not None:
        pos = _pos(mult, dense.MATMUL_MAP, i=lambda: i, j=lambda: j,
                   k=lambda: a_k[e])
        prods = dense.positional_value(mult, pos, e.shape, dense.MATMUL_MAP)
    else:
        prods = dense.apply_binop(mult, a.vals[e], a_dt, b_vals[b_slot],
                                  b_dt)
    prods = st.cast_values(prods, mult.return_type, mono.type)
    key, order = torch.sort(i * max(out_ncols, 1) + j, stable=True)
    uniq, seg = torch.unique_consecutive(key, return_inverse=True)
    ok = torch.ones(key.numel(), dtype=torch.bool, device=dev)
    vals, _ = segment_reduce_sorted(seg, prods[order], ok, mono, uniq.numel(),
                                    mono.type)
    ncols = max(out_ncols, 1)
    return store_from_parts(uniq // ncols, uniq % ncols, vals, out_nrows,
                            out_ncols, mono.type)


# --------------------------------------------------------------------- #
# the masked dot: C(M) << A @ B for a mask M that is sparse and not
# complemented.  For each mask entry (i, j) the shorter of A(i, :) and
# B(:, j) is expanded and each of its contraction indices k is looked up
# by a binary search in the other side's (major, k)-sorted keys.  Work and
# memory: one term per expanded index, sum over M of min(deg_A(i),
# deg_B(j)), against Gustavson's sum over k of deg_A(k) * deg_B(k).
def _dot_side(sp, use_csc):
    """(major, k, vals) of one side, sorted by (major, k)."""
    if use_csc:
        perm = sp.csc_perm()
        return sp.cols[perm], sp.rows[perm], sp.vals[perm]
    return sp.rows, sp.cols, sp.vals


def _dot_mask_ok(msp, m_dt, structure):
    if structure:
        return torch.ones(msp.nvals(), dtype=torch.bool, device=msp.device)
    return dense.truthy(msp.vals, m_dt)


def _dot_degrees(a, b, msp, m_dt, structure, at, bt, out_nrows, out_ncols):
    a_side = _dot_side(a, at)
    b_side = _dot_side(b, not bt)
    dev = a.device
    indptr_a = torch.searchsorted(a_side[0], _iota(out_nrows + 1, dev))
    indptr_b = torch.searchsorted(b_side[0], _iota(out_ncols + 1, dev))
    deg_a = indptr_a[1:] - indptr_a[:-1]
    deg_b = indptr_b[1:] - indptr_b[:-1]
    ok_m = _dot_mask_ok(msp, m_dt, structure)
    da, db = deg_a[msp.rows], deg_b[msp.cols]
    cnt = torch.where(ok_m, torch.minimum(da, db), 0)
    return a_side, b_side, indptr_a, indptr_b, ok_m, da, db, cnt


def spgemm_dot_total(a, b, msp, m_dt, structure, at, bt, out_nrows,
                     out_ncols, k_dim):
    """[gustavson_total, dot_total] as one int64 device tensor, so the
    host picks the formulation with one device read."""
    gus = spgemm_total(a, b, at, bt, k_dim)
    cnt = _dot_degrees(a, b, msp, m_dt, structure, at, bt, out_nrows,
                       out_ncols)[-1]
    return torch.stack([gus, cnt.sum()])


def spgemm_masked_dot(a, b, msp, at, bt, ring, a_dt, b_dt, m_dt, structure,
                      out_nrows, out_ncols, k_dim, total):
    """The masked dot.  An output entry sits at a mask entry (that passes a
    value mask) with at least one term whose index both sides store."""
    mult, mono = ring.binaryop, ring.monoid
    (a_side, b_side, indptr_a, indptr_b, ok_m, da, db,
     cnt) = _dot_degrees(a, b, msp, m_dt, structure, at, bt, out_nrows,
                         out_ncols)
    a_major, a_k, a_vals = a_side
    b_major, b_k, b_vals = b_side
    na, nb = a_k.numel(), b_k.numel()
    dev = a.device
    kd1 = k_dim + 1
    mr, mc = msp.rows, msp.cols
    # X: the k of both sides (A first); Y: both sides' composite keys (B
    # first, A's above every key of B), so one search serves either side
    x_k = torch.cat([a_k, b_k])
    y = torch.cat([b_major * kd1 + b_k,
                   a_major * kd1 + a_k + (out_ncols + 1) * kd1])
    ua = da <= db  # expand A's row where it is the shorter side
    start = torch.where(ua, indptr_a[:-1][mr], na + indptr_b[:-1][mc])
    base = torch.where(ua, mc * kd1, mr * kd1 + (out_ncols + 1) * kd1)
    mo, t = _expand(cnt, total)
    src = start[mo] + t
    del t
    tgt = base[mo] + x_k[src]
    q, found = _find(y, tgt)
    del tgt
    if mult.parent.name == "pair":
        prods = torch.ones(found.shape, dtype=mult.return_type.torch_type,
                           device=dev)
    elif mult._positional is not None:
        # the term's k: the expanded side's index, which the other side
        # stores wherever the term is found
        pos = _pos(mult, dense.MATMUL_MAP, i=lambda: mr[mo],
                   j=lambda: mc[mo], k=lambda: x_k[src])
        prods = dense.positional_value(mult, pos, found.shape,
                                       dense.MATMUL_MAP)
    else:
        ua_t = ua[mo]
        av = _take(a_vals, torch.where(ua_t, src, q - nb))
        bv = _take(b_vals, torch.where(ua_t, q, src - na))
        prods = dense.apply_binop(mult, av, a_dt, bv, b_dt)
    out_vals, out_valid = segment_reduce_sorted(
        mo, prods, found, mono, msp.nvals(), mult.return_type)
    keep = (out_valid & ok_m).nonzero().reshape(-1)
    return store_from_parts(mr[keep], mc[keep], out_vals[keep], out_nrows,
                            out_ncols, mono.type)


# --------------------------------------------------------------------- #
# extract (GrB_Matrix_extract): inverse maps and a re-sort, no densify
def extract_submatrix(sp, rows, cols, in_order):
    """A[rows, cols] for duplicate-free index lists (int64 on the store's
    device): each entry's row and column looked up in inverse maps of the
    lists, the entries on both kept, re-keyed and sorted.  Where both lists
    increase (in_order) the kept entries are already in (row, col) order
    and the sort is skipped.  O(nnz + nrows + ncols); one device read, the
    number of entries kept."""
    dev = sp.device
    n_r, n_c = rows.numel(), cols.numel()
    inv_r = torch.full((sp.nrows,), -1, dtype=_I64, device=dev)
    inv_r[rows] = _iota(n_r, dev)
    inv_c = torch.full((sp.ncols,), -1, dtype=_I64, device=dev)
    inv_c[cols] = _iota(n_c, dev)
    nr, nc = inv_r[sp.rows], inv_c[sp.cols]
    keep = ((nr >= 0) & (nc >= 0)).nonzero().reshape(-1)
    nr, nc, vals = nr[keep], nc[keep], sp.vals[keep]
    if not in_order:
        w = max(n_c, 1)
        key, order = torch.sort(nr * w + nc)
        nr, nc, vals = key // w, key % w, vals[order]
    return store_from_parts(nr, nc, vals, n_r, n_c, sp.dtype)


def extract_rowcol_dense(sp, fixed, idx, axis_row):
    """A[fixed, idx] (axis_row) or A[idx, fixed] as a dense vector store
    of len(idx): one binary search over the (row, col) keys for each
    element asked for; no device read."""
    ncols = max(sp.ncols, 1)
    target = fixed * ncols + idx if axis_row else idx * ncols + fixed
    q, found = _find(sp.struct.keys(), target)
    vals = torch.where(found, _take(sp.vals, q),
                       sp.vals.new_zeros(()).to(q.device))
    return vals, found


# --------------------------------------------------------------------- #
# assign (GrB_Matrix_assign and GxB_subassign onto a sparse matrix)
def _keyed_store(rows, cols, vals, nrows, ncols, dtype, in_order):
    """A store of entries at distinct coordinates, sorted by (row, col)
    unless they already are (in_order)."""
    if not in_order:
        key, order = torch.sort(rows * max(ncols, 1) + cols)
        rows, cols, vals = rows[order], cols[order], vals[order]
    return store_from_parts(rows, cols, vals, nrows, ncols, dtype)


def region_store(rows, cols, v_vals, v_ok, nrows, ncols, dtype, in_order):
    """A dense region-shaped value plane (len(rows) x len(cols), or
    broadcast to it) placed at C's coordinates rows x cols, as a store of
    its present elements (one device read: how many)."""
    n_c = cols.numel()
    shape = (rows.numel(), n_c)
    idx = v_ok.expand(shape).reshape(-1).nonzero().reshape(-1)
    vals = v_vals.expand(shape).reshape(-1)[idx]
    return _keyed_store(rows[idx // max(n_c, 1)], cols[idx % max(n_c, 1)],
                        vals, nrows, ncols, dtype, in_order)


def placed_store(v, rows, cols, nrows, ncols, in_order):
    """A sparse region value (a store of len(rows) x len(cols)) placed at
    C's coordinates rows x cols."""
    return _keyed_store(rows[v.rows], cols[v.cols], v.vals, nrows, ncols,
                        v.dtype, in_order)


def membership_fn(rows, cols, nrows, ncols):
    """in_region(r, c): is (r, c) in rows x cols (int64 on the device)?"""
    in_r = torch.zeros(nrows, dtype=torch.bool, device=rows.device)
    in_r[rows] = True
    in_c = torch.zeros(ncols, dtype=torch.bool, device=cols.device)
    in_c[cols] = True

    def fn(r, c):
        return in_r[r] & in_c[c]

    return fn


def assign_sparse(c, z, c_dt, z_dt, accum, replace, mask_fn, in_region_fn,
                  submask):
    """Assign the region content z (a store at C's coordinates) into C.

    GrB_assign: C's region takes z's content (accum merges inside the
    region), then the mask and replace act over the whole of C.
    GxB_subassign (submask): the mask and replace act inside the region
    only.  The result is the merge of both stores less the elements
    deleted (one device read for the merge, one for the result)."""
    rows, cols, c_idx, z_idx, has_c, has_z = merge_slots(c, z)
    c_val, z_val = _take(c.vals, c_idx), _take(z.vals, z_idx)
    in_region = in_region_fn(rows, cols) | has_z
    msk = torch.ones_like(has_c) if mask_fn is None else mask_fn(rows, cols)
    z_cast = st.cast_values(z_val, z_dt, c_dt)
    if accum is None:
        zp_ok = torch.where(in_region, has_z, has_c)
        zp_val = torch.where(in_region & has_z, z_cast, c_val)
    else:
        both = st.cast_values(
            dense.apply_binop(accum, c_val, c_dt, z_val, z_dt,
                              pos=_pos(accum, i=lambda: rows,
                                       j=lambda: cols)),
            accum.return_type, c_dt)
        zp_ok = torch.where(in_region, has_c | has_z, has_c)
        zp_val = torch.where(in_region & has_c & has_z, both,
                             torch.where(in_region & has_z & ~has_c, z_cast,
                                         c_val))
    kept_c = has_c & (not replace)
    if submask:
        take_zp = in_region & msk
        out_ok = torch.where(in_region, torch.where(msk, zp_ok, kept_c),
                             has_c)
    else:
        take_zp = msk
        out_ok = torch.where(msk, zp_ok, kept_c)
    vals = torch.where(take_zp, zp_val, c_val)
    idx = out_ok.nonzero().reshape(-1)
    return store_from_parts(rows[idx], cols[idx], vals[idx], c.nrows,
                            c.ncols, c_dt)


def delete_where(c, region):
    """C less the elements where region holds (one device read)."""
    return _filtered(c, ~region, c.vals, c.dtype)


# --------------------------------------------------------------------- #
# order operations, scans and layout on sorted COO (the Matrix.ss and
# Vector.ss extensions; the JAX package runs them on its dense store)
def order_key(vals, dtype, how, rng_keys=None):
    """The key ``how`` orders each group's entries by (the JAX package's
    ``_row_order``): BOOL as a small integer, descending as ``~v`` for
    integers and ``-v`` for floats, UINT64 by its unsigned order; the
    random keys given for "random"; None for "first" and "last", which
    order by position.  A complex value orders by its real part, then its
    imaginary part (XLA's sort), so its key is that pair of tensors."""
    if how in ("first", "last"):
        return None
    if how == "random":
        return rng_keys
    if how not in ("smallest", "asc", "largest", "desc"):
        raise ValueError(f"Invalid how: {how}")
    if dtype.is_complex:
        v = vals.to(torch.complex128)
        if how in ("largest", "desc"):
            v = -v
        return v.real, v.imag
    if dtype.is_float:
        v = vals.to(torch.float64)
        return -v if how in ("largest", "desc") else v
    v = vals.to(_I64)
    if dtype is _dt.UINT64:
        v = v ^ torch.iinfo(_I64).min
    return ~v if how in ("largest", "desc") else v


def argsort_key(key, dim=-1):
    """A stable argsort by key, or lexicographically by a tuple of keys
    (the first key major)."""
    if not isinstance(key, tuple):
        return torch.sort(key, dim=dim, stable=True)[1]
    order = torch.sort(key[-1], dim=dim, stable=True)[1]
    for k in reversed(key[:-1]):
        order = torch.gather(order, dim, torch.sort(
            torch.gather(k, dim, order), dim=dim, stable=True)[1])
    return order


def group_order(group, key, how="first"):
    """Permutation ordering entries, sorted by (group, minor), by (group,
    key, minor): stable sorts, so ties keep their minor order; "last"
    reverses the minor order.  Returns (order, rank of order's entries
    within their group)."""
    n = group.numel()
    order = torch.arange(n, dtype=_I64, device=group.device)
    if how == "last":
        order = torch.flip(order, (0,))
    elif key is not None:
        order = argsort_key(key)
    order = order[torch.sort(group[order], stable=True)[1]]
    g = group[order]
    start = torch.searchsorted(g, g, right=False)
    return order, torch.arange(n, dtype=_I64, device=group.device) - start


def _rank_of(order, rank):
    out = torch.empty_like(rank)
    out[order] = rank
    return out


def _rows_first(rows, cols, *vals):
    """Entries sorted by (col, row) -> sorted by (row, col) (a stable sort
    by row)."""
    p = torch.sort(rows, stable=True)[1]
    return (rows[p], cols[p]) + tuple(v[p] for v in vals)


def sort_store(sp, how, rowwise=True):
    """(values, permutation) stores of ``A.ss.sort``: each row's (column's)
    entries in key order, packed to columns (rows) 0..count-1; the
    permutation holds each one's source column (row) as INT64."""
    if rowwise:
        group, minor, vals = sp.rows, sp.cols, sp.vals
    else:
        perm = sp.csc_perm()
        group, minor, vals = sp.cols[perm], sp.rows[perm], sp.vals[perm]
    order, rank = group_order(group, order_key(vals, sp.dtype, how), how)
    g, src, v = group[order], minor[order], vals[order]
    if rowwise:
        rows, cols = g, rank
    else:
        rows, cols, v, src = _rows_first(rank, g, v, src)
    struct = Structure(rows, cols, sp.nrows, sp.ncols)
    return (SparseStore(struct, v, sp.dtype),
            SparseStore(struct, src, _dt.INT64))


def selectk_store(sp, how, k, rng_keys=None):
    """The entries of rank < k in their row, at their places."""
    order, rank = group_order(
        sp.rows, order_key(sp.vals, sp.dtype, how, rng_keys), how)
    return _filtered(sp, _rank_of(order, rank) < k, sp.vals, sp.dtype)


def compactify_store(sp, how, width, rng_keys=None):
    """Each row's entries in key order packed left into columns
    0..min(count, width)-1 of an nrows x width store."""
    order, rank = group_order(
        sp.rows, order_key(sp.vals, sp.dtype, how, rng_keys), how)
    keep = (rank < width).nonzero().reshape(-1)
    order, rank = order[keep], rank[keep]
    return store_from_parts(sp.rows[order], rank, sp.vals[order], sp.nrows,
                            width, sp.dtype)


def group_barrier(group):
    """int32 barrier: 1 at the first entry of each group (and at 0)."""
    b = torch.ones(group.numel(), dtype=torch.int32, device=group.device)
    if group.numel() > 1:
        b[1:] = (group[1:] != group[:-1]).to(torch.int32)
    return b


def scan_values(group, vals, op, in_dt):
    """Inclusive scan of vals (sorted by group, cast from in_dt to the op's
    type) restarting at each group, in the op's return type.  A monoid
    the sort pipeline's kernel types take (FP32, INT32, UINT32, BOOL, the
    narrow integers) runs kernel K6 (sortpipe.segscan); every other type
    and associative op runs the log-step plain scan on the device, and an
    op that is not associative folds left to right."""
    from . import sortpipe

    t = op.type
    x = st.cast_values(vals, in_dt, t)
    barrier = group_barrier(group)
    mono = op.monoid
    n = x.numel()
    if n and mono is not None and sortpipe.eligible_reduce(mono, t):
        comb = sortpipe.monoid_combine(mono)
        L = max(-(-n // sortpipe.SEG_BLOCK), 1) * sortpipe.SEG_BLOCK
        bar = torch.ones(L, dtype=torch.int32, device=x.device)
        bar[:n] = barrier
        car = torch.zeros(L, dtype=sortpipe.carrier_dtype(t), device=x.device)
        car[:n] = sortpipe.to_carrier(x, t)
        (out,) = sortpipe.segscan(bar, [car], [comb])
        res = sortpipe.from_carrier(out[:n], t)
    elif n:
        def fn(a, b):
            return st.cast_values(op(a, b), op.return_type, t)

        if mono is not None or op.name in _ASSOCIATIVE:
            res = sortpipe.segscan_plain(barrier, x, fn)
        else:
            res = _scan_left_to_right(group, x, fn)
    else:
        res = x
    return st.cast_values(res, t, op.return_type)


# ops without a monoid whose scan does not depend on the grouping
_ASSOCIATIVE = frozenset(("first", "second", "any", "pair"))


def _scan_left_to_right(group, x, fn):
    """acc = fn(acc, next) along each group, one step per entry of the
    longest group: the scan of an op that is not associative (``minus``)
    folds strictly left to right."""
    rank = group_order(group, None)[1]
    acc = x.clone()
    for k in range(1, int(rank.max()) + 1):
        idx = (rank == k).nonzero().reshape(-1)
        acc[idx] = fn(acc[idx - 1], x[idx])
    return acc


def scan_store(sp, op, rowwise=True):
    """``A.ss.scan``: the inclusive scan of each row's (column's) entries,
    in the input's structure and the op's return type."""
    if rowwise:
        out = scan_values(sp.rows, sp.vals, op, sp.dtype)
    else:
        perm = sp.csc_perm()
        scanned = scan_values(sp.cols[perm], sp.vals[perm], op, sp.dtype)
        out = torch.empty_like(scanned)
        out[perm] = scanned
    return sp.with_values(out, op.return_type)


def split_store(sp, row_sizes, col_sizes):
    """The grid of tiles (a list of rows of stores) of the given row and
    column sizes, each tile's entries shifted to its origin.  One binary
    search finds every tile row's entries; in each, a stable sort by the
    tile column keeps the (row, col) order and makes each tile a slice
    (one read of the counts a tile row)."""
    dev = sp.device
    r_edges = np.concatenate([[0], np.cumsum(row_sizes)]).astype(np.int64)
    c_edges = np.concatenate([[0], np.cumsum(col_sizes)]).astype(np.int64)
    bounds = torch.searchsorted(
        sp.rows, torch.from_numpy(r_edges).to(dev)).tolist()
    inner = torch.from_numpy(c_edges[1:-1]).to(dev)
    grid = []
    for t, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        rows, cols, vals = sp.rows[lo:hi], sp.cols[lo:hi], sp.vals[lo:hi]
        tile = torch.bucketize(cols, inner, out_int32=True, right=True)
        if len(col_sizes) > 1:
            p = torch.sort(tile, stable=True)[1]
            rows, cols, vals = rows[p], cols[p], vals[p]
        counts = torch.bincount(tile, minlength=len(col_sizes)).tolist()
        row, start = [], 0
        for j, cnt in enumerate(counts):
            sl = slice(start, start + cnt)
            row.append(store_from_parts(
                rows[sl] - int(r_edges[t]), cols[sl] - int(c_edges[j]),
                vals[sl], int(row_sizes[t]), int(col_sizes[j]), sp.dtype))
            start += cnt
        grid.append(row)
    return grid


def _exclusive_cumsum(x):
    return torch.cumsum(x, 0) - x


def concat_stores(grid, dtype):
    """One store from a grid (list of rows) of stores of dtype.  Each
    entry is written once, straight to its place in the (row, col) order:
    in a tile row, row r's entries of tile j follow those of the tiles
    before it, which a count per row and tile gives (no sort, no copy of
    the tiles beside the result)."""
    ncols = sum(t.ncols for t in grid[0])
    total = sum(t.nvals() for row in grid for t in row)
    dev = grid[0][0].device
    out_r = torch.empty(total, dtype=_I64, device=dev)
    out_c = torch.empty(total, dtype=_I64, device=dev)
    out_v = st.zeros_values((total,), dtype, dev)
    base = r_off = 0
    for row in grid:
        if sum(t.ncols for t in row) != ncols:
            raise ValueError("tiles in each row must have the same total "
                             "number of columns")
        h = row[0].nrows
        counts = [torch.bincount(t.rows, minlength=h) for t in row]
        row_start = base + _exclusive_cumsum(sum(counts))
        before = torch.zeros(h, dtype=_I64, device=dev)
        c_off = 0
        for t, cnt in zip(row, counts):
            if t.nvals():
                start = row_start - _exclusive_cumsum(cnt) + before
                pos = start[t.rows] + _iota(t.nvals(), dev)
                out_r[pos] = t.rows + r_off
                out_c[pos] = t.cols + c_off
                out_v[pos] = t.vals
            before += cnt
            c_off += t.ncols
        base += sum(t.nvals() for t in row)
        r_off += h
    return store_from_parts(out_r, out_c, out_v, r_off, ncols, dtype)


def reshape_store(sp, nrows, ncols, columnwise=False):
    """The entries at their places in the flat row-major (column-major)
    order of an nrows x ncols store."""
    if columnwise:
        lin = sp.cols * sp.nrows + sp.rows
        r, c = lin % nrows, lin // nrows
        p = torch.sort(r * ncols + c)[1]
        r, c, v = r[p], c[p], sp.vals[p]
    else:
        lin = sp.rows * sp.ncols + sp.cols
        r, c, v = lin // ncols, lin % ncols, sp.vals
    return store_from_parts(r, c, v, nrows, ncols, sp.dtype)
