"""Distributed reduce, element-wise, masked SpGEMM and extract over row
blocks (graphblas_tpu/parallel/ops.py).

Every function works on a BlockedCSR (spmv.py) and computes each block with
the port's single-device engine on the block's store:

- ``dist_reduce_axis``: to the rows, each block reduces its own rows
  (``execute.sparse_reduce_axis``); to the columns, each block a partial
  over every column, folded with the monoid;
- ``dist_reduce_scalar``: each block's fold, then the fold of the blocks;
- ``dist_masked_spgemm``: C(M) << A @ op(B) for a mask that is sparse and
  not complemented, with M in A's row blocks: the masked dot
  (``sparse.spgemm_masked_dot`` with its own ``spgemm_dot_total``) of each
  row block of A and M against B, copied whole to the block's device;
- ``dist_masked_spgemm_sharded``: the same with B in row blocks too, which
  rotate: at step s, block d holds only B's block (d + s) % n_blocks, with
  its rows made global; each step's value at every mask entry folds into
  the block's accumulator with the monoid;
- ``dist_ewise_same_structure``: element by element over the blocks of two
  stores of one structure, no communication;
- ``dist_extract``: each block's extract with its rows made global, the
  blocks' results joined.

A positional multiply or predicate sees global row ids (block row + block
offset).  Results are global SparseStores on the mesh's first block
device.
"""

import torch

from ..core import trace as _trace
from .spmv import _combine_partials, _to


def _cat_blocks(parts, nrows, ncols, dtype, dev, in_order=True):
    """One store of per-block (rows, cols, vals) with global ids; the blocks
    come in row order, so their concatenation is sorted unless a block's
    rows were permuted (in_order False: sorted here)."""
    from ..core.engine import sparse as spx

    if not parts:
        return spx.empty_store(nrows, ncols, dtype, dev)
    rows = torch.cat([p[0].to(dev) for p in parts])
    cols = torch.cat([p[1].to(dev) for p in parts])
    vals = torch.cat([p[2].to(dev) for p in parts])
    if not in_order:
        w = max(ncols, 1)
        key, order = torch.sort(rows * w + cols)
        rows, cols, vals = key // w, key % w, vals[order]
    return spx.store_from_parts(rows, cols, vals, nrows, ncols, dtype)


def dist_reduce_axis(blocked, mono, in_dt, *, dest_rows, n_out):
    """Row (dest_rows) or column monoid reduce of a distributed matrix:
    global dense (vals[n_out], valid[n_out]) on the first block device."""
    from ..core import execute

    dev0 = blocked.devices[0]
    if dest_rows:
        outs = [_to(execute.sparse_reduce_axis(blk, in_dt, 1, mono), dev0)
                for blk in blocked.blocks]
        vals = torch.cat([o[0] for o in outs])
        ok = torch.cat([o[1] for o in outs])
    else:
        vals, ok = _combine_partials(
            [_to(execute.sparse_reduce_axis(blk, in_dt, 0, mono), dev0)
             for blk in blocked.blocks], mono)
    return vals[:n_out], ok[:n_out]


def dist_reduce_scalar(blocked, mono, in_dt):
    """Monoid fold of every stored value: each block's fold, then the
    blocks' in order.  A 0-d (value, valid) on the first block device."""
    from ..core import execute

    dev0 = blocked.devices[0]
    return _combine_partials(
        [_to(execute.sparse_reduce_scalar(blk, mono, in_dt), dev0)
         for blk in blocked.blocks], mono)


def _moved(sp, dev):
    """A SparseStore on dev: the store itself where it is there already
    (its plans kept), else a copy."""
    from ..core.engine import sparse as spx
    from ..core.engine.sortpipe import norm_device

    if norm_device(sp.device) == norm_device(dev):
        return sp
    return spx.SparseStore(
        spx.Structure(sp.rows.to(dev), sp.cols.to(dev), sp.nrows, sp.ncols),
        sp.vals.to(dev), sp.dtype)


def _global_rows(blk, off, nrows):
    """A block's store with its rows made global (a store of nrows rows;
    the columns and values are the block's own tensors)."""
    from ..core.engine import sparse as spx

    return spx.SparseStore(
        spx.Structure(blk.rows + off, blk.cols, nrows, blk.ncols),
        blk.vals, blk.dtype)


def _dot_block(a_blk, b_sp, m_blk, ring, a_dt, b_dt, m_dt, structure, bt,
               n_out_cols, k_dim, row_offset):
    """The masked dot of one row block against (part of) B at every entry
    of the block's mask: (values, valid), or None where no term exists."""
    from ..core.engine import sparse as spx

    if 0 in (a_blk.nvals(), b_sp.nvals(), m_blk.nvals()):
        return None
    rows = a_blk.nrows
    total = _trace.read("parallel.dot_total", int, spx.spgemm_dot_total(
        a_blk, b_sp, m_blk, m_dt, structure, False, bt, rows, n_out_cols,
        k_dim)[1])
    if total == 0:
        return None
    vals, valid, ok_m = spx.masked_dot_slots(
        a_blk, b_sp, m_blk, False, bt, ring, a_dt, b_dt, m_dt, structure,
        rows, n_out_cols, k_dim, total, row_offset=row_offset)
    return vals, valid & ok_m


def _mask_entries(m_blk, slots, off):
    """The (global rows, cols, vals) of a block's mask entries that hold a
    value."""
    vals, ok = slots
    keep = _trace.nonzero("parallel.mask_entries", ok)
    return m_blk.rows[keep] + off, m_blk.cols[keep], vals[keep]


def dist_masked_spgemm(a_blocked, b_sp, m_blocked, ring, a_dt, b_dt, m_dt,
                       structure, *, bt, n_out_rows, n_out_cols):
    """C(M) << A @ op(B): the masked dot of each row block of A and M
    against B, copied whole to the block's device.  Returns a global store
    in the monoid's type."""
    rows_per = a_blocked.rows_per
    k_dim = b_sp.ncols if bt else b_sp.nrows
    parts = []
    for d, (a_blk, m_blk) in enumerate(zip(a_blocked.blocks,
                                           m_blocked.blocks)):
        slots = _dot_block(a_blk, _moved(b_sp, a_blk.device), m_blk, ring,
                           a_dt, b_dt, m_dt, structure, bt, n_out_cols,
                           k_dim, d * rows_per)
        if slots is not None:
            parts.append(_mask_entries(m_blk, slots, d * rows_per))
    return _cat_blocks(parts, n_out_rows, n_out_cols, ring.monoid.type,
                       a_blocked.devices[0])


def dist_masked_spgemm_sharded(a_blocked, b_blocked, m_blocked, ring, a_dt,
                               b_dt, m_dt, structure, *, bt, n_out_rows,
                               n_out_cols):
    """C(M) << A @ op(B) with B in row blocks too: no block holds all of B.
    At step s block d holds B's block (d + s) % n_blocks, moved to its
    device with its rows made global; the block contributes the terms of
    its contraction range (bt False) or of its output columns (bt True),
    and each step's value at every mask entry folds into block d's
    accumulator with the monoid."""
    mono = ring.monoid
    nb = a_blocked.n_blocks
    rows_per = a_blocked.rows_per
    k_dim = b_blocked.n
    parts = []
    for d, (a_blk, m_blk) in enumerate(zip(a_blocked.blocks,
                                           m_blocked.blocks)):
        dev = a_blk.device
        acc = None
        for s in range(nb):
            kb = (d + s) % nb
            b_blk = _moved(b_blocked.blocks[kb], dev)
            b_glob = _global_rows(b_blk, kb * b_blocked.rows_per, k_dim)
            slots = _dot_block(a_blk, b_glob, m_blk, ring, a_dt, b_dt, m_dt,
                               structure, bt, n_out_cols, k_dim,
                               d * rows_per)
            if slots is not None:
                acc = slots if acc is None else \
                    _combine_partials([acc, slots], mono)
        if acc is not None:
            parts.append(_mask_entries(m_blk, acc, d * rows_per))
    return _cat_blocks(parts, n_out_rows, n_out_cols, mono.type,
                       a_blocked.devices[0])


def dist_ewise_same_structure(a_blocked, b_blocked, op, a_dt, b_dt, z_dt):
    """Element by element over two distributions of one structure: block
    b's values are op(A's, B's); a BlockedCSR of z_dt over the same
    coordinates."""
    from ..core.engine import sparse as spx

    blocks = []
    for b, (a_blk, b_blk) in enumerate(zip(a_blocked.blocks,
                                           b_blocked.blocks)):
        z = spx.ewise_same_structure(
            _global_rows(a_blk, b * a_blocked.rows_per, a_blocked.n),
            _moved(b_blk, a_blk.device), op, a_dt, b_dt, z_dt)
        blocks.append(a_blk.with_values(z.vals, z_dt))
    return a_blocked.with_blocks(blocks, z_dt)


def dist_extract(blocked, rows, cols, in_order, nrows, ncols):
    """A[rows, cols] over the row blocks (duplicate-free index lists, int64
    tensors): each block's extract with its rows made global (an A of
    nrows x ncols), the blocks' results joined.  in_order: both lists
    increase, and so the joined result is sorted."""
    from ..core.engine import sparse as spx

    rows_per = blocked.rows_per
    parts = []
    for b, blk in enumerate(blocked.blocks):
        dev = blk.device
        out = spx.extract_submatrix(
            _global_rows(blk, b * rows_per, nrows), rows.to(dev),
            cols.to(dev), in_order)
        if out.nvals():
            parts.append((out.rows, out.cols, out.vals))
    return _cat_blocks(parts, rows.numel(), cols.numel(), blocked.dtype,
                       blocked.devices[0], in_order)
