"""Distributed semiring SpMV over a row-block distribution
(graphblas_tpu/parallel/spmv.py).

A square matrix is cut into row blocks, one per entry of the mesh's
sharded axis: block ``b`` holds the global rows ``[b*rows_per,
(b+1)*rows_per)`` as a compact, sorted SparseStore of shape
``(rows_per, n)`` with block-local row ids and global column ids, on the
mesh device at index ``b`` of that axis (index 0 of every other axis; the
other axes hold no replica).  ``n`` is padded to a multiple of the block
count; the padded rows hold no entry.

Each block computes with the port's single-device engine on its own
store: the lanepipe, the sort pipeline or the generic sparse engine, as
``execute.sparse_matvec`` chooses, with the block's plans built once and
kept in its store.  The direction decides the communication:

- contraction over stored COLUMNS (mxv, or vxm of A.T): the input vector
  is copied whole to every block's device (the all-gather) and each block
  computes its own rows of the output;
- contraction over stored ROWS (vxm, or mxv of A.T): each block takes its
  slice of the input and computes a partial over the whole output, and
  the partials are folded with the monoid, in block order, under their
  validity (the JAX package's psum/pmin/pmax and its fold for any other
  monoid).

The JAX package needs the padded, ``edge_ok``-gated block arrays for the
static shapes of ``shard_map`` under ``jit``; eager PyTorch does not.  A
mesh may name one device several times (a mesh of four ``cuda:0``
entries is four blocks on one card), and then every copy between blocks
is a no-op.
"""

import numpy as np
import torch

from ..core import trace as _trace

__all__ = ["make_blocked_csr", "dist_mxv", "dist_mxv_ring", "dist_bfs_step",
           "dist_pagerank_step", "BlockedCSR"]


class BlockedCSR:
    """Row blocks of a square sparse matrix: ``blocks[b]`` is the
    SparseStore of block b (local rows, global columns) on
    ``devices[b]``.  ``n`` is the padded size, ``nnz`` the number of
    stored entries and ``dtype`` the graphblas DataType of the values."""

    __slots__ = ("blocks", "devices", "n", "rows_per", "n_blocks", "nnz",
                 "mesh", "axis", "dtype")

    def __init__(self, blocks, devices, n, rows_per, mesh, axis, dtype):
        self.blocks = list(blocks)
        self.devices = list(devices)
        self.n = n
        self.rows_per = rows_per
        self.n_blocks = len(self.blocks)
        self.nnz = sum(blk.nvals() for blk in self.blocks)
        self.mesh = mesh
        self.axis = axis
        self.dtype = dtype

    def with_blocks(self, blocks, dtype):
        """The same distribution over other blocks (of the same shape)."""
        return BlockedCSR(blocks, self.devices, self.n, self.rows_per,
                          self.mesh, self.axis, dtype)

    def __repr__(self):
        return (f"BlockedCSR(n={self.n}, n_blocks={self.n_blocks}, "
                f"rows_per={self.rows_per}, nnz={self.nnz}, "
                f"dtype={self.dtype.name})")


def block_devices(mesh, axis):
    """The device of each block: index b along `axis`, 0 along the rest."""
    ax = mesh.axis_names.index(axis)
    out = []
    for b in range(mesh.shape[axis]):
        idx = [0] * mesh.devices.ndim
        idx[ax] = b
        out.append(mesh.devices[tuple(idx)])
    return out


def _split_rows(sp, n, rows_per, devices):
    """The row blocks of a SparseStore (sorted by row: each block is a
    slice, a view where it stays on the store's device), with local row
    ids; the host copy, where the store has one, is sliced too, so that
    no plan reads the device."""
    from ..core.engine import sparse as spx

    n_blocks = len(devices)
    edges = np.arange(n_blocks + 1, dtype=np.int64) * rows_per
    host = sp.struct._host
    if host is not None:
        bounds = np.searchsorted(host[0], edges).tolist()
    else:
        bounds = _trace.read("parallel.split_rows", lambda: torch.searchsorted(
            sp.rows, torch.from_numpy(edges).to(sp.device)).tolist())
    host_vals = sp._host_vals
    blocks = []
    for b, dev in enumerate(devices):
        s, e = bounds[b], bounds[b + 1]
        off = b * rows_per
        struct = spx.Structure(
            (sp.rows[s:e] - off).to(dev), sp.cols[s:e].to(dev),
            rows_per, n,
            host=None if host is None else (host[0][s:e] - off,
                                            host[1][s:e]))
        blocks.append(spx.SparseStore(
            struct, sp.vals[s:e].to(dev), sp.dtype,
            host_vals=None if host_vals is None else host_vals[s:e]))
    return blocks


def make_blocked_csr(A, mesh, *, axis=None, dtype=np.float32):
    """Cut a gb.Matrix (sparse- or dense-backed) or a (rows, cols, vals, n)
    tuple (values of `dtype`; no duplicate coordinates) into row blocks
    over the mesh's `axis` (its first by default).  Square matrices only
    (graph adjacency).  A one-block mesh on the matrix's device keeps the
    matrix's own store, and with it its plans."""
    from ..core.dtypes import lookup_dtype
    from ..core.engine import sparse as spx
    from ..core.engine.sortpipe import norm_device

    if axis is None:
        axis = mesh.axis_names[0]
    n_blocks = mesh.shape[axis]
    devices = block_devices(mesh, axis)
    if isinstance(A, tuple):
        r, c, v, n = A
        gb_dt = lookup_dtype(np.dtype(dtype))
        sp = spx.build_sparse_store(r, c, np.asarray(v, dtype), n, n, gb_dt,
                                    devices[0])
    else:
        if A.nrows != A.ncols:
            raise ValueError("blocked distribution requires a square matrix")
        n, gb_dt, sp = A.nrows, A.dtype, A._sparse
        if sp is None:
            r, c, v = A.to_coo()
            sp = spx.build_sparse_store(r, c, v, n, n, gb_dt, devices[0])
    n_pad = n + (-n) % n_blocks
    rows_per = n_pad // n_blocks
    if n_blocks == 1 and n_pad == n and \
            norm_device(sp.device) == norm_device(devices[0]):
        blocks = [sp]
    else:
        blocks = _split_rows(sp, n_pad, rows_per, devices)
    return BlockedCSR(blocks, devices, n_pad, rows_per, mesh, axis, gb_dt)


def _resolve_ring(ring, a_dt, u_dt):
    """A typed or untyped semiring, or its name, as the typed semiring of
    the two operand types."""
    from ..core.dtypes import unify
    from ..core.operator.base import typed

    if isinstance(ring, str):
        from .. import semiring as semiring_ns

        ring = getattr(semiring_ns, ring)
    return typed(ring, unify(a_dt, u_dt), "Semiring")


def _to(pair, dev):
    return tuple(x.to(dev) for x in pair)


def _combine_partials(parts, mono):
    """Fold per-block (values, valid) partials with the monoid, in block
    order: where both hold a value, the monoid of the two; where one does,
    its value.  Returns (values, valid) on the first part's device."""
    from ..core.engine import dense

    acc, acc_ok = parts[0]
    dev = acc_ok.device
    for vals, ok in parts[1:]:
        vals, ok = vals.to(dev), ok.to(dev)
        merged = dense.apply_binop(mono.binaryop, acc, mono.type, vals,
                                   mono.type)
        acc = torch.where(acc_ok & ok, merged, torch.where(ok, vals, acc))
        acc_ok = acc_ok | ok
    return acc, acc_ok


def _padded(x, n):
    if x.shape[0] >= n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])


def dist_mxv_ring(blocked, u_vals, u_valid, ring, u_dt=None, *, kind="mxv",
                  at=False):
    """w = op(A) (ring) u, block by block.

    u_vals/u_valid: global (n,) tensors (shorter ones are padded) on any
    device.  Returns (w_vals, w_valid), global (n,) tensors on the mesh's
    first block device.  `ring` may be a semiring object or name; `at`
    applies A.T."""
    return dist_mxv_arrays(blocked.blocks, blocked, u_vals, u_valid, ring,
                           u_dt, kind=kind, at=at)


def dist_mxv_arrays(blocks, blocked, u_vals, u_valid, ring, u_dt=None, *,
                    kind="mxv", at=False):
    """Like :func:`dist_mxv_ring` over other block stores of `blocked`'s
    shape (the JAX package passes its block arrays here for ``jit``)."""
    from ..core import execute
    from ..core.dtypes import lookup_dtype

    n, rows_per = blocked.n, blocked.rows_per
    a_dt = blocked.dtype
    if u_dt is None:
        u_dt = lookup_dtype(u_vals.dtype)
    ring = _resolve_ring(ring, a_dt if kind == "mxv" else u_dt,
                         u_dt if kind == "mxv" else a_dt)
    at = bool(at)
    u_vals, u_valid = _padded(u_vals, n), _padded(u_valid, n)
    dev0 = blocked.devices[0]
    if (kind == "mxv") == at:
        # contraction over stored rows: each block its slice of u, a
        # partial over every output, folded with the monoid
        parts = []
        for b, blk in enumerate(blocks):
            sl = slice(b * rows_per, (b + 1) * rows_per)
            dev = blk.device
            parts.append(_to(execute.sparse_matvec(
                blk, a_dt, kind, at, u_vals[sl].to(dev), u_valid[sl].to(dev),
                u_dt, ring), dev0))
        return _combine_partials(parts, ring.monoid)
    # contraction over stored columns: u whole on each block's device, each
    # block its own rows of w
    outs = [_to(execute.sparse_matvec(
        blk, a_dt, kind, at, u_vals.to(blk.device), u_valid.to(blk.device),
        u_dt, ring), dev0) for blk in blocks]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def dist_mxv(blocked, x, ring="plus_times"):
    """y = A (ring) x with a dense (all-present) x.  Returns (y, present)."""
    valid = torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)
    return dist_mxv_ring(blocked, x, valid, ring, kind="mxv")


def dist_bfs_step(blocked, frontier, visited, levels, depth):
    """One level-BFS step through the lor_land semiring.

    frontier/visited: bool (n,); levels: int32 (n,).  Returns
    (new_frontier, new_visited, new_levels, frontier_nonempty)."""
    from .. import semiring as semiring_ns
    from ..core.dtypes import BOOL

    depth = _trace.read("parallel.bfs_depth", torch.as_tensor, depth,
                        dtype=levels.dtype, device=levels.device)
    levels = torch.where(frontier, depth, levels)
    visited = visited | frontier
    ring = semiring_ns.lor_land[BOOL]
    y, present = dist_mxv_ring(blocked, frontier, frontier, ring, BOOL,
                               kind="vxm")
    new_frontier = present & y & ~visited.to(y.device)
    return new_frontier, visited, levels, new_frontier.any()


def dist_pagerank_step(blocked, r, inv_outdeg, damping, base):
    """One PageRank iteration through plus_times: r' = damping * (r/deg) A
    + base (pull formulation over the row blocks)."""
    contrib = r * inv_outdeg
    y, present = dist_mxv_ring(blocked, contrib, torch.ones_like(
        contrib, dtype=torch.bool), "plus_times", kind="vxm")
    return damping * torch.where(present, y, torch.zeros_like(y)) + base
