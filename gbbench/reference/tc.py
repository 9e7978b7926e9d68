"""Triangles of an undirected graph, each counted once: every edge is
oriented from the lower to the higher (degree, id) rank, and a triangle
u < v < w is found as the wedge v, w of u's out-list closed by the edge
(v, w).  Ordering by degree bounds each out-list by about sqrt(2 m)."""

import torch

from . import csr, expand

BLOCK = 1 << 25  # wedges tested at once


def oriented(rows, cols, n):
    """Edges (u, v) with rank(u) < rank(v), renumbered by rank and sorted
    by key u * n + v: (keys, indptr, v)."""
    deg = torch.bincount(rows, minlength=n)
    rank = torch.empty(n, dtype=torch.int64, device=rows.device)
    rank[torch.argsort(deg, stable=True)] = torch.arange(n, device=rows.device)
    u, v = rank[rows], rank[cols]
    low = u < v
    keys = torch.sort(u[low] * n + v[low]).values
    u, v = keys // n, keys % n
    indptr, v = csr(u, v, n)
    return keys, indptr, v


def per_edge(rows, cols, n):
    """Triangles closed over each oriented edge (u, v), int64, in the
    order of :func:`oriented`'s keys: the count of w after v in u's
    out-list with (v, w) an edge."""
    keys, indptr, v = oriented(rows, cols, n)
    m = keys.numel()
    u = keys // n
    after = indptr[u + 1] - torch.arange(m, device=keys.device) - 1
    cum = torch.cumsum(after, 0)
    out = torch.zeros(m, dtype=torch.int64, device=keys.device)
    e0 = 0
    while e0 < m:
        # the edges from e0 whose wedges fit in one block (at least one)
        base = int(cum[e0 - 1]) if e0 else 0
        e1 = max(e0 + 1, int(torch.searchsorted(cum, base + BLOCK,
                                                right=True)))
        e1 = min(e1, m)
        edge = torch.arange(e0, e1, device=keys.device)
        pos, owner = expand(edge + 1, after[e0:e1])
        q = v[edge[owner]] * n + v[pos]
        at = torch.searchsorted(keys, q).clamp_(max=m - 1)
        out[e0:e1] = torch.zeros(e1 - e0, dtype=torch.int64,
                                 device=keys.device).index_add_(
            0, owner, (keys[at] == q).to(torch.int64))
        e0 = e1
    return out


def count(rows, cols, n):
    """The number of triangles, as a Python int (int64 sums)."""
    return int(per_edge(rows, cols, n).sum())
