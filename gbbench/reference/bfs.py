"""Breadth-first levels by frontier expansion over a CSR."""

import torch

from . import csr, expand


def levels(rows, cols, n, source):
    """int64 level of every vertex from ``source`` (the source 1, each hop
    one more, 0 where not reached), over the entries (rows, cols) sorted
    by row."""
    indptr, nbr = csr(rows, cols, n)
    lev = torch.zeros(n, dtype=torch.int64, device=rows.device)
    frontier = torch.tensor([int(source)], device=rows.device)
    d = 1
    while frontier.numel():
        lev[frontier] = d
        d += 1
        starts = indptr[frontier]
        pos, _ = expand(starts, indptr[frontier + 1] - starts)
        nxt = torch.unique(nbr[pos])
        frontier = nxt[lev[nxt] == 0]
    return lev
