"""Single-source shortest paths by label-correcting relaxation over a
CSR: each round relaxes the out-edges of the vertices whose distance fell
in the round before, and takes each destination's least candidate."""

import torch

from . import csr, expand


def distances(rows, cols, weights, n, source):
    """int64 shortest-path distance of every vertex from ``source`` over
    the entries (rows, cols) sorted by row with their ``weights`` (at
    least 0), the source 0 and -1 where a vertex is not reached."""
    indptr, nbr = csr(rows, cols, n)
    w = weights.to(torch.int64)
    unreached = torch.iinfo(torch.int64).max
    dist = torch.full((n,), unreached, dtype=torch.int64, device=rows.device)
    dist[source] = 0
    frontier = torch.tensor([int(source)], device=rows.device)
    while frontier.numel():
        starts = indptr[frontier]
        pos, owner = expand(starts, indptr[frontier + 1] - starts)
        # every frontier vertex has a finite distance: no sum overflows
        cand = dist[frontier][owner] + w[pos]
        new = dist.scatter_reduce(0, nbr[pos], cand, "amin")
        frontier = torch.nonzero(new < dist).reshape(-1)
        dist = new
    return torch.where(dist == unreached, -1, dist)
