"""Single-source shortest paths as GAP's sssp runs it: each trial is one
``algorithms.sssp`` call (Bellman-Ford over ``min_plus``) on the weighted
graph, from a source drawn from the seed among the vertices with at least
``min_degree`` neighbours, a new one each trial, cycling through
``sources`` of them (the same draw as the ``bfs`` driver's).  A trial
returns the distance vector read back to the host (-1 where a vertex was
not reached).  The check holds it to the configuration's ``sssp``
guarantee: every distance exact, every unreached vertex without an
entry."""

import numpy as np

from ..reference import sssp as ref_sssp
from .bfs import prepare, source  # noqa: F401  (the driver's interface)

LIMIT = 0  # integer distances: an exact comparison


def trial(program, A, state, i):
    dist = program.algorithms.sssp(A, source(state, i))
    return dist.to_dense(fill_value=-1)


def _distances(rows, cols, values, n, src):
    return ref_sssp.distances(rows, cols, values, n, src).cpu().numpy()


def check(graph, state, kept, device):
    rows, cols = graph.rows.to(device), graph.cols.to(device)
    values = graph.values.to(device)
    refs, mismatches, failed = {}, 0, 0
    for i, got in kept:
        src = source(state, i)
        if src not in refs:
            refs[src] = _distances(rows, cols, values, graph.n, src)
        bad = int(np.count_nonzero(
            np.asarray(got).astype(np.int64) != refs[src]))
        mismatches += bad
        failed += bad > 0
    return {"dist_mismatches": {"value": mismatches, "limit": LIMIT}}, failed


def control(graph, state, i, device):
    """Distances over each edge in one direction only (the entries with
    row < column), as a program that stored half of a symmetric matrix
    and forgot the other half would give: the guarantee broken is
    ``undirected``."""
    up = graph.rows < graph.cols
    return _distances(graph.rows[up].to(device), graph.cols[up].to(device),
                      graph.values[up].to(device), graph.n, source(state, i))
