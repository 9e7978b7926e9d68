"""Breadth-first search (graphblas_tpu/algorithms/bfs.py).

Level BFS, per level: a masked scalar assign, a masked ``lor_land`` vxm
and a ``lor`` reduce that is read on the host.  Parent BFS, per level: a
masked ``min_secondi`` vxm (the positional multiply gives each edge's
source), its ``nvals`` read on the host, and a masked copy into the
parents.
"""

from .. import Vector, dtypes, monoid, semiring
from ..core import trace as _trace


@_trace.spanned("gb.algo:bfs_level")
def bfs_level(A, source=0):
    """Level of each reachable node (source has level 1).

    Returns an INT64 Vector; unreachable nodes have no entry.
    """
    n = A.nrows
    v = Vector(dtypes.INT64, n, name="level")
    q = Vector(dtypes.BOOL, n, name="frontier")
    q[source] = True
    ring = semiring.lor_land[bool]
    d = 0
    while True:
        d += 1
        v(mask=q.V)[:] = d
        q(~v.S, replace=True) << q.vxm(A, ring)
        if not q.reduce(monoid.lor, allow_empty=False).new().value:
            break
    return v


@_trace.spanned("gb.algo:bfs_parent")
def bfs_parent(A, source=0):
    """Parent of each reachable node in a BFS tree (the source is its own
    parent): the smallest node of the previous level with an edge to it.

    Returns an INT64 Vector; unreachable nodes have no entry.
    """
    n = A.nrows
    parent = Vector(dtypes.INT64, n, name="parent")
    parent[source] = source
    q = Vector(dtypes.INT64, n, name="frontier")
    q[source] = source
    ring = semiring.ss.min_secondi
    while True:
        # secondi(q[k], A[k, j]) is k: the smallest frontier node k -> j
        q(~parent.S, replace=True) << q.vxm(A, ring)
        if q.nvals == 0:
            break
        parent(q.S) << q
    return parent
