"""Breadth-first search (graphblas_tpu/algorithms/bfs.py).

Per level: a masked scalar assign, a masked ``lor_land`` vxm and a ``lor``
reduce that is read on the host.
"""

from .. import Vector, dtypes, monoid, semiring


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


def bfs_parent(A, source=0):
    """Parent of each reachable node in a BFS tree.  Needs the positional
    semiring ``min_secondi``, which the port does not have yet."""
    raise NotImplementedError(
        "bfs_parent needs the positional semiring min_secondi: ROADMAP.md "
        "queue 1, item 9")
