"""Single-source shortest paths (graphblas_tpu/algorithms/sssp.py):
Bellman-Ford iteration ``d(min) << d.vxm(A, min_plus)``."""

from .. import Vector, binary, semiring
from ..core import trace as _trace


@_trace.spanned("gb.algo:sssp")
def sssp(A, source=0, *, max_iters=None):
    """Shortest-path distances from source over the min_plus semiring.

    Works for any edge-weight dtype the SpMV engines take; returns the
    distances as a Vector (no entry = unreachable).  The distance vector
    starts with one entry, so the first iterations run the sparse-vector
    branch of the SpMV.
    """
    n = A.nrows
    d = Vector(A.dtype, n, name="dist")
    d[source] = 0
    ring = semiring.min_plus
    iters = n if max_iters is None else max_iters
    for _ in range(iters):
        with _trace.span("sssp:round"):
            prev = d.dup()
            d(accum=binary.min) << d.vxm(A, ring)
            if d.isequal(prev):
                break
    return d
