"""PageRank (graphblas_tpu/algorithms/pagerank.py): the FP64 power
iteration over the row-normalized adjacency ``W = diag(1/outdeg) A``."""

from .. import Vector, binary, dtypes, monoid, semiring, unary
from ..core import trace as _trace


@_trace.spanned("gb.algo:pagerank")
def pagerank(A, damping=0.85, tol=1e-8, max_iters=100, *, dangling=True):
    """PageRank of the directed graph with adjacency A (A[i,j] = edge i->j).

    r_{t+1} = damping * (r_t @ W + dangling_mass/n) + (1-damping)/n
    where W is the row-normalized adjacency.  Returns (rank Vector FP64,
    iterations used).  Each iteration reads two scalars on the host: the
    dangling mass and the change, which decides the stop.
    """
    n = A.nrows
    outdeg = A.reduce_rowwise(monoid.plus).new(dtype=dtypes.FP64,
                                               name="outdeg")
    inv = outdeg.apply(unary.minv).new()
    W = inv.diag().mxm(A.dup(dtype=dtypes.FP64),
                       semiring.plus_times).new(name="W")
    r = Vector.from_scalar(1.0 / n, n, dtypes.FP64, name="rank")
    teleport = (1.0 - damping) / n
    it = 0
    for it in range(1, max_iters + 1):
        prev = r.dup()
        new = r.vxm(W, semiring.plus_times).new()
        if dangling:
            dm = r.dup(mask=~outdeg.S)
            dangling_sum = float(
                dm.reduce(monoid.plus, allow_empty=False).new().value)
        else:
            dangling_sum = 0.0
        base = teleport + damping * dangling_sum / n
        # r = dense(base) + damping * propagated; nodes with no in-edges
        # (absent in `new`) still receive the base mass
        scaled = new.apply(binary.times, right=damping).new()
        r << Vector.from_scalar(base, n, dtypes.FP64)
        r(accum=binary.plus) << scaled
        delta = r.ewise_union(prev, binary.minus, 0.0, 0.0).new()
        err = float(delta.apply(unary.abs).reduce(
            monoid.plus, allow_empty=False).new().value)
        if err < tol:
            break
    return r, it
