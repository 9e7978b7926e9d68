"""Triangle counting (graphblas_tpu/algorithms/triangles.py): the sum of
C<L> = L plus_pair L.T, where L is the strictly lower triangle of the
symmetrized pattern.  On a sparse-backed graph the product is the masked
dot, bounded by the mask (execute._spgemm_run)."""

from .. import Matrix, binary, dtypes, monoid, select, semiring, unary
from ..core import trace as _trace


@_trace.spanned("gb.algo:triangle_count")
def triangle_count(A):
    """Number of triangles in the undirected graph of A (pattern only)."""
    S = A.apply(unary.one).new(dtype=dtypes.INT64)
    S(accum=binary.max) << A.T.new(dtype=dtypes.INT64).apply(unary.one)
    L = S.select(select.tril, -1).new(name="L")
    C = Matrix(dtypes.INT64, L.nrows, L.ncols)
    C(L.S) << L.mxm(L.T, semiring.plus_pair)
    s = C.reduce_scalar(monoid.plus, allow_empty=False).new()
    return int(s.value)
