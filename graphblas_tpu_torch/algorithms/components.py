"""Connected components by FastSV (graphblas_tpu/algorithms/components.py):
hooking over ``min_second`` and pointer jumping by extract, both
accumulated with ``binary.min``."""

import numpy as np

from .. import binary, dtypes, semiring
from ..core.vector import Vector
from ..core import trace as _trace


@_trace.spanned("gb.algo:connected_components")
def connected_components(A):
    """The component label of each vertex: the smallest vertex id it
    reaches, with the edges taken as undirected.  Returns an INT64 dense
    Vector."""
    n = A.nrows
    S = A.dup(dtype=dtypes.BOOL)
    S(accum=binary.lor) << A.T.new(dtype=dtypes.BOOL)
    f = Vector.from_dense(np.arange(n, dtype=np.int64), name="parent")
    ring = semiring.min_second
    while True:
        prev = f.dup()
        # hook: f[i] = min(f[i], min over the neighbours j of f[j])
        f(accum=binary.min) << S.mxv(f, ring).new(name="mngp")
        # shortcut: f[i] = min(f[i], f[f[i]]) (pointer jumping)
        for _ in range(2):
            parents = f.to_coo()[1].astype(np.int64)
            f(accum=binary.min) << f[parents]
        if f.isequal(prev):
            break
    return f
