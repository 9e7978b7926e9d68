"""Graph algorithms built on the GraphBLAS surface
(graphblas_tpu/algorithms/): the ones whose operations the port has.

``sssp``, ``bfs_level``, ``pagerank`` (FP64, ``diag().mxm``) and
``triangle_count`` (the masked dot ``C<L> = L plus_pair L.T``) run as in
the JAX package, sparse-backed or dense-backed.  ``bfs_parent`` raises
until the positional semirings are ported (ROADMAP.md queue 1, item 9);
``connected_components`` needs extract by index lists (``f[parents]``,
item 10) and is not here yet.
"""

from .bfs import bfs_level, bfs_parent
from .pagerank import pagerank
from .sssp import sssp
from .triangles import triangle_count

__all__ = ["bfs_level", "bfs_parent", "pagerank", "sssp", "triangle_count"]
