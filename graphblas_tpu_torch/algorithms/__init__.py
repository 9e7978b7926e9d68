"""Graph algorithms built on the GraphBLAS surface
(graphblas_tpu/algorithms/): the ones whose operations the port has.

``sssp`` and ``bfs_level`` run as in the JAX package.  ``bfs_parent``
raises until positional semirings are ported; ``pagerank`` (FP64,
``diag().mxm``), ``connected_components`` and ``triangle_count`` are not
here yet (ROADMAP.md queue 1, items 9 and 10).
"""

from .bfs import bfs_level, bfs_parent
from .sssp import sssp

__all__ = ["bfs_level", "bfs_parent", "sssp"]
