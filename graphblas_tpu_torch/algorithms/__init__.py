"""Graph algorithms built on the GraphBLAS surface
(graphblas_tpu/algorithms/): the ones whose operations the port has.

``sssp``, ``bfs_level``, ``bfs_parent`` (the positional ring
``min_secondi``), ``pagerank`` (FP64, ``diag().mxm``),
``connected_components`` (FastSV: ``min_second`` hooking and pointer
jumping by extract) and ``triangle_count`` (the masked dot ``C<L> = L
plus_pair L.T``) run as in the JAX package, sparse-backed or
dense-backed.
"""

from .bfs import bfs_level, bfs_parent
from .components import connected_components
from .pagerank import pagerank
from .sssp import sssp
from .triangles import triangle_count

__all__ = ["bfs_level", "bfs_parent", "connected_components", "pagerank",
           "sssp", "triangle_count"]
