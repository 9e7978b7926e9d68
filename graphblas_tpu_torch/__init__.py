"""graphblas_tpu_torch: the PyTorch and CUDA port of graphblas_tpu.

The same user code runs after ``import graphblas_tpu_torch as gb`` for the
part ported so far.  Sparse matrices (``Matrix.from_coo``, and every
matrix over ``auto_sparse_limit`` elements) stay sparse on their device:
``vxm``/``mxv`` over the lanepipe SpMV engine, the sort pipeline for the
matrices it turns down and for row and column reduces, and the generic
sparse engine for every other ring, monoid and type (FP64, INT64, ...),
for ``apply``, ``select``, ``A.T``, casts, element-wise operations,
``reduce_scalar``, ``mxm`` (SpGEMM by Gustavson's expansion or the masked
dot, and scaling by a diagonal) and the masked write-back.  Dense-backed
matrices (``from_dense``, and every matrix of at most
``auto_sparse_limit`` elements) take the dense engine: ``mxm``,
``mxv``/``vxm``/``inner``, ``power``, element-wise operations, reduces and
``diag``, whose tropical products run a kernel of their own (seven
hand-written CUDA kernels for the H100 in all).  Dense vectors, masks,
scalar assignment, ``ss.iterate`` and the algorithms ``sssp``,
``bfs_level``, ``pagerank`` and ``triangle_count`` run on both backings.
Everything runs on ``cuda`` unless the caller asks for the CPU with
``config.set(device="cpu")``.  What is not ported yet raises
``NotImplementedError`` naming its ROADMAP.md item.

The package imports torch and numpy only, never jax or graphblas_tpu.
"""

from . import (binary, dtypes, exceptions, indexunary, monoid, select,
               semiring, ss, unary)
from .core.config import config
from .core.matrix import Matrix
from .core.scalar import Scalar
from .core.vector import Vector

from . import algorithms  # noqa: E402  (imports Vector from this package)

__all__ = ["Matrix", "Vector", "Scalar", "config", "algorithms", "binary",
           "dtypes", "exceptions", "indexunary", "monoid", "select",
           "semiring", "ss", "unary"]
