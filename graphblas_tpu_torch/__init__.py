"""graphblas_tpu_torch: the PyTorch and CUDA port of graphblas_tpu.

The same user code runs after ``import graphblas_tpu_torch as gb`` for the
part ported so far: sparse matrices built with ``Matrix.from_coo``, dense
vectors, masks, ``vxm``/``mxv`` over the lanepipe SpMV engine and, for
matrices it turns down, the sort pipeline, row and column reduces;
dense-backed matrices (``from_dense``, and every matrix of at most
``auto_sparse_limit`` elements) with ``mxm``, ``mxv``/``vxm``/``inner``,
``power``, element-wise operations, reduces and ``diag`` over the dense
engine, whose tropical products run a kernel of their own (seven
hand-written CUDA kernels for the H100 in all); ``apply``, ``reduce``,
scalar assignment, ``ss.iterate`` and the algorithms ``sssp`` and
``bfs_level``.  Everything runs on ``cuda`` unless the
caller asks for the CPU with ``config.set(device="cpu")``.  What is not
ported yet raises ``NotImplementedError`` naming its ROADMAP.md item.

The package imports torch and numpy only, never jax or graphblas_tpu.
"""

from . import binary, dtypes, exceptions, monoid, semiring, ss, unary
from .core.config import config
from .core.matrix import Matrix
from .core.scalar import Scalar
from .core.vector import Vector

from . import algorithms  # noqa: E402  (imports Vector from this package)

__all__ = ["Matrix", "Vector", "Scalar", "config", "algorithms", "binary",
           "dtypes", "exceptions", "monoid", "semiring", "ss", "unary"]
