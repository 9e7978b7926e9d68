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
extract, assign and delete by index lists (``A[rows, cols]``,
``C(mask, accum)[idx] << v``, ``C[idx](mask) << v``, ``del C[idx]``),
membership and iteration, the positional operators (``binary.ss``,
``unary.ss``, ``semiring.ss``) in every context, the aggregators
(``agg``), ``kronecker``, ``reposition``, ``ss.iterate`` and the
algorithms ``sssp``, ``bfs_level``, ``bfs_parent``, ``pagerank``,
``connected_components`` and ``triangle_count`` run on both backings.  Operators may be given as the
JAX package's strings (``"+"``, ``"min_plus[FP64]"``).  Everything runs
on ``cuda`` unless the caller asks for the CPU with
``config.set(device="cpu")``.  What is not ported yet raises
``NotImplementedError`` naming its ROADMAP.md item.

The package imports torch and numpy only, never jax or graphblas_tpu.
"""


class _ReplaceSingleton:
    """``replace``: given to ``C(mask, replace)`` it sets replace=True."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "replace"


replace = _ReplaceSingleton()

from . import (agg, binary, dtypes, exceptions, indexunary,  # noqa: E402
               monoid, select, semiring, ss, unary)
from .core.config import config  # noqa: E402
from .core.matrix import Matrix  # noqa: E402
from .core.scalar import Scalar  # noqa: E402
from .core.vector import Vector  # noqa: E402
from .exceptions import GraphblasException  # noqa: E402

from . import algorithms  # noqa: E402  (imports Vector from this package)

__all__ = ["Matrix", "Vector", "Scalar", "config", "agg", "algorithms",
           "binary", "dtypes", "exceptions", "GraphblasException",
           "indexunary", "monoid", "replace", "select", "semiring", "ss",
           "unary"]

# the JAX package's names that the port lacks, and their ROADMAP.md items
_NOT_PORTED = {"io": 12, "op": 12, "viz": 12, "Recorder": 12,
               "backend": 12, "init": 12, "parallel": 13}


def __getattr__(name):
    if name in _NOT_PORTED:
        from .core.operator.base import not_ported

        raise not_ported(f"graphblas_tpu_torch.{name}", _NOT_PORTED[name])
    raise AttributeError(
        f"module 'graphblas_tpu_torch' has no attribute {name!r}")
