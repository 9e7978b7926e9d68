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
membership and iteration, the infix expressions (``A @ B``, ``x | y``,
``x & y``, Python arithmetic and comparisons, ``select.value(A > 0)``),
the mask algebra (``v.S & u.V``), the constructors and exports (CSR, CSC,
DCSR, DCSC, edge lists, dicts, ``build``, ``resize``, ``outer``), the
positional operators (``binary.ss``,
``unary.ss``, ``semiring.ss``) in every context, the aggregators
(``agg``), ``kronecker``, ``reposition``, ``ss.iterate`` and the
algorithms ``sssp``, ``bfs_level``, ``bfs_parent``, ``pagerank``,
``connected_components`` and ``triangle_count`` run on both backings, and
so do ``Matrix.ss``/``Vector.ss`` (formats, import and export, split and
concat, sort, selectk, compactify, the prefix scan, serialize), ``gb.ss``
(``diag``, ``concat``, ``config``, ``about``, ``Context``), the reprs,
pickling, ``gb.io``, ``gb.viz`` and the ``Recorder``.  The
eleven real types (BOOL, INT8-INT64, UINT8-UINT64, FP32, FP64) and every
operator of the JAX package's ``binary``, ``unary``, ``monoid``,
``semiring``, ``select`` and ``indexunary`` namespaces (with ``numpy``,
``ss``, ``gb.op``, user operators over tensors) resolve as there; the
kernels take every builtin multiply on the types of at most 32 bits, each
operand in its own type.  Operators may be given as the JAX package's
strings (``"+"``, ``"min_plus[FP64]"``).  Everything runs
on ``cuda`` unless the caller asks for the CPU with
``config.set(device="cpu")``.  ``backend`` is ``"torch"``: PyTorch with
the hand-written CUDA kernels.  What is not ported yet raises
``NotImplementedError`` naming its ROADMAP.md item.

The package imports torch and numpy only, never jax or graphblas_tpu.
"""


from . import core as _core

__version__ = "0.1.0"

backend = "torch"


class _ReplaceSingleton:
    """``replace``: given to ``C(mask, replace)`` it sets replace=True."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "replace"

    def __reduce__(self):
        return "replace"


replace = _ReplaceSingleton()


def init(backend="torch", blocking=None):
    """Set the execution mode once: ``backend`` must be "torch" (or
    "cuda", "cpu"), and ``blocking=True`` makes every operation wait for
    the card to finish (for debugging and timing).  A second call with
    other parameters raises RuntimeError."""
    if backend not in ("torch", "cuda", "cpu"):
        raise ValueError(f"Bad backend name: {backend!r}.  This package's "
                         f"backend is 'torch'.")
    if _core._init_params is not None:
        if _core._blocking is not None and blocking is not None and \
                blocking != _core._blocking:
            raise RuntimeError("graphblas_tpu_torch is already initialized "
                               "with different parameters")
        return
    _core._init_params = {"backend": backend, "blocking": bool(blocking)}
    _core._blocking = bool(blocking)

from . import (agg, binary, dtypes, exceptions, indexunary,  # noqa: E402
               monoid, op, select, semiring, ss, unary)
from .core.config import config  # noqa: E402
from .core.matrix import Matrix  # noqa: E402
from .core.scalar import Scalar  # noqa: E402
from .core.vector import Vector  # noqa: E402
from .core import infix as _infix  # noqa: E402,F401  (|, &, @, arithmetic)
from .core.recorder import Recorder  # noqa: E402
from .exceptions import GraphblasException  # noqa: E402

from . import algorithms, io, viz  # noqa: E402  (they import Vector)

__all__ = ["Matrix", "Vector", "Scalar", "Recorder", "config", "agg",
           "algorithms", "backend", "binary", "dtypes", "exceptions",
           "GraphblasException", "indexunary", "init", "io", "monoid", "op",
           "replace", "select", "semiring", "ss", "unary", "viz"]

# the JAX package's names that the port lacks, and their ROADMAP.md items
_NOT_PORTED = {"parallel": 13}


def __getattr__(name):
    if name in _NOT_PORTED:
        from .core.operator.base import not_ported

        raise not_ported(f"graphblas_tpu_torch.{name}", _NOT_PORTED[name])
    raise AttributeError(
        f"module 'graphblas_tpu_torch' has no attribute {name!r}")
