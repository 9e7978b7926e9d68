"""``graphblas_tpu_torch.ss``: extensions beyond the GraphBLAS C API."""

__all__ = ["iterate"]


def iterate(body, state, *, cond=None, max_iter=64):
    """Run an algorithm loop (graphblas_tpu/ss/__init__.py ``iterate``).

    ``body(state, i)`` mutates the collections of ``state`` in place
    through normal GraphBLAS calls; ``i`` is a 1-based INT64 Scalar
    counter.  ``cond(state, i)``, evaluated after each body run, returns a
    Scalar; the loop continues while it is truthy (do-while), and always
    stops after ``max_iter`` runs.  Returns the number of runs.

    ``state`` maps names to Vectors and Matrices (anything else raises
    TypeError, as in the JAX package): the body replaces their stores
    through ``<<``.  The loop is plain Python and nothing is traced
    (the JAX package traces the body once, and its ``mxm`` planning has a
    branch for traced dense operands that needs no counterpart here);
    reading ``cond`` costs one device sync per iteration.  Replaying the
    body as a CUDA graph is ROADMAP.md queue 1, item 6.
    """
    from ..core.dtypes import INT64
    from ..core.matrix import Matrix
    from ..core.scalar import Scalar
    from ..core.vector import Vector

    for name, v in state.items():
        if not isinstance(v, (Vector, Matrix)):
            raise TypeError(
                f"state[{name!r}] must be a Vector or Matrix; got {type(v)}")
    i = 0
    while i < max_iter:
        i += 1
        counter = Scalar.from_value(i, INT64)
        body(state, counter)
        if cond is not None:
            c = cond(state, counter)
            if c.is_empty or not c.value:
                break
    return i


# the JAX package's names of gb.ss that the port lacks
_WAITING = frozenset(("diag", "concat", "config", "about", "burble"))


def __getattr__(name):
    from ..core.operator.base import missing

    raise missing("ss", name, _WAITING)
