"""``graphblas_tpu_torch.exceptions``: the error classes the port raises
(graphblas_tpu/exceptions.py).  The two that the port used to raise as
``ValueError`` subclass it, and ``IndexOutOfBound`` subclasses
``IndexError``, so either name catches them."""

__all__ = ["GraphblasException", "DimensionMismatch", "EmptyObject",
           "IndexOutOfBound", "OutOfMemory"]


class GraphblasException(Exception):
    pass


class DimensionMismatch(GraphblasException, ValueError):
    pass


class EmptyObject(GraphblasException):
    pass


class OutOfMemory(GraphblasException):
    pass


class IndexOutOfBound(GraphblasException, IndexError):
    pass
