"""``graphblas_tpu_torch.exceptions``: the GraphBLAS error classes
(graphblas_tpu/exceptions.py), all seventeen, under GraphblasException as
there.  Two that the port used to raise as builtin errors keep those as a
second base: ``DimensionMismatch`` subclasses ``ValueError`` and
``IndexOutOfBound`` ``IndexError``, so either name catches them."""

__all__ = ["GraphblasException", "NoValue", "UninitializedObject",
           "InvalidObject", "NullPointer", "InvalidValue", "InvalidIndex",
           "DomainMismatch", "DimensionMismatch", "OutputNotEmpty",
           "OutOfMemory", "InsufficientSpace", "IndexOutOfBound", "Panic",
           "EmptyObject", "NotImplementedException", "UdfParseError"]


class GraphblasException(Exception):
    """Base class for all GraphBLAS exceptions."""


class NoValue(GraphblasException):
    """Attempted to extract an element that is not present."""


class UninitializedObject(GraphblasException):
    """Object has not been initialized."""


class InvalidObject(GraphblasException):
    """One of the collection objects is in an invalid state."""


class NullPointer(GraphblasException):
    """A null pointer was passed."""


class InvalidValue(GraphblasException):
    """An invalid value was passed (duplicate indices without a dup_op)."""


class InvalidIndex(GraphblasException):
    """An index is out of range for its object (single-element ops)."""


class DomainMismatch(GraphblasException):
    """The domains (dtypes) of operators and collections do not meet."""


class DimensionMismatch(GraphblasException, ValueError):
    """Array dimensions are incompatible for the requested operation."""


class OutputNotEmpty(GraphblasException):
    """Attempted to build a collection that already contains values."""


class OutOfMemory(GraphblasException):
    """The engine ran out of memory (or a densify passed dense_limit)."""


class InsufficientSpace(GraphblasException):
    """Provided buffers are too small."""


class IndexOutOfBound(GraphblasException, IndexError):
    """An index is outside the allowed range."""


class Panic(GraphblasException):
    """Unrecoverable internal error."""


class EmptyObject(GraphblasException):
    """An object with no value was used where a value is required."""


class NotImplementedException(GraphblasException):
    """The requested feature is not implemented."""


class UdfParseError(GraphblasException):
    """Failed to compile a user-defined function."""
