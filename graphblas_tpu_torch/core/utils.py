"""Small shared utilities (graphblas_tpu/core/utils.py): ``output_type``
and its registry.  The JAX package's ``x64_*`` scoping helpers serve JAX's
32-bit default and have no counterpart here."""

_output_types = {}


def output_type(val):
    """The collection class a value stands for: an expression's output
    class, a registered class, or the value's own type."""
    ot = getattr(val, "output_type", None)
    if isinstance(ot, type):
        return ot
    try:
        return _output_types[type(val)]
    except KeyError:
        return type(val)


def get_order(order):
    """"rowwise" or "columnwise" from the JAX package's spellings."""
    val = {"c", "row", "rows", "rowwise", "f", "col", "cols", "column",
           "columns", "columnwise"}.intersection([str(order).lower()])
    if not val:
        raise ValueError(f'order argument should be "rowwise" or '
                         f'"columnwise"; got {order!r}')
    return "rowwise" if val.pop() in ("c", "row", "rows", "rowwise") \
        else "columnwise"


def ints_to_numpy_buffer(array, dtype, *, name="array"):
    """A 1-d integer (or bool) array as dtype; ValueError for floats or a
    higher rank."""
    import numpy as np

    if (isinstance(array, np.ndarray)
            and not np.issubdtype(array.dtype, np.integer)
            and not np.issubdtype(array.dtype, np.bool_)):
        raise ValueError(f"{name} must be integers, not {array.dtype.name}")
    array = np.asarray(array, dtype)
    if array.ndim > 1:
        raise ValueError(f"{name} must be 1-dimensional")
    return array
