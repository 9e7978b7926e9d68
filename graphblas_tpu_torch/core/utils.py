"""Small shared utilities (graphblas_tpu/core/utils.py): ``output_type``
and its registry, and ``normalize_chunks`` of ``ss.split``.  The JAX
package's ``x64_*`` scoping helpers serve JAX's 32-bit default and have
no counterpart here."""

import numpy as np

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
    if (isinstance(array, np.ndarray)
            and not np.issubdtype(array.dtype, np.integer)
            and not np.issubdtype(array.dtype, np.bool_)):
        raise ValueError(f"{name} must be integers, not {array.dtype.name}")
    array = np.asarray(array, dtype)
    if array.ndim > 1:
        raise ValueError(f"{name} must be 1-dimensional")
    return array


def normalize_chunks(chunks, shape):
    """Normalize a chunk specification against a shape (for ss.split).

    Accepts an int, a list of ints (None: the rest of the dimension), or
    one such spec per dimension.  Returns a list (per dimension) of lists
    of chunk sizes.
    """
    if isinstance(chunks, (list, tuple)) and len(chunks) == len(shape) and any(
        isinstance(c, (list, tuple)) or c is None for c in chunks
    ):
        chunkspec = chunks
    elif len(shape) == 2 and isinstance(chunks, (list, tuple)) \
            and len(chunks) == 2:
        chunkspec = chunks
    else:
        chunkspec = [chunks] * len(shape)
    out = []
    for spec, dim in zip(chunkspec, shape):
        if spec is None:
            out.append([dim])
        elif isinstance(spec, (int, np.integer)):
            n_full, rem = divmod(dim, int(spec))
            sizes = [int(spec)] * n_full
            if rem:
                sizes.append(rem)
            if not sizes:
                sizes = [0]
            out.append(sizes)
        elif isinstance(spec, (list, tuple)):
            sizes = []
            none_idx = None
            total = 0
            for i, s in enumerate(spec):
                if s is None:
                    if none_idx is not None:
                        raise TypeError("Bad chunk spec: only one None "
                                        "allowed per dimension")
                    none_idx = i
                    sizes.append(None)
                else:
                    s = int(s)
                    if s < 0:
                        raise ValueError(f"Chunk size must be "
                                         f"non-negative; got {s}")
                    sizes.append(s)
                    total += s
            if none_idx is not None:
                if total > dim:
                    raise ValueError(f"Chunks are too large; {total} > {dim}")
                sizes[none_idx] = dim - total
            elif total != dim:
                raise ValueError(f"Chunks do not add up to dimension "
                                 f"size: {total} != {dim}")
            out.append(sizes)
        else:
            raise TypeError(f"Bad type for chunks: {type(spec)}")
    return out
