"""Operations and bytes a call needs, computed from its inputs alone,
whatever implements it."""

INDEX_BYTES = 4   # a column index, and a row offset, below 2**31 entries


def spmv_bytes(n, nnz, value_bytes, vector_bytes=1):
    """w = u A over an n x n matrix of nnz stored entries: each entry's
    index and value read once, the n + 1 row offsets read once, u read
    once and w written once."""
    return (nnz * (INDEX_BYTES + value_bytes) + (n + 1) * INDEX_BYTES
            + 2 * n * vector_bytes)
