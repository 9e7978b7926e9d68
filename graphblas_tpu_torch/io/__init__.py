"""I/O and interop (graphblas_tpu/io/__init__.py): Matrix Market
(``mmread`` reads with scipy where it is installed and with the native
reader below otherwise; ``mmwrite``), and the converters from and to
scipy.sparse, networkx, numpy, awkward and pydata/sparse.  Each optional
package is imported inside the function that needs it."""

import numpy as np

from ..core.matrix import Matrix
from ..core.vector import Vector

__all__ = [
    "mmread",
    "mmwrite",
    "from_scipy_sparse",
    "to_scipy_sparse",
    "from_networkx",
    "to_networkx",
    "from_numpy",
    "to_numpy",
    "from_awkward",
    "to_awkward",
    "from_pydata_sparse",
    "to_pydata_sparse",
]


def mmread(source, engine="auto", *, dup_op=None, name=None, **opts):
    """Read a Matrix Market file into a Matrix."""
    try:
        from scipy.io import mmread as _scipy_mmread
        from scipy.sparse import issparse

        array = _scipy_mmread(source)
        if issparse(array):
            coo = array.tocoo()
            return Matrix.from_coo(
                coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data,
                nrows=coo.shape[0], ncols=coo.shape[1], dup_op=dup_op,
                name=name)
        return Matrix.from_dense(np.asarray(array), name=name)
    except ImportError:
        pass
    return _mmread_native(source, dup_op=dup_op, name=name)


def _mmread_native(source, *, dup_op=None, name=None):
    if hasattr(source, "read"):
        text = source.read()
        if isinstance(text, bytes):
            text = text.decode()
        lines = text.splitlines()
    else:
        with open(source) as f:
            lines = f.read().splitlines()
    header = lines[0].strip().split()
    if len(header) < 5 or header[0] not in ("%%MatrixMarket", "%MatrixMarket"):
        raise ValueError("Invalid Matrix Market header")
    _, obj, fmt, field, symmetry = header[:5]
    fmt = fmt.lower()
    field = field.lower()
    symmetry = symmetry.lower()
    body = [ln for ln in lines[1:] if ln.strip() and not ln.startswith("%")]
    dims = body[0].split()
    if fmt == "coordinate":
        nrows, ncols, nnz = int(dims[0]), int(dims[1]), int(dims[2])
        rows = np.empty(nnz, np.int64)
        cols = np.empty(nnz, np.int64)
        if field == "pattern":
            vals = np.ones(nnz, np.int64)
            for k, ln in enumerate(body[1 : nnz + 1]):
                parts = ln.split()
                rows[k] = int(parts[0]) - 1
                cols[k] = int(parts[1]) - 1
        else:
            np_t = np.float64 if field in ("real", "double") else (
                np.complex128 if field == "complex" else np.int64)
            vals = np.empty(nnz, np_t)
            for k, ln in enumerate(body[1 : nnz + 1]):
                parts = ln.split()
                rows[k] = int(parts[0]) - 1
                cols[k] = int(parts[1]) - 1
                if field == "complex":
                    vals[k] = complex(float(parts[2]), float(parts[3]))
                else:
                    vals[k] = np_t(parts[2])
        if symmetry in ("symmetric", "skew-symmetric", "hermitian"):
            off = rows != cols
            extra_r = cols[off]
            extra_c = rows[off]
            extra_v = vals[off]
            if symmetry == "skew-symmetric":
                extra_v = -extra_v
            elif symmetry == "hermitian":
                extra_v = np.conj(extra_v)
            rows = np.concatenate([rows, extra_r])
            cols = np.concatenate([cols, extra_c])
            vals = np.concatenate([vals, extra_v])
        return Matrix.from_coo(rows, cols, vals, nrows=nrows, ncols=ncols,
                               dup_op=dup_op, name=name)
    # array (dense) format
    nrows, ncols = int(dims[0]), int(dims[1])
    np_t = np.float64 if field in ("real", "double") else (
        np.complex128 if field == "complex" else np.int64)
    flat = np.array([np_t(x) for ln in body[1:] for x in ln.split()], np_t)
    dense = flat.reshape(ncols, nrows).T  # column-major order in file
    return Matrix.from_dense(dense, name=name)


def mmwrite(target, matrix, engine="auto", *, comment="", field=None,
            precision=None, symmetry=None, **opts):
    """Write a Matrix in the Matrix Market coordinate format."""
    rows, cols, vals = matrix.to_coo()
    dt = matrix.dtype
    if field is None:
        field = ("integer" if dt.is_int or dt.is_bool
                 else "complex" if dt.is_complex else "real")
    lines = [f"%%MatrixMarket matrix coordinate {field} general"]
    if comment:
        for ln in comment.split("\n"):
            lines.append(f"%{ln}")
    lines.append(f"{matrix.nrows} {matrix.ncols} {len(vals)}")
    for r, c, v in zip(rows.tolist(), cols.tolist(), vals.tolist()):
        if field == "complex":
            lines.append(f"{int(r) + 1} {int(c) + 1} {v.real:.17g} "
                         f"{v.imag:.17g}")
        elif field == "integer":
            lines.append(f"{int(r) + 1} {int(c) + 1} {int(v)}")
        else:
            lines.append(f"{int(r) + 1} {int(c) + 1} {v:.17g}")
    text = "\n".join(lines) + "\n"
    if hasattr(target, "write"):
        target.write(text)
    else:
        with open(target, "w") as f:
            f.write(text)


# ---------------------------------------------------------------------- #
def from_scipy_sparse(A, *, dup_op=None, name=None):
    """A Matrix from a scipy.sparse array or matrix: a canonical CSR one
    through ``Matrix.from_csr`` (its own arrays, no COO copy), any other
    through its COO form (duplicates combine with dup_op)."""
    if A.format == "csr" and A.has_canonical_format and dup_op is None:
        return Matrix.from_csr(A.indptr.astype(np.int64),
                               A.indices.astype(np.int64), A.data,
                               nrows=A.shape[0], ncols=A.shape[1], name=name)
    coo = A.tocoo()
    return Matrix.from_coo(coo.row.astype(np.int64), coo.col.astype(np.int64),
                           coo.data, nrows=coo.shape[0], ncols=coo.shape[1],
                           dup_op=dup_op, name=name)


def to_scipy_sparse(A, format="csr"):
    """A scipy.sparse array of the matrix in format."""
    import scipy.sparse as ss

    rows, cols, vals = A.to_coo()
    rv = ss.coo_array((vals, (rows.astype(np.int64), cols.astype(np.int64))),
                      shape=A.shape)
    return rv.asformat(format)


def from_networkx(G, nodelist=None, dtype=None, weight="weight", name=None):
    """A Matrix of the graph's adjacency (edge attribute weight)."""
    import networkx as nx

    A = nx.to_scipy_sparse_array(G, nodelist=nodelist, dtype=None,
                                 weight=weight)
    M = from_scipy_sparse(A, name=name)
    if dtype is not None:
        M = M.dup(dtype)
    return M


def to_networkx(m, edge_attribute="weight"):
    """A networkx DiGraph of the matrix's entries."""
    import networkx as nx

    rows, cols, vals = m.to_coo()
    G = nx.DiGraph()
    if edge_attribute is None:
        G.add_edges_from(zip(rows.tolist(), cols.tolist()))
    else:
        G.add_weighted_edges_from(
            zip(rows.tolist(), cols.tolist(), vals.tolist()),
            weight=edge_attribute)
    return G


def from_numpy(m):
    if m.ndim == 1:
        return Vector.from_dense(m)
    return Matrix.from_dense(m)


def to_numpy(m):
    return m.to_dense(fill_value=0)


def from_awkward(A, *, name=None):
    """A Matrix or Vector from an array made by to_awkward."""
    import awkward as ak

    # expect records with fields written by to_awkward
    fields = set(A.fields)
    if {"indices", "values"} <= fields:
        size = A.layout.parameters.get("size")
        if size is None:
            raise ValueError("Missing size parameter for Vector")
        return Vector.from_coo(np.asarray(A.indices.layout.content),
                               np.asarray(A.values.layout.content),
                               size=int(size), name=name)
    if {"rows", "cols", "values"} <= fields:
        nrows = A.layout.parameters.get("nrows")
        ncols = A.layout.parameters.get("ncols")
        return Matrix.from_coo(np.asarray(ak.flatten(A.rows, axis=None)),
                               np.asarray(ak.flatten(A.cols, axis=None)),
                               np.asarray(ak.flatten(A.values, axis=None)),
                               nrows=int(nrows), ncols=int(ncols), name=name)
    raise ValueError("Unknown awkward structure for GraphBLAS import")


def to_awkward(A, format=None):
    """An awkward array of the entries, the shape in its parameters."""
    import awkward as ak

    if A.ndim == 1:
        idx, vals = A.to_coo()
        rv = ak.Array({"indices": [idx.tolist()], "values": [vals.tolist()]})
        return ak.with_parameter(rv, "size", A.size)
    rows, cols, vals = A.to_coo()
    rv = ak.Array({"rows": [rows.tolist()], "cols": [cols.tolist()],
                   "values": [vals.tolist()]})
    rv = ak.with_parameter(rv, "nrows", A.nrows)
    return ak.with_parameter(rv, "ncols", A.ncols)


def from_pydata_sparse(s, *, dup_op=None, name=None):
    """A Matrix or Vector from a pydata/sparse array."""
    import sparse

    coo = sparse.COO(s)
    if coo.ndim == 1:
        return Vector.from_coo(coo.coords[0].astype(np.int64), coo.data,
                               size=coo.shape[0], name=name)
    return Matrix.from_coo(coo.coords[0].astype(np.int64),
                           coo.coords[1].astype(np.int64), coo.data,
                           nrows=coo.shape[0], ncols=coo.shape[1],
                           dup_op=dup_op, name=name)


def to_pydata_sparse(A, format="coo"):
    """A pydata/sparse array of the entries."""
    import sparse

    if A.ndim == 1:
        idx, vals = A.to_coo()
        return sparse.COO(idx[None, :].astype(np.int64), vals, shape=A.shape)
    rows, cols, vals = A.to_coo()
    coo = sparse.COO(np.stack([rows, cols]).astype(np.int64), vals,
                     shape=A.shape)
    return coo.asformat(format) if format != "coo" else coo
