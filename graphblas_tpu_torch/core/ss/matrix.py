"""``Matrix.ss`` (graphblas_tpu/core/ss/matrix.py): storage-format control
and the data-plane extensions.

Import and export in the ten formats of the JAX package, with its field
names and dtypes (a dict exported by one package imports into the other);
split and concat; the iterators; flatten and reshape; selectk, compactify
and sort; serialize in the JAX package's ``GBTPU0`` blob; the prefix scan;
the per-matrix config, whose ``sparsity_control`` moves the matrix
between its two backings.

A sparse-backed matrix stays sparse through all of these (but an export to
a bitmap or full format): they shift, filter and sort its coordinates on
the device (core/engine/sparse.py), where the JAX package works on its
dense store.  A dense-backed matrix takes the dense engine's twins."""

import pickle
import zlib

import numpy as np
import torch

from ...exceptions import InvalidValue
from .. import dtypes as _dt
from .. import trace as _trace
from ..engine import dense
from ..engine import sparse as spx
from ..engine import store as st
from ..utils import normalize_chunks


class MatrixConfig(dict):
    """The per-matrix config.  ``sparsity_control`` is live: "sparse" or
    "hypersparse" moves a dense-backed matrix to a sparse store, "bitmap"
    or "full" densifies a sparse one (under ``dense_limit``);
    ``sparsity_status`` reports the backing."""

    _defaults = {
        "format": "bitmapr",
        "sparsity_control": "auto",
        "hyper_switch": 0.0625,
        "bitmap_switch": 0.04,
    }
    _SPARSITY = {"auto", "sparse", "hypersparse", "bitmap", "full"}

    def __init__(self, parent):
        super().__init__(self._defaults)
        self._parent = parent

    def __getitem__(self, key):
        if key == "sparsity_status":
            return "sparse" if self._parent._sparse is not None else "bitmap"
        if key == "format":
            return self._parent.ss.format
        return super().__getitem__(key)

    def __setitem__(self, key, value):
        if key == "sparsity_status":
            raise InvalidValue("sparsity_status is read-only")
        if key == "sparsity_control":
            if value not in self._SPARSITY:
                raise InvalidValue(
                    f"Invalid sparsity_control: {value!r}; must be one of "
                    f"{sorted(self._SPARSITY)}")
            p = self._parent
            if value in ("sparse", "hypersparse") and p._sparse is None:
                from .. import execute

                execute._sparsify(p)
            elif value in ("bitmap", "full") and p._sparse is not None:
                p._densify()
        super().__setitem__(key, value)


def _iso(pres):
    return len(pres) > 0 and bool((pres == pres.flat[0]).all())


def _broadcast_iso(v, n, is_iso):
    """An iso export may carry one value for all n entries."""
    v = np.asarray(v)
    if is_iso and v.size >= 1 and (v.ndim == 0 or len(v) != n):
        v = np.broadcast_to(v.reshape(-1)[:1], (n,) + v.shape[1:])
    return v


def rng_keys(n):
    """Random keys of ``how="random"`` (numpy's generator, as the JAX
    package)."""
    return np.random.default_rng().random(n, dtype=np.float32)


class MatrixSS:
    __slots__ = "_parent", "config", "__weakref__"

    def __init__(self, parent):
        self._parent = parent
        self.config = MatrixConfig(parent)

    # ------------------------------------------------------------------ #
    def _hypersparse(self):
        """Hypersparse when sparsity_control says so, or (auto) when fewer
        than hyper_switch of the rows hold an entry; counted on the host
        copy of the sorted rows."""
        p = self._parent
        if p._sparse is None:
            return False
        ctl = self.config.get("sparsity_control", "auto")
        if ctl == "hypersparse":
            return True
        if ctl != "auto" or p.nrows == 0:
            return False
        rows = p._sparse.struct.host()[0]
        nvec = int(np.count_nonzero(np.diff(rows))) + 1 if len(rows) else 0
        return nvec < self.config.get("hyper_switch", 0.0625) * p.nrows

    @property
    def format(self):
        if self._parent._sparse is not None:
            return "hypercsr" if self._hypersparse() else "csr"
        return "bitmapr"

    @property
    def orientation(self):
        return "rowwise"

    @property
    def nbytes(self):
        """Bytes of the backing: per entry its value and two int64
        coordinates (sparse), or a value and a valid flag per element."""
        p = self._parent
        size = p.dtype.np_type.itemsize
        if p._sparse is not None:
            return p._sparse.nvals() * (size + 16)
        return p.nrows * p.ncols * (size + 1)

    def _present_values(self):
        p = self._parent
        if p._sparse is not None:
            return p._sparse.host_coo()[2]
        vals, ok = p._host_arrays()
        return vals[ok]

    @property
    def is_iso(self):
        return _iso(self._present_values())

    @property
    def iso_value(self):
        from ..scalar import Scalar

        pres = self._present_values()
        if not _iso(pres):
            raise ValueError("Matrix is not iso-valued")
        return Scalar.from_value(pres.flat[0], self._parent.dtype)

    # ------------------------------------------------------------------ #
    def export(self, format=None, *, sort=True, give_ownership=False,
               raw=False):
        """The matrix as a dict of numpy arrays in one of the ten formats
        (the JAX package's field names); values are never trimmed to one
        for an iso matrix, and the importers take both forms."""
        p = self._parent
        if format is None or format == "rowwise":
            format = "hypercsr" if self._hypersparse() else "csr"
        elif format == "columnwise":
            format = "csc"
        format = format.lower()
        iso = self.is_iso
        shape = {"nrows": p.nrows, "ncols": p.ncols}
        if format == "csr":
            indptr, cols, v = p.to_csr()
            rv = {"indptr": indptr, "col_indices": cols, "values": v,
                  "sorted_cols": True, **shape}
        elif format == "csc":
            indptr, rows, v = p.to_csc()
            rv = {"indptr": indptr, "row_indices": rows, "values": v,
                  "sorted_rows": True, **shape}
        elif format == "hypercsr":
            rows, indptr, cols, v = p.to_dcsr()
            rv = {"rows": rows, "indptr": indptr, "col_indices": cols,
                  "values": v, "sorted_cols": True, **shape}
            if raw:
                rv["nvec"] = len(rows)
        elif format == "hypercsc":
            cols, indptr, rows, v = p.to_dcsc()
            rv = {"cols": cols, "indptr": indptr, "row_indices": rows,
                  "values": v, "sorted_rows": True, **shape}
            if raw:
                rv["nvec"] = len(cols)
        elif format in ("bitmapr", "bitmapc", "fullr", "fullc"):
            vals, ok = p._host_arrays()
            order = "C" if format.endswith("r") else "F"
            if format.startswith("full"):
                if not ok.all():
                    raise InvalidValue(f"Matrix is not full; cannot export "
                                       f"as {format}")
                rv = {"values": np.array(vals, order=order), **shape}
            else:
                rv = {"bitmap": np.array(ok, order=order),
                      "values": np.array(vals, order=order),
                      "nvals": int(ok.sum()), **shape}
        elif format in ("coor", "cooc", "coo"):
            r, c, v = p.to_coo()
            if format == "cooc":
                order = np.lexsort((r, c))
                r, c, v = r[order], c[order], v[order]
            rv = {"rows": r, "cols": c, "values": v, **shape,
                  "sorted_rows": format != "cooc",
                  "sorted_cols": format == "cooc"}
        else:
            raise ValueError(f"Invalid format: {format}")
        rv["is_iso"] = iso
        rv["format"] = format
        if give_ownership:
            p.clear()
        return rv

    def unpack(self, format=None, *, sort=True, raw=False):
        """export(give_ownership=True): the matrix is left empty."""
        return self.export(format, sort=sort, give_ownership=True, raw=raw)

    def unpack_hyperhash(self, *, compute=False, name=None):
        """The hyper-hash of a hypersparse matrix.  None unless compute
        (no matrix keeps one); with compute, an INT64 (table_size, 2)
        Matrix of open addressing: row t holds (row, its position in the
        hypercsr ``rows``) of the row hashed to slot t (linear probing,
        table_size the power of two >= 2 * nvec).  None for a matrix that
        does not export as hypercsr."""
        if not compute:
            return None
        exp = self.export("rowwise")
        if exp.get("format") != "hypercsr":
            return None
        from ..matrix import Matrix

        rows = np.asarray(exp["rows"], np.int64)
        nvec = len(rows)
        size = 1
        while size < max(2 * nvec, 1):
            size *= 2
        mask = size - 1
        table_r = np.full(size, -1, np.int64)
        table_k = np.full(size, -1, np.int64)
        for k, r in enumerate(rows):
            h = (int(r) * 0x9E3779B1) & mask
            while table_r[h] >= 0:
                h = (h + 1) & mask
            table_r[h] = r
            table_k[h] = k
        occ = np.flatnonzero(table_r >= 0)
        return Matrix.from_coo(
            np.repeat(occ, 2), np.tile(np.array([0, 1]), len(occ)),
            np.stack([table_r[occ], table_k[occ]], axis=1).reshape(-1),
            dtype="INT64", nrows=size, ncols=2, name=name or "hyper_hash")

    @classmethod
    def import_any(cls, **kwargs):
        """A Matrix from a dict of one of the ten formats (``format``, or
        the format its fields imply)."""
        from ..matrix import Matrix

        fmt = kwargs.get("format")
        if fmt is None:
            if "indptr" in kwargs:
                if "rows" in kwargs:
                    fmt = "hypercsr"
                elif "cols" in kwargs:
                    fmt = "hypercsc"
                elif "col_indices" in kwargs:
                    fmt = "csr"
                else:
                    fmt = "csc"
            elif "bitmap" in kwargs:
                fmt = "bitmapr"
            elif "rows" in kwargs or "cols" in kwargs:
                fmt = "coor"
            else:
                fmt = "fullr"
        fmt = fmt.lower()
        nrows, ncols = kwargs.get("nrows"), kwargs.get("ncols")
        dtype = kwargs.get("dtype")
        is_iso = bool(kwargs.get("is_iso", False))
        shape = {"nrows": nrows, "ncols": ncols}
        if fmt in ("csr", "csc"):
            indptr = np.asarray(kwargs["indptr"], np.int64)
            make = Matrix.from_csr if fmt == "csr" else Matrix.from_csc
            minor = kwargs["col_indices" if fmt == "csr" else "row_indices"]
            return make(indptr, minor, _broadcast_iso(
                kwargs["values"], int(indptr[-1]), is_iso), dtype, **shape)
        if fmt in ("hypercsr", "hypercsc"):
            major = np.asarray(kwargs["rows" if fmt == "hypercsr"
                                      else "cols"], np.int64)
            indptr = np.asarray(kwargs["indptr"], np.int64)
            nvec = int(kwargs.get("nvec", len(major)))
            make = Matrix.from_dcsr if fmt == "hypercsr" else Matrix.from_dcsc
            minor = kwargs["col_indices" if fmt == "hypercsr"
                           else "row_indices"]
            return make(major[:nvec], indptr[:nvec + 1], minor,
                        _broadcast_iso(kwargs["values"], int(indptr[nvec]),
                                       is_iso), dtype, **shape)
        if fmt in ("bitmapr", "bitmapc"):
            bitmap = np.asarray(kwargs["bitmap"], bool)
            vals = np.asarray(kwargs["values"])
            if bitmap.ndim == 1:
                bitmap = bitmap.reshape(nrows, ncols)
            if is_iso and vals.shape != bitmap.shape:
                vals = np.broadcast_to(vals.reshape(-1)[:1], bitmap.shape)
            elif vals.ndim == 1:
                vals = vals.reshape(bitmap.shape)
            dt = _dt.lookup_dtype(dtype if dtype is not None else vals.dtype)
            m = Matrix(dt, *bitmap.shape)
            dev = m.device
            if m._sparse is not None:  # over auto_sparse_limit: sparse
                r, c = np.nonzero(bitmap)
                m.build(r, c, vals[r, c])
            else:
                m._set_store(_dt.to_tensor(np.ascontiguousarray(vals), dt,
                                           dev),
                             _trace.upload("ss.bitmap", torch.from_numpy(
                                 np.ascontiguousarray(bitmap)), dev))
            return m
        if fmt in ("fullr", "fullc"):
            vals = np.asarray(kwargs["values"])
            if is_iso and nrows is not None and vals.shape != (nrows, ncols):
                vals = np.broadcast_to(vals.reshape(-1)[:1], (nrows, ncols))
            elif vals.ndim == 1 and nrows is not None:
                vals = vals.reshape(nrows, ncols)
            return Matrix.from_dense(np.ascontiguousarray(vals), dtype=dtype)
        if fmt in ("coor", "cooc", "coo"):
            rows = np.asarray(kwargs["rows"], np.int64)
            return Matrix.from_coo(rows, np.asarray(kwargs["cols"], np.int64),
                                   _broadcast_iso(kwargs["values"], len(rows),
                                                  is_iso), dtype, **shape)
        raise ValueError(f"Invalid format: {fmt}")

    def _make_importer(fmt):  # noqa: N805 -- used at class-build time
        def _import(cls, **kwargs):
            kwargs["format"] = fmt
            return MatrixSS.import_any.__func__(cls, **kwargs)

        _import.__name__ = f"import_{fmt}"
        _import.__doc__ = f"A Matrix from the `{fmt}` fields."
        return classmethod(_import)

    import_csr = _make_importer("csr")
    import_csc = _make_importer("csc")
    import_hypercsr = _make_importer("hypercsr")
    import_hypercsc = _make_importer("hypercsc")
    import_bitmapr = _make_importer("bitmapr")
    import_bitmapc = _make_importer("bitmapc")
    import_fullr = _make_importer("fullr")
    import_fullc = _make_importer("fullc")
    import_coor = _make_importer("coor")
    import_cooc = _make_importer("cooc")
    import_coo = _make_importer("coo")
    del _make_importer

    def pack_any(self, **kwargs):
        """Refill the matrix in place from a dict (the inverse of
        unpack)."""
        p = self._parent
        kwargs.setdefault("nrows", p.nrows)
        kwargs.setdefault("ncols", p.ncols)
        kwargs.setdefault("dtype", p.dtype)
        _adopt(p, self.import_any(**kwargs))

    def _make_packer(fmt):  # noqa: N805
        def _pack(self, **kwargs):
            kwargs["format"] = fmt
            return MatrixSS.pack_any(self, **kwargs)

        _pack.__name__ = f"pack_{fmt}"
        _pack.__doc__ = f"Refill the matrix from the `{fmt}` fields."
        return _pack

    pack_csr = _make_packer("csr")
    pack_csc = _make_packer("csc")
    pack_hypercsr = _make_packer("hypercsr")
    pack_hypercsc = _make_packer("hypercsc")
    pack_bitmapr = _make_packer("bitmapr")
    pack_bitmapc = _make_packer("bitmapc")
    pack_fullr = _make_packer("fullr")
    pack_fullc = _make_packer("fullc")
    pack_coor = _make_packer("coor")
    pack_cooc = _make_packer("cooc")
    pack_coo = _make_packer("coo")
    del _make_packer

    # ------------------------------------------------------------------ #
    def split(self, chunks, *, name=None):
        """A 2-D list of tiles; a sparse-backed matrix gives sparse-backed
        tiles."""
        from ..matrix import Matrix

        p = self._parent
        row_sizes, col_sizes = normalize_chunks(chunks, p.shape)
        if p._sparse is not None:
            return [[Matrix._from_sparse(p.dtype, t) for t in row]
                    for row in spx.split_store(p._sparse, row_sizes,
                                               col_sizes)]
        tiles, r0 = [], 0
        for rs in row_sizes:
            row, c0 = [], 0
            for cs in col_sizes:
                row.append(Matrix._from_planes(
                    p.dtype, p._d_vals[r0:r0 + rs, c0:c0 + cs].contiguous(),
                    p._d_valid[r0:r0 + rs, c0:c0 + cs].contiguous()))
                c0 += cs
            tiles.append(row)
            r0 += rs
        return tiles

    def concat(self, tiles):
        """Fill the matrix from a 2-D grid of tiles (the inverse of
        split)."""
        from ...ss import concat as _concat

        p = self._parent
        m = _concat(tiles, dtype=p.dtype)
        if m.shape != p.shape:
            raise ValueError(f"tiles concatenate to shape {m.shape}, "
                             f"expected {p.shape}")
        _adopt(p, m)

    def build_diag(self, vector, k=0):
        p = self._parent
        _adopt(p, vector.diag(k))

    def build_scalar(self, rows, columns, value):
        """Build with one value at every given position."""
        rows = np.asarray(rows, np.int64)
        self._parent.build(rows, np.asarray(columns, np.int64),
                           np.broadcast_to(np.asarray(value), rows.shape))

    # ------------------------------------------------------------------ #
    def iterkeys(self, seek=0):
        r, c, _ = self._parent.to_coo()
        for i in range(seek, len(r)):
            yield (int(r[i]), int(c[i]))

    def itervalues(self, seek=0):
        _, _, v = self._parent.to_coo()
        for i in range(seek, len(v)):
            yield v[i]

    def iteritems(self, seek=0):
        r, c, v = self._parent.to_coo()
        for i in range(seek, len(r)):
            yield ((int(r[i]), int(c[i])), v[i])

    def head(self, n=10, dtype=None, *, sort=False):
        r, c, v = self._parent.to_coo(dtype)
        return r[:n], c[:n], v[:n]

    # ------------------------------------------------------------------ #
    def flatten(self, order="rowwise", *, name=None):
        """The elements as a Vector of nrows * ncols, row by row (or
        column by column); a sparse store places its entries by their
        coordinates."""
        from ..vector import Vector

        p = self._parent
        colwise = order in ("columnwise", "F", "col")
        n = p.nrows * p.ncols
        if p._sparse is None:
            vals, ok = p._d_vals, p._d_valid
            if colwise:
                vals, ok = vals.T, ok.T
            return Vector._from_store(p.dtype, vals.reshape(-1),
                                      ok.reshape(-1), name=name)
        sp = p._sparse
        lin = sp.cols * p.nrows + sp.rows if colwise else \
            sp.rows * p.ncols + sp.cols
        vals = st.zeros_values((n,), p.dtype, p.device)
        ok = torch.zeros(n, dtype=torch.bool, device=p.device)
        vals[lin] = sp.vals
        _trace.put("ss.diag", ok, lin, True)
        return Vector._from_store(p.dtype, vals, ok, name=name)

    def reshape(self, nrows, ncols=None, order="rowwise", *, name=None):
        """The elements in the same row-major (or column-major) order in
        an nrows x ncols matrix of the same backing."""
        from ..matrix import Matrix

        p = self._parent
        if ncols is None:
            if isinstance(nrows, tuple):
                nrows, ncols = nrows
            else:
                ncols = p.nrows * p.ncols // nrows
        nrows, ncols = int(nrows), int(ncols)
        if nrows * ncols != p.nrows * p.ncols:
            raise ValueError(
                f"Cannot reshape {p.shape} into ({nrows}, {ncols}): "
                "total number of elements must be unchanged")
        colwise = order in ("columnwise", "F", "col")
        if p._sparse is not None:
            return Matrix._from_sparse(p.dtype, spx.reshape_store(
                p._sparse, nrows, ncols, colwise), name=name)
        vals, ok = p._d_vals, p._d_valid
        if colwise:
            vals = vals.T.reshape(ncols, nrows).T
            ok = ok.T.reshape(ncols, nrows).T
        else:
            vals = vals.reshape(nrows, ncols)
            ok = ok.reshape(nrows, ncols)
        return Matrix._from_planes(p.dtype, vals.contiguous(),
                                   ok.contiguous(), name=name)

    # ------------------------------------------------------------------ #
    def _keys(self, how, shape):
        if how != "random":
            return None
        return _trace.upload("ss.random_keys", torch.from_numpy(
            rng_keys(shape)), self._parent.device)

    def selectk(self, how, k, *, name=None):
        """At most k entries of each row, chosen by how (first, last,
        smallest, largest, random), at their places."""
        from ..matrix import Matrix

        p = self._parent
        if how not in ("first", "last", "smallest", "largest", "random"):
            raise ValueError(f"Invalid how: {how}")
        if p._sparse is not None:
            sp = p._sparse
            return Matrix._from_sparse(p.dtype, spx.selectk_store(
                sp, how, int(k), self._keys(how, sp.nvals())), name=name)
        vals, ok = dense.rowwise_selectk(p._d_vals, p._d_valid, p.dtype, how,
                                         int(k), self._keys(how, p.shape))
        return Matrix._from_planes(p.dtype, vals, ok, name=name)

    def compactify(self, how="first", ncols=None, *, name=None):
        """Each row's entries, in how's order, packed into its first
        columns; the result has ncols columns (default: the largest row
        count)."""
        from ..matrix import Matrix

        p = self._parent
        sp = p._sparse
        if ncols is not None:
            width = int(ncols)
        elif sp is not None:
            width = int(torch.bincount(sp.rows, minlength=1).max()) \
                if sp.nvals() else 0
        else:
            width = int(p._d_valid.sum(dim=1).max()) if p.nrows else 0
        if sp is not None:
            return Matrix._from_sparse(p.dtype, spx.compactify_store(
                sp, how, width, self._keys(how, sp.nvals())), name=name)
        vals, ok = dense.rowwise_compactify(p._d_vals, p._d_valid, p.dtype,
                                            how, width,
                                            self._keys(how, p.shape))
        return Matrix._from_planes(p.dtype, vals, ok, name=name)

    def sort(self, op="<", values=True, permutation=True, *, rowwise=True,
             nthreads=None):
        """Each row's (column's) values sorted by op ("<" ascending, ">"
        descending; ties by column), packed left, and the permutation: the
        source column (row) of each, as INT64."""
        from ..matrix import Matrix
        from ..operator.utils import binary_from_string

        if isinstance(op, str):
            op = binary_from_string(op)
        descending = getattr(op, "name", "lt") in ("gt", ">")
        p = self._parent
        if p._sparse is not None:
            c_sp, p_sp = spx.sort_store(p._sparse,
                                        "desc" if descending else "asc",
                                        rowwise)
            outs = [Matrix._from_sparse(p.dtype, c_sp),
                    Matrix._from_sparse(_dt.INT64, p_sp)]
        else:
            a_vals, a_ok = p._d_vals, p._d_valid
            if not rowwise:
                a_vals, a_ok = a_vals.T, a_ok.T
            c_vals, p_vals, out_ok = dense.rowwise_sort(a_vals, a_ok,
                                                        p.dtype, descending)
            if not rowwise:
                c_vals, p_vals, out_ok = c_vals.T, p_vals.T, out_ok.T
            outs = [Matrix._from_planes(p.dtype, c_vals.contiguous(),
                                        out_ok.contiguous()),
                    Matrix._from_planes(_dt.INT64, p_vals.contiguous(),
                                        out_ok.contiguous())]
        outs = [o for o, want in zip(outs, (values, permutation)) if want]
        return outs[0] if len(outs) == 1 else tuple(outs)

    # ------------------------------------------------------------------ #
    def serialize(self, compression="default", level=None, *, nthreads=None):
        """The matrix as a uint8 array: the JAX package's ``GBTPU0`` blob
        (a pickled dict of its COO, zlib-compressed unless compression is
        None or "none")."""
        p = self._parent
        r, c, v = p.to_coo()
        payload = pickle.dumps({"dtype": _dtype_key(p.dtype), "nrows": p.nrows,
                                "ncols": p.ncols, "rows": r, "cols": c,
                                "values": v},
                               protocol=pickle.HIGHEST_PROTOCOL)
        return _blob(b"GBTPU0", payload, compression, level)

    @staticmethod
    def deserialize(data, dtype=None, *, nthreads=None):
        from ..matrix import Matrix

        d = _unblob(b"GBTPU0", data)
        return Matrix.from_coo(
            d["rows"].astype(np.int64), d["cols"].astype(np.int64),
            d["values"], dtype if dtype is not None else d["dtype"],
            nrows=d["nrows"], ncols=d["ncols"])

    def scan(self, op="plus", order="rowwise", *, name=None):
        """The inclusive prefix scan of each row's (column's) entries by a
        BinaryOp or Monoid, in the input's structure and the op's return
        type (sparse.scan_values: kernel K6 for the monoids and types it
        takes)."""
        from ..matrix import Matrix

        p = self._parent
        typed_op = _scan_op(op, p.dtype)
        rowwise = order in ("rowwise", "C", "row")
        sp = p._sparse if p._sparse is not None else \
            spx.from_dense(p._d_vals, p._d_valid, p.dtype)
        out = spx.scan_store(sp, typed_op, rowwise)
        if p._sparse is not None:
            return Matrix._from_sparse(typed_op.return_type, out, name=name)
        vals, ok = spx.densify(out, typed_op.return_type, p.device)
        return Matrix._from_planes(typed_op.return_type, vals, ok, name=name)


def _dtype_key(dt):
    """The type as a serialized blob names it: a builtin's name, a
    user-defined type's numpy type string (the JAX package's)."""
    return dt.np_type.str if dt._is_udt else dt.name


def _scan_op(op, dtype):
    """A scan's op typed for dtype: a BinaryOp, a Monoid's, or a name."""
    from ..operator.base import typed

    if getattr(op, "opclass", None) == "Monoid":
        op = op.binaryop
    return typed(op, dtype, "BinaryOp")


def _adopt(p, m):
    """Matrix p takes m's backing, shape and contents."""
    if m._sparse is not None:
        p._set_sparse_store(m._sparse)
    else:
        p._set_store(m._d_vals, m._d_valid)
    p._nrows, p._ncols = m.nrows, m.ncols


def _blob(magic, payload, compression, level):
    if compression in (None, "none"):
        blob = magic + b"\x00" + payload
    else:
        blob = magic + b"\x01" + zlib.compress(
            payload, 6 if level is None else int(level))
    return np.frombuffer(blob, dtype=np.uint8)


def _unblob(magic, data):
    blob = bytes(np.asarray(data, np.uint8))
    if not blob.startswith(magic):
        raise InvalidValue("Invalid serialized blob")
    payload = blob[7:]
    if blob[6] == 1:
        payload = zlib.decompress(payload)
    return pickle.loads(payload)  # noqa: S301 -- the package's own blob
