"""``Vector.ss`` (graphblas_tpu/core/ss/vector.py): the three vector
formats (sparse, bitmap, full) with the JAX package's field names, split
and concat, selectk, compactify, sort, serialize in its ``GBTPU1`` blob
and the prefix scan (over the stored entries, kernel K6 for the monoids
and types it takes), and ``random_choice``."""

import pickle

import numpy as np
import torch

from ...exceptions import InvalidValue
from .. import dtypes as _dt
from ..engine import dense
from ..engine import sparse as spx
from ..engine import store as st
from ..utils import normalize_chunks
from .matrix import (_blob, _broadcast_iso, _dtype_key, _iso, _scan_op,
                     _unblob, rng_keys)


class VectorSS:
    __slots__ = "_parent", "config", "__weakref__"

    def __init__(self, parent):
        self._parent = parent
        self.config = {"format": "bitmap", "sparsity_control": "auto"}

    @property
    def format(self):
        return "bitmap"

    @property
    def nbytes(self):
        p = self._parent
        return p.size * (p.dtype.np_type.itemsize + 1)

    def _present_values(self):
        vals, ok = self._parent._host_arrays()
        return vals[ok]

    @property
    def is_iso(self):
        return _iso(self._present_values())

    @property
    def iso_value(self):
        from ..scalar import Scalar

        pres = self._present_values()
        if not _iso(pres):
            raise ValueError("Vector is not iso-valued")
        return Scalar.from_value(pres.flat[0], self._parent.dtype)

    # ------------------------------------------------------------------ #
    def export(self, format=None, *, sort=True, give_ownership=False,
               raw=False):
        p = self._parent
        format = "sparse" if format is None else format.lower()
        vals, ok = p._host_arrays()
        iso = self.is_iso
        if format == "sparse":
            idx, v = p.to_coo()
            rv = {"indices": idx, "values": v, "sorted_index": True,
                  "size": p.size}
        elif format == "bitmap":
            rv = {"bitmap": ok.copy(), "values": vals.copy(),
                  "nvals": int(ok.sum()), "size": p.size}
        elif format == "full":
            if not ok.all():
                raise InvalidValue("Vector is not full; cannot export as "
                                   "full")
            rv = {"values": vals.copy(), "size": p.size}
        else:
            raise ValueError(f"Invalid format: {format}")
        rv["is_iso"] = iso
        rv["format"] = format
        if give_ownership:
            p.clear()
        return rv

    def unpack(self, format=None, *, sort=True, raw=False):
        """export(give_ownership=True): the vector is left empty."""
        return self.export(format, sort=sort, give_ownership=True, raw=raw)

    @classmethod
    def import_any(cls, **kwargs):
        from ..vector import Vector

        fmt = kwargs.get("format")
        if fmt is None:
            fmt = "sparse" if "indices" in kwargs else (
                "bitmap" if "bitmap" in kwargs else "full")
        fmt = fmt.lower()
        dtype = kwargs.get("dtype")
        size = kwargs.get("size")
        is_iso = bool(kwargs.get("is_iso", False))
        if fmt == "sparse":
            idx = np.asarray(kwargs["indices"], np.int64)
            return Vector.from_coo(idx, _broadcast_iso(
                kwargs["values"], len(idx), is_iso), dtype, size=size)
        if fmt == "bitmap":
            bitmap = np.asarray(kwargs["bitmap"], bool)
            vals = _broadcast_iso(kwargs["values"], bitmap.shape[0], is_iso)
            dt = _dt.lookup_dtype(dtype if dtype is not None else vals.dtype)
            v = Vector(dt, bitmap.shape[0])
            v._set_store(_dt.to_tensor(vals, dt, v.device),
                         torch.from_numpy(bitmap.copy()).to(v.device))
            return v
        if fmt == "full":
            n = size if size is not None else \
                len(np.asarray(kwargs["values"]).reshape(-1))
            return Vector.from_dense(np.ascontiguousarray(_broadcast_iso(
                kwargs["values"], n, is_iso)), dtype=dtype)
        raise ValueError(f"Invalid format: {fmt}")

    def _make_importer(fmt):  # noqa: N805 -- used at class-build time
        def _import(cls, **kwargs):
            kwargs["format"] = fmt
            return VectorSS.import_any.__func__(cls, **kwargs)

        _import.__name__ = f"import_{fmt}"
        _import.__doc__ = f"A Vector from the `{fmt}` fields."
        return classmethod(_import)

    import_sparse = _make_importer("sparse")
    import_bitmap = _make_importer("bitmap")
    import_full = _make_importer("full")
    del _make_importer

    def pack_any(self, **kwargs):
        """Refill the vector in place from a dict."""
        p = self._parent
        kwargs.setdefault("size", p.size)
        kwargs.setdefault("dtype", p.dtype)
        v = self.import_any(**kwargs)
        p._set_store(v._d_vals, v._d_valid)

    def _make_packer(fmt):  # noqa: N805
        def _pack(self, **kwargs):
            kwargs["format"] = fmt
            return VectorSS.pack_any(self, **kwargs)

        _pack.__name__ = f"pack_{fmt}"
        _pack.__doc__ = f"Refill the vector from the `{fmt}` fields."
        return _pack

    pack_sparse = _make_packer("sparse")
    pack_bitmap = _make_packer("bitmap")
    pack_full = _make_packer("full")
    del _make_packer

    # ------------------------------------------------------------------ #
    def split(self, chunks, *, name=None):
        from ..vector import Vector

        p = self._parent
        (sizes,) = normalize_chunks(chunks, p.shape)
        tiles, i0 = [], 0
        for s in sizes:
            tiles.append(Vector._from_store(p.dtype, p._vals[i0:i0 + s],
                                            p._valid[i0:i0 + s]))
            i0 += s
        return tiles

    def concat(self, tiles):
        """Fill the vector from a list of tiles (the inverse of split)."""
        from ...ss import concat as _concat

        p = self._parent
        v = _concat(list(tiles), dtype=p.dtype)
        if v.size != p.size:
            raise ValueError(f"tiles concatenate to size {v.size}, "
                             f"expected {p.size}")
        p._set_store(v._vals, v._valid)

    def build_scalar(self, indices, value):
        indices = np.asarray(indices, np.int64)
        self._parent.build(indices,
                           np.broadcast_to(np.asarray(value), indices.shape))

    def iterkeys(self, seek=0):
        idx, _ = self._parent.to_coo()
        for i in range(seek, len(idx)):
            yield int(idx[i])

    def itervalues(self, seek=0):
        _, v = self._parent.to_coo()
        for i in range(seek, len(v)):
            yield v[i]

    def iteritems(self, seek=0):
        idx, v = self._parent.to_coo()
        for i in range(seek, len(idx)):
            yield (int(idx[i]), v[i])

    def head(self, n=10, dtype=None, *, sort=False):
        idx, v = self._parent.to_coo(dtype)
        return idx[:n], v[:n]

    # ------------------------------------------------------------------ #
    def _keys(self, how):
        if how != "random":
            return None
        p = self._parent
        return torch.from_numpy(rng_keys(p.size)).to(p.device)

    def selectk(self, how, k, *, name=None):
        from ..vector import Vector

        p = self._parent
        if how not in ("first", "last", "smallest", "largest", "random"):
            raise ValueError(f"Invalid how: {how}")
        vals, ok = dense.rowwise_selectk(p._vals, p._valid, p.dtype, how,
                                         int(k), self._keys(how))
        return Vector._from_store(p.dtype, vals, ok, name=name)

    def compactify(self, how="first", size=None, *, name=None):
        from ..vector import Vector

        p = self._parent
        width = int(p._valid.sum()) if size is None else int(size)
        vals, ok = dense.rowwise_compactify(p._vals, p._valid, p.dtype, how,
                                            width, self._keys(how))
        return Vector._from_store(p.dtype, vals, ok, name=name)

    def sort(self, op="<", values=True, permutation=True, *, nthreads=None):
        from ..operator.utils import binary_from_string
        from ..vector import Vector

        if isinstance(op, str):
            op = binary_from_string(op)
        descending = getattr(op, "name", "lt") in ("gt", ">")
        p = self._parent
        c_vals, p_vals, out_ok = dense.rowwise_sort(p._vals, p._valid,
                                                    p.dtype, descending)
        outs = [Vector._from_store(p.dtype, c_vals, out_ok),
                Vector._from_store(_dt.INT64, p_vals, out_ok)]
        outs = [o for o, want in zip(outs, (values, permutation)) if want]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def serialize(self, compression="default", level=None, *, nthreads=None):
        """The JAX package's ``GBTPU1`` blob."""
        p = self._parent
        idx, v = p.to_coo()
        payload = pickle.dumps({"dtype": _dtype_key(p.dtype), "size": p.size,
                                "indices": idx, "values": v},
                               protocol=pickle.HIGHEST_PROTOCOL)
        return _blob(b"GBTPU1", payload, compression, level)

    @staticmethod
    def deserialize(data, dtype=None, *, nthreads=None):
        from ..vector import Vector

        d = _unblob(b"GBTPU1", data)
        return Vector.from_coo(d["indices"].astype(np.int64), d["values"],
                               dtype if dtype is not None else d["dtype"],
                               size=d["size"])

    def scan(self, op="plus", *, name=None):
        """The inclusive prefix scan of the stored entries, in the vector's
        structure and the op's return type."""
        from ..vector import Vector

        p = self._parent
        typed_op = _scan_op(op, p.dtype)
        idx = p._valid.nonzero().reshape(-1)
        out = spx.scan_values(torch.zeros_like(idx), p._vals[idx], typed_op,
                              p.dtype)
        vals = st.zeros_values((p.size,), typed_op.return_type, p.device)
        vals[idx] = out
        return Vector._from_store(typed_op.return_type, vals,
                                  p._valid.clone(), name=name)


def random_choice(n, k):
    """k distinct indices chosen uniformly from range(n), as uint64."""
    n, k = int(n), int(k)
    if k >= n:
        return np.arange(n, dtype=np.uint64)
    return np.random.default_rng().choice(n, size=k, replace=False).astype(
        np.uint64)
