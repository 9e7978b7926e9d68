"""Interchange between the port and the JAX package, and what must stay
sparse.

* A dict exported by one package imports into the other, for the ten
  matrix formats and the three vector formats, with the same field names
  and array dtypes; a ``serialize`` blob of either package deserializes in
  the other (compressed or not); the port's matrix dense-backed and
  sparse-backed.
* ``split``/``gb.ss.concat``, ``flatten``/``reshape``, ``build_diag`` and
  ``gb.ss.diag`` give the JAX package's entries, and a sparse-backed
  matrix gives sparse-backed results.
* The reprs of a sparse-backed matrix, its transpose and its masks are the
  JAX package's text for the same matrix, the grid and the summary of a
  matrix over ``dense_limit``.
* A Recorder writes the same lines in both packages for the same calls.
* Pickling keeps names, types, entries and (over ``auto_sparse_limit``)
  the sparse backing.
* A spy on the dense-plane constructors (``sparse.densify`` and
  ``BaseType._dense_planes``) shows that no order operation, scan,
  split/concat, reshape, repr, export to a sparse format, serialize or
  pickle of a sparse-backed matrix builds a plane.
"""

import pickle

import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt
from graphblas_tpu_torch.core import base as port_base
from graphblas_tpu_torch.core.engine import sparse as port_sparse

torch.set_num_threads(1)

MATRIX_FORMATS = ("csr", "csc", "hypercsr", "hypercsc", "bitmapr", "bitmapc",
                  "fullr", "fullc", "coor", "cooc")
VECTOR_FORMATS = ("sparse", "bitmap", "full")
BACKINGS = {"dense": {}, "sparse": {"auto_sparse_limit": 0}}


def _coo(full=False, dtype="FP64"):
    rng = np.random.default_rng(3)
    ok = np.ones((5, 7), bool) if full else rng.random((5, 7)) < 0.4
    ok[1, :] = full
    r, c = np.nonzero(ok)
    v = (rng.integers(-8, 9, len(r)) * 0.5).astype(
        gbt.dtypes.lookup_dtype(dtype).np_type)
    return r, c, v


def _matrix(gb, full=False, dtype="FP64", name=None):
    r, c, v = _coo(full, dtype)
    return gb.Matrix.from_coo(r, c, v, dtype=dtype, nrows=5, ncols=7,
                              name=name)


def _vector(gb, full=False):
    idx = np.arange(9) if full else np.array([0, 3, 4, 8])
    return gb.Vector.from_coo(idx, np.arange(len(idx)) * 1.5, dtype="FP32",
                              size=9)


def _same(a, b):
    """Same shape, type name and entries (across packages)."""
    assert a.shape == b.shape
    assert a.dtype.name == b.dtype.name
    for x, y in zip(a.to_coo(), b.to_coo()):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _same_fields(d_port, d_ref):
    assert set(d_port) == set(d_ref)
    for k, x in d_ref.items():
        if isinstance(x, np.ndarray):
            assert d_port[k].dtype == x.dtype, (k, d_port[k].dtype, x.dtype)
            np.testing.assert_array_equal(d_port[k], x)
        else:
            assert d_port[k] == x, k


@pytest.mark.parametrize("backing", BACKINGS)
@pytest.mark.parametrize("fmt", MATRIX_FORMATS)
def test_matrix_dicts_cross_packages(fmt, backing):
    full = fmt.startswith("full")
    with gbt.config.set(device="cpu", **BACKINGS[backing]):
        A = _matrix(gbt, full)
        assert (A._sparse is not None) == (backing == "sparse")
        d_port = A.ss.export(fmt)
        jA = _matrix(gbj, full)
        d_ref = jA.ss.export(fmt)
        _same_fields(d_port, d_ref)
        _same(gbt.Matrix.ss.import_any(**d_ref), jA)
        _same(gbj.Matrix.ss.import_any(**d_port), A)
        named = dict(d_ref)
        named.pop("format")
        _same(getattr(gbt.Matrix.ss, f"import_{fmt}")(**named), A)


@pytest.mark.parametrize("fmt", VECTOR_FORMATS)
def test_vector_dicts_cross_packages(fmt):
    full = fmt == "full"
    with gbt.config.set(device="cpu"):
        v = _vector(gbt, full)
        jv = _vector(gbj, full)
        d_port, d_ref = v.ss.export(fmt), jv.ss.export(fmt)
        _same_fields(d_port, d_ref)
        _same(gbt.Vector.ss.import_any(**d_ref), jv)
        _same(gbj.Vector.ss.import_any(**d_port), v)


@pytest.mark.parametrize("compression", ["default", None])
@pytest.mark.parametrize("backing", BACKINGS)
def test_blobs_cross_packages(backing, compression):
    with gbt.config.set(device="cpu", **BACKINGS[backing]):
        A, v = _matrix(gbt, dtype="INT16"), _vector(gbt)
        jA, jv = _matrix(gbj, dtype="INT16"), _vector(gbj)
        _same(gbj.Matrix.ss.deserialize(A.ss.serialize(compression)), A)
        _same(gbj.Vector.ss.deserialize(v.ss.serialize(compression)), v)
        B = gbt.Matrix.ss.deserialize(jA.ss.serialize(compression))
        _same(B, jA)
        assert (B._sparse is not None) == (backing == "sparse")
        _same(gbt.Vector.ss.deserialize(jv.ss.serialize(compression)), jv)
        assert bytes(A.ss.serialize(None)) == bytes(jA.ss.serialize(None))


@pytest.mark.parametrize("backing", BACKINGS)
def test_layout_matches(backing):
    chunks = ([2, None], 3, [[1, 4], [3, 4]])
    with gbt.config.set(device="cpu", **BACKINGS[backing]):
        A, jA = _matrix(gbt), _matrix(gbj)
        sparse = backing == "sparse"
        for spec in chunks:
            tiles, jtiles = A.ss.split(spec), jA.ss.split(spec)
            for row, jrow in zip(tiles, jtiles):
                for t, jt in zip(row, jrow):
                    _same(t, jt)
                    assert (t._sparse is not None) == sparse
            B = gbt.ss.concat(tiles)
            _same(B, A)
            assert (B._sparse is not None) == sparse
            C = gbt.Matrix(A.dtype, *A.shape)
            C.ss.concat(tiles)
            _same(C, A)
        _same(A.ss.flatten(), jA.ss.flatten())
        _same(A.ss.flatten("columnwise"), jA.ss.flatten("columnwise"))
        for shape, order in (((7, 5), "rowwise"), ((35, 1), "rowwise"),
                             ((7, 5), "columnwise"), ((1, 35), "columnwise")):
            R = A.ss.reshape(*shape, order=order)
            _same(R, jA.ss.reshape(*shape, order=order))
            assert (R._sparse is not None) == sparse
        _same(gbt.ss.concat([[A, A], [A, A]], dtype="INT64"),
              gbj.ss.concat([[jA, jA], [jA, jA]], dtype="INT64"))
        _same(gbt.ss.concat([[A.T], [A.T]]), gbj.ss.concat([[jA.T], [jA.T]]))
        assert A.ss.is_iso == jA.ss.is_iso
        assert A.ss.format == ("csr" if sparse else "bitmapr")
        v, jv = _vector(gbt), _vector(gbj)
        _same(gbt.ss.diag(v, 2), gbj.ss.diag(jv, 2))
        _same(gbt.ss.diag(A, -1), gbj.ss.diag(jA, -1))
        D = gbt.Matrix("FP32", 1, 1)
        D.ss.build_diag(v, -1)
        _same(D, gbj.ss.diag(jv, -1))


def test_sparse_reprs_match():
    """Each repr on a fresh pair: a repr of the JAX package's transpose or
    mask densifies its sparse parent in place (and its format becomes
    bitmapr), where the port's reads the coordinates."""
    views = (lambda m: m, lambda m: m.T, lambda m: m.S, lambda m: ~m.V)
    with gbt.config.set(device="cpu", auto_sparse_limit=0), \
            gbj.config.set(auto_sparse_limit=0):
        for dtype in ("FP64", "INT8", "BOOL"):
            for view in views:
                for f in (repr, lambda x: x._repr_html_()):
                    A = _matrix(gbt, dtype=dtype, name="A")
                    jA = _matrix(gbj, dtype=dtype, name="A")
                    assert A._sparse is not None and jA._sparse is not None
                    assert f(view(A)) == f(view(jA))
        with gbt.config.set(dense_limit=10), gbj.config.set(dense_limit=10):
            for f in (repr, lambda x: x._repr_html_()):
                A, jA = _matrix(gbt, name="A"), _matrix(gbj, name="A")
                assert f(A) == f(jA)
                assert "(0, " in f(A)


def test_recorder_lines_match():
    def calls(gb):
        A = _matrix(gb, name="A")
        v = gb.Vector.from_coo([0, 3], [1.0, 2.0], size=7, name="v")
        w = gb.Vector("FP64", 5, name="w")
        with gb.Recorder() as rec:
            w << A.mxv(v, gb.semiring.min_plus)
            w(accum=gb.binary.plus) << A.reduce_rowwise(gb.monoid.max)
            A.T.new(name="AT")
            A.apply(gb.unary.ainv).new()
            A.reduce_scalar().new()
            v.ewise_mult(v).new(name="vv")
            u = gb.Vector("FP64", 7, name="u")
            u(v.S, replace=True) << A.T.mxv(w)
        return rec.data

    with gbt.config.set(device="cpu"):
        got = calls(gbt)
    assert got == calls(gbj)
    assert len(got) == 7


def test_pickle_round_trip_keeps_names_and_backings():
    with gbt.config.set(device="cpu"):
        A = _matrix(gbt, dtype="INT8", name="A")
        v = _vector(gbt)
        v.name = "v"
        s = gbt.Scalar.from_value(2**40, name="s")
        e = gbt.Scalar("FP32", name="e")
        objs = [A, v, v, s, e, gbt.binary.plus, gbt.monoid.lor,
                gbt.agg.mean, gbt.semiring.min_plus, gbt.unary.ainv["INT32"],
                gbt.dtypes.UINT64, gbt.replace]
        again = pickle.loads(pickle.dumps(objs))
        with gbt.config.set(auto_sparse_limit=20):  # 35 elements: sparse
            S = _matrix(gbt, dtype="UINT16", name="S")
            S2 = pickle.loads(pickle.dumps(S))
        for a, b in zip(objs[:2] + [S], again[:2] + [S2]):
            _same(a, b)
            assert a.name == b.name
            assert (a._sparse is None) == (b._sparse is None)
        assert S2._sparse is not None and A._sparse is None
        assert again[3].value == 2**40 and again[3].name == "s"
        assert again[4].is_empty and again[4].dtype.name == "FP32"
        assert all(a is b for a, b in zip(objs[5:], again[5:]))


def test_sparse_stays_sparse(monkeypatch):
    """No order operation, scan, split/concat, reshape, repr, sparse
    export, serialize or pickle of a sparse-backed matrix builds a dense
    plane."""
    calls = []
    real_densify = port_sparse.densify
    real_planes = port_base.BaseType._dense_planes

    def densify(*args, **kwargs):
        calls.append("densify")
        return real_densify(*args, **kwargs)

    def planes(self):
        calls.append("_dense_planes")
        return real_planes(self)

    monkeypatch.setattr(port_sparse, "densify", densify)
    monkeypatch.setattr(port_base.BaseType, "_dense_planes", planes)
    with gbt.config.set(device="cpu", auto_sparse_limit=0):
        A = _matrix(gbt, name="A")
        assert A._sparse is not None
        A.ss.sort()
        A.ss.sort(">", rowwise=False)
        A.ss.selectk("largest", 2)
        A.ss.selectk("random", 2)
        A.ss.compactify("last")
        A.ss.scan()
        A.ss.scan("max", order="columnwise")
        A.ss.scan("minus")
        gbt.ss.concat(A.ss.split([2, 4]))
        A.ss.reshape(7, 5, order="columnwise")
        repr(A), repr(A.T), repr(A.S), A._repr_html_()
        for fmt in ("csr", "csc", "hypercsr", "hypercsc", "coor", "cooc"):
            gbt.Matrix.ss.import_any(**A.ss.export(fmt))
        gbt.Matrix.ss.deserialize(A.ss.serialize())
        pickle.loads(pickle.dumps(A))
        A.ss.is_iso, A.ss.nbytes, A.ss.format, list(A.ss.iteritems())
        gbt.io.from_scipy_sparse(gbt.io.to_scipy_sparse(A))
    assert calls == []
    with gbt.config.set(device="cpu", auto_sparse_limit=0):
        A.ss.export("bitmapr")  # a dense format: the one plane asked for
    assert calls


def test_sparsity_control_moves_backing():
    with gbt.config.set(device="cpu"):
        A = _matrix(gbt)
        assert A.ss.config["sparsity_status"] == "bitmap"
        A.ss.config["sparsity_control"] = "sparse"
        assert A._sparse is not None and A.ss.format == "csr"
        _same(A, _matrix(gbj))
        A.ss.config["sparsity_control"] = "hypersparse"
        assert A.ss.format == "hypercsr"
        A.ss.config["sparsity_control"] = "full"
        assert A._sparse is None and A.ss.format == "bitmapr"
        _same(A, _matrix(gbj))


def test_scipy_csr_import_is_direct():
    scipy_sparse = pytest.importorskip("scipy.sparse")
    r, c, v = _coo()
    S = scipy_sparse.csr_array((v, (r, c)), shape=(5, 7))
    with gbt.config.set(device="cpu", auto_sparse_limit=0):
        A = gbt.io.from_scipy_sparse(S)
        assert A._sparse is not None
        _same(A, gbj.io.from_scipy_sparse(S))
        for fmt in ("csr", "csc", "coo"):
            back = gbt.io.to_scipy_sparse(A, fmt)
            assert back.format == fmt
            assert (back != S).nnz == 0
        dup = scipy_sparse.coo_array(([1.0, 2.0], ([0, 0], [1, 1])),
                                     shape=(2, 2))
        _same(gbt.io.from_scipy_sparse(dup, dup_op=gbt.binary.plus),
              gbj.io.from_scipy_sparse(dup, dup_op=gbj.binary.plus))


def test_backend_and_init():
    assert gbt.backend == "torch"
    with pytest.raises(ValueError, match="backend is 'torch'"):
        gbt.init("tpu")
    gbt.init("torch", blocking=False)
    with pytest.raises(RuntimeError):
        gbt.init("torch", blocking=True)


def test_viz_names_missing_packages():
    import importlib.util

    for fn, mod in ((gbt.viz.datashade, "datashader"),):
        if importlib.util.find_spec(mod) is None:
            with gbt.config.set(device="cpu"):
                with pytest.raises(ImportError, match=mod):
                    fn(_matrix(gbt))
    if importlib.util.find_spec("matplotlib") is not None:
        import matplotlib

        matplotlib.use("Agg")
        with gbt.config.set(device="cpu", auto_sparse_limit=0):
            ax = gbt.viz.spy(_matrix(gbt), show=False)
        assert ax is not None
