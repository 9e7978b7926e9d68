"""User-defined types in the port: the reference's tests (the twin of
tests/test_udt.py, all eight), then point and (3,)float32 collections on
both backings through the engines, export/import, ``serialize`` and
pickling against the JAX package on the same inputs, and what the JAX
package refuses against numpy.  Run on the CPU."""

import pickle

import numpy as np
import pytest

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt
from tests.test_torch_operator_grids import twin

twin("test_udt", globals())

POINT = np.dtype([("x", np.float64), ("y", np.float64)])
VEC3 = np.dtype("(3,)float32")


def _points(n, seed):
    rng = np.random.default_rng(seed)
    out = np.empty(n, POINT)
    out["x"] = rng.integers(-9, 9, n)
    out["y"] = rng.integers(-9, 9, n)
    return out


def _mats(gb, sparse=True):
    """Two point matrices of different structure (sparse-backed when
    sparse), a point vector and a (3,)float32 vector."""
    pt = gb.dtypes.register_anonymous(POINT, "torch_udt_point")
    v3 = gb.dtypes.register_anonymous(VEC3, "torch_udt_vec3")
    rng = np.random.default_rng(5)
    out = []
    with gb.config.set(auto_sparse_limit=0 if sparse else 1 << 40):
        for seed in (1, 2):
            ok = rng.random((7, 6)) < 0.4
            ok[3, :] = False
            r, c = np.nonzero(ok)
            out.append(gb.Matrix.from_coo(r, c, _points(len(r), seed),
                                          dtype=pt, nrows=7, ncols=6))
    idx = np.array([0, 2, 5])
    out.append(gb.Vector.from_coo(idx, _points(3, 3), dtype=pt, size=6))
    out.append(gb.Vector.from_coo(
        np.arange(4), rng.integers(-5, 5, (4, 3)).astype(np.float32),
        dtype=v3, size=5))
    return out


def _addpt(a, b):
    return {"x": a["x"] + b["x"], "y": a["y"] * b["y"]}


def _udt_ops(gb):
    add = gb.binary.register_anonymous(_addpt, is_udt=True)
    scale = gb.unary.register_anonymous(
        lambda a: {"x": a["x"] * 2, "y": -a["y"]}, is_udt=True)
    mono = gb.monoid.register_anonymous(
        gb.binary.register_anonymous(
            lambda a, b: {"x": a["x"] + b["x"], "y": a["y"] + b["y"]},
            is_udt=True), 0.0)
    vadd = gb.binary.register_anonymous(lambda a, b: a + b * 2, is_udt=True)
    return add, scale, mono, vadd


def _run(gb, sparse):
    A, B, u, w = _mats(gb, sparse)
    add, scale, mono, vadd = _udt_ops(gb)
    out = {
        "ewise_add": A.ewise_add(B, add).new(),
        "ewise_mult": A.ewise_mult(B, add).new(),
        "apply": A.apply(scale).new(),
        "reduce_rowwise": A.reduce_rowwise(mono).new(),
        "reduce_columnwise": A.reduce_columnwise(mono).new(),
        "transpose": A.T.new(),
        "extract": A[[0, 2, 4], [1, 3, 5]].new(),
        "any_rowwise": A.reduce_rowwise(gb.monoid.any).new(),
        "first": A.ewise_add(B, gb.binary.first).new(),
        "select": A.select(gb.select.tril, 0).new(),
        "vector_ewise": u.ewise_add(u, add).new(),
        "subarray": w.ewise_mult(w, vadd).new(),
    }
    C = A.dup()
    C[[1, 5], [0, 2]] = B[[1, 5], [0, 2]].new()
    out["assign"] = C
    D = A.dup()
    del D[2, :]
    out["delete"] = D
    E = A.dup()
    E.clear()  # the backing stays
    E(B.S) << A
    out["structural_mask"] = E
    F = A.dup()
    F.clear()
    F(B.V) << A  # a value mask over a user-defined type: its structure
    out["value_mask"] = F
    return out


def _coo(x):
    *idx, v = x.to_coo()
    return [np.asarray(i) for i in idx], v


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_udt_engines_match_jax(sparse):
    want = _run(gbj, sparse)
    with gbt.config.set(device="cpu"):
        got = _run(gbt, sparse)
    assert set(got) == set(want)
    for key in want:
        g, w = got[key], want[key]
        assert g.dtype.np_type == w.dtype.np_type, key
        (gi, gv), (wi, wv) = _coo(g), _coo(w)
        for a, b in zip(gi, wi):
            np.testing.assert_array_equal(a, b, err_msg=key)
        np.testing.assert_array_equal(gv, wv, err_msg=key)
        if g.ndim == 2:
            assert (g._sparse is not None) == sparse, key


@pytest.mark.parametrize("fmt", ["csr", "csc", "hypercsr", "coor",
                                 "bitmapr", "fullr"])
def test_udt_export_import_match_jax(fmt):
    def run(gb):
        A, _, u, _ = _mats(gb)
        if fmt == "fullr":
            A = gb.Matrix.from_dense(np.array(
                [[(1.0, 2.0), (3.0, 4.0)], [(5.0, 6.0), (7.0, 8.0)]],
                POINT), dtype=A.dtype)
        exp = A.ss.export(fmt)
        back = gb.Matrix.ss.import_any(**exp, dtype=A.dtype)
        vexp = u.ss.export("sparse")
        vback = gb.Vector.ss.import_any(**vexp, dtype=u.dtype)
        return exp, back, vback

    wexp, wback, wv = run(gbj)
    with gbt.config.set(device="cpu"):
        gexp, gback, gv = run(gbt)
    assert set(gexp) == set(wexp)
    for k in wexp:
        if isinstance(wexp[k], np.ndarray):
            np.testing.assert_array_equal(gexp[k], wexp[k], err_msg=k)
            assert gexp[k].dtype == wexp[k].dtype, k
        else:
            assert gexp[k] == wexp[k], k
    for g, w in ((gback, wback), (gv, wv)):
        for a, b in zip(g.to_coo(), w.to_coo()):
            np.testing.assert_array_equal(a, b)


def test_udt_serialize_and_pickle_match_jax():
    def run(gb):
        A, _, u, w = _mats(gb)
        blob = A.ss.serialize()
        return (blob, gb.Matrix.ss.deserialize(blob, dtype=A.dtype),
                u.ss.serialize(), w)

    wblob, wback, wvblob, ww = run(gbj)
    with gbt.config.set(device="cpu"):
        gblob, gback, gvblob, gw = run(gbt)
        # each package reads the other's blob
        cross = gbt.Matrix.ss.deserialize(wblob, dtype=gback.dtype)
        vcross = gbt.Vector.ss.deserialize(wvblob, dtype=cross.dtype)
        port_pickle = pickle.loads(pickle.dumps((gback, gw)))
    jax_back = gbj.Matrix.ss.deserialize(gblob, dtype=wback.dtype)
    for g in (gback, cross, port_pickle[0]):
        for a, b in zip(g.to_coo(), wback.to_coo()):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(jax_back.to_coo(), wback.to_coo()):
        np.testing.assert_array_equal(a, b)
    assert vcross.nvals == 3
    for a, b in zip(port_pickle[1].to_coo(), ww.to_coo()):
        np.testing.assert_array_equal(a, b)
    assert port_pickle[1].dtype.np_type == VEC3


def test_udt_where_the_reference_raises():
    """outer, kronecker, ss.flatten, an any_first mxv and ewise_union over
    a user-defined type, which the JAX package refuses (its dict values
    meet jnp calls; a reference quirk), against numpy."""
    pt = gbt.dtypes.register_anonymous(POINT, "torch_udt_point")
    add = gbt.binary.register_anonymous(
        lambda a, b: {"x": a["x"] - b["x"], "y": a["y"] + b["y"]},
        is_udt=True)
    pv = _points(3, 9)
    idx = np.array([0, 3, 5])
    with gbt.config.set(device="cpu"):
        u = gbt.Vector.from_coo(idx, pv, dtype=pt, size=6)
        O = u.outer(u, add).new()
        r, c, v = O.to_coo()
        assert np.array_equal(r, np.repeat(idx, 3))
        assert np.array_equal(c, np.tile(idx, 3))
        i, j = np.repeat(np.arange(3), 3), np.tile(np.arange(3), 3)
        assert np.array_equal(v["x"], pv["x"][i] - pv["x"][j])
        assert np.array_equal(v["y"], pv["y"][i] + pv["y"][j])
        M = gbt.Matrix.from_coo([0, 1], [1, 0], pv[:2], dtype=pt, nrows=2,
                                ncols=2)
        K = M.kronecker(M, add).new()
        kr, kc, kv = K.to_coo()
        assert K.nvals == 4 and list(zip(kr, kc)) == [(0, 3), (1, 2),
                                                      (2, 1), (3, 0)]
        pairs = [(0, 0), (0, 1), (1, 0), (1, 1)]
        assert np.array_equal(kv["x"], [pv["x"][a] - pv["x"][b]
                                        for a, b in pairs])
        fi, fv = M.ss.flatten().to_coo()
        assert np.array_equal(fi, [1, 2]) and np.array_equal(fv, pv[:2])
        w = M.mxv(gbt.Vector.from_coo([0, 1], pv[1:], dtype=pt, size=2),
                  gbt.semiring.any_first).new()
        assert np.array_equal(w.to_coo()[1], pv[:2])
        e = np.array((1.0, 2.0), POINT)[()]
        U = M.ewise_union(M.T.new(), add, e, e).new()
        assert np.array_equal(U.to_coo()[2]["x"], [pv["x"][0] - pv["x"][1],
                                                   pv["x"][1] - pv["x"][0]])
        for dup, want in ((gbt.binary.first, pv[0]), (add, None)):
            D = gbt.Vector.from_coo([1, 1, 1], pv, dtype=pt, size=2,
                                    dup_op=dup)
            got = D[1].new().value
            if want is None:  # folded left to right
                assert got["x"] == pv["x"][0] - pv["x"][1] - pv["x"][2]
                assert got["y"] == pv["y"].sum()
            else:
                assert got == want
        v3 = gbt.dtypes.register_anonymous(np.dtype("(3,)float64"),
                                           "torch_udt_v3")
        a = np.arange(12.0).reshape(4, 3)
        w = gbt.Vector.from_coo(np.arange(4), a, dtype=v3, size=4)
        vsum = gbt.monoid.register_anonymous(gbt.binary.register_anonymous(
            lambda x, y: x + y, is_udt=True), 0.0)
        np.testing.assert_array_equal(w.reduce(vsum).new().value,
                                      a.sum(axis=0))
