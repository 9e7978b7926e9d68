"""The PyTorch port's dense engine against the JAX package's.

Engine level: ``dense.semiring_matmul`` of both packages on the same numpy
planes (values and validity from a seed, an empty row of A, and an
all-missing B) for the library products (plus_times, lor_land, the pair
rings), the four tropical rings, which the port sends to kernel K7's plain
version, and rings only the generic blocked product takes (positional
multiplies and the ``any`` monoid among them).
API level, at n <= 256: ``from_dense``/``from_coo``, ``mxm`` with ``.T`` on
either side and under mask, accum and replace, ``mxv``/``vxm``/``inner``,
``power``, element-wise operations, reduces, ``diag``, and the all-pairs
shortest-path loop under ``ss.iterate``.

Tolerances: output structure, BOOL, integer and min/max results exact (one
rounding per product, order-independent reduce); FP32 ``plus_times`` and
``plus`` reduces to rel 1e-5 (sums run in another order).  Stored NaN and
infinities are held exactly at shapes the JAX package's blocked product
takes as one k-block: across blocks it joins with ``fmin``, so there a
NaN's fate depends on the block size, where the port always propagates it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt
from graphblas_tpu.core.engine import dense as jdense
from graphblas_tpu_torch.core.engine import dense as tdense
from graphblas_tpu_torch.core.engine import tropical as ttr

torch.set_num_threads(1)

M, K, N = 24, 40, 16  # one k-block of the generic product in both packages


@pytest.fixture
def cpu():
    with gbt.config.set(device="cpu"):
        yield


def planes(seed, shape, dtype, p_valid=0.6, special=False):
    rng = np.random.default_rng(seed)
    if dtype == "BOOL":
        v = rng.random(shape) < 0.6
    elif dtype in ("INT32", "INT64"):
        v = rng.integers(-20, 20, shape)
    else:
        # positive, so that sums do not cancel and rel 1e-5 is meaningful
        v = rng.random(shape) * 4 + 0.5
        if special:
            v = rng.standard_normal(shape) * 4
            pick = rng.random(shape)
            v[pick < 0.05] = np.inf
            v[(pick >= 0.05) & (pick < 0.1)] = -np.inf
            v[(pick >= 0.1) & (pick < 0.13)] = np.nan
    v = v.astype(gbt.dtypes.lookup_dtype(dtype).np_type)
    return v, rng.random(shape) < p_valid


def ring_of(gb, name):
    """A semiring by name; the positional ones live under ``semiring.ss``."""
    ns = gb.semiring.ss if name[-1] in "ij" and "_" in name and \
        name.split("_")[1][:-1] in ("first", "second") else gb.semiring
    return getattr(ns, name)


def both_products(ring_name, dtype, a, aok, b, bok):
    """(port values, port valid, JAX values, JAX valid, port ring)."""
    jring = ring_of(gbj, ring_name)[dtype]
    tring = ring_of(gbt, ring_name)[dtype]
    jdt = gbj.dtypes.lookup_dtype(dtype)
    tdt = gbt.dtypes.lookup_dtype(dtype)
    with jax.enable_x64(True):
        jv, jok = jdense.semiring_matmul(jnp.asarray(a), jnp.asarray(aok),
                                         jnp.asarray(b), jnp.asarray(bok),
                                         jring, jdt, jdt)
        jv, jok = np.asarray(jv), np.asarray(jok)
    tv, tok = tdense.semiring_matmul(
        torch.from_numpy(a), torch.from_numpy(aok), torch.from_numpy(b),
        torch.from_numpy(bok), tring, tdt, tdt)
    assert jring.return_type.name == tring.return_type.name
    return tv.numpy(), tok.numpy(), jv, jok, tring


def assert_product(tv, tok, jv, jok, rel=None):
    assert np.array_equal(tok, jok)
    assert tv.dtype == jv.dtype
    g, w = tv[jok], jv[jok]
    if rel is None:
        assert ((g == w) | (np.isnan(g) & np.isnan(w))).all()
    else:
        assert np.allclose(g, w, rtol=rel, atol=0, equal_nan=True)


RINGS = [
    ("plus_times", "FP32", 1e-5), ("plus_times", "FP64", 1e-12),
    ("plus_times", "INT32", None), ("plus_times", "INT64", None),
    ("lor_land", "BOOL", None), ("plus_pair", "FP32", None),
    ("plus_pair", "INT64", None), ("any_pair", "INT32", None),
    ("min_plus", "FP32", None), ("max_plus", "FP32", None),
    ("min_max", "FP32", None), ("max_min", "FP32", None),
    ("min_plus", "FP64", None), ("min_plus", "INT32", None),
    ("min_times", "FP32", None), ("max_times", "FP32", None),
    ("min_first", "FP32", None), ("min_second", "INT64", None),
    ("plus_plus", "INT32", None), ("plus_min", "INT64", None),
    ("min_secondi", "FP32", None), ("any_firstj", "FP32", None),
    ("any_secondj", "BOOL", None), ("min_firsti", "INT64", None),
]


@pytest.mark.parametrize("ring_name,dtype,rel", RINGS)
def test_semiring_matmul_parity(ring_name, dtype, rel):
    a, aok = planes(1, (M, K), dtype)
    b, bok = planes(2, (K, N), dtype)
    aok[3, :] = False          # an empty row of A
    before = ttr.plain_calls
    tv, tok, jv, jok, tring = both_products(ring_name, dtype, a, aok, b, bok)
    assert not tok[3].any() and tok.any()
    assert_product(tv, tok, jv, jok, rel)
    tropical = (ring_name in ("min_plus", "max_plus", "min_max", "max_min")
                and tring.binaryop.type.is_float)
    assert ttr.plain_calls == before + tropical  # only those rings take K7
    # an all-missing operand: no output entry, in both packages
    tv, tok, jv, jok, _ = both_products(ring_name, dtype, a, aok, b,
                                        np.zeros_like(bok))
    assert not tok.any() and not jok.any()


@pytest.mark.parametrize("ring_name,rel", [
    ("min_plus", None), ("max_plus", None), ("min_max", None),
    ("max_min", None), ("min_times", None), ("plus_min", 1e-5)])
def test_semiring_matmul_stored_inf_and_nan(ring_name, rel):
    a, aok = planes(3, (M, K), "FP32", special=True)
    b, bok = planes(4, (K, N), "FP32", special=True)
    tv, tok, jv, jok, _ = both_products(ring_name, "FP32", a, aok, b, bok)
    assert np.isnan(jv[jok]).any() and np.isinf(jv[jok]).any()
    assert_product(tv, tok, jv, jok, rel)


@pytest.mark.parametrize("ring_name", ["min_plus", "min_times"])
def test_semiring_matmul_several_k_blocks(ring_name):
    """128 x 600 x 128: three k-blocks of the generic product."""
    assert tdense._matmul_block_size(128, 600, 128) == 256 == \
        jdense._matmul_block_size(128, 600, 128)
    a, aok = planes(5, (128, 600), "FP32", p_valid=0.02)
    b, bok = planes(6, (600, 128), "FP32", p_valid=0.02)
    tv, tok, jv, jok, _ = both_products(ring_name, "FP32", a, aok, b, bok)
    assert 0 < tok.sum() < tok.size
    assert_product(tv, tok, jv, jok)


# --------------------------------------------------------------------- #
# through both public APIs
def port_matrix_of(jA):
    """A dense store of the JAX package as a port Matrix: its host arrays
    through ``from_dense``, then the validity plane."""
    vals, ok = jA._host_arrays()
    tA = gbt.Matrix.from_dense(vals, dtype=jA.dtype.name)
    tA._set_store(tA._vals, torch.from_numpy(ok.copy()))
    return tA


def random_matrices(seed, shape, dtype, density=0.3):
    rng = np.random.default_rng(seed)
    nr, nc = shape
    nnz = max(1, int(nr * nc * density))
    lin = rng.choice(nr * nc, nnz, replace=False)
    r, c = lin // nc, lin % nc
    if dtype == "BOOL":
        v = rng.random(nnz) < 0.7
    elif dtype.startswith("INT"):
        v = rng.integers(-9, 9, nnz)
    else:
        v = rng.random(nnz) + 0.5  # positive: sums do not cancel
    jA = gbj.Matrix.from_coo(r, c, v, dtype=dtype, nrows=nr, ncols=nc)
    assert jA._sparse is None
    tA = gbt.Matrix.from_coo(r, c, v, dtype=dtype, nrows=nr, ncols=nc)
    assert tA._sparse is None
    return jA, tA


def assert_same_collection(got, want, rel=None):
    """Port collection against JAX collection: dtype and structure exactly,
    values exactly or to rel."""
    assert got.dtype.name == want.dtype.name
    assert tuple(got.shape) == tuple(want.shape)
    g, w = got.to_coo(), want.to_coo()
    for gi, wi in zip(g[:-1], w[:-1]):
        assert np.array_equal(gi, wi)
    if rel is None:
        assert np.array_equal(g[-1], w[-1], equal_nan=g[-1].dtype.kind == "f")
    else:
        assert np.allclose(g[-1], w[-1], rtol=rel, atol=0)


def test_constructors_and_exports(cpu):
    jA, tA = random_matrices(1, (30, 20), "FP32")
    assert_same_collection(tA, jA)
    assert tA.nvals == jA.nvals == 180
    assert_same_collection(port_matrix_of(jA), jA)
    assert np.array_equal(tA.to_dense(fill_value=-1), jA.to_dense(fill_value=-1))
    with pytest.raises(TypeError, match="fill_value"):
        tA.to_dense()
    d = np.arange(12, dtype=np.int64).reshape(3, 4) % 5
    jD = gbj.Matrix.from_dense(d, missing_value=0)
    tD = gbt.Matrix.from_dense(d, missing_value=0)
    assert_same_collection(tD, jD)
    assert tD.dtype.name == "INT64" and tD.nvals == 9
    assert np.array_equal(tD.T.to_dense(fill_value=7), jD.T.to_dense(fill_value=7))
    with pytest.raises(TypeError, match="2-dimensional"):
        gbt.Matrix.from_dense(np.arange(3))
    jS = gbj.Matrix.from_scalar(2.5, 3, 2, dtype="FP32")
    tS = gbt.Matrix.from_scalar(2.5, 3, 2, dtype="FP32")
    assert_same_collection(tS, jS)
    assert tA[3, 4].new().value == jA[3, 4].new().value
    i, j = (int(x[0]) for x in tA.to_coo()[:2])
    assert tA[i, j].new().value == jA[i, j].new().value
    with pytest.raises(IndexError):
        tA[30, 0]
    assert_same_collection(tA[:, 0].new(), jA[:, 0].new())
    # two backings: dense under auto_sparse_limit, sparse above it
    with gbt.config.set(auto_sparse_limit=100):
        assert gbt.Matrix("FP32", 10, 10)._sparse is None
        big = gbt.Matrix.from_coo([0, 10], [1, 9], [1.0, 2.0], nrows=11,
                                  ncols=11)
        assert big._sparse is not None and big.nvals == 2
        assert big.dup()._sparse is big._sparse
        assert big.to_dense(fill_value=0).sum() == 3.0


def test_dup_isequal_isclose(cpu):
    jA, tA = random_matrices(2, (12, 9), "FP32")
    B = tA.dup()
    assert B.isequal(tA) and B.isclose(tA) and B._vals is not tA._vals
    C = tA.dup(dtype="FP64")
    assert C.dtype.name == "FP64" and C.isequal(tA)
    assert not C.isequal(tA, check_dtype=True)
    assert tA.dup(clear=True).nvals == 0
    assert_same_collection(tA.dup(mask=tA.V), jA.dup(mask=jA.V))
    assert not tA.isequal(tA.T.new().T.new().dup(clear=True))
    assert tA.T.new().T.new().isequal(tA)
    assert tA.T.isequal(tA.T.new()) and tA.T.isclose(tA.T)
    assert not tA.isequal(gbt.Matrix("FP32", 9, 12))
    with pytest.raises(TypeError):
        tA.isequal(3)


MXM_RINGS = [("plus_times", "FP32", 1e-5), ("min_plus", "FP32", None),
             ("max_min", "FP32", None), ("lor_land", "BOOL", None),
             ("plus_times", "INT64", None), ("min_secondi", "FP32", None)]


@pytest.mark.parametrize("at,bt", [(False, False), (True, False),
                                   (False, True), (True, True)])
@pytest.mark.parametrize("ring_name,dtype,rel", MXM_RINGS)
def test_mxm_parity(ring_name, dtype, rel, at, bt, cpu):
    jA, tA = random_matrices(3, (20, 32) if not at else (32, 20), dtype)
    jB, tB = random_matrices(4, (32, 14) if not bt else (14, 32), dtype)
    jr, tr = ring_of(gbj, ring_name), ring_of(gbt, ring_name)
    want = (jA.T if at else jA).mxm(jB.T if bt else jB, jr).new()
    got = (tA.T if at else tA).mxm(tB.T if bt else tB, tr).new()
    assert got.shape == (20, 14)
    assert_same_collection(got, want, rel)


def test_mxm_mask_accum_replace(cpu):
    jA, tA = random_matrices(5, (25, 25), "FP32", 0.2)
    jM, tM = random_matrices(6, (25, 25), "BOOL", 0.5)
    jr, tr = gbj.semiring.min_plus, gbt.semiring.min_plus
    for kw in ({}, {"accum": "min"}, {"mask": "S"}, {"mask": "V"},
               {"mask": "~S", "replace": True},
               {"mask": "V", "accum": "plus", "replace": True}):
        outs = []
        for gb, A, Mk, ring in ((gbj, jA, jM, jr), (gbt, tA, tM, tr)):
            C = A.dup()
            mask = {None: None, "S": Mk.S, "V": Mk.V, "~S": ~Mk.S}[kw.get("mask")]
            accum = getattr(gb.binary, kw["accum"]) if "accum" in kw else None
            C(mask=mask, accum=accum, replace=kw.get("replace", False)) \
                << A.mxm(A, ring)
            outs.append(C)
        assert_same_collection(outs[1], outs[0], 1e-6)
    want = jA.mxm(jA, jr).new(mask=jM.S)
    got = tA.mxm(tA, tr).new(mask=tM.S)
    assert_same_collection(got, want)
    C = tA.dup()
    C << tA.T                      # a transposed view on the right of <<
    assert C.isequal(tA.T.new())
    with pytest.raises(gbt.exceptions.DimensionMismatch):
        tA(mask=gbt.Matrix("BOOL", 3, 3).S) << tA.mxm(tA)


@pytest.mark.parametrize("ring_name,dtype,rel", MXM_RINGS[:5])
def test_mxv_vxm_inner_parity(ring_name, dtype, rel, cpu):
    rng = np.random.default_rng(7)
    jA, tA = random_matrices(8, (18, 26), dtype)
    jr = getattr(gbj.semiring, ring_name)
    tr = getattr(gbt.semiring, ring_name)

    def vectors(size):
        idx = np.sort(rng.choice(size, size * 2 // 3, replace=False))
        v = (rng.random(len(idx)) < 0.7) if dtype == "BOOL" else \
            rng.integers(1, 9, len(idx))
        return (gbj.Vector.from_coo(idx, v, dtype=dtype, size=size),
                gbt.Vector.from_coo(idx, v, dtype=dtype, size=size))

    ju, tu = vectors(26)
    jw, tw = vectors(18)
    assert_same_collection(tA.mxv(tu, tr).new(), jA.mxv(ju, jr).new(), rel)
    assert_same_collection(tA.T.mxv(tw, tr).new(), jA.T.mxv(jw, jr).new(), rel)
    assert_same_collection(tw.vxm(tA, tr).new(), jw.vxm(jA, jr).new(), rel)
    assert_same_collection(tu.vxm(tA.T, tr).new(), ju.vxm(jA.T, jr).new(), rel)
    ju2, tu2 = vectors(26)
    want = ju.inner(ju2, jr).new().value
    got = tu.inner(tu2, tr).new().value
    assert got == (pytest.approx(want, rel=rel) if rel else want)
    with pytest.raises(gbt.exceptions.DimensionMismatch):
        tA.mxv(tw, tr)
    with pytest.raises(gbt.exceptions.DimensionMismatch):
        tu.inner(tw, tr)
    with pytest.raises(TypeError):
        tA.mxv(tA, tr)


def apsp_graph(n, seed=0):
    """A ring plus random chords with positive weights, zero diagonal."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.arange(n), rng.integers(0, n, 2 * n)])
    dst = np.concatenate([(np.arange(n) + 1) % n, rng.integers(0, n, 2 * n)])
    keep = src != dst
    lin = np.unique(src[keep] * n + dst[keep])
    src, dst = lin // n, lin % n
    w = (rng.random(len(src)) + 0.1).astype(np.float32)
    return (np.concatenate([src, np.arange(n)]),
            np.concatenate([dst, np.arange(n)]),
            np.concatenate([w, np.zeros(n, np.float32)]))


@pytest.mark.parametrize("n,sparse", [(40, False), (40, True), (13, False)])
def test_power_min_plus_is_apsp(n, sparse, cpu):
    """power(n) over min_plus against the JAX package and scipy; a
    sparse-backed operand is densified under dense_limit."""
    import scipy.sparse as sps
    from scipy.sparse.csgraph import shortest_path

    src, dst, w = apsp_graph(n)
    limit = 0 if sparse else 1 << 22
    with gbj.config.set(auto_sparse_limit=limit), \
            gbt.config.set(auto_sparse_limit=limit):
        jA = gbj.Matrix.from_coo(src, dst, w, dtype="FP32", nrows=n, ncols=n)
        tA = gbt.Matrix.from_coo(src, dst, w, dtype="FP32", nrows=n, ncols=n)
    assert (tA._sparse is not None) == sparse
    before = ttr.plain_calls
    got = tA.power(n, gbt.semiring.min_plus["FP32"]).new()
    products = ttr.plain_calls - before
    assert products == (n.bit_length() - 1) + bin(n).count("1") - 1
    want = jA.power(n, gbj.semiring.min_plus["FP32"]).new()
    assert_same_collection(got, want)
    off = src != dst
    ref = shortest_path(sps.csr_matrix((w[off].astype(np.float64),
                                        (src[off], dst[off])), shape=(n, n)))
    assert got.nvals == n * n  # the ring reaches every node
    assert np.allclose(got.to_dense(), ref, rtol=1e-5, atol=0)
    # the closure over lor_land takes the library product
    jB = gbj.Matrix.from_coo(src, dst, np.ones(len(src), bool), dtype="BOOL",
                             nrows=n, ncols=n)
    tB = gbt.Matrix.from_coo(src, dst, np.ones(len(src), bool), dtype="BOOL",
                             nrows=n, ncols=n)
    assert_same_collection(tB.power(n, gbt.semiring.lor_land["BOOL"]).new(),
                           jB.power(n, gbj.semiring.lor_land["BOOL"]).new())
    assert_same_collection(tA.T.power(3, gbt.semiring.max_plus).new(),
                           jA.T.power(3, gbj.semiring.max_plus).new(), 1e-6)


def test_power_error_contract(cpu):
    jA, tA = random_matrices(9, (5, 5), "FP32")
    for gb, A in ((gbj, jA), (gbt, tA)):
        with pytest.raises(TypeError, match="positive integer"):
            A.power(1.5)
        with pytest.raises(TypeError, match="positive integer"):
            A.power(True)
        with pytest.raises(ValueError, match="positive integer"):
            A.power(0)
        with pytest.raises(ValueError, match="positive integer"):
            A.power(-1)
    with pytest.raises(gbj.exceptions.DimensionMismatch):
        gbj.Matrix("FP32", 2, 3).power(2)
    with pytest.raises(gbt.exceptions.DimensionMismatch):
        gbt.Matrix("FP32", 2, 3).power(2)
    assert_same_collection(tA.power(1).new(), jA.power(1).new())
    assert_same_collection(tA.power(5).new(), jA.power(5).new(), 1e-5)
    assert_same_collection(tA.power(np.int64(2)).new(dtype="FP64"),
                           jA.power(np.int64(2)).new(dtype="FP64"), 1e-5)


def test_apsp_loop_under_iterate(cpu):
    """D(accum=min) << D.mxm(D, min_plus) as an ss.iterate body with the
    Matrix as loop state, on both packages."""
    n = 24
    src, dst, w = apsp_graph(n, seed=3)
    outs = []
    for gb in (gbj, gbt):
        A = gb.Matrix.from_coo(src, dst, w, dtype="FP32", nrows=n, ncols=n)
        D = A.dup()
        ring = gb.semiring.min_plus["FP32"]

        def body(s, i, gb=gb, ring=ring):
            s["D"](accum=gb.binary.min) << s["D"].mxm(s["D"], ring)

        it = gb.ss.iterate(body, {"D": D}, max_iter=5)  # 2**5 >= n hops
        assert int(it) == 5
        outs.append((D, A))
    (jD, jA), (tD, tA) = outs
    assert_same_collection(tD, jD)
    assert tD.isequal(tA.power(n, gbt.semiring.min_plus).new())
    # a plain-Python cond on the port: stop once a product changes nothing
    D = tA.dup()
    seen = {}

    def body(s, i):
        seen["prev"] = s["D"].dup()
        s["D"](accum=gbt.binary.min) << s["D"].mxm(s["D"],
                                                     gbt.semiring.min_plus)

    def changed(s, i):
        return gbt.Scalar.from_value(not s["D"].isequal(seen["prev"]))

    it = gbt.ss.iterate(body, {"D": D}, cond=changed, max_iter=20)
    assert 2 <= it <= 6 and D.isequal(tD)


@pytest.mark.parametrize("dtype,op", [("FP32", "plus"), ("FP32", "min"),
                                      ("INT64", "times"), ("BOOL", "lor"),
                                      ("INT32", "first")])
def test_ewise_parity(dtype, op, cpu):
    jA, tA = random_matrices(10, (15, 11), dtype, 0.4)
    jB, tB = random_matrices(11, (15, 11), dtype, 0.4)
    jC, tC = random_matrices(12, (11, 15), dtype, 0.4)
    jo, to = getattr(gbj.binary, op), getattr(gbt.binary, op)
    rel = 1e-6 if dtype == "FP32" and op == "plus" else None
    assert_same_collection(tA.ewise_add(tB, to).new(),
                           jA.ewise_add(jB, jo).new(), rel)
    assert_same_collection(tA.ewise_mult(tB, to).new(),
                           jA.ewise_mult(jB, jo).new(), rel)
    assert_same_collection(tA.ewise_add(tC.T, to).new(),
                           jA.ewise_add(jC.T, jo).new(), rel)
    assert_same_collection(tC.T.ewise_mult(tA, to).new(),
                           jC.T.ewise_mult(jA, jo).new(), rel)
    if dtype != "BOOL":
        assert_same_collection(tA.ewise_union(tB, to, 2, 3).new(),
                               jA.ewise_union(jB, jo, 2, 3).new(), rel)
    with pytest.raises(gbt.exceptions.DimensionMismatch):
        tA.ewise_add(tC, to)
    with pytest.raises(TypeError):
        tA.ewise_mult(3, to)


def test_binary_min_max_ignore_nan(cpu):
    """GraphBLAS min/max as binary ops skip a NaN operand, in both."""
    a = np.array([[np.nan, 1.0, 5.0]], np.float32)
    b = np.array([[2.0, np.nan, 3.0]], np.float32)
    for op, want in (("min", [2.0, 1.0, 3.0]), ("max", [2.0, 1.0, 5.0])):
        j = gbj.Matrix.from_dense(a).ewise_mult(
            gbj.Matrix.from_dense(b), getattr(gbj.binary, op)).new()
        t = gbt.Matrix.from_dense(a).ewise_mult(
            gbt.Matrix.from_dense(b), getattr(gbt.binary, op)).new()
        assert t.to_dense().tolist() == j.to_dense().tolist() == [want]


@pytest.mark.parametrize("dtype,mono,rel", [
    ("FP32", "plus", 1e-5), ("FP32", "min", None), ("INT64", "times", None),
    ("INT32", "max", None), ("BOOL", "lor", None), ("BOOL", "land", None),
    ("FP32", "any", None), ("FP64", "plus", 1e-12)])
def test_dense_reduce_parity(dtype, mono, rel, cpu):
    jA, tA = random_matrices(13, (17, 12), dtype, 0.25)
    jm, tm = getattr(gbj.monoid, mono), getattr(gbt.monoid, mono)
    assert_same_collection(tA.reduce_rowwise(tm).new(),
                           jA.reduce_rowwise(jm).new(), rel)
    assert_same_collection(tA.reduce_columnwise(tm).new(),
                           jA.reduce_columnwise(jm).new(), rel)
    assert_same_collection(tA.T.reduce_rowwise(tm).new(),
                           jA.T.reduce_rowwise(jm).new(), rel)
    want = jA.reduce_scalar(jm).new().value
    got = tA.reduce_scalar(tm).new().value
    assert got == (pytest.approx(want, rel=rel) if rel else want)
    assert tA.T.reduce_scalar(tm).new().value == got
    empty = gbt.Matrix(dtype, 3, 4)
    assert empty.reduce_scalar(tm).new().value is None
    assert empty.reduce_rowwise(tm).new().nvals == 0
    if mono != "any":
        assert empty.reduce_scalar(tm, allow_empty=False).new().value == \
            gbj.Matrix(dtype, 3, 4).reduce_scalar(
                jm, allow_empty=False).new().value


@pytest.mark.parametrize("k", [0, 2, -3, 40])
def test_diag(k, cpu):
    jA, tA = random_matrices(14, (9, 13), "INT64", 0.5)
    assert_same_collection(tA.diag(k), jA.diag(k))


def test_limits_and_not_ported(cpu):
    with gbt.config.set(auto_sparse_limit=0):
        S = gbt.Matrix.from_coo([0, 1, 2], [1, 2, 0], [1.0, 2.0, 3.0],
                                dtype="FP32", nrows=3, ncols=3)
        D = gbt.Matrix.from_dense(np.ones((3, 3), np.float32))
    assert S._sparse is not None and D._sparse is None
    # mxm with a sparse operand is SpGEMM: the result stays sparse, and the
    # dense operand takes a sparse backing (as in the JAX package)
    with gbj.config.set(auto_sparse_limit=0):
        jS = gbj.Matrix.from_coo([0, 1, 2], [1, 2, 0], [1.0, 2.0, 3.0],
                                 dtype="FP32", nrows=3, ncols=3)
        jD = gbj.Matrix.from_dense(np.ones((3, 3), np.float32))
    for got, want in ((S.mxm(S), jS.mxm(jS)), (S.mxm(D), jS.mxm(jD)),
                      (D.mxm(S.T, gbt.semiring.min_plus),
                       jD.mxm(jS.T, gbj.semiring.min_plus))):
        got = got.new()
        assert got._sparse is not None
        assert_same_collection(got, want.new())
    assert S._sparse is not None and D._sparse is not None
    D = gbt.Matrix.from_dense(np.ones((3, 3), np.float32))
    with gbt.config.set(dense_limit=8):
        with pytest.raises(gbt.exceptions.OutOfMemory, match="dense_limit=8"):
            S.power(2).new()
        with pytest.raises(gbt.exceptions.OutOfMemory):
            S.S._as_array()
    assert S._sparse is not None
    got = S.power(3, gbt.semiring.min_plus).new()   # densifies under the limit
    assert got.to_coo()[2].tolist() == [6.0, 6.0, 6.0]
    assert S._sparse is None
    jD3 = gbj.Matrix.from_dense(np.ones((3, 3), np.float32))
    for call in (lambda M: M.kronecker(M), lambda M: M.reposition(1, 1)):
        assert_same_collection(call(D).new(), call(jD3).new())
    # select and apply on a dense-backed matrix: the dense engine's twins
    jD = gbj.Matrix.from_dense(-np.arange(9, dtype=np.float32).reshape(3, 3))
    D = gbt.Matrix.from_dense(-np.arange(9, dtype=np.float32).reshape(3, 3))
    for name, call in (("tril", lambda A: A.select("tril")),
                       ("abs", lambda A: A.apply("abs"))):
        got = call(D).new()
        assert got._sparse is None, name
        assert_same_collection(got, call(jD).new())
    assert gbt.config["dense_limit"] == 1 << 26 == gbj.config["dense_limit"]
    assert gbt.config["auto_sparse_limit"] == 1 << 22
