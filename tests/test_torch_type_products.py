"""vxm and mxv over the new types and operators through both public APIs,
dense-backed (the dense engine) and sparse-backed (the pipelines and the
generic sparse engine), against the JAX package on the same seeded
inputs: integers and BOOL exactly, FP32 within rel 1e-5.  The rings mix
operand types (BOOL x FP32 plus_times), narrow types (INT8 min_plus),
comparisons (lor_lt), the new monoids (lxor, eq, bxor) and multiplies K1
does not compile (UINT64, floordiv), which take the generic engine."""

import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt

from .test_torch_k1_types import _values

torch.set_num_threads(1)


@pytest.fixture
def cpu():
    with gbt.config.set(device="cpu"):
        yield


API_CASES = [("plus_times", "FP32", "BOOL", "FP32"),
             ("plus_times", "INT32", "BOOL", "INT32"),
             ("min_plus", "FP32", "FP32", "INT32"),
             ("plus_times", "INT8", "INT8", "INT8"),
             ("min_plus", "INT8", "INT8", "INT8"),
             ("max_minus", "UINT16", "UINT16", "UINT16"),
             ("lor_lt", "FP32", "FP32", "FP32"),
             ("lxor_land", "BOOL", "BOOL", "BOOL"),
             ("bxor_band", "UINT16", "UINT16", "UINT16"),
             ("eq_eq", "BOOL", "BOOL", "BOOL"),
             ("plus_times", "UINT64", "UINT64", "UINT64"),
             ("plus_floordiv", "INT16", "INT16", "INT16"),
             ("min_bshift", "INT16", "INT16", "INT16"),
             ("bor_bget", "UINT8", "UINT8", "UINT8")]


def _both(rng, a_t, u_t, sparse, n=60):
    # finite FP32 values: the JAX package's compiled paths rewrite x *
    # float(b) of a BOOL b as a select (see test_gather_mult_matches_pallas)
    r, c = np.nonzero(rng.random((n, n)) < 0.15)
    a = _values(rng, a_t, len(r), finite=True)
    if a_t.startswith(("INT", "UINT")):
        a[a == 0] = 1  # floordiv by 0 is the type's extreme in both
    ui = np.flatnonzero(rng.random(n) < 0.7)
    u = _values(rng, u_t, len(ui), finite=True)
    if u_t.startswith(("INT", "UINT")):
        u[u == 0] = 1
    out = []
    for gb in (gbj, gbt):
        lim = 0 if sparse else gb.config["auto_sparse_limit"]
        with gb.config.set(auto_sparse_limit=lim):
            A = gb.Matrix.from_coo(r, c, a, dtype=a_t, nrows=n, ncols=n)
        out.append((A, gb.Vector.from_coo(ui, u, dtype=u_t, size=n)))
    return out


def _same(got, want):
    assert got.dtype.name == want.dtype.name
    (gi, gv), (wi, wv) = got.to_coo(), want.to_coo()
    np.testing.assert_array_equal(gi, wi)
    if wv.dtype.kind == "f":
        np.testing.assert_allclose(gv, wv, rtol=1e-5)
    else:
        np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("ring,rt,a_t,u_t", API_CASES,
                         ids=[f"{c[0]}-{c[2]}x{c[3]}" for c in API_CASES])
def test_products_through_both_apis(cpu, ring, rt, a_t, u_t, sparse):
    (jA, jx), (tA, tx) = _both(np.random.default_rng(3), a_t, u_t, sparse)
    for kind in ("vxm", "mxv"):
        jr, tr = getattr(gbj.semiring, ring)[rt], getattr(gbt.semiring, ring)[rt]
        if kind == "vxm":
            want, got = jx.vxm(jA, jr).new(), tx.vxm(tA, tr).new()
        else:
            want, got = jA.mxv(jx, jr).new(), tA.mxv(tx, tr).new()
        assert want.nvals > 0
        _same(got, want)
