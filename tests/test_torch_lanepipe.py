"""Lanepipe SpMV of the PyTorch port against the JAX package's lanepipe.

Kernel level: the port's plain versions of K1 (gather_mult, with its
validity output), K4 (fused_permC_scan_permA) and K5 (lane_segscan)
against the Pallas kernels in interpret mode, on the same plan arrays
(handed over with ``lanepipe.plan_from_numpy``).
Pipeline level: mxv/vxm through both public APIs, the JAX side under the
``lane_on`` pattern of tests/test_lanepipe.py so that its lanepipe runs
(on the CPU it would otherwise take another engine).  BOOL and integer
results and the output structure must match exactly; FP32 is held to
rel 1e-5, the tolerance of tests/test_lanepipe.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt
from graphblas_tpu.core.engine import lanepipe as jlp
from graphblas_tpu.core.engine import permute as jpm
from graphblas_tpu.core.engine import sortpipe as jsp
from graphblas_tpu_torch.core.engine import lanepipe as tlp

from .test_lanepipe import SEMIRINGS, lane_on, random_graph  # noqa: F401

torch.set_num_threads(1)

CARRIER = {"FP32": np.float32, "INT32": np.int32, "BOOL": np.int32,
           "UINT32": np.uint32}


def rand_values(rng, n, dtype):
    if dtype == "BOOL":
        return rng.random(n) < 0.7
    if dtype in ("INT32", "UINT32"):
        return rng.integers(0, 50, n)
    return rng.random(n).astype(np.float32)


def assert_values_match(got, want, dtype):
    """Port (idx, vals) against JAX (idx, vals): structure exactly, values
    exactly or, for FP32, to rel 1e-5."""
    gi, gv = got
    wi, wv = want
    assert np.array_equal(gi, wi)
    if dtype == "FP32":
        assert np.allclose(gv, wv, rtol=1e-5, atol=0)
    else:
        assert np.array_equal(gv, wv)


# --------------------------------------------------------------------- #
# K1 and K4 on identical plan arrays
def both_entries(r, c, v, dtype, n, dest_is_row):
    d, k = (r, c) if dest_is_row else (c, r)
    vals = np.asarray(v).astype(CARRIER[dtype])
    with jax.enable_x64(True):
        plan = jlp.build_plan(d, k, vals, n, n)
        perms = {"routeP": jpm.build_perm_plan(plan["route"]),
                 "extP": jpm.build_perm_plan(plan["ext_rank"])}
    tentry = tlp.plan_from_numpy(plan, perms, "cpu")
    jdev = {name: jnp.asarray(plan[name].astype(np.int32)
                              if plan[name].dtype == bool else plan[name])
            for name in ("meta", "idx1_g", "locidx_g", "okg", "avals_g")}
    jdev["routeP"] = jpm.plan_to_device(perms["routeP"])[1]
    return plan, tentry, jdev


def padded_u(xv, xok, dtype, n):
    ru = -(-n // tlp.WINDOW_K) * tlp.WINDOW_K
    u2 = np.zeros(ru, CARRIER[dtype])
    u2[:n] = xv
    u2ok = np.zeros(ru, np.int32)
    u2ok[:n] = xok
    return u2.reshape(-1, 128), u2ok.reshape(-1, 128)


GATHER_CASES = [
    # ring, dtype, kind, packed, full_u, permA
    ("plus_times", "FP32", "vxm", False, True, True),
    ("plus_times", "FP32", "mxv", False, False, True),
    ("min_first", "FP32", "vxm", False, False, False),
    ("lor_land", "BOOL", "vxm", True, False, True),
    ("lor_land", "BOOL", "mxv", True, False, False),
    ("plus_times", "INT32", "mxv", False, True, True),
    ("band_bor", "UINT32", "vxm", False, True, True),
]


@pytest.mark.parametrize("ring_name,dtype,kind,packed,full_u,with_pa",
                         GATHER_CASES)
def test_gather_mult_matches_pallas(rng, monkeypatch, ring_name, dtype, kind,
                                    packed, full_u, with_pa):
    monkeypatch.setattr(jlp, "_INTERPRET", True)
    n = 200
    r, c, v = random_graph(rng, n, 1500, dtype)
    plan, tentry, jdev = both_entries(r, c, v, dtype, n, kind == "mxv")
    xv = rand_values(rng, n, dtype)
    xok = np.ones(n, bool) if full_u else rng.random(n) < 0.6
    u2, u2ok = padded_u(xv, xok, dtype, n)
    jring = getattr(gbj.semiring, ring_name)[dtype]
    tring = getattr(gbt.semiring, ring_name)[dtype]
    kw = dict(kind=kind, R_g=plan["R_g"], nblocks=plan["nblocks_g"],
              packed=packed, full_u=full_u)
    jdt = jring.binaryop.type
    with jax.enable_x64(False):
        want, want_ok = jlp.gather_mult(
            tuple(jdev[k] for k in ("meta", "idx1_g", "locidx_g", "okg",
                                    "avals_g")),
            jnp.asarray(u2), jnp.asarray(u2ok), jring.binaryop, jdt, jdt,
            jring.monoid, permA=jdev["routeP"][0] if with_pa else None, **kw)
    td = tentry["dev"]
    tdt = tring.binaryop.type
    with gbt.config.set(device="cpu"):
        tu2, tu2ok = tlp.pad_u(
            gbt.Vector.from_dense(xv, dtype=dtype)._vals,
            torch.from_numpy(xok), tdt, n)
    got, got_ok = tlp.gather_mult(
        (td["meta"], td["idx1_g"], td["locidx_g"], td["okg"], td["avals_g"]),
        tu2, tu2ok, tring.binaryop, tdt, tdt, tring.monoid,
        permA=td["routeP"][0] if with_pa else None, **kw)
    want = np.asarray(want)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert (got_ok is None) == (want_ok is None)
    if want_ok is not None:
        assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))


SCAN_CASES = [("plus", "FP32", False), ("plus", "INT32", False),
              ("min", "FP32", False), ("max", "INT32", False),
              ("min", "UINT32", False), ("lor", "BOOL", True),
              ("land", "BOOL", True)]


def check_fused_scan(monkeypatch, mono_name, dtype, packed, R, layout, seed):
    """K4's plain version against the Pallas kernel in interpret mode on
    random route and extract indices and the barrier layout(rng, R):
    FP32 plus to rel 1e-5, the rest bitwise."""
    monkeypatch.setattr(jlp, "_INTERPRET", True)
    rng = np.random.default_rng(seed)
    shape = (R, 128)
    pc = rng.integers(0, 1 << 21, shape).astype(np.int32)
    pa = rng.integers(0, 1 << 21, shape).astype(np.int32)
    barrier = layout(rng, R)
    if packed:
        vals = rng.integers(0, 3, shape).astype(np.int32)
    elif dtype == "FP32":
        vals = rng.random(shape).astype(np.float32)
    else:
        vals = rng.integers(-1000, 1000, shape).astype(CARRIER[dtype])
    z_c = CARRIER[dtype]
    comb = jsp.monoid_scan_fn(mono_name, z_c)
    if packed:
        def jcombine(a, b):
            r = comb(a - 1, b - 1) + 1
            return jnp.where(a == 0, b, jnp.where(b == 0, a, r))
    else:
        def jcombine(a, b):
            r = comb(a, b)
            return r.astype(a.dtype) if r.dtype != a.dtype else r
    with jax.enable_x64(False):
        want = np.asarray(jlp.fused_permC_scan_permA(
            jnp.asarray(pc), jnp.asarray(barrier), jnp.asarray(pa),
            jnp.asarray(vals), jcombine))
    tmono = getattr(gbt.monoid, mono_name)[dtype]
    combine = tlp.combines(tmono)[1 if packed else 0]
    tvals = torch.from_numpy(vals.view(np.int32) if dtype == "UINT32"
                             else vals)
    got = tlp.fused_permC_scan_permA(
        torch.from_numpy(pc), torch.from_numpy(barrier), torch.from_numpy(pa),
        tvals, combine).numpy()
    if dtype == "FP32" and mono_name == "plus":
        assert np.allclose(got, want, rtol=1e-5, atol=0)
    else:
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("mono_name,dtype,packed", SCAN_CASES)
def test_fused_scan_matches_pallas(monkeypatch, mono_name, dtype, packed):
    """Runs that cross 128-row tiles and 512-row grid steps."""
    check_fused_scan(monkeypatch, mono_name, dtype, packed, 1024,
                     long_run_barrier, 5)


def long_run_barrier(rng, R):
    """Barriers at 1/300 and in row 0; lane 5's only barrier is row 0, so
    its run crosses every tile."""
    b = (rng.random((R, 128)) < 1 / 300).astype(np.int32)
    b[0] = 1
    b[:, 5] = 0
    b[0, 5] = 1
    return b


def barrier_tile(rng, R):
    """Barriers at 1/300 and in row 0; tile 1 has a barrier in every row
    of every lane."""
    b = long_run_barrier(rng, R)
    b[128:256] = 1
    return b


@pytest.mark.parametrize("R,layout", [(24 * 128, long_run_barrier),
                                      (512, barrier_tile)],
                         ids=["run_over_24_tiles", "tile_of_barriers"])
@pytest.mark.parametrize("mono_name,dtype,packed", [("plus", "FP32", False),
                                                    ("max", "INT32", False)])
def test_fused_scan_barrier_layouts_match_pallas(monkeypatch, R, layout,
                                                 mono_name, dtype, packed):
    """A lane's carry across 24 tiles (more than the 17 a plan's run can
    span), and a tile whose every row restarts."""
    check_fused_scan(monkeypatch, mono_name, dtype, packed, R, layout, 7)


def lane_scan_inputs(dtype, with_ok, row0_barrier=True):
    """(R,128) scan inputs whose runs cross 128-row tiles."""
    rng = np.random.default_rng(11)
    R = 512
    barrier = (rng.random((R, 128)) < 1 / 200).astype(np.int32)
    barrier[0] = 1 if row0_barrier else 0
    barrier[:, 7] = 0  # one lane's run crosses every tile
    if dtype == "FP32":
        vals = rng.random((R, 128)).astype(np.float32)
    else:
        vals = rng.integers(-1000, 1000, (R, 128)).astype(CARRIER[dtype])
    ok = (rng.random((R, 128)) < 0.3).astype(np.int32) if with_ok else None
    return barrier, vals, ok


def jax_scan_combine(mono_name, dtype):
    comb = jsp.monoid_scan_fn(mono_name, CARRIER[dtype])

    def jcombine(a, b):
        r = comb(a, b)
        return r.astype(a.dtype) if r.dtype != a.dtype else r

    return jcombine


def port_lane_segscan(barrier, vals, ok, mono_name, dtype):
    combine = tlp.combines(getattr(gbt.monoid, mono_name)[dtype])[0]
    tvals = torch.from_numpy(vals.view(np.int32) if dtype == "UINT32" else vals)
    got, got_ok = tlp.lane_segscan(
        torch.from_numpy(barrier), tvals,
        None if ok is None else torch.from_numpy(ok), combine)
    return got.numpy(), None if got_ok is None else got_ok.numpy()


def assert_scan_match(got, want, mono_name, dtype):
    if dtype == "FP32" and mono_name in ("plus", "times"):
        assert np.allclose(got, want, rtol=1e-5, atol=0)
    else:
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


LANE_SCAN_CASES = [("plus", "FP32"), ("min", "FP32"), ("plus", "INT32"),
                   ("max", "INT32"), ("min", "UINT32")]


@pytest.mark.parametrize("with_ok", [True, False])
@pytest.mark.parametrize("mono_name,dtype", LANE_SCAN_CASES)
def test_lane_segscan_matches_pallas(monkeypatch, mono_name, dtype, with_ok):
    """K5's plain version against the Pallas kernel, with the validity
    channel and with ok=None."""
    monkeypatch.setattr(jlp, "_INTERPRET", True)
    barrier, vals, ok = lane_scan_inputs(dtype, with_ok)
    with jax.enable_x64(False):
        want, want_ok = jlp.lane_segscan(
            jnp.asarray(barrier), jnp.asarray(vals),
            None if ok is None else jnp.asarray(ok),
            jax_scan_combine(mono_name, dtype))
    got, got_ok = port_lane_segscan(barrier, vals, ok, mono_name, dtype)
    assert_scan_match(got, np.asarray(want), mono_name, dtype)
    assert (got_ok is None) == (want_ok is None) == (not with_ok)
    if with_ok:
        assert np.array_equal(got_ok, np.asarray(want_ok))


@pytest.mark.parametrize("with_ok", [True, False])
@pytest.mark.parametrize("mono_name,dtype", LANE_SCAN_CASES[:3])
def test_lane_segscan_row0_without_barrier(mono_name, dtype, with_ok):
    """Row 0 starts a run whether or not its barrier is set."""
    barrier, vals, ok = lane_scan_inputs(dtype, with_ok, row0_barrier=False)
    want, want_ok = jlp._segscan_xla(
        jnp.asarray(barrier), jnp.asarray(vals),
        None if ok is None else jnp.asarray(ok),
        jax_scan_combine(mono_name, dtype))
    got, got_ok = port_lane_segscan(barrier, vals, ok, mono_name, dtype)
    assert_scan_match(got, np.asarray(want), mono_name, dtype)
    if with_ok:
        assert np.array_equal(got_ok, np.asarray(want_ok))
    # the same input with row 0 flagged gives the same scan
    barrier[0] = 1
    again, _ = port_lane_segscan(barrier, vals, ok, mono_name, dtype)
    assert np.array_equal(again.view(np.int32), got.view(np.int32))


# --------------------------------------------------------------------- #
# the pipeline through both public APIs
def both_matrices(r, c, v, dtype, n):
    with gbj.config.set(auto_sparse_limit=0):
        jA = gbj.Matrix.from_coo(r, c, v, dtype=dtype, nrows=n, ncols=n)
    assert jA._sparse is not None
    tA = gbt.Matrix.from_coo(r, c, v, dtype=dtype, nrows=n, ncols=n)
    return jA, tA


def both_vectors(xv, dtype, idx=None, n=None):
    if idx is None:
        return (gbj.Vector.from_dense(np.asarray(xv), dtype=dtype),
                gbt.Vector.from_dense(np.asarray(xv), dtype=dtype))
    return (gbj.Vector.from_coo(idx, xv, dtype=dtype, size=n),
            gbt.Vector.from_coo(idx, xv, dtype=dtype, size=n))


@pytest.fixture
def cpu():
    """The CPU, and every Matrix sparse-backed: these tests hold the SpMV
    engines, which a matrix under ``auto_sparse_limit`` would bypass."""
    with gbt.config.set(device="cpu", auto_sparse_limit=0):
        yield


@pytest.mark.parametrize("ring_name,dtype", SEMIRINGS)
def test_mxv_parity(rng, ring_name, dtype, lane_on, cpu):
    n = 200
    r, c, v = random_graph(rng, n, 1500, dtype)
    jA, tA = both_matrices(r, c, v, dtype, n)
    jx, tx = both_vectors(rand_values(rng, n, dtype), dtype)
    want = jA.mxv(jx, getattr(gbj.semiring, ring_name)[dtype]).new()
    got = tA.mxv(tx, getattr(gbt.semiring, ring_name)[dtype]).new()
    assert lane_on, "the JAX lanepipe was not used"
    assert got.dtype.name == want.dtype.name
    assert_values_match(got.to_coo(), want.to_coo(), dtype)


@pytest.mark.parametrize("mono_name,dtype", [("min", "FP32"), ("plus", "INT32")])
def test_lane_segscan_ok_beyond_0_1_matches_pallas(monkeypatch, mono_name,
                                                   dtype):
    """The validity channel is any int32, scanned by max: ok in
    [-1000, 1000], negatives included, against the Pallas kernel in
    interpret mode over three tiles (the contract K5 keeps on the card)."""
    monkeypatch.setattr(jlp, "_INTERPRET", True)
    rng = np.random.default_rng(12)
    R = 384
    barrier = (rng.random((R, 128)) < 1 / 60).astype(np.int32)
    barrier[0] = 1
    barrier[:, 3] = 0
    barrier[0, 3] = 1  # lane 3's run crosses every tile
    if dtype == "FP32":
        vals = rng.random((R, 128)).astype(np.float32)
    else:
        vals = rng.integers(-1000, 1000, (R, 128)).astype(np.int32)
    ok = rng.integers(-1000, 1001, (R, 128)).astype(np.int32)
    with jax.enable_x64(False):
        want, want_ok = jlp.lane_segscan(
            jnp.asarray(barrier), jnp.asarray(vals), jnp.asarray(ok),
            jax_scan_combine(mono_name, dtype))
    got, got_ok = port_lane_segscan(barrier, vals, ok, mono_name, dtype)
    assert_scan_match(got, np.asarray(want), mono_name, dtype)
    assert np.array_equal(got_ok, np.asarray(want_ok))
    assert (got_ok < 0).any() and (got_ok > 1).any()
