"""Host planning of the PyTorch port against the JAX package.

The port keeps its own copies of the lanepipe and Clos-permutation plan
builders and of the native coloring (graphblas_tpu_torch never imports
graphblas_tpu); these tests hold the copies to the originals array for
array on the graphs of tests/test_lanepipe.py, the SPLIT_DEG=16 two-level
case included.
"""

import jax
import numpy as np
import pytest
import torch

from graphblas_tpu import native as jnative
from graphblas_tpu.core.engine import lanepipe as jlp
from graphblas_tpu.core.engine import permute as jpm
from graphblas_tpu_torch import native as tnative
from graphblas_tpu_torch.core import dtypes as tdt
from graphblas_tpu_torch.core.engine import lanepipe as tlp
from graphblas_tpu_torch.core.engine import permute as tpm

from .test_lanepipe import random_graph

torch.set_num_threads(1)

# (n, edges, dtype) of the graphs in tests/test_lanepipe.py
GRAPHS = [(200, 1500, "FP32"), (200, 1500, "INT32"), (200, 1500, "BOOL"),
          (200, 1500, "UINT32"), (150, 1200, "FP32"), (120, 900, "FP32"),
          (100, 600, "FP32"), (256, 2000, "FP32")]
CARRIER = {"FP32": np.float32, "INT32": np.int32, "BOOL": np.int32,
           "UINT32": np.uint32}


def assert_same_dict(a, b):
    assert a.keys() == b.keys()
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, key
            assert np.array_equal(x, y), key
        else:
            assert x == y, key


def skewed_graph(rng, n=64):
    """tests/test_lanepipe.py:131: column 3 gets an edge from every row."""
    r = np.concatenate([np.arange(n), np.arange(0, n, 3)])
    c = np.concatenate([np.full(n, 3), (np.arange(0, n, 3) + 1) % n])
    lin = np.unique(r.astype(np.int64) * n + c)
    r, c = lin // n, lin % n
    return r, c, rng.random(len(r)).astype(np.float32)


def both_plans(d, k, vals, n):
    with jax.enable_x64(True):
        want = jlp.build_plan(d, k, vals, n, n)
    got = tlp.build_plan(d, k, vals, n, n)
    return got, want


@pytest.mark.parametrize("n,e,dtype", GRAPHS)
@pytest.mark.parametrize("dest_is_row", [True, False])
def test_build_plan_identical(rng, n, e, dtype, dest_is_row):
    r, c, v = random_graph(rng, n, e, dtype)
    d, k = (r, c) if dest_is_row else (c, r)
    vals = np.asarray(v).astype(CARRIER[dtype])
    got, want = both_plans(d.astype(np.int64), k.astype(np.int64), vals, n)
    assert want is not None
    assert_same_dict(got, want)


def test_build_plan_two_level_identical(rng, monkeypatch):
    monkeypatch.setattr(jlp, "SPLIT_DEG", 16)
    monkeypatch.setattr(tlp, "SPLIT_DEG", 16)
    r, c, v = skewed_graph(rng)
    got, want = both_plans(c, r, v, 64)
    assert want["two_level"] and got["two_level"]
    assert_same_dict(got, want)


def test_build_plan_over_pack_limit_is_none_in_both():
    # one destination with 5000 in-edges at the default SPLIT_DEG packs
    # its lane far beyond PACK_LIMIT
    n = 5001
    k = np.arange(1, n, dtype=np.int64)
    d = np.zeros(n - 1, np.int64)
    got, want = both_plans(d, k, np.ones(n - 1, np.float32), n)
    assert got is None and want is None


def zipf_graph(rng, n=3000, e=12000):
    """Columns from a power law (density ~ k^(-2/3)): node 0 takes about
    7% of the edges, the first 10 nodes 15%."""
    k = (n * rng.random(e) ** 3).astype(np.int64)
    lin = np.unique(rng.integers(0, n, e) * n + k)
    return lin // n, lin % n, rng.random(len(lin)).astype(np.float32)


def hub_graph(rng, n=64, hub=5):
    """Row `hub` and column 3 each hold an edge of every node, so at
    SPLIT_DEG=16 the plan is two-level in both directions."""
    r = np.concatenate([np.arange(n), np.full(n, hub)])
    c = np.concatenate([np.full(n, 3), np.arange(n)])
    lin = np.unique(r * n + c)
    return lin // n, lin % n, rng.random(len(lin)).astype(np.float32)


@pytest.mark.parametrize("pkg", ["torch", "jax"])
@pytest.mark.parametrize("dest_is_row", [True, False])
@pytest.mark.parametrize("kind", ["random", "zipf", "two_level"])
def test_gather_plan_invariants(rng, monkeypatch, kind, dest_is_row, pkg):
    """What K1 (csrc/gather_mult.cu) relies on, on the plans of both
    packages: row and column indices of the G block's 128x128 table z,
    each window's 128 rows of u inside the table pad_u makes, 7-bit fields
    in the route's stage-A index, two 128-row tiles a G block."""
    if kind == "random":
        n = 200
        r, c, v = random_graph(rng, n, 1500, "FP32")
    elif kind == "zipf":
        n = 3000
        r, c, v = zipf_graph(rng, n)
    else:
        n = 64
        monkeypatch.setattr(jlp, "SPLIT_DEG", 16)
        monkeypatch.setattr(tlp, "SPLIT_DEG", 16)
        r, c, v = hub_graph(rng, n)
    d, k = (r, c) if dest_is_row else (c, r)
    lp_, pm_ = (tlp, tpm) if pkg == "torch" else (jlp, jpm)
    with jax.enable_x64(True):
        plan = lp_.build_plan(d.astype(np.int64), k.astype(np.int64),
                              np.asarray(v, np.float32), n, n)
        assert plan is not None
        permA = pm_.build_perm_plan(plan["route"])["packed_A"]
    assert plan["two_level"] == (kind == "two_level")
    R_g, nb = plan["R_g"], plan["nblocks_g"]
    assert R_g == nb * tlp.BR_G
    for name, rows in (("locidx_g", R_g), ("idx1_g", nb * 128)):
        x = plan[name]
        assert x.shape == (rows, 128), name
        assert x.min() >= 0 and x.max() < 128, name
    u_rows = tlp.pad_u(torch.zeros(n), torch.ones(n, dtype=torch.bool),
                       tdt.FP32, n)[0].shape[0]
    wins = plan["meta"][:, 0].astype(np.int64)
    assert plan["meta"].shape == (nb, 3)
    assert wins.min() >= 0 and (wins * 128 + 128).max() <= u_rows
    assert permA.shape[0] >= R_g
    assert permA.min() >= 0 and permA.max() < 1 << 21


@pytest.mark.parametrize("T", [1, 4, 129])
def test_build_perm_plan_identical(T):
    pi = np.random.default_rng(T).permutation(T * tpm.N_TILE)
    with jax.enable_x64(True):
        want = jpm.build_perm_plan(pi)
    assert_same_dict(tpm.build_perm_plan(pi), want)


@pytest.mark.parametrize("which", ["route", "ext_rank"])
def test_build_perm_plan_of_lanepipe_plans(rng, which):
    r, c, v = random_graph(rng, 200, 1500, "FP32")
    plan = tlp.build_plan(c, r, v, 200, 200)
    with jax.enable_x64(True):
        want = jpm.build_perm_plan(plan[which])
    assert_same_dict(tpm.build_perm_plan(plan[which]), want)


def _coloring_inputs(seed, ngraphs=3, m=16, d=8):
    """ngraphs random d-regular bipartite multigraphs on m+m nodes."""
    rng = np.random.default_rng(seed)
    us, vs = [], []
    for _ in range(ngraphs):
        us.append(np.repeat(np.arange(m), d))
        vs.append(rng.permutation(np.repeat(np.arange(m), d)))
    offs = np.arange(ngraphs + 1, dtype=np.int64) * m * d
    return (np.concatenate(us).astype(np.int32),
            np.concatenate(vs).astype(np.int32), offs, m, d)


def _assert_proper(colors, u, v, offs, d):
    assert colors.min() >= 0 and colors.max() < d
    for g in range(len(offs) - 1):
        sl = slice(offs[g], offs[g + 1])
        for side in (u[sl], v[sl]):
            pairs = side.astype(np.int64) * d + colors[sl]
            assert len(np.unique(pairs)) == len(pairs)


@pytest.mark.parametrize("seed", [0, 1])
def test_clos_color_native_and_numpy(seed):
    u, v, offs, m, d = _coloring_inputs(seed)
    assert tnative.permplan_loaded()
    native = tnative.clos_color(u, v, offs, m, d)
    fallback = tnative._clos_color_py(u, v, offs, m, d)
    # both are proper colorings, and each is the JAX package's to the bit
    _assert_proper(native, u, v, offs, d)
    _assert_proper(fallback, u, v, offs, d)
    assert np.array_equal(native, jnative.clos_color(u, v, offs, m, d))
    assert np.array_equal(fallback, jnative._clos_color_py(u, v, offs, m, d))


def test_coo_helpers_match_numpy():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 300, 10000)
    cols = rng.integers(0, 300, 10000)
    perm = tnative.coo_argsort(rows, cols, 300, 300)
    assert np.array_equal(rows[perm] * 300 + cols[perm],
                          np.sort(rows * 300 + cols))
    flags, uniq = tnative.coo_mark_unique(rows[perm], cols[perm])
    assert uniq == len(np.unique(rows * 300 + cols)) == int(flags.sum())
