"""``parallel.dist_mxv_ring`` of the port against the JAX package's.

The port on a mesh of 8 ``cpu`` blocks, the JAX package on its 8 virtual
CPU devices, the same blocked matrix (n = 61, padded to 64) and vector
from a seed.  One case a ring, the four covering both directions of
contraction: over columns (the vector copied to every block; plus_times
FP32 mxv, max_first INT64 vxm of A.T) and over rows (partials folded with
the monoid; min_plus FP32 vxm, lor_land BOOL mxv of A.T).  Each JAX call
compiles a ``shard_map`` (6-17 s on the CPU), which is why the other
combinations are held against the port's unsharded calls in
tests/test_torch_parallel.py, which also runs the max_first case (to keep
each file near 40 s on one worker).  Validity exact, values where valid:
FP32 to rel 1e-5, INT64 and BOOL exact.
"""

import numpy as np
import pytest
import torch

import graphblas_tpu_torch as gbt
from graphblas_tpu_torch.core.engine import lanepipe as tlp
from graphblas_tpu_torch.parallel import dist_mxv_ring, make_blocked_csr, \
    make_mesh

torch.set_num_threads(1)

N = 61
CASES = [("plus_times", "FP32", "mxv", False),
         ("min_plus", "FP32", "vxm", False),
         ("lor_land", "BOOL", "mxv", True),
         ("max_first", "INT64", "vxm", True)]


@pytest.mark.parametrize("ring,dtype,kind,at", CASES[:3])
def test_dist_mxv_ring_matches_jax(monkeypatch, ring, dtype, kind, at):
    check_ring(monkeypatch, ring, dtype, kind, at)


def check_ring(monkeypatch, ring, dtype, kind, at):
    import jax
    import jax.numpy as jnp
    from graphblas_tpu.parallel import dist_mxv_ring as jring
    from graphblas_tpu.parallel import make_blocked_csr as jblocked
    from graphblas_tpu.parallel import make_mesh as jmesh

    monkeypatch.setattr(tlp, "PACK_LIMIT", -1e9)  # the sort pipeline
    rng = np.random.default_rng(5)
    lin = np.unique(rng.integers(0, N * N, 500))
    r, c = lin // N, lin % N
    np_dt = gbt.dtypes.lookup_dtype(dtype).np_type
    v = (rng.random(len(r)) * 50).astype(np_dt)
    x = (rng.random(N) * 10).astype(np_dt)
    x_ok = rng.random(N) < 0.8
    with gbt.config.set(device="cpu"):
        tb = make_blocked_csr((r, c, v, N), make_mesh(
            (8,), devices=[torch.device("cpu")] * 8), dtype=np_dt)
        got, got_ok = dist_mxv_ring(tb, torch.from_numpy(x),
                                    torch.from_numpy(x_ok), ring, kind=kind,
                                    at=at)
    with jax.enable_x64(True):
        jb = jblocked((r, c, v, N), jmesh((8,), ("i",)), dtype=np_dt)
        want, want_ok = jring(jb, jnp.asarray(x), jnp.asarray(x_ok), ring,
                              kind=kind, at=at)
        want, want_ok = np.asarray(want), np.asarray(want_ok)
    assert got.shape == got_ok.shape == want.shape == (64,)
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    g, w = got.numpy()[want_ok], want[want_ok]
    assert g.dtype == w.dtype
    if dtype == "FP32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
    else:
        np.testing.assert_array_equal(g, w)
    assert want_ok.any() and not want_ok[N:].any()
