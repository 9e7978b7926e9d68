"""Clos permutation kernels of the PyTorch port against the Pallas kernels.

The port's plain versions of K2 (tile_perm) and K3 (mid_perm) run on the
CPU; the JAX package's Pallas kernels run in interpret mode on the same
plan arrays, and the whole apply_perm composition is held against the JAX
package's XLA reference ``permute._apply_xla``.  Permutations move bits:
everything must be bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphblas_tpu.core.engine import permute as jpm
from graphblas_tpu_torch.core.engine import permute as tpm

torch.set_num_threads(1)

L_MIN = 4 * tpm.N_TILE  # the smallest lanepipe plan (T=4)


@pytest.fixture(scope="module")
def plan():
    """One random permutation of L_MIN and both packages' plan tensors."""
    pi = np.random.default_rng(7).permutation(L_MIN)
    with jax.enable_x64(True):
        host = jpm.build_perm_plan(pi)
    meta, jdev = jpm.plan_to_device(host)
    tmeta, tdev = tpm.plan_to_device(host, "cpu")
    return pi, meta, jdev, tmeta, tdev


def rand_arrays(seed, dtype, rows=L_MIN // 128):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.standard_normal((rows, 128)).astype(np.float32)
    return rng.integers(-2**31, 2**31, (rows, 128)).astype(np.int32)


def bitwise_equal(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("stage", [0, 2])
@pytest.mark.parametrize("nch", [1, 2])
def test_tile_perm_matches_pallas(plan, stage, nch):
    _, _, jdev, _, tdev = plan
    xs = [rand_arrays(10 + c, np.float32 if c else np.int32)
          for c in range(nch)]
    want = jpm._tile_perm_pallas(jdev[stage], [jnp.asarray(x) for x in xs],
                                 True)
    if nch == 1:
        want = [want]
    got = tpm.tile_perm(tdev[stage], [torch.from_numpy(x) for x in xs])
    for g, w in zip(got, want):
        bitwise_equal(g, w)


@pytest.mark.parametrize("out_T", [None, 2, 1])
def test_mid_perm_matches_pallas(plan, out_T):
    _, meta, jdev, _, tdev = plan
    T, T128, T_pad = meta["T"], meta["T128"], meta["T_pad"]
    y = rand_arrays(3, np.int32, rows=tpm.N_TILE)[:, :T].copy()
    want = jpm._mid_perm_pallas(jdev[1], [jnp.asarray(y)], T128, T_pad, True,
                                out_T=out_T)
    got, = tpm.mid_perm(tdev[1], [torch.from_numpy(y)], T128, T_pad,
                        out_T=out_T)
    bitwise_equal(got, want)


@pytest.mark.parametrize("out_limit", [None, 20000, 100])
def test_apply_perm_matches_xla(plan, out_limit):
    pi, meta, jdev, tmeta, tdev = plan
    x = rand_arrays(5, np.float32)
    ix = rand_arrays(6, np.int32)
    want = jpm._apply_xla(meta, jdev, [jnp.asarray(x), jnp.asarray(ix)])
    got = tpm.apply_perm(tmeta, tdev, [torch.from_numpy(x),
                                       torch.from_numpy(ix)],
                         out_limit=out_limit)
    TV = 4 if out_limit is None else -(-out_limit // tpm.N_TILE)
    assert got[0].shape == (TV * 128, 128)
    for g, w in zip(got, want):
        bitwise_equal(g, np.asarray(w)[:TV * 128])
    # and the definition: out[pi[p]] = in[p]
    ref = np.empty(L_MIN, np.float32)
    ref[pi] = x.reshape(-1)
    assert np.array_equal(got[0].numpy().reshape(-1), ref[:TV * tpm.N_TILE])


def test_split_stages_compose_to_apply_perm(plan):
    """pre_c + stage C, and stage A + post_a, are apply_perm."""
    _, _, _, tmeta, tdev = plan
    x = torch.from_numpy(rand_arrays(8, np.int32))
    full, = tpm.apply_perm(tmeta, tdev, [x])
    pre, = tpm.apply_perm_pre_c(tmeta, tdev, [x])
    assert torch.equal(tpm.tile_perm(tdev[2], [pre])[0], full)
    a, = tpm.tile_perm(tdev[0], [x])
    assert torch.equal(tpm.apply_perm(tmeta, tdev, [a], skip_a=True)[0], full)
    post, = tpm.apply_perm_post_a(tmeta, tdev, [a], out_limit=1)
    assert torch.equal(post, full[:128])


def test_tile_perm_rejects_mismatched_shapes(plan):
    _, _, _, _, tdev = plan
    with pytest.raises(ValueError):
        tpm.tile_perm(tdev[0], [torch.zeros(128, 128, dtype=torch.int32)])
