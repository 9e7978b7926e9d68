"""Clos permutation kernels of the PyTorch port against the Pallas kernels.

The port's plain versions of K2 (tile_perm) and K3 (mid_perm_plain on the
port layout, and mid_perm_tiles on the tile layout) run on the CPU; the JAX package's Pallas
kernels run in interpret mode on the same plan arrays (wrapped in the JAX
package's exchange transposes for the tile layout), and the whole
apply_perm composition is held against the JAX package's XLA reference
``permute._apply_xla``.  Permutations move bits: everything must be
bitwise equal.  A gather needs no valid plan to be compared, so the cases
at T128 = 2 use a random packed index.
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


def rand_packed(seed, rows, cols, s_hi=128):
    """A random packed index: two 7-bit fields in [0, 128) and the third
    (bits 14-20, K3's group select S) in [0, s_hi)."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, 128, (2, rows, cols))
    c = rng.integers(0, s_hi, (rows, cols))
    return (a | (b << 7) | (c << 14)).astype(np.int32)


def jax_mid_tiles(p, xs, T, T128, T_pad, out_T):
    """The JAX package's stage B on the tile layout: its exchange, the
    Pallas kernel in interpret mode, its exchange back (permute.py:352-357
    there)."""
    mids = [jnp.asarray(x).reshape(T, tpm.N_TILE).T for x in xs]
    zs = jpm._mid_perm_pallas(jnp.asarray(p), mids, T128, T_pad, True,
                              out_T=out_T)
    if len(xs) == 1:
        zs = [zs]
    return [z.T.reshape(-1, 128) for z in zs]


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
    got, = tpm.mid_perm_plain(tdev[1], [torch.from_numpy(y)], T128, T_pad,
                              out_T=out_T)
    bitwise_equal(got, want)


def test_tile_perm_five_channels_matches_pallas(plan):
    """Five channels: the CUDA wrapper splits them over two launches."""
    _, _, jdev, _, tdev = plan
    xs = [rand_arrays(20 + c, np.float32 if c % 2 else np.int32)
          for c in range(5)]
    want = jpm._tile_perm_pallas(jdev[2], [jnp.asarray(x) for x in xs], True)
    got = tpm.tile_perm(tdev[2], [torch.from_numpy(x) for x in xs])
    assert len(got) == 5
    for g, w in zip(got, want):
        bitwise_equal(g, w)


@pytest.mark.parametrize("out_T", [None, 2, 1])
@pytest.mark.parametrize("nch", [1, 2])
def test_mid_perm_tiles_matches_pallas(plan, out_T, nch):
    _, meta, jdev, _, tdev = plan
    T, T128, T_pad = meta["T"], meta["T128"], meta["T_pad"]
    xs = [rand_arrays(30 + c, np.float32 if c else np.int32)
          for c in range(nch)]
    want = jax_mid_tiles(jdev[1], xs, T, T128, T_pad, out_T)
    got = tpm.mid_perm_tiles(tdev[1], [torch.from_numpy(x) for x in xs], T,
                             T128, T_pad, out_T=out_T)
    TW = T if out_T is None else out_T
    for g, w in zip(got, want):
        assert g.shape == (TW * 128, 128)
        bitwise_equal(g, w)


@pytest.mark.parametrize("out_T", [None, 130, 128, 1])
@pytest.mark.parametrize("layout", ["port", "tiles"])
def test_mid_perm_two_groups_matches_pallas(layout, out_T):
    """T128 = 2 (T = 200, T_pad = 256): the select field S picks one of two
    port groups, which no T <= 128 plan exercises; out_T = 130 trims inside
    the second group, 128 at its edge, 1 inside the first."""
    T, T_pad, T128 = 200, 256, 2
    p = rand_packed(40, tpm.N_TILE, T_pad, s_hi=T128)
    tp = torch.from_numpy(p)
    if layout == "port":
        y = rand_arrays(41, np.int32, rows=tpm.N_TILE)[:, :T].copy()
        want = jpm._mid_perm_pallas(jnp.asarray(p), [jnp.asarray(y)], T128,
                                    T_pad, True, out_T=out_T)
        got, = tpm.mid_perm_plain(tp, [torch.from_numpy(y)], T128, T_pad,
                                  out_T=out_T)
    else:
        x = rand_arrays(41, np.int32, rows=T * 128)
        want, = jax_mid_tiles(p, [x], T, T128, T_pad, out_T)
        got, = tpm.mid_perm_tiles(tp, [torch.from_numpy(x)], T, T128, T_pad,
                                  out_T=out_T)
    bitwise_equal(got, want)


def test_mid_perm_tiles_is_the_exchanged_port_layout():
    """mid_perm_tiles == exchange_out(mid_perm_plain(exchange_in(x))), and
    only the plain versions count exchanges."""
    T, T_pad, T128 = 200, 256, 2
    p = torch.from_numpy(rand_packed(42, tpm.N_TILE, T_pad, s_hi=T128))
    x = torch.from_numpy(rand_arrays(43, np.int32, rows=T * 128))
    before = tpm.exchanges
    got, = tpm.mid_perm_tiles(p, [x], T, T128, T_pad, out_T=3)
    assert tpm.exchanges == before + 2
    z, = tpm.mid_perm_plain(p, [x.reshape(T, tpm.N_TILE).t().contiguous()],
                            T128, T_pad, out_T=3)
    assert torch.equal(got, z.t().contiguous().reshape(-1, 128))


@pytest.mark.parametrize("x_rows,p_shape,T,T_pad", [
    (200 * 128, (tpm.N_TILE, 256), 201, 256),     # input is not T tiles
    (200 * 128, (tpm.N_TILE, 384), 200, 256),     # index is not T_pad wide
    (300 * 128, (tpm.N_TILE, 256), 300, 256),     # T past the padded ports
])
def test_mid_perm_tiles_rejects_bad_shapes(x_rows, p_shape, T, T_pad):
    p = torch.zeros(p_shape, dtype=torch.int32)
    x = torch.zeros((x_rows, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="bad"):
        tpm.mid_perm_tiles(p, [x], T, T_pad // 128, T_pad)


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
