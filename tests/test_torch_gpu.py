"""Tests of the PyTorch port that need a CUDA device.

A CUDA kernel has no interpret mode, so on a machine without a card these
skip; ``chip_smoke.py`` runs the full comparisons there.  The file imports
torch and the port only, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from graphblas_tpu_torch.core.engine import kernels as K
from graphblas_tpu_torch.core.engine import permute as pm
from graphblas_tpu_torch.core.engine import tropical as ttr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    return torch.device("cuda")


def same(got, want):
    return bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("red,comb", [("min", "plus"), ("max", "times"),
                                      ("max", "min")])
def test_tropical_kernel_matches_plain(cuda, red, comb, dtype):
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.standard_normal((300, 260))).to(cuda, dtype)
    b = torch.from_numpy(rng.standard_normal((260, 200))).to(cuda, dtype)
    before = K.launches["tropical_matmul"]
    got = ttr.tropical_matmul(a, b, red, comb)
    assert K.launches["tropical_matmul"] == before + 1
    assert same(got, ttr.tropical_matmul_plain(a, b, red, comb))


@pytest.mark.gpu
@pytest.mark.parametrize("red,comb", ttr.MASKED_PAIRS)
def test_tropical_kernel_with_validity_planes(cuda, red, comb):
    rng = np.random.default_rng(10)
    a = rng.standard_normal((130, 70)).astype(np.float32)
    b = rng.standard_normal((70, 90)).astype(np.float32)
    a[rng.random(a.shape) < 0.05] = np.inf
    b[rng.random(b.shape) < 0.05] = -np.inf
    b[rng.random(b.shape) < 0.02] = np.nan
    a, b = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    aok = torch.from_numpy(rng.random((130, 70)) < 0.6).to(cuda)
    bok = torch.from_numpy(rng.random((70, 90)) < 0.6).to(cuda)
    got = ttr.tropical_matmul(a, b, red, comb, aok, bok)
    assert same(got, ttr.tropical_matmul_plain(a, b, red, comb, aok, bok))


@pytest.mark.gpu
def test_tropical_wrapper_refuses_strided_operands(cuda):
    a = torch.zeros((8, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ttr.tropical_matmul(a.t()[:, :4], a[:4], "min", "plus")


# ---- K2 tile_perm and K3 mid_perm: bitwise against their plain versions.
# A gather needs no valid plan: the packed indices are random, with K3's
# select field S below T128.
def packed(rng, rows, cols, s_hi=128):
    a, b = rng.integers(0, 128, (2, rows, cols))
    c = rng.integers(0, s_hi, (rows, cols))
    return torch.from_numpy((a | (b << 7) | (c << 14)).astype(np.int32))


def words(rng, nch, shape):
    return [torch.from_numpy(rng.integers(-2**31, 2**31, shape)
                             .astype(np.int32)) for _ in range(nch)]


@pytest.mark.gpu
@pytest.mark.parametrize("nch", [1, 2, 5])
@pytest.mark.parametrize("T,TV", [(4, None), (4, 1), (4, 3), (200, None),
                                  (200, 3)])
def test_tile_perm_kernel_matches_plain(cuda, T, TV, nch):
    rng = np.random.default_rng(11)
    rows = (T if TV is None else TV) * 128
    p = packed(rng, T * 128, 128)[:rows]
    xs = words(rng, nch, (rows, 128))
    want = pm.tile_perm_plain(p, xs)
    before = K.launches["tile_perm"]
    got = pm.tile_perm(p.to(cuda), [x.to(cuda) for x in xs])
    per = K.lib("tile_perm").tile_perm_channels()
    assert K.launches["tile_perm"] == before + -(-nch // per)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def mid_case(rng, T, nch, out_T):
    """A random K3 route of T ports on the tile layout, its inputs, the
    plain version's outputs and the kernel's, and the launches it took."""
    T_pad = max(128, -(-T // 128) * 128)
    T128 = T_pad // 128
    p = packed(rng, pm.N_TILE, T_pad, s_hi=T128)
    xs = words(rng, nch, (T * 128, 128))
    want = pm.mid_perm_tiles_plain(p, xs, T, T128, T_pad, out_T)
    before, ex = K.launches["mid_perm"], pm.exchanges
    got = pm.mid_perm_tiles(p.cuda(), [x.cuda() for x in xs], T, T128, T_pad,
                            out_T)
    assert pm.exchanges == ex
    return want, got, K.launches["mid_perm"] - before


@pytest.mark.gpu
@pytest.mark.parametrize("nch", [1, 2, 5])
@pytest.mark.parametrize("out_T", [None, 1, 3])
@pytest.mark.parametrize("T", [4, 200])
def test_mid_perm_kernel_matches_plain(cuda, T, out_T, nch):
    want, got, n = mid_case(np.random.default_rng(12), T, nch, out_T)
    assert n == -(-nch // K.MAXCH)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("T,nch,launches", [
    (200, 2, 1),    # 8 rows a block, both channels in one launch
    (4000, 2, 1),   # 8 rows would overflow shared memory: 4 rows
    (4000, 5, 3),   # 4 rows hold two channels: three launches
])
def test_mid_perm_tiles_every_block_height(cuda, T, nch, launches):
    """mid_perm.cu sizes its blocks to the card's shared memory: 8 rows at
    narrow routes, 4 at wide ones, fewer channels a launch where even 4
    rows cannot hold them all."""
    want, got, n = mid_case(np.random.default_rng(13), T, nch, 130)
    assert n == launches
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("out_limit", [None, 20000, 100])
def test_apply_perm_on_the_card_moves_no_exchange(cuda, out_limit):
    """A real plan (T = 4): the card's composition equals the CPU's and
    runs no exchange transpose."""
    pi = np.random.default_rng(14).permutation(4 * pm.N_TILE)
    host = pm.build_perm_plan(pi)
    meta, cpu_dev = pm.plan_to_device(host, "cpu")
    _, gpu_dev = pm.plan_to_device(host, cuda)
    xs = words(np.random.default_rng(15), 2, (4 * 128, 128))
    want = pm.apply_perm(meta, cpu_dev, xs, out_limit=out_limit)
    before = (K.launches["tile_perm"], K.launches["mid_perm"], pm.exchanges)
    got = pm.apply_perm(meta, gpu_dev, [x.to(cuda) for x in xs],
                        out_limit=out_limit)
    assert (K.launches["tile_perm"], K.launches["mid_perm"], pm.exchanges) \
        == (before[0] + 2, before[1] + 1, before[2])
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
