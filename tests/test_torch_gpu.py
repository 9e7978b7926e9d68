"""Tests of the PyTorch port that need a CUDA device.

A CUDA kernel has no interpret mode, so on a machine without a card these
skip; ``chip_smoke.py`` runs the full comparisons there.  The file imports
torch and the port only, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from graphblas_tpu_torch import monoid
from graphblas_tpu_torch.core.engine import kernels as K
from graphblas_tpu_torch.core.engine import lanepipe as lp
from graphblas_tpu_torch.core.engine import permute as pm
from graphblas_tpu_torch.core.engine import sortpipe as sp
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


# --------------------------------------------------------------------- #
# K6 segscan: the single pass with its decoupled look-back
def seg_barrier(rng, kind, L):
    T = sp.SEG_BLOCK
    b = np.zeros(L, np.int32)
    if kind == "tile starts":
        b[::T] = 1
    elif kind == "tile ends":
        b[T - 1::T] = 1
    elif kind == "every element":
        b[:] = 1
    elif kind == "random":
        b[rng.random(L) < 1 / 500] = 1
        b[L // 4:L // 2] = 0  # one segment over a quarter of the tiles
    return torch.from_numpy(b)


def seg_values(rng, combine, L):
    """Values for a channel: FP32 in [0.5, 1.5) or 32-bit integers."""
    if combine.dt is not None and combine.dt.is_float:
        return torch.from_numpy(rng.random(L, dtype=np.float32) + 0.5)
    hi = 2 if combine is sp.COUNT or (combine.dt is not None
                                      and combine.dt.is_bool) else 1000
    return torch.from_numpy(rng.integers(0 if hi == 2 else -hi, hi, L)
                            .astype(np.int32))


def seg_check(cuda, barrier, combines, vals):
    """K6 on the card against its plain version on the CPU: FP32 plus and
    times to rel 1e-5, everything else bitwise; one launch per group of
    at most four channels."""
    before = K.launches["segscan"]
    got = sp.segscan(barrier.to(cuda), [v.to(cuda) for v in vals], combines)
    assert K.launches["segscan"] - before == -(-len(vals) // K.MAXCH)
    want = sp.segscan_channels_plain(barrier, vals, combines)
    for g, w, c in zip(got, want, combines):
        g = g.cpu()
        if c.dt is not None and c.dt.is_float and c.monoid in ("plus", "times"):
            assert bool(((g - w).abs() <= 1e-5 * w.abs()).all()), c
        else:
            assert torch.equal(g, w), c
    return got


PLUS_COUNT = [sp.monoid_combine(monoid.plus["FP32"]), sp.COUNT]
FILL = [sp.FIRST, sp.FIRST]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,L", [
    ("none", 1 << 23), ("none", 4096), ("tile starts", 1 << 20),
    ("tile ends", 1 << 20), ("every element", 1 << 20), ("random", 1 << 20),
    ("random", 4096), ("tile ends", 4096)])
@pytest.mark.parametrize("combines", [PLUS_COUNT, FILL], ids=["plus", "fill"])
def test_segscan_look_back_edge_cases(cuda, kind, L, combines):
    """No barrier at all (one segment through every tile), barriers only at
    tile starts or only at tile ends, at every element, and one tile."""
    rng = np.random.default_rng(21)
    bar = seg_barrier(rng, kind, L)
    seg_check(cuda, bar, combines, [seg_values(rng, c, L) for c in combines])


SEG_TUPLES = {
    "plus_fp32": PLUS_COUNT,
    "min_fp32": [sp.monoid_combine(monoid.min["FP32"]), sp.COUNT],
    "max_fp32": [sp.monoid_combine(monoid.max["FP32"]), sp.COUNT],
    "lor_bool": [sp.monoid_combine(monoid.lor["BOOL"]), sp.COUNT],
    "plus_int32": [sp.monoid_combine(monoid.plus["INT32"]), sp.COUNT],
    "fill": FILL,
    # an FP32 product over one segment of 2**16 elements differs between
    # two fold orders by some sqrt(2**16) * 2**-24 = 1.5e-5 relative, so
    # FP32 times is held with exact factors instead (see
    # test_segscan_fp32_times_across_tiles)
    "generic_1": [sp.monoid_combine(monoid.times["INT32"])],
    "generic_2": [sp.monoid_combine(monoid.min["INT32"]), sp.FIRST],
    "generic_3": [sp.monoid_combine(monoid.max["UINT32"]), sp.FIRST,
                  sp.COUNT],
    "generic_4": [sp.monoid_combine(monoid.band["UINT32"]), sp.FIRST,
                  sp.COUNT, sp.monoid_combine(monoid.land["BOOL"])],
    "two_groups": [sp.monoid_combine(monoid.plus["FP32"]), sp.FIRST,
                   sp.COUNT, sp.monoid_combine(monoid.max["INT32"]),
                   sp.monoid_combine(monoid.min["FP32"])],
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SEG_TUPLES))
def test_segscan_every_combine(cuda, name):
    """Each channel tuple with inline combines, the run-time path at one to
    four channels, and five channels (two launches)."""
    combines = SEG_TUPLES[name]
    rng = np.random.default_rng(22)
    L = 64 * sp.SEG_BLOCK
    bar = seg_barrier(rng, "random", L)
    seg_check(cuda, bar, combines, [seg_values(rng, c, L) for c in combines])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["none", "random"])
def test_segscan_repeated_launches_are_bitwise_stable(cuda, kind):
    """A look-back with a wrong fence fails now and then, not always: 200
    launches, each equal to the first in every bit (FP32 plus included,
    whose fold order is fixed by the tiles, not by the timing)."""
    rng = np.random.default_rng(23)
    L = 1 << 22
    bar = seg_barrier(rng, kind, L).to(cuda)
    vals = [seg_values(rng, c, L).to(cuda) for c in PLUS_COUNT]
    first = sp.segscan(bar, vals, PLUS_COUNT)
    for _ in range(200):
        again = sp.segscan(bar, vals, PLUS_COUNT)
        for a, f in zip(again, first):
            assert torch.equal(a.view(torch.int32), f.view(torch.int32))


@pytest.mark.gpu
def test_segscan_fp32_times_across_tiles(cuda):
    """An FP32 product carried across tiles, in segments of about three:
    the factors are 1/2, 1 and 2, so each product is exact in any fold
    order and must agree in every bit, and a wrong carry shows."""
    rng = np.random.default_rng(25)
    T = sp.SEG_BLOCK
    L = 64 * T
    bar = torch.zeros(L, dtype=torch.int32)
    bar[1000::3 * T + 1234] = 1
    f = torch.from_numpy(rng.choice(np.float32([0.5, 1, 2]), L,
                                    p=[0.01, 0.98, 0.01]))
    times = [sp.monoid_combine(monoid.times["FP32"])]
    got = sp.segscan(bar.to(cuda), [f.to(cuda)], times)[0].cpu()
    assert torch.equal(got, sp.segscan_channels_plain(bar, [f], times)[0])
    assert len(set(got.tolist())) > 10


# --------------------------------------------------------------------- #
# K1 gather_mult: bitwise against its plain version for every (type, op)
# pair the kernel takes, templated (FP32 times and plus, BOOL land) or
# through its out-of-line multiply; then the logical multiplies end to end
K1_TYPES = ("FP32", "INT32", "UINT32", "BOOL")
K1_OPS = ("times", "plus", "first", "second", "pair", "min", "max", "land",
          "lor", "band", "bor")
K1_PAIRS = [(op, dt) for op in K1_OPS for dt in K1_TYPES
            if not (op in ("band", "bor") and dt in ("FP32", "BOOL"))]
K1_N = 3 * lp.WINDOW_K  # three windows: the last one ends at the end of u2
_k1_plans = {}


def k1_plan(cuda, kind):
    """The device plan of a random FP32 matrix for vxm or mxv (cached)."""
    if kind not in _k1_plans:
        import graphblas_tpu_torch as gb

        rng = np.random.default_rng(27)
        lin = np.unique(rng.integers(0, K1_N * K1_N, 2 * K1_N))
        with gb.config.set(device=cuda, auto_sparse_limit=0):
            A = gb.Matrix.from_coo(lin // K1_N, lin % K1_N,
                                   np.ones(len(lin), np.float32),
                                   dtype="FP32", nrows=K1_N, ncols=K1_N)
        e = lp.get_plan(A._sparse, kind == "mxv", device=cuda)
        assert e is not None
        _k1_plans[kind] = e
    return _k1_plans[kind]


def k1_words(rng, shape, dt, cuda):
    """Carrier words of type dt with the values that tell multiplies apart:
    FP32 zeros of both signs, NaN, infinities, a subnormal; integers over
    the full range, so that products and sums wrap."""
    if dt == "FP32":
        pool = np.float32([0, -0.0, 1.5, -2, np.nan, np.inf, -np.inf,
                           3e-39, 1e30, 7])
        x = np.where(rng.random(shape) < 0.5, rng.choice(pool, shape),
                     rng.standard_normal(shape).astype(np.float32))
        return torch.from_numpy(x.astype(np.float32)).to(cuda)
    if dt == "BOOL":
        return torch.from_numpy(rng.integers(0, 2, shape, dtype=np.int32)).to(cuda)
    x = rng.integers(-2**31, 2**31, shape, dtype=np.int64)
    small = rng.random(shape) < 0.3
    x[small] = rng.integers(-3, 4, int(small.sum()))
    return torch.from_numpy(x.astype(np.int32)).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("op,dt", K1_PAIRS)
def test_gather_mult_matches_plain(cuda, op, dt):
    """vxm and mxv, a full and a sparse u (the okp output), with and
    without the route's stage A, and for BOOL packed and not: every output
    bitwise equal to gather_mult_plain, one launch a call."""
    from graphblas_tpu_torch import binary

    rng = np.random.default_rng(28)
    mult = getattr(binary, op)[dt]
    mono = (monoid.lor if dt == "BOOL" else monoid.min)[dt]
    for kind in ("vxm", "mxv"):
        e = k1_plan(cuda, kind)
        d = e["dev"]
        R_g, nb = e["R_g"], e["nblocks_g"]
        assert int(d["meta"][:, 0].max()) * 128 + 128 == K1_N // 128
        plan_g = (d["meta"], d["idx1_g"], d["locidx_g"], d["okg"],
                  k1_words(rng, (R_g, 128), dt, cuda))
        u2 = k1_words(rng, (K1_N // 128, 128), dt, cuda)
        u2ok = torch.from_numpy(rng.integers(0, 2, u2.shape, dtype=np.int32)).to(cuda)
        for full_u in (True, False):
            for permA in (d["routeP"][0], None):
                for packed in ((True, False) if dt == "BOOL" else (False,)):
                    kw = dict(kind=kind, R_g=R_g, nblocks=nb, packed=packed,
                              full_u=full_u, permA=permA)
                    args = (plan_g, u2, u2ok, mult, mult.type, mult.type, mono)
                    before = K.launches["gather_mult"]
                    got = lp.gather_mult(*args, **kw)
                    assert K.launches["gather_mult"] == before + 1
                    want = lp.gather_mult_plain(*args, **kw)
                    tag = (kind, full_u, permA is not None, packed)
                    assert torch.equal(got[0].view(torch.int32),
                                       want[0].view(torch.int32)), tag
                    assert (got[1] is None) == (want[1] is None), tag
                    if want[1] is not None:
                        assert torch.equal(got[1], want[1]), tag


@pytest.mark.gpu
def test_gather_mult_repeats_bitwise(cuda):
    """200 launches of the SSSP variant (FP32 plus, okp, stage A) give the
    bits of the first."""
    from graphblas_tpu_torch import semiring

    rng = np.random.default_rng(29)
    e = k1_plan(cuda, "vxm")
    d = e["dev"]
    ring = semiring.min_plus["FP32"]
    u2 = k1_words(rng, (K1_N // 128, 128), "FP32", cuda)
    u2ok = torch.from_numpy(rng.integers(0, 2, u2.shape, dtype=np.int32)).to(cuda)
    plan_g = (d["meta"], d["idx1_g"], d["locidx_g"], d["okg"], d["avals_g"])

    def run():
        v, h = lp.gather_mult(plan_g, u2, u2ok, ring.binaryop, ring.monoid.type,
                              ring.monoid.type, ring.monoid, kind="vxm",
                              R_g=e["R_g"], nblocks=e["nblocks_g"],
                              permA=d["routeP"][0])
        return torch.cat([v.view(torch.int32).reshape(-1), h.reshape(-1)])

    first = run()
    for _ in range(200):
        assert torch.equal(run(), first)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["vxm", "mxv"])
@pytest.mark.parametrize("dtype,ring", [("FP32", "plus_land"),
                                        ("INT32", "min_lor")])
def test_logical_multiplies_in_their_type_on_the_card(cuda, dtype, ring, kind):
    """land and lor over FP32 and INT32 multiply the operands' truth values
    to 1 or 0 in the type (a NaN is true, -0.0 false): the lanepipe on the
    card, through K1, gives the CPU's result."""
    import graphblas_tpu_torch as gb

    rng = np.random.default_rng(24)
    n = 3000
    r, c = np.nonzero(rng.random((n, n)) < 0.002)
    if dtype == "FP32":
        pool = np.float32([0, -0.0, 1.5, -2, np.nan])
        v, x = rng.choice(pool, len(r)), rng.choice(pool, n)
    else:
        v, x = rng.integers(-2, 3, len(r)), rng.integers(-2, 3, n)
    xi = np.flatnonzero(rng.random(n) < 0.7)
    out = {}
    for dev in ("cpu", "cuda"):
        with gb.config.set(device=dev, auto_sparse_limit=0):
            A = gb.Matrix.from_coo(r, c, v, dtype=dtype, nrows=n, ncols=n)
            u = gb.Vector.from_coo(xi, x[xi], dtype=dtype, size=n)
            sr = getattr(gb.semiring, ring)[dtype]
            before = K.launches["gather_mult"]
            w = (u.vxm(A, sr) if kind == "vxm" else A.mxv(u, sr)).new()
            out[dev] = w.to_coo()
    assert K.launches["gather_mult"] > before
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    assert len(np.unique(out["cpu"][1])) > 1


# --------------------------------------------------------------------- #
# K4 fused_permC_scan_permA: one launch, a single pass with a look-back
# (monoid, type, packed): the cases of test_torch_lanepipe.py's SCAN_CASES
K4_CASES = [("plus", "FP32", False), ("plus", "INT32", False),
            ("min", "FP32", False), ("max", "INT32", False),
            ("min", "UINT32", False), ("lor", "BOOL", True),
            ("land", "BOOL", True)]


def k4_inputs(rng, tiles, kind, dtype, packed, exact=False):
    """Route and extract indices, a barrier layout and values, on the CPU.
    exact: FP32 values 0, 1 or 2, whose sums are exact in any order."""
    shape = (tiles * 128, 128)
    pc = rng.integers(0, 1 << 21, shape).astype(np.int32)
    pa = rng.integers(0, 1 << 21, shape).astype(np.int32)
    if kind == "every row":
        bar = np.ones(shape, np.int32)
    else:
        p = {"row 0 only": 0, "random": 1 / 300, "long run": 1 / 300}[kind]
        bar = (rng.random(shape) < p).astype(np.int32)
        bar[0] = 1
        if kind == "long run":
            bar[1:, 5] = 0  # lane 5's run crosses every tile
    if packed:
        vals = rng.integers(0, 3, shape).astype(np.int32)
    elif dtype == "FP32":
        vals = (rng.integers(0, 3, shape) if exact
                else rng.random(shape) + 0.5).astype(np.float32)
    elif dtype == "UINT32":
        vals = rng.integers(-2**31, 2**31, shape).astype(np.int32)
    else:
        vals = rng.integers(-1000, 1000, shape).astype(np.int32)
    return [torch.from_numpy(a) for a in (pc, bar, pa, vals)]


def k4_check(cuda, mono_name, dtype, packed, inputs, rel=None):
    """K4 on the card against its plain version on the CPU, bitwise or to
    rel; one launch a call."""
    comb = lp.combines(getattr(monoid, mono_name)[dtype])[1 if packed else 0]
    before = K.launches["fused_permC_scan_permA"]
    got = lp.fused_permC_scan_permA(*(t.to(cuda) for t in inputs), comb)
    assert K.launches["fused_permC_scan_permA"] - before == 1
    want = lp.fused_permC_scan_permA_plain(*inputs, comb)
    got = got.cpu()
    if rel is None:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        assert bool(((got - want).abs() <= rel * want.abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("mono_name,dtype,packed", K4_CASES)
def test_fused_scan_every_case(cuda, mono_name, dtype, packed):
    """Each (monoid, type, packed) case, inline or through the run-time
    combine, at 40 tiles: FP32 plus to rel 1e-5, the rest bitwise."""
    rng = np.random.default_rng(31)
    inputs = k4_inputs(rng, 40, "random", dtype, packed)
    rel = 1e-5 if (mono_name, dtype) == ("plus", "FP32") else None
    k4_check(cuda, mono_name, dtype, packed, inputs, rel)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,tiles", [("row 0 only", 64), ("every row", 8),
                                        ("random", 264), ("long run", 80)])
@pytest.mark.parametrize("mono_name,dtype", [("plus", "FP32"),
                                             ("plus", "INT32"),
                                             ("min", "FP32")])
def test_fused_scan_barrier_layouts(cuda, kind, tiles, mono_name, dtype):
    """No barrier but row 0 (every lane one run), a barrier in every row,
    barriers at 1/300, and one lane's run over more tiles than the
    look-back window (32): bitwise, FP32 plus on exact values."""
    rng = np.random.default_rng(32)
    inputs = k4_inputs(rng, tiles, kind, dtype, False, exact=True)
    k4_check(cuda, mono_name, dtype, False, inputs)


@pytest.mark.gpu
def test_fused_scan_repeated_launches_are_bitwise_stable(cuda):
    """A look-back with a wrong fence fails now and then, not always: 200
    launches of FP32 plus at the zipf plan's 264 tiles, each equal to the
    first in every bit (the fold order is fixed by the tiles, not by the
    timing)."""
    rng = np.random.default_rng(33)
    pc, bar, pa, vals = (t.to(cuda) for t in
                         k4_inputs(rng, 264, "long run", "FP32", False))
    comb = lp.combines(monoid.plus["FP32"])[0]
    first = lp.fused_permC_scan_permA(pc, bar, pa, vals, comb).view(torch.int32)
    for _ in range(200):
        again = lp.fused_permC_scan_permA(pc, bar, pa, vals, comb)
        assert torch.equal(again.view(torch.int32), first)


@pytest.mark.gpu
def test_fused_scan_is_one_launch_a_call(cuda):
    """Each call adds exactly one launch to the count, also at one tile."""
    rng = np.random.default_rng(34)
    comb = lp.combines(monoid.plus["INT32"])[0]
    for tiles in (1, 3):
        inputs = [t.to(cuda) for t in k4_inputs(rng, tiles, "random", "INT32",
                                                 False)]
        before = K.launches["fused_permC_scan_permA"]
        lp.fused_permC_scan_permA(*inputs, comb)
        lp.fused_permC_scan_permA(*inputs, comb)
        assert K.launches["fused_permC_scan_permA"] - before == 2


# --------------------------------------------------------------------- #
# K5 lane_segscan: one launch, a single pass with a look-back per lane
# every (monoid, type) the port's scan combines take, and the packed BOOL
# codes
K5_CASES = [(m, dt, False) for m in ("plus", "times", "min", "max")
            for dt in ("FP32", "INT32", "UINT32")] + [
    ("band", "UINT32", False), ("bor", "UINT32", False),
    ("lor", "BOOL", False), ("land", "BOOL", False),
    ("lor", "BOOL", True), ("land", "BOOL", True)]
_k5_plan = []


def k5_zipf_barrier(cuda):
    """The scan-layout barrier of a zipf-like graph's vxm plan (n = 2**15,
    degree 8, destinations zipf(1.5): a hub's run spans several tiles)."""
    if not _k5_plan:
        import graphblas_tpu_torch as gb

        rng = np.random.default_rng(41)
        n = 1 << 15
        src = rng.integers(0, n, 8 * n)
        dst = (rng.zipf(1.5, 8 * n) - 1) % n
        lin = np.unique(src * n + dst)
        with gb.config.set(device=cuda, auto_sparse_limit=0):
            A = gb.Matrix.from_coo(lin // n, lin % n,
                                   np.ones(len(lin), np.float32),
                                   dtype="FP32", nrows=n, ncols=n)
        e = lp.get_plan(A._sparse, False, device=cuda)
        assert e is not None
        _k5_plan.append(e["dev"]["barrier"].cpu())
    return _k5_plan[0]


def k5_barrier(rng, kind, tiles):
    """(tiles * 128, 128) barrier words of one layout, on the CPU."""
    shape = (tiles * 128, 128)
    if kind == "every row":
        return torch.ones(shape, dtype=torch.int32)
    if kind == "none":
        return torch.zeros(shape, dtype=torch.int32)
    bar = (rng.random(shape) < 1 / 40).astype(np.int32)
    if kind == "no barrier in row 0":
        bar[0] = 0
    else:
        bar[0] = 1
    return torch.from_numpy(bar)


def k5_values(rng, shape, dtype, packed, exact=False):
    """Carrier words: FP32 in [0.5, 1.5) (or 0, 1, 2 with exact, whose sums
    are exact in any order), integers over the full range for UINT32 and
    in [-1000, 1000) for INT32, 0/1 for BOOL, codes 0-2 packed."""
    if packed:
        v = rng.integers(0, 3, shape).astype(np.int32)
    elif dtype == "FP32":
        v = (rng.integers(0, 3, shape) if exact
             else rng.random(shape) + 0.5).astype(np.float32)
    elif dtype == "UINT32":
        v = rng.integers(-2**31, 2**31, shape).astype(np.int32)
    elif dtype == "BOOL":
        v = rng.integers(0, 2, shape).astype(np.int32)
    else:
        v = rng.integers(-1000, 1000, shape).astype(np.int32)
    return torch.from_numpy(v)


def k5_ok(rng, shape):
    """Validity words in [-1000, 1000], not only 0 and 1."""
    return torch.from_numpy(rng.integers(-1000, 1001, shape).astype(np.int32))


def k5_check(cuda, mono_name, dtype, packed, bar, vals, ok, rel=None):
    """K5 on the card against its plain version on the CPU, bitwise or to
    rel; one launch a call."""
    comb = lp.combines(getattr(monoid, mono_name)[dtype])[1 if packed else 0]
    before = K.launches["lane_segscan"]
    gv, gh = lp.lane_segscan(bar.to(cuda), vals.to(cuda),
                             None if ok is None else ok.to(cuda), comb)
    assert K.launches["lane_segscan"] - before == 1
    pv, ph = lp.lane_segscan_plain(bar, vals, ok, comb)
    gv = gv.cpu()
    if rel is None:
        assert torch.equal(gv.view(torch.int32), pv.view(torch.int32))
    else:
        assert bool(((gv - pv).abs() <= rel * pv.abs()).all())
    assert (gh is None) == (ok is None)
    if ok is not None:
        assert torch.equal(gh.cpu(), ph)


@pytest.mark.gpu
@pytest.mark.parametrize("with_ok", [True, False])
@pytest.mark.parametrize("mono_name,dtype,packed", K5_CASES)
def test_lane_segscan_every_case(cuda, mono_name, dtype, packed, with_ok):
    """Each (monoid, type, packed) case, inline or through the run-time
    combine, at 40 tiles, with and without the validity channel: FP32
    plus and times to rel 1e-5, the rest bitwise."""
    rng = np.random.default_rng(42)
    bar = k5_barrier(rng, "random", 40)
    vals = k5_values(rng, bar.shape, dtype, packed)
    ok = k5_ok(rng, bar.shape) if with_ok else None
    rel = 1e-5 if dtype == "FP32" and mono_name in ("plus", "times") else None
    k5_check(cuda, mono_name, dtype, packed, bar, vals, ok, rel)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,tiles", [("zipf plan", 0),
                                        ("no barrier in row 0", 24),
                                        ("none", 80), ("every row", 8),
                                        ("random", 1)])
@pytest.mark.parametrize("mono_name,dtype", [("min", "FP32"), ("plus", "FP32"),
                                             ("plus", "INT32")])
def test_lane_segscan_barrier_layouts(cuda, kind, tiles, mono_name, dtype):
    """The zipf-like plan's barrier, no barrier in row 0 (row 0 starts a
    run either way), no barrier at all over 80 tiles (every lane one run,
    longer than the look-back window of 32), a barrier in every row, and a
    single tile; with ok in [-1000, 1000]: bitwise, FP32 plus on exact
    values."""
    rng = np.random.default_rng(43)
    bar = (k5_zipf_barrier(cuda) if kind == "zipf plan"
           else k5_barrier(rng, kind, tiles))
    vals = k5_values(rng, bar.shape, dtype, False, exact=True)
    k5_check(cuda, mono_name, dtype, False, bar, vals, k5_ok(rng, bar.shape))


@pytest.mark.gpu
def test_lane_segscan_repeated_launches_are_bitwise_stable(cuda):
    """200 launches of FP32 plus with validity over 264 tiles with no
    barrier but row 0, each equal to the first in every bit (the fold
    order is fixed by the tiles, not by the timing)."""
    rng = np.random.default_rng(44)
    bar = k5_barrier(rng, "none", 264).to(cuda)
    bar[0] = 1
    vals = k5_values(rng, bar.shape, "FP32", False).to(cuda)
    ok = k5_ok(rng, bar.shape).to(cuda)
    comb = lp.combines(monoid.plus["FP32"])[0]
    fv, fh = lp.lane_segscan(bar, vals, ok, comb)
    fv = fv.view(torch.int32).clone()
    for _ in range(200):
        gv, gh = lp.lane_segscan(bar, vals, ok, comb)
        assert torch.equal(gv.view(torch.int32), fv)
        assert torch.equal(gh, fh)


@pytest.mark.gpu
def test_lane_segscan_is_one_launch_a_call(cuda):
    """Each call adds exactly one launch to the count, with and without
    the validity channel, also at one tile."""
    rng = np.random.default_rng(45)
    comb = lp.combines(monoid.min["FP32"])[0]
    for tiles in (1, 3):
        bar = k5_barrier(rng, "random", tiles).to(cuda)
        vals = k5_values(rng, bar.shape, "FP32", False).to(cuda)
        ok = k5_ok(rng, bar.shape).to(cuda)
        before = K.launches["lane_segscan"]
        lp.lane_segscan(bar, vals, ok, comb)
        lp.lane_segscan(bar, vals, None, comb)
        assert K.launches["lane_segscan"] - before == 2


# --------------------------------------------------------------------- #
# the generic sparse engine (torch ops, no kernel of its own) on the card
# against the same calls on the CPU, which the CPU tests hold against the
# JAX package
def _sparse_engine_results(device):
    import graphblas_tpu_torch as gb

    rng = np.random.default_rng(12)
    n = 300
    r = rng.integers(0, n, 3000)
    c = (rng.zipf(1.6, 3000) - 1) % n
    with gb.config.set(device=device, auto_sparse_limit=0):
        A = gb.Matrix.from_coo(r, c, rng.random(3000), dtype="FP64",
                               nrows=n, ncols=n, dup_op=gb.binary.plus)
        B = A.apply(gb.unary.one).new(dtype="INT64")
        L = B.select(gb.select.tril, -1).new()
        x = gb.Vector.from_dense(rng.random(n))
        C = gb.Matrix("INT64", n, n)
        C(L.S) << L.mxm(L.T, gb.semiring.plus_pair)
        G = L.mxm(L.T, gb.semiring.plus_pair).new(mask=L.S,
                                                  axb_method="gustavson")
        out = [A.T.new(), L, C, G, A.mxm(A).new(),
               A.ewise_union(A.T, gb.binary.minus, 0.0, 0.0).new(),
               A.ewise_mult(A.T).new(),
               x.diag().mxm(A, gb.semiring.plus_times).new(),
               x.vxm(A, gb.semiring.plus_times).new(),
               A.mxv(x, gb.semiring.min_plus).new(),
               B.reduce_columnwise(gb.monoid.max).new(),
               B.reduce_rowwise(gb.monoid.any).new()]
        E = gb.Matrix("FP64", n, n)
        out += [E.reduce_rowwise(gb.monoid.plus).new(),
                x.vxm(E, gb.semiring.plus_times).new()]
        out.append(gb.algorithms.triangle_count(A))
        out.append(gb.algorithms.pagerank(A)[0])
    return out


@pytest.mark.gpu
def test_sparse_engine_matches_cpu(cuda):
    """Structure and integers exact; floats per entry to rel 1e-12 (each
    output's sum runs in another order on the card)."""
    got, want = _sparse_engine_results("cuda"), _sparse_engine_results("cpu")
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(g, int):
            assert g == w, i
            continue
        assert g.dtype == w.dtype, i
        gc, wc = g.to_coo(), w.to_coo()
        for a, b in zip(gc[:-1], wc[:-1]):
            assert np.array_equal(a, b), i
        if wc[-1].dtype.kind != "f":
            assert np.array_equal(gc[-1], wc[-1]), i
            continue
        np.testing.assert_allclose(gc[-1], wc[-1], rtol=1e-12, atol=0,
                                   err_msg=str(i))


# --------------------------------------------------------------------- #
# extract, assign and delete by index lists, and connected_components
# (torch ops, no kernel of their own) on the card against the same calls
# on the CPU, which tests/test_torch_index.py holds against the JAX package
def _index_results(device, backing):
    import graphblas_tpu_torch as gb

    rng = np.random.default_rng(13)
    n = 400
    r = rng.integers(0, n, 4000)
    c = (rng.zipf(1.6, 4000) - 1) % n
    rows = np.sort(rng.choice(n, 150, replace=False))
    cols = rng.choice(n, 120, replace=False)
    dup = rng.integers(0, n, 90)
    limit = {"auto_sparse_limit": 0} if backing == "sparse" else {}
    with gb.config.set(device=device, **limit):
        A = gb.Matrix.from_coo(r, c, rng.integers(-9, 9, 4000),
                               dtype="INT64", nrows=n, ncols=n,
                               dup_op=gb.binary.plus)
        M = A.select(gb.select.tril).new()
        out = [A[rows, cols].new(), A[cols, rows].new(), A[7, :].new(),
               A[:, int(c[0])].new(), A[rows, 3].new()]
        B = A[rows, cols].new().apply(gb.binary.times, right=2).new()
        C = A.dup()
        C(accum=gb.binary.plus)[rows, cols] << B
        D = A.dup()
        D(M.S, replace=True)[rows, cols] << B
        E = A.dup()
        E[rows, cols](B.V) << 5
        F = A.dup()
        del F[rows, cols]
        out += [C, D, E, F]
        f = gb.Vector.from_dense(rng.integers(0, n, n))
        out.append(f[dup].new())
        f[dup] = -1
        f(accum=gb.binary.min) << f[rng.integers(0, n, n)]
        out += [f, gb.algorithms.connected_components(A)]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("backing", ["sparse", "dense"])
def test_index_and_components_match_cpu(cuda, backing):
    """Exact: every value is a copy or one accumulate of integers."""
    got = _index_results("cuda", backing)
    want = _index_results("cpu", backing)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        if backing == "sparse" and g.ndim == 2:
            assert g._sparse is not None, i
        for a, b in zip(g.to_coo(), w.to_coo()):
            assert np.array_equal(a, b), i


# --------------------------------------------------------------------- #
# positional operators, aggregators, kronecker and reposition (torch ops,
# no kernel of their own) on the card against the same calls on the CPU,
# which tests/test_torch_positional.py and tests/test_torch_agg.py hold
# against the JAX package
def _positional_agg_results(device, backing):
    import graphblas_tpu_torch as gb

    rng = np.random.default_rng(14)
    n = 300
    r = rng.integers(0, n, 3000)
    c = (rng.zipf(1.6, 3000) - 1) % n
    limit = {"auto_sparse_limit": 0} if backing == "sparse" else {}
    with gb.config.set(device=device, **limit):
        A = gb.Matrix.from_coo(r, c, rng.random(3000).astype(np.float32),
                               dtype="FP32", nrows=n, ncols=n,
                               dup_op=gb.binary.plus)
        L = A.apply(gb.unary.one).new(dtype="INT64").select(
            gb.select.tril, -1).new()
        out = [gb.algorithms.bfs_parent(A, 0),
               L.mxm(L.T, gb.semiring.ss.min_secondi).new(
                   mask=L.S, axb_method="dot"),
               A.mxm(A, gb.semiring.ss.min_firsti).new(),
               A.apply(gb.binary.ss.firstj, right=0).new(),
               A.apply(gb.unary.ss.positioni).new(),
               A.reduce_rowwise(gb.agg.count).new(),
               A.reduce_columnwise(gb.agg.ss.argmin).new(),
               A.reduce_rowwise(gb.agg.mean).new(),
               A.reduce_scalar(gb.agg.stdp).new(),
               A[:8, :16].new().kronecker(A[:16, :8].new()).new(),
               A.reposition(7, -11).new()]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("backing", ["sparse", "dense"])
def test_positional_and_aggregators_match_cpu(cuda, backing):
    """Integers and indices exact; the float aggregates to rel 1e-6 (their
    sums run in another order on the card)."""
    got = _positional_agg_results("cuda", backing)
    want = _positional_agg_results("cpu", backing)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        if g.ndim == 0:
            np.testing.assert_allclose(g.value, w.value, rtol=1e-6)
            continue
        gc, wc = g.to_coo(), w.to_coo()
        for a, b in zip(gc[:-1], wc[:-1]):
            assert np.array_equal(a, b), i
        if wc[-1].dtype.kind == "f":
            np.testing.assert_allclose(gc[-1], wc[-1], rtol=1e-6, atol=0,
                                       err_msg=str(i))
        else:
            assert np.array_equal(gc[-1], wc[-1]), i


# --------------------------------------------------------------------- #
# the operators slice: K1 over every builtin multiply and type of at most
# 32 bits, each operand in its own type (the templated fast paths and
# the out-of-line multiply); K4, K5 and K6 with lxor, lxnor, eq and bxor;
# the products that raised on the card before K1 took mixed types
K1_ALL_TYPES = ("FP32", "INT32", "UINT32", "BOOL", "INT8", "INT16", "UINT8",
                "UINT16")


def _k1_grid():
    from graphblas_tpu_torch import binary
    from graphblas_tpu_torch.core import dtypes as dts

    out = []
    for op in K.K1_OP:
        for t in K1_ALL_TYPES:
            if dts.lookup_dtype(t) not in getattr(binary, op)._typed_ops:
                continue
            mult = getattr(binary, op)[t]
            if K.k1_code(mult, dts.lookup_dtype(t), dts.lookup_dtype(t),
                         mult.return_type) is not None:
                out.append((op, t, t, t))
    return out


K1_GRID = _k1_grid()
K1_MIXED = [("times", "BOOL", "FP32", "FP32"), ("times", "BOOL", "INT32", "INT32"),
            ("plus", "FP32", "INT32", "FP32"), ("lt", "INT8", "FP32", "FP32"),
            ("times", "UINT16", "INT32", "INT32"), ("plus", "FP32", "INT8", "INT8"),
            ("bxor", "INT32", "UINT8", "UINT8"), ("pow", "UINT8", "INT16", "INT16"),
            ("land", "FP32", "BOOL", "BOOL"), ("eq", "UINT32", "INT32", "INT32"),
            ("minus", "INT16", "UINT16", "UINT16"), ("max", "UINT32", "FP32", "FP32"),
            ("bshift", "INT8", "INT32", "INT8"), ("cdiv", "FP32", "UINT8", "UINT8")]


def k1_typed_words(rng, shape, name, cuda):
    """Carrier words of any type K1 takes: FP32 with zeros of both signs,
    NaN, infinities, a subnormal and values past the integer ranges;
    integers over their type's range and small ones; BOOL 0/1."""
    if name in ("FP32", "BOOL", "INT32"):
        return k1_words(rng, shape, name, cuda) if name != "FP32" else \
            torch.from_numpy(np.where(
                rng.random(shape) < 0.5,
                rng.choice(np.float32([0, -0.0, 1.5, -2, np.nan, np.inf,
                                       -np.inf, 3e-39, 300.7, -40000.5, 3e9]),
                           shape),
                4 * rng.standard_normal(shape)).astype(np.float32)).to(cuda)
    info = np.iinfo(np.dtype(name.lower()))
    x = rng.integers(int(info.min), int(info.max) + 1, shape, dtype=np.int64)
    small = rng.random(shape) < 0.4
    x[small] = rng.integers(-3 if info.min < 0 else 0, 9, int(small.sum()))
    return torch.from_numpy(x.astype(np.dtype(name.lower())).astype(np.int64)
                            .astype(np.int32)).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("op,a_t,u_t,t", K1_GRID + K1_MIXED,
                         ids=[f"{o}-{a}x{u}-{t}" for o, a, u, t in K1_GRID + K1_MIXED])
def test_gather_mult_every_builtin_op(cuda, op, a_t, u_t, t):
    """vxm and mxv, a sparse u (okp), through the route's stage A, the
    BOOL monoid packed and not: bitwise equal to gather_mult_plain on the
    card, one launch a call."""
    from graphblas_tpu_torch import binary
    from graphblas_tpu_torch.core import dtypes as dts

    rng = np.random.default_rng(35)
    mult = getattr(binary, op)[t]
    ret = mult.return_type
    mono = (monoid.lor if ret is dts.BOOL else monoid.min)[ret]
    a_dt, u_dt = dts.lookup_dtype(a_t), dts.lookup_dtype(u_t)
    for kind in ("vxm", "mxv"):
        e = k1_plan(cuda, kind)
        d = e["dev"]
        R_g, nb = e["R_g"], e["nblocks_g"]
        plan_g = (d["meta"], d["idx1_g"], d["locidx_g"], d["okg"],
                  k1_typed_words(rng, (R_g, 128), a_t, cuda))
        u2 = k1_typed_words(rng, (K1_N // 128, 128), u_t, cuda)
        u2ok = torch.from_numpy(rng.integers(0, 2, u2.shape, dtype=np.int32)).to(cuda)
        for packed in ((True, False) if ret is dts.BOOL else (False,)):
            kw = dict(kind=kind, R_g=R_g, nblocks=nb, packed=packed,
                      permA=d["routeP"][0])
            args = (plan_g, u2, u2ok, mult, a_dt, u_dt, mono)
            before = K.launches["gather_mult"]
            got = lp.gather_mult(*args, **kw)
            assert K.launches["gather_mult"] == before + 1
            want = lp.gather_mult_plain(*args, **kw)
            tag = (kind, packed)
            assert torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32)), tag
            if want[1] is not None:
                assert torch.equal(got[1], want[1]), tag


NEW_SCANS = [("lxor", "BOOL", True), ("lxor", "BOOL", False),
             ("lxnor", "BOOL", True), ("eq", "BOOL", True),
             ("eq", "BOOL", False), ("bxor", "UINT32", False)]
K4_LAYOUTS = [("row 0 only", 64), ("every row", 8), ("random", 264),
              ("long run", 80)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,tiles", K4_LAYOUTS)
@pytest.mark.parametrize("mono_name,dtype,packed", NEW_SCANS)
def test_fused_scan_new_combines(cuda, mono_name, dtype, packed, kind, tiles):
    """K4 with the combines of the operators slice, over the barrier
    layouts of test_fused_scan_barrier_layouts: bitwise."""
    rng = np.random.default_rng(36)
    pc, bar, pa, vals = k4_inputs(rng, tiles, kind, dtype, packed)
    if dtype == "BOOL" and not packed:
        vals = vals & 1
    k4_check(cuda, mono_name, dtype, packed, [pc, bar, pa, vals])


@pytest.mark.gpu
@pytest.mark.parametrize("kind,tiles", [("no barrier in row 0", 24),
                                        ("none", 80), ("every row", 8),
                                        ("random", 1)])
@pytest.mark.parametrize("mono_name,dtype,packed", NEW_SCANS)
def test_lane_segscan_new_combines(cuda, mono_name, dtype, packed, kind, tiles):
    """K5 with the combines of the operators slice and a validity channel,
    over the barrier layouts of test_lane_segscan_barrier_layouts:
    bitwise."""
    rng = np.random.default_rng(37)
    bar = k5_barrier(rng, kind, tiles)
    vals = k5_values(rng, bar.shape, dtype, packed)
    k5_check(cuda, mono_name, dtype, packed, bar, vals, k5_ok(rng, bar.shape))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["tile starts", "tile ends", "every element",
                                  "random"])
@pytest.mark.parametrize("mono_name,dtype", [("lxor", "BOOL"), ("lxnor", "BOOL"),
                                             ("eq", "BOOL"), ("bxor", "UINT32")])
def test_segscan_new_combines(cuda, mono_name, dtype, kind):
    """K6 with the combines of the operators slice beside a count, over
    the look-back's barrier layouts: bitwise; and 200 launches of each
    equal to the first."""
    rng = np.random.default_rng(38)
    L = 16 * sp.SEG_BLOCK
    bar = seg_barrier(rng, kind, L)
    pair = [sp.monoid_combine(getattr(monoid, mono_name)[dtype]), sp.COUNT]
    vals = [torch.from_numpy((rng.integers(0, 2, L) if dtype == "BOOL" else
                              rng.integers(-2**31, 2**31, L)).astype(np.int32)),
            seg_values(rng, sp.COUNT, L)]
    first = seg_check(cuda, bar, pair, vals)
    if kind == "random":
        for _ in range(200):
            again = sp.segscan(bar.to(cuda), [v.to(cuda) for v in vals], pair)
            assert all(torch.equal(a, f) for a, f in zip(again, first))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["vxm", "mxv"])
@pytest.mark.parametrize("ring,rt,a_t,u_t", [
    ("plus_times", "FP32", "BOOL", "FP32"),
    ("plus_times", "INT32", "BOOL", "INT32"),
    ("min_plus", "FP32", "FP32", "INT32")])
def test_mixed_operand_products_on_the_card(cuda, ring, rt, a_t, u_t, kind):
    """The products that raised NotImplementedError on the card while K1
    took one type: PageRank's plus_times over a BOOL adjacency with an FP32
    and an INT32 vector, and an INT32 vector's min_plus over FP32 weights.
    Through the lanepipe and K1, equal to numpy (FP32 sums to rel 1e-5)."""
    import graphblas_tpu_torch as gb

    rng = np.random.default_rng(39)
    n = 3000
    r, c = np.nonzero(rng.random((n, n)) < 0.002)
    a = (rng.random(len(r)) < 0.6 if a_t == "BOOL"
         else rng.choice(np.float32([0.25, 1, 2, -1.5]), len(r)))
    x = (rng.random(n).astype(np.float32) if u_t == "FP32"
         else rng.integers(-1000, 1000, n).astype(np.int32))
    with gb.config.set(device=cuda, auto_sparse_limit=0):
        A = gb.Matrix.from_coo(r, c, a, dtype=a_t, nrows=n, ncols=n)
        u = gb.Vector.from_coo(np.arange(n), x, dtype=u_t, size=n)
        sr = getattr(gb.semiring, ring)[rt]
        before = K.launches["gather_mult"]
        w = (u.vxm(A, sr) if kind == "vxm" else A.mxv(u, sr)).new()
        assert K.launches["gather_mult"] > before
        gi, gv = w.to_coo()
    k, d = (r, c) if kind == "vxm" else (c, r)
    prod = (x[k].astype(np.float64) * a if ring == "plus_times"
            else x[k].astype(np.float32) + a)
    if ring == "plus_times":
        want = np.zeros(n)
        np.add.at(want, d, prod)
    else:
        want = np.full(n, np.inf, np.float32)
        np.minimum.at(want, d, prod)
    idx = np.unique(d)
    np.testing.assert_array_equal(gi, idx)
    if rt == "INT32":
        np.testing.assert_array_equal(gv, want[idx].astype(np.int64)
                                      .astype(np.int32))
    elif ring == "min_plus":
        np.testing.assert_array_equal(gv, want[idx])
    else:
        np.testing.assert_allclose(gv, want[idx], rtol=1e-5)


# ---- the infix slice on the card: the infix forms launch what the method
# forms launch and compute the same bits
def _launch_counts():
    return dict(K.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["vxm", "mxv", "mxm_sparse", "mxm_dense"])
def test_infix_forms_match_method_forms(cuda, kind):
    """``semiring.plus_times(u @ A)``, ``min_plus(A @ u)`` and
    ``min_plus(A @ B)`` against ``u.vxm``, ``A.mxv`` and ``A.mxm``: the
    same bits and the same kernel launches."""
    import graphblas_tpu_torch as gb

    rng = np.random.default_rng(41)
    n = 3000 if kind != "mxm_dense" else 300
    r, c = np.nonzero(rng.random((n, n)) < 0.003)
    a = rng.choice(np.float32([0.25, 1, 2, 3.5]), len(r))
    x = rng.random(n).astype(np.float32)
    limit = 0 if kind != "mxm_dense" else 1 << 22
    with gb.config.set(device=cuda, auto_sparse_limit=limit):
        A = gb.Matrix.from_coo(r, c, a, dtype="FP32", nrows=n, ncols=n)
        u = gb.Vector.from_coo(np.arange(n), x, dtype="FP32", size=n)
        pt, mp = gb.semiring.plus_times["FP32"], gb.semiring.min_plus["FP32"]
        forms = {"vxm": (lambda: u.vxm(A, pt), lambda: pt(u @ A)),
                 "mxv": (lambda: A.mxv(u, mp), lambda: mp(A @ u)),
                 "mxm_sparse": (lambda: A.mxm(A.T, mp), lambda: mp(A @ A.T)),
                 "mxm_dense": (lambda: A.mxm(A, mp), lambda: mp(A @ A))}[kind]
        forms[0]().new()  # plans
        outs, counts = [], []
        for fn in forms:
            before = _launch_counts()
            outs.append(fn().new())
            torch.cuda.synchronize()
            counts.append({k: K.launches[k] - v for k, v in before.items()})
    assert counts[0] == counts[1]
    if kind in ("vxm", "mxv"):
        assert counts[0]["gather_mult"] == 1
    if kind == "mxm_dense":
        assert counts[0]["tropical_matmul"] >= 1
    g, m = outs[1].to_coo(), outs[0].to_coo()
    for gg, mm in zip(g, m):
        np.testing.assert_array_equal(gg, mm)


@pytest.mark.gpu
@pytest.mark.parametrize("combine", ["v.S & u.V", "~v.S | u.S"])
def test_combined_mask_vxm(cuda, combine):
    """A vxm under a combined mask, on the lanepipe, against numpy."""
    import graphblas_tpu_torch as gb

    rng = np.random.default_rng(43)
    n = 4000
    r, c = np.nonzero(rng.random((n, n)) < 0.002)
    a = rng.random(len(r)).astype(np.float32)
    x = rng.random(n).astype(np.float32)
    v_in, u_in, u_val = (rng.random(n) < p for p in (0.3, 0.5, 0.5))
    with gb.config.set(device=cuda, auto_sparse_limit=0):
        A = gb.Matrix.from_coo(r, c, a, dtype="FP32", nrows=n, ncols=n)
        xv = gb.Vector.from_coo(np.arange(n), x, dtype="FP32", size=n)
        v = gb.Vector.from_coo(np.flatnonzero(v_in), 1.0, dtype="FP32",
                               size=n)
        u = gb.Vector.from_coo(np.flatnonzero(u_in), u_val[u_in],
                               dtype="BOOL", size=n)
        mask = v.S & u.V if combine == "v.S & u.V" else ~v.S | u.S
        w = gb.Vector(gb.dtypes.FP32, n)
        before = K.launches["gather_mult"]
        w(mask) << gb.semiring.plus_times["FP32"](xv @ A)
        assert K.launches["gather_mult"] == before + 1
        gi, gv = w.to_coo()
    want = np.bincount(c, weights=x[r].astype(np.float64) * a, minlength=n)
    allowed = (v_in & u_in & u_val if combine == "v.S & u.V"
               else ~v_in | u_in)
    idx = np.flatnonzero(allowed & (np.bincount(c, minlength=n) > 0))
    np.testing.assert_array_equal(gi, idx)
    np.testing.assert_allclose(gv, want[idx], rtol=1e-5)


@pytest.mark.gpu
def test_from_csr_to_csr_on_the_card(cuda):
    """from_csr at n = 2**16 stays sparse on the card and round-trips
    scipy's CSR and CSC bitwise."""
    import scipy.sparse as sps

    import graphblas_tpu_torch as gb

    rng = np.random.default_rng(47)
    n = 1 << 16
    r = rng.integers(0, n, 8 * n)
    c = (rng.zipf(1.5, 8 * n) - 1) % n
    S = sps.csr_matrix((rng.random(len(r)).astype(np.float32), (r, c)),
                       shape=(n, n))
    S.sum_duplicates()
    S.sort_indices()
    with gb.config.set(device=cuda):
        A = gb.Matrix.from_csr(S.indptr, S.indices, S.data, dtype="FP32",
                               nrows=n, ncols=n)
        assert A._sparse is not None and A._sparse.device.type == "cuda"
        indptr, ind, data = A.to_csr()
        cptr, cind, cdata = A.to_csc()
    Sc = S.tocsc()
    Sc.sort_indices()
    for got, want in ((indptr, S.indptr), (ind, S.indices), (data, S.data),
                      (cptr, Sc.indptr), (cind, Sc.indices),
                      (cdata, Sc.data)):
        np.testing.assert_array_equal(got.astype(want.dtype), want)


# ---- the ss extensions on the card: the scan runs K6, an imported graph
# runs the products, dense tiles joined by concat run K7
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,op", [("FP32", "plus"), ("INT32", "plus"),
                                      ("FP32", "max"), ("UINT16", "min"),
                                      ("BOOL", "lor")])
@pytest.mark.parametrize("order", ["rowwise", "columnwise"])
def test_ss_scan_launches_k6(cuda, dtype, op, order):
    """``A.ss.scan`` on a sparse store is one K6 call and equals the same
    scan by K6's plain version on the card's arrays."""
    import graphblas_tpu_torch as gb
    from graphblas_tpu_torch.core.engine import sparse as spx

    rng = np.random.default_rng(53)
    n = 20000
    r = rng.integers(0, n, 6 * n)
    c = (rng.zipf(1.6, 6 * n) - 1) % n
    vals = rng.integers(0, 5, len(r))
    with gb.config.set(device=cuda):
        A = gb.Matrix.from_coo(r, c, vals, dtype=dtype, nrows=n, ncols=n,
                               dup_op=gb.binary.first)
        assert A._sparse is not None
        before = K.launches["segscan"]
        S = A.ss.scan(op, order=order)
        torch.cuda.synchronize()
        assert K.launches["segscan"] == before + 1
        sp_ = A._sparse
        typed = getattr(gb.binary, op)[A.dtype]
        if order == "rowwise":
            group, x, perm = sp_.rows, sp_.vals, None
        else:
            perm = sp_.csc_perm()
            group, x = sp_.cols[perm], sp_.vals[perm]
        car = sp.to_carrier(x, A.dtype)
        plain = sp.segscan_channels_plain(
            spx.group_barrier(group), [car],
            [sp.monoid_combine(typed.monoid)])[0]
        plain = sp.from_carrier(plain, A.dtype)
        got = S._sparse.vals if perm is None else S._sparse.vals[perm]
        if dtype == "FP32":
            torch.testing.assert_close(got, plain, rtol=1e-6, atol=0)
        else:
            assert torch.equal(got, plain)


@pytest.mark.gpu
def test_import_csr_then_vxm_on_the_card(cuda):
    """A graph exported as CSR and imported again gives the original's vxm
    bitwise, through the same kernels."""
    import graphblas_tpu_torch as gb

    rng = np.random.default_rng(59)
    n = 1 << 15
    r = rng.integers(0, n, 8 * n)
    c = (rng.zipf(1.5, 8 * n) - 1) % n
    w = rng.random(len(r)).astype(np.float32)
    with gb.config.set(device=cuda):
        A = gb.Matrix.from_coo(r, c, w, dtype="FP32", nrows=n, ncols=n,
                               dup_op=gb.binary.plus)
        B = gb.Matrix.ss.import_csr(**A.ss.export("csr"))
        assert B.isequal(A) and B._sparse is not None
        u = gb.Vector.from_coo(np.arange(n), rng.random(n).astype(np.float32),
                               dtype="FP32", size=n)
        ring = gb.semiring.plus_times["FP32"]
        outs, counts = [], []
        for M in (A, B):
            u.vxm(M, ring).new()  # plans
            before = _launch_counts()
            outs.append(u.vxm(M, ring).new())
            torch.cuda.synchronize()
            counts.append({k: K.launches[k] - v for k, v in before.items()})
    assert counts[0] == counts[1] and counts[0]["gather_mult"] == 1
    assert outs[0].isequal(outs[1])


@pytest.mark.gpu
def test_concat_dense_tiles_then_min_plus_launches_k7(cuda):
    import graphblas_tpu_torch as gb

    rng = np.random.default_rng(61)
    full = rng.random((512, 512)).astype(np.float32)
    full[rng.random(full.shape) < 0.5] = np.inf
    with gb.config.set(device=cuda):
        tiles = [[gb.Matrix.from_dense(full[i:i + 256, j:j + 256],
                                       missing_value=np.inf)
                  for j in (0, 256)] for i in (0, 256)]
        D = gb.ss.concat(tiles)
        assert D._sparse is None
        E = gb.Matrix.from_dense(full, missing_value=np.inf)
        before = K.launches["tropical_matmul"]
        got = D.mxm(D, gb.semiring.min_plus).new()
        torch.cuda.synchronize()
        assert K.launches["tropical_matmul"] > before
        assert got.isequal(E.mxm(E, gb.semiring.min_plus).new())


# --------------------------------------------------------------------- #
# the complex types and user-defined types on the card: torch ops, no
# kernel, until a complex value turns real (creal, cimag)
def _magnetic(gb, n, dtype, seed=71):
    """A zipf-like digraph with weights exp(i theta) / outdeg."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, 6 * n)
    c = (rng.zipf(1.5, 6 * n) - 1) % n
    lin = np.unique(r * n + c)
    r, c = lin // n, lin % n
    deg = np.bincount(r, minlength=n)
    theta = rng.uniform(0, 2 * np.pi, len(r))
    w = (np.exp(1j * theta) / deg[r]).astype(
        gb.dtypes.lookup_dtype(dtype).np_type)
    return r, c, w, theta, deg


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rel", [("FC32", 1e-5), ("FC64", 1e-12)])
def test_complex_vxm_and_reduce_on_the_card(cuda, dtype, rel):
    import scipy.sparse as sps

    import graphblas_tpu_torch as gb

    n = 1 << 14
    r, c, w, _, _ = _magnetic(gb, n, dtype)
    M = sps.csr_matrix((w.astype(np.complex128), (r, c)), shape=(n, n))
    rng = np.random.default_rng(72)
    x = (rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)).astype(w.dtype)
    with gb.config.set(device=cuda, auto_sparse_limit=0):
        A = gb.Matrix.from_coo(r, c, w, dtype=dtype, nrows=n, ncols=n)
        u = gb.Vector.from_dense(x, dtype=dtype)
        before = _launch_counts()
        got = {"vxm": u.vxm(A, gb.semiring.plus_times[dtype]).new(),
               "mxv": A.mxv(u, gb.semiring.plus_times[dtype]).new(),
               "rows": A.reduce_rowwise(gb.monoid.plus[dtype]).new(),
               "cols": A.reduce_columnwise(gb.monoid.plus[dtype]).new()}
        total = A.reduce_scalar(gb.monoid.plus[dtype]).new().value
        torch.cuda.synchronize()
        assert _launch_counts() == before  # no complex value in a kernel
    xs = x.astype(np.complex128)
    want = {"vxm": M.T @ xs, "mxv": M @ xs,
            "rows": np.asarray(M.sum(axis=1)).ravel(),
            "cols": np.asarray(M.sum(axis=0)).ravel()}
    for key, vec in got.items():
        idx, vals = vec.to_coo()
        assert vec.dtype.name == dtype
        ref = want[key][idx.astype(np.int64)]
        scale = np.abs(ref).max()
        assert np.all(np.abs(vals - ref) <= rel * np.maximum(np.abs(ref),
                                                            scale)), key
    assert abs(total - M.sum()) <= rel * abs(M.sum()) + rel


@pytest.mark.gpu
def test_udt_ewise_add_on_the_card(cuda):
    import graphblas_tpu_torch as gb

    pt = gb.dtypes.register_anonymous(
        np.dtype([("x", np.float64), ("y", np.float64)]), "gpu_point_t")
    rng = np.random.default_rng(73)
    n = 1 << 12
    mats = []
    for _ in range(2):
        lin = np.unique(rng.integers(0, n * n, 8 * n))
        v = np.empty(len(lin), pt.np_type)
        v["x"], v["y"] = rng.random(len(lin)), rng.random(len(lin))
        mats.append((lin, v))
    add = gb.binary.register_anonymous(
        lambda a, b: {"x": a["x"] + b["x"], "y": a["y"] - b["y"]},
        is_udt=True)
    with gb.config.set(device=cuda, auto_sparse_limit=0):
        A, B = (gb.Matrix.from_coo(lin // n, lin % n, v, dtype=pt, nrows=n,
                                   ncols=n) for lin, v in mats)
        before = _launch_counts()
        C = A.ewise_add(B, add).new()
        torch.cuda.synchronize()
        assert _launch_counts() == before
        assert C._sparse is not None and C._sparse.vals.device.type == "cuda"
    (la, va), (lb, vb) = mats
    keys = np.union1d(la, lb)
    r, c, got = C.to_coo()
    assert np.array_equal(r.astype(np.int64) * n + c.astype(np.int64), keys)
    ia, ib = np.isin(keys, la), np.isin(keys, lb)
    wx, wy = np.zeros(len(keys)), np.zeros(len(keys))
    pa, pb = np.searchsorted(la, keys[ia]), np.searchsorted(lb, keys[ib])
    wx[ia] += va["x"][pa]
    wx[ib] += vb["x"][pb]
    wy[ia] += va["y"][pa]
    wy[ib & ia] -= vb["y"][np.searchsorted(lb, keys[ib & ia])]
    wy[ib & ~ia] = vb["y"][np.searchsorted(lb, keys[ib & ~ia])]
    assert np.array_equal(got["x"], wx) and np.array_equal(got["y"], wy)


@pytest.mark.gpu
def test_creal_of_cmplx_runs_pagerank_through_the_kernels(cuda):
    """creal(W cmplx V) is W bit for bit, contiguous, and a PageRank vxm
    on it launches the same kernels as on W, with the same result."""
    import graphblas_tpu_torch as gb

    n = 1 << 15
    r, c, w, theta, deg = _magnetic(gb, n, "FC32")
    wr = (1.0 / deg[r]).astype(np.float32)
    vi = (np.sin(theta) / deg[r]).astype(np.float32)
    ring = gb.semiring.plus_times["FP32"]
    with gb.config.set(device=cuda, auto_sparse_limit=0):
        W = gb.Matrix.from_coo(r, c, wr, dtype="FP32", nrows=n, ncols=n)
        V = gb.Matrix.from_coo(r, c, vi, dtype="FP32", nrows=n, ncols=n)
        Z = W.ewise_mult(V, gb.binary.cmplx).new()
        assert Z.dtype.name == "FC32"
        Re = Z.apply(gb.unary.creal).new()
        Im = Z.apply(gb.unary.cimag).new()
        assert Re._sparse.vals.is_contiguous()
        assert Re.isequal(W, check_dtype=True)
        assert Im.isequal(V, check_dtype=True)
        u = gb.Vector.from_dense(np.full(n, 1.0 / n, np.float32))
        outs, counts = [], []
        for M in (W, Re):
            u.vxm(M, ring).new()  # plans
            before = _launch_counts()
            outs.append(u.vxm(M, ring).new())
            torch.cuda.synchronize()
            counts.append({k: K.launches[k] - v for k, v in before.items()})
        assert counts[0] == counts[1] and counts[0]["gather_mult"] == 1
        assert outs[0].isequal(outs[1])
        before = K.launches["segscan"]
        rim = Im.reduce_rowwise().new()
        assert K.launches["segscan"] > before
        assert rim.isequal(V.reduce_rowwise().new())
