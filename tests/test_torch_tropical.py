"""Kernel K7's plain version against the Pallas kernel it replaces.

``graphblas_tpu_torch.core.engine.tropical.tropical_matmul_plain`` and
``graphblas_tpu.core.engine.kernels.tropical.tropical_matmul`` (the Pallas
kernel itself, run on the CPU in the TPU interpret mode) get the same numpy
operands, made from a seed, with missing entries encoded as the reduce's
identity.  All 12 (reduce, combine) pairs, a ragged shape and a
block-multiple one, FP32 and FP64, and operands that hold NaN and both
infinities: every element must be equal, NaN matching NaN (min/max and
one rounding per product are order-independent, so there is no tolerance).

One quirk of the Pallas kernel is kept out of the comparison: it pads a
ragged k with the identity on both operands, and for (max, times) the
padding's product (-inf)(-inf) = +inf wins every maximum.  That pair is
held at shapes whose k the kernel does not pad.

The entry point with validity planes has no Pallas counterpart; it is held
against a loop over k in numpy that skips every pair with a missing
operand, and against the JAX package's blocked product through
``semiring_matmul`` in test_torch_dense.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphblas_tpu.core.engine.kernels import tropical as jtr
from graphblas_tpu_torch.core.engine import tropical as ttr

torch.set_num_threads(1)

REDS = ("min", "max")
COMBS = ("plus", "min", "max", "times", "first", "second")
RAGGED = (300, 260, 200)   # m, k, n: the Pallas kernel pads m and k
BLOCKS = (256, 128, 256)   # one block of each Pallas dimension
RAGGED_MN = (300, 256, 200)  # k a multiple of the Pallas k block


def operands(seed, shape, dtype, ident, special=False):
    """a (m,k) and b (k,n) with a fifth of the entries missing (encoded as
    ident); with `special`, stored NaN and infinities of both signs."""
    rng = np.random.default_rng(seed)
    m, k, n = shape
    out = []
    for s in ((m, k), (k, n)):
        v = (rng.standard_normal(s) * 10).astype(dtype)
        if special:
            pick = rng.random(s)
            v[pick < 0.01] = np.inf
            v[(pick >= 0.01) & (pick < 0.02)] = -np.inf
            v[(pick >= 0.02) & (pick < 0.025)] = np.nan
        v[rng.random(s) < 0.2] = ident
        out.append(v)
    return out


def pallas(a, b, red, comb):
    """The Pallas kernel in interpret mode.  Its callbacks run on threads
    that see only the global x64 flag, so FP64 sets that and puts it back."""
    x64 = a.dtype == np.float64
    before = jax.config.jax_enable_x64
    try:
        if x64:
            jax.config.update("jax_enable_x64", True)
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(jtr.tropical_matmul(
                jnp.asarray(a), jnp.asarray(b), red, comb))
    finally:
        jax.config.update("jax_enable_x64", before)


def assert_same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    assert same.all(), f"{(~same).sum()} of {same.size} elements differ"


@pytest.mark.parametrize("comb", COMBS)
@pytest.mark.parametrize("red", REDS)
def test_plain_matches_pallas_fp32(red, comb):
    ident = np.inf if red == "min" else -np.inf
    ragged = RAGGED_MN if (red, comb) == ("max", "times") else RAGGED
    for shape in (ragged, BLOCKS):
        for special in (False, True):
            a, b = operands(len(comb) + special, shape, np.float32, ident,
                            special)
            got = ttr.tropical_matmul_plain(torch.from_numpy(a),
                                            torch.from_numpy(b), red, comb)
            assert_same(got.numpy(), pallas(a, b, red, comb))


@pytest.mark.parametrize("red,comb", [("min", "plus"), ("max", "min")])
def test_plain_matches_pallas_fp64(red, comb):
    ident = np.inf if red == "min" else -np.inf
    for special in (False, True):
        a, b = operands(7 + special, RAGGED, np.float64, ident, special)
        got = ttr.tropical_matmul_plain(torch.from_numpy(a),
                                        torch.from_numpy(b), red, comb)
        assert got.dtype == torch.float64
        assert_same(got.numpy(), pallas(a, b, red, comb))


def test_pallas_pads_max_times_with_plus_inf():
    """The quirk the module docstring names: the port's product is the
    true maximum where the Pallas kernel returns +inf."""
    a = -np.ones((4, 130), np.float32)
    b = np.ones((130, 4), np.float32)
    assert np.isposinf(pallas(a, b, "max", "times")).all()
    got = ttr.tropical_matmul_plain(torch.from_numpy(a), torch.from_numpy(b),
                                    "max", "times")
    assert (got.numpy() == -1.0).all()


def masked_reference(a, b, aok, bok, red, comb):
    """Loop over k, skipping pairs with a missing operand; red propagates
    NaN, comb is the GraphBLAS binary op."""
    ident = np.inf if red == "min" else -np.inf
    rfn = np.minimum if red == "min" else np.maximum
    cfn = {"plus": np.add, "fmin": np.fmin, "fmax": np.fmax}[comb]
    out = np.full((a.shape[0], b.shape[1]), ident, a.dtype)
    for k in range(a.shape[1]):
        with np.errstate(invalid="ignore"):
            p = cfn(a[:, k, None], b[None, k, :])
        ok = aok[:, k, None] & bok[None, k, :]
        out = rfn(out, np.where(ok, p, a.dtype.type(ident)))
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("red,comb", ttr.MASKED_PAIRS)
def test_validity_planes_skip_missing_pairs(red, comb, dtype):
    rng = np.random.default_rng(11)
    for shape in ((70, 90, 50), (1, 90, 50), (70, 90, 1), (1, 33, 1)):
        ident = np.inf if red == "min" else -np.inf
        a, b = operands(3, shape, dtype, ident, special=True)
        aok = rng.random(a.shape) < 0.6
        bok = rng.random(b.shape) < 0.6
        aok[0, :] = False  # an empty row: its outputs stay at the identity
        got = ttr.tropical_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                  red, comb, torch.from_numpy(aok),
                                  torch.from_numpy(bok))
        assert_same(got.numpy(), masked_reference(a, b, aok, bok, red, comb))
        assert (got[0].numpy() == ident).all()


def test_wrapper_on_cpu_is_the_plain_version():
    a, b = operands(5, (40, 30, 20), np.float32, np.inf)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    before = ttr.plain_calls
    got = ttr.tropical_matmul(ta, tb, "min", "plus")
    assert ttr.plain_calls == before + 1
    assert torch.equal(got, ttr.tropical_matmul_plain(ta, tb, "min", "plus"))
    assert got.shape == (40, 20)
    empty = ttr.tropical_matmul(ta[:, :0], tb[:0], "max", "plus")
    assert (empty == -np.inf).all()  # k = 0: nothing but the identity
    assert ttr.available() == torch.cuda.is_available()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    a = torch.zeros(4, 3)
    b = torch.zeros(3, 5)
    ok = torch.ones(4, 3, dtype=torch.bool)
    with pytest.raises(ValueError, match="shapes"):
        ttr.tropical_matmul(a, a, "min", "plus")
    with pytest.raises(ValueError, match="no \\(plus"):
        ttr.tropical_matmul(a, b, "plus", "times")
    with pytest.raises(TypeError, match="float32 or"):
        ttr.tropical_matmul(a.int(), b.int(), "min", "plus")
    with pytest.raises(TypeError, match="float32 or"):
        ttr.tropical_matmul(a, b.double(), "min", "plus")
    with pytest.raises(ValueError, match="both validity planes"):
        ttr.tropical_matmul(a, b, "min", "plus", ok)
    with pytest.raises(ValueError, match="no entry point"):
        ttr.tropical_matmul(a, b, "min", "times", ok,
                            torch.ones(3, 5, dtype=torch.bool))
    with pytest.raises(TypeError, match="bool"):
        ttr.tropical_matmul(a, b, "min", "plus", ok.int(),
                            torch.ones(3, 5, dtype=torch.int32))
