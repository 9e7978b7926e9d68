"""K1's multiply over every builtin operator and type of at most 32 bits,
each operand in its own type, against the JAX package.

- The predicate that decides what K1 takes (``kernels.k1_code``, which
  ``sortpipe.eligible_spmv`` asks): mixed operand types are K1's (PageRank
  over a BOOL adjacency, an INT32 vector times BOOL or FP32 matrices);
  user functions, numpy ufuncs, the JAX package's Python binaries and
  64-bit types are not, on the CPU as on the card.
- The grid: ``sortpipe.multiply`` (what K1's plain version and the sort
  pipeline compute) against the JAX package's ``dense.apply_binop`` and
  cast, eagerly, for every (op, type) pair and a set of mixed pairs, both
  operand orders.  Integers and BOOL exactly; FP32 within rel 1e-6 (the
  math libraries' last bits), NaN where NaN.
- K1's plain version against the Pallas kernel in interpret mode on the
  same plan arrays, for eight variants of the slice (mixed, narrow,
  comparison, the new monoids): integer words bitwise, FP32 values equal.

tests/test_torch_type_products.py and test_torch_type_reduces.py take the
new types through both public APIs.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt
from graphblas_tpu.core.engine import dense as jdense
from graphblas_tpu.core.engine import lanepipe as jlp
from graphblas_tpu.core.engine import store as jst
from graphblas_tpu_torch.core import dtypes as tdt
from graphblas_tpu_torch.core.engine import kernels as K
from graphblas_tpu_torch.core.engine import lanepipe as tlp
from graphblas_tpu_torch.core.engine import sortpipe as tsp

from .test_lanepipe import random_graph
from .test_torch_lanepipe import both_entries, padded_u

torch.set_num_threads(1)

TYPES = ("BOOL", "INT8", "INT16", "INT32", "UINT8", "UINT16", "UINT32",
         "FP32")
N = 97


# --------------------------------------------------------------------- #
# the predicate
def test_k1_takes_mixed_operands():
    """The three calls that reached K1 with a_dt != u_dt (and raised on the
    card before): K1 takes them, each operand in its own type."""
    S, d = gbt.semiring, gbt.dtypes
    for ring, a_dt, u_dt in ((S.plus_times["FP32"], d.BOOL, d.FP32),
                             (S.plus_times["INT32"], d.BOOL, d.INT32),
                             (S.min_plus["FP32"], d.FP32, d.INT32)):
        for x_dt, y_dt in ((a_dt, u_dt), (u_dt, a_dt)):  # mxv, vxm
            code = K.k1_code(ring.binaryop, x_dt, y_dt, ring.monoid.type)
            assert code is not None and code[1] == 0, ring  # not a fast path
        assert tsp.eligible_spmv(ring, a_dt, u_dt)
    # the fast paths keep their templates
    for ring, dt, fast in ((S.plus_times, "FP32", 1), (S.min_plus, "FP32", 2),
                           (S.lor_land, "BOOL", 3)):
        r = ring[dt]
        t = r.binaryop.type
        assert K.k1_code(r.binaryop, t, t, r.monoid.type) == (
            K.k1_code(r.binaryop, t, t, r.monoid.type)[0], fast)


def test_k1_refuses_what_it_cannot_compile():
    """A multiply that is not in the builtin table, or a type of 64 bits,
    is refused up front, and the generic engine takes the ring."""
    S, d = gbt.semiring, gbt.dtypes
    udf = gbt.binary.register_anonymous(lambda x, y: x * 2 + y, "udf_k1")
    refused = [(S.plus_floordiv["INT16"], d.INT16),
               (S.numpy.add_floor_divide["INT32"], d.INT32),
               (S.plus_times["UINT64"], d.UINT64),
               (S.plus_truediv["INT8"], d.INT8),  # an FP64 product
               (gbt.semiring.get_semiring(gbt.monoid.plus, udf)["INT32"],
                d.INT32),
               (S.ss.min_firsti["INT32"], d.INT32)]
    for ring, dt in refused:
        assert K.k1_code(ring.binaryop, dt, dt, ring.monoid.type) is None, ring
        assert not tsp.eligible_spmv(ring, dt, dt), ring
    # and the new monoids scan where their types fit a carrier
    for ring, dt in ((S.lxor_land["BOOL"], d.BOOL),
                     (S.eq_eq["BOOL"], d.BOOL),
                     (S.bxor_band["UINT16"], d.UINT16),
                     (S.lxnor_lt["FP32"], d.FP32)):
        assert tsp.eligible_spmv(ring, dt, dt), ring


# --------------------------------------------------------------------- #
# the grid against the JAX package's multiply
def _values(rng, name, n, small_exponent=False, finite=False):
    if name == "FP32":
        if small_exponent:
            return rng.integers(-10, 11, n).astype(np.float32)
        if finite:
            return (4 * rng.standard_normal(n)).astype(np.float32)
        pool = np.float32([0, -0.0, 1.5, -2, np.nan, np.inf, -np.inf, 7,
                           300.7, -40000.5, 3e9, 0.5])
        x = np.where(rng.random(n) < 0.5, rng.choice(pool, n),
                     4 * rng.standard_normal(n))
        return x.astype(np.float32)
    if name == "BOOL":
        return rng.random(n) < 0.5
    npt = np.dtype(name.lower())
    info = np.iinfo(npt)
    x = rng.integers(int(info.min), int(info.max) + 1, n,
                     dtype=np.uint64 if name == "UINT64" else np.int64)
    small = rng.random(n) < 0.4
    x[small] = rng.integers(-3 if info.min < 0 else 0, 9, int(small.sum()))
    return x.astype(npt)


GRID = [(op, t, t, t) for op in K.K1_OP for t in TYPES
        if tdt.lookup_dtype(t) in getattr(gbt.binary, op)._typed_ops
        and K.k1_code(getattr(gbt.binary, op)[t], tdt.lookup_dtype(t),
                      tdt.lookup_dtype(t),
                      getattr(gbt.binary, op)[t].return_type) is not None]
MIXED = [("times", "BOOL", "FP32", "FP32"), ("times", "BOOL", "INT32", "INT32"),
         ("plus", "FP32", "INT32", "FP32"), ("lt", "INT8", "FP32", "FP32"),
         ("times", "UINT16", "INT32", "INT32"), ("plus", "FP32", "INT8", "INT8"),
         ("bxor", "INT32", "UINT8", "UINT8"), ("pow", "UINT8", "INT16", "INT16"),
         ("land", "FP32", "BOOL", "BOOL"), ("eq", "UINT32", "INT32", "INT32"),
         ("minus", "INT16", "UINT16", "UINT16"), ("max", "UINT32", "FP32", "FP32"),
         ("bshift", "INT8", "INT32", "INT8"), ("cdiv", "FP32", "UINT8", "UINT8"),
         ("rminus", "BOOL", "INT16", "INT16"), ("atan2", "INT16", "INT16", "INT16")]


@pytest.mark.parametrize("op,a_t,u_t,t", GRID + MIXED,
                         ids=[f"{o}-{a}x{u}-{t}" for o, a, u, t in GRID + MIXED])
def test_multiply_matches_jax(op, a_t, u_t, t):
    rng = np.random.default_rng(zlib.crc32(f"{op}{a_t}{u_t}{t}".encode()))
    a = _values(rng, a_t, N)
    u = _values(rng, u_t, N, small_exponent=op == "ldexp")
    tmult = getattr(gbt.binary, op)[t]
    jmult = getattr(gbj.binary, op)[t]
    assert (tmult.type.name, tmult.return_type.name) == \
        (jmult.type.name, jmult.return_type.name)
    z_t = tmult.return_type  # the monoid's type: the product's own
    a_dt, u_dt = tdt.lookup_dtype(a_t), tdt.lookup_dtype(u_t)
    ja_dt, ju_dt = gbj.dtypes.lookup_dtype(a_t), gbj.dtypes.lookup_dtype(u_t)
    a_c = tsp.to_carrier(tdt.to_tensor(a, a_dt, "cpu"), a_dt)
    u_c = tsp.to_carrier(tdt.to_tensor(u, u_dt, "cpu"), u_dt)
    for kind in ("mxv", "vxm"):
        got = tdt.to_numpy(tsp.from_carrier(
            tsp.multiply(tmult, a_c, u_c, a_dt, u_dt, z_t, kind), z_t), z_t)
        with jax.enable_x64(True):
            x, xd, y, yd = (a, ja_dt, u, ju_dt) if kind == "mxv" else \
                (u, ju_dt, a, ja_dt)
            want = jdense.apply_binop(jmult, jnp.asarray(x), xd,
                                      jnp.asarray(y), yd)
            want = np.asarray(jst.cast_values(want, jmult.return_type,
                                              jmult.return_type))
        assert got.dtype == want.dtype
        if want.dtype.kind == "f":
            nan = np.isnan(want)
            assert np.array_equal(np.isnan(got), nan), kind
            np.testing.assert_allclose(got[~nan], want[~nan], rtol=1e-6,
                                       err_msg=kind)
        else:
            np.testing.assert_array_equal(got, want, err_msg=kind)


# --------------------------------------------------------------------- #
# K1's plain version against the Pallas kernel, on the slice's variants
PALLAS_CASES = [
    # ring, ring type, matrix type, vector type, kind, full_u, permA
    ("plus_times", "FP32", "BOOL", "FP32", "vxm", True, True),
    ("plus_times", "INT32", "BOOL", "INT32", "mxv", False, True),
    ("min_plus", "FP32", "FP32", "INT32", "vxm", False, False),
    ("min_plus", "INT8", "INT8", "INT8", "mxv", True, True),
    ("lor_lt", "FP32", "FP32", "FP32", "vxm", False, True),
    ("bxor_band", "UINT16", "UINT16", "UINT16", "vxm", False, True),
    ("eq_eq", "BOOL", "BOOL", "BOOL", "mxv", False, False),
    ("max_minus", "UINT16", "UINT16", "UINT16", "mxv", True, True),
]
JCARRIER = {"FP32": np.float32, "UINT32": np.uint32}


@pytest.mark.parametrize("ring_name,rt,a_t,u_t,kind,full_u,with_pa",
                         PALLAS_CASES,
                         ids=[f"{c[0]}-{c[2]}x{c[3]}-{c[4]}" for c in PALLAS_CASES])
def test_gather_mult_matches_pallas(rng, monkeypatch, ring_name, rt, a_t, u_t,
                                    kind, full_u, with_pa):
    monkeypatch.setattr(jlp, "_INTERPRET", True)
    n = 200
    r, c, _ = random_graph(rng, n, 1500, "FP32")
    a = _values(rng, a_t, len(r))
    a_carrier = tsp.np_carrier(a, tdt.lookup_dtype(a_t))
    d, k = (r, c) if kind == "mxv" else (c, r)
    plan, tentry, jdev = both_entries(r, c, a_carrier.view(np.float32)
                                      if a_t == "FP32" else a_carrier,
                                      "FP32" if a_t == "FP32" else "INT32", n,
                                      kind == "mxv")
    # finite: the Pallas kernel, under XLA's simplifier, computes x *
    # float(b) of a BOOL b as a select, which gives 0 where IEEE (the
    # port, and the JAX package's eager multiply in the grid above) gives
    # NaN for an infinite x
    xv = _values(rng, u_t, n, finite=True)
    xok = np.ones(n, bool) if full_u else rng.random(n) < 0.6
    u_car = tsp.np_carrier(xv, tdt.lookup_dtype(u_t))
    u2, u2ok = padded_u(u_car.view(np.float32) if u_t == "FP32" else u_car,
                        xok, "FP32" if u_t == "FP32" else "INT32", n)
    jring = getattr(gbj.semiring, ring_name)[rt]
    tring = getattr(gbt.semiring, ring_name)[rt]
    packed = tring.monoid.type.is_bool
    kw = dict(kind=kind, R_g=plan["R_g"], nblocks=plan["nblocks_g"],
              packed=packed, full_u=full_u)
    ja, ju = gbj.dtypes.lookup_dtype(a_t), gbj.dtypes.lookup_dtype(u_t)
    with jax.enable_x64(False):
        want, want_ok = jlp.gather_mult(
            tuple(jdev[k] for k in ("meta", "idx1_g", "locidx_g", "okg",
                                    "avals_g")),
            jnp.asarray(u2.astype(JCARRIER.get(u_t, u2.dtype))),
            jnp.asarray(u2ok), jring.binaryop, ja, ju, jring.monoid,
            permA=jdev["routeP"][0] if with_pa else None, **kw)
    td = tentry["dev"]
    got, got_ok = tlp.gather_mult(
        (td["meta"], td["idx1_g"], td["locidx_g"], td["okg"], td["avals_g"]),
        torch.from_numpy(u2), torch.from_numpy(u2ok), tring.binaryop,
        tdt.lookup_dtype(a_t), tdt.lookup_dtype(u_t), tring.monoid,
        permA=td["routeP"][0] if with_pa else None, **kw)
    want = np.asarray(want)
    if want.dtype.kind == "f":
        # equal values, NaN where NaN: XLA rewrites x * float(b) of a BOOL
        # b as a select, so its 0 is +0 where the port's x * 0.0 is -0
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert (got_ok is None) == (want_ok is None)
    if want_ok is not None:
        assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))
