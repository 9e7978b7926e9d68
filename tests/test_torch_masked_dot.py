"""The masked dot's count mode (engine/sparse.py ``dot_by_counts``): under a
builtin ``pair`` multiply the value at each mask entry follows from its
number of matching terms, which ``masked_dot_counts`` (kernel K8 on the
card, its plain version here) counts without a tensor per term.

Held bit for bit against the expansion of every term
(``_dot_term_slots``, the path every other ring takes) for each monoid
the count mode takes, over BOOL, INT8 (plus past 127, so the cast wraps),
INT32, INT64, UINT64 and FP32, structural and value masks (the value mask
has false values), A and B each transposed or not, mask entries with no
term, entries whose terms all miss, and empty rows and columns; and the
same products, through ``mxm`` with ``axb_method="dot"``, against the JAX
package's, structure, type and values exactly.  The counts themselves
against Python sets."""

import os
import sys

import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gb
from graphblas_tpu_torch.core import trace
from graphblas_tpu_torch.core.engine import sparse as spx

torch.set_num_threads(1)

NR, NC, KD = 40, 36, 300  # output rows, output columns, contraction
HUB = 3  # rows of A and columns of B that share about 190 indices

RINGS = ([("plus", t) for t in ("INT8", "INT32", "INT64", "UINT64", "FP32")]
         + [("any", t) for t in ("BOOL", "INT8", "INT32", "INT64", "UINT64",
                                 "FP32")]
         + [(m, t) for m in ("min", "max", "times")
            for t in ("INT8", "INT32", "INT64", "UINT64", "FP32")]
         + [("land", "BOOL"), ("lor", "BOOL"), ("band", "UINT64"),
            ("bor", "UINT64")])
SIDES = [(False, True), (False, False), (True, True), (True, False)]


def _effective(seed):
    """(A as (i, k), B as (k, j), mask (i, j, value)) coordinates: HUB rows
    of A and columns of B over most of k < 200 (counts above 127), row 5
    of A and column 7 of B empty, and a sparse random rest."""
    rng = np.random.default_rng(seed)
    a = rng.random((NR, KD)) < 0.1
    b = rng.random((KD, NC)) < 0.1
    a[:HUB, :200] = rng.random((HUB, 200)) < 0.97
    b[:200, :HUB] = rng.random((200, HUB)) < 0.97
    a[5] = False
    b[:, 7] = False
    m = rng.random((NR, NC)) < 0.3
    m[np.arange(HUB), np.arange(HUB)] = True
    m[5, :4] = m[:4, 7] = True
    mi, mj = np.nonzero(m)
    mv = rng.random(len(mi)) < 0.7
    mv[:HUB] = True
    return np.nonzero(a), np.nonzero(b), (mi, mj, mv)


def _store(r, c, nrows, ncols, dtype="INT64", vals=None):
    vals = np.ones(len(r), np.int64) if vals is None else vals
    with gb.config.set(device="cpu", auto_sparse_limit=0):
        M = gb.Matrix.from_coo(r, c, vals, dtype=dtype, nrows=nrows,
                               ncols=ncols)
    assert M._sparse is not None
    return M._sparse


_CACHE = {}


def operands(at, bt):
    """Stores (a, b, mask) for C<M> = op(A) @ op(B): a is stored as A.T
    where at, b as B where bt is False and as B.T where it is True."""
    key = (at, bt)
    if key not in _CACHE:
        (ai, ak), (bk, bj), (mi, mj, mv) = _effective(7)
        a = _store(ak, ai, KD, NR) if at else _store(ai, ak, NR, KD)
        b = _store(bj, bk, NC, KD) if bt else _store(bk, bj, KD, NC)
        m = _store(mi, mj, NR, NC, "BOOL", mv)
        _CACHE[key] = a, b, m
    return _CACHE[key]


def slots(fn, ring, at, bt, structure):
    a, b, m = operands(at, bt)
    total = int(spx.spgemm_dot_total(a, b, m, gb.dtypes.BOOL, structure, at,
                                     bt, NR, NC, KD)[1])
    return fn(a, b, m, at, bt, ring, gb.dtypes.INT64, gb.dtypes.INT64,
              gb.dtypes.BOOL, structure, NR, NC, KD, total)


def bits(x):
    if x.dtype.is_floating_point:
        return x.view({4: torch.int32, 8: torch.int64}[x.element_size()])
    return x


@pytest.mark.parametrize("at,bt", SIDES, ids=["nt", "nn", "tt", "tn"])
@pytest.mark.parametrize("structure", [True, False], ids=["S", "V"])
@pytest.mark.parametrize("mono,typ", RINGS,
                         ids=[f"{m}_pair-{t}" for m, t in RINGS])
def test_count_mode_is_the_term_path_bit_for_bit(mono, typ, structure, at,
                                                 bt):
    ring = getattr(gb.semiring, f"{mono}_pair")[typ]
    assert spx.dot_by_counts(ring)
    got = slots(spx.masked_dot_slots, ring, at, bt, structure)
    want = slots(spx._dot_term_slots, ring, at, bt, structure)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(bits(g), bits(w))
    vals, valid, ok_m = got
    assert bool(valid.any()) and not bool(valid.all())
    if not structure:
        assert not bool(ok_m.all())
    if (mono, typ) == ("plus", "INT8"):
        assert bool((vals[valid] < 0).any())  # a count past 127 wrapped


_JAX = {}


def raw(x):
    """A numpy array's bits, so floats compare exactly."""
    return x if x.dtype == bool else x.view(f"u{x.itemsize}")


def jax_product(mono, typ, structure):
    """C<M> = A @ B under mono_pair[typ] by the JAX package, as (type name,
    rows, cols, values); the same for every at/bt, so made once."""
    key = (mono, typ, structure)
    if key not in _JAX:
        (ai, ak), (bk, bj), (mi, mj, mv) = _effective(7)
        with gbj.config.set(auto_sparse_limit=0):
            A = gbj.Matrix.from_coo(ai, ak, 1, dtype="INT64", nrows=NR,
                                    ncols=KD)
            B = gbj.Matrix.from_coo(bk, bj, 1, dtype="INT64", nrows=KD,
                                    ncols=NC)
            M = gbj.Matrix.from_coo(mi, mj, mv, dtype="BOOL", nrows=NR,
                                    ncols=NC)
            ring = getattr(gbj.semiring, f"{mono}_pair")[typ]
            C = A.mxm(B, ring).new(mask=M.S if structure else M.V,
                                   axb_method="dot")
            _JAX[key] = (C.dtype.name, *C.to_coo())
    return _JAX[key]


@pytest.mark.parametrize("at,bt", SIDES, ids=["nt", "nn", "tt", "tn"])
@pytest.mark.parametrize("structure", [True, False], ids=["S", "V"])
@pytest.mark.parametrize("mono,typ", RINGS,
                         ids=[f"{m}_pair-{t}" for m, t in RINGS])
def test_count_mode_is_the_jax_packages_product(mono, typ, structure, at,
                                                bt):
    """The port's mxm, A and B each stored transposed or not, by the count
    mode (its counter says so), equal to the JAX package's product."""
    (ai, ak), (bk, bj), (mi, mj, mv) = _effective(7)
    with gb.config.set(device="cpu", auto_sparse_limit=0):
        if at:
            A = gb.Matrix.from_coo(ak, ai, 1, dtype="INT64", nrows=KD,
                                   ncols=NR).T
        else:
            A = gb.Matrix.from_coo(ai, ak, 1, dtype="INT64", nrows=NR,
                                   ncols=KD)
        if bt:
            B = gb.Matrix.from_coo(bj, bk, 1, dtype="INT64", nrows=NC,
                                   ncols=KD).T
        else:
            B = gb.Matrix.from_coo(bk, bj, 1, dtype="INT64", nrows=KD,
                                   ncols=NC)
        M = gb.Matrix.from_coo(mi, mj, mv, dtype="BOOL", nrows=NR, ncols=NC)
        ring = getattr(gb.semiring, f"{mono}_pair")[typ]
        before = trace.counts["masked_dot.kernel_entries"]
        C = A.mxm(B, ring).new(mask=M.S if structure else M.V,
                               axb_method="dot")
        assert trace.counts["masked_dot.kernel_entries"] - before == M.nvals
        got = (C.dtype.name, *C.to_coo())
    want = jax_product(mono, typ, structure)
    assert got[0] == want[0] == typ
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(raw(g), raw(w))
    if (mono, typ) == ("plus", "INT8"):
        assert (got[3] < 0).any()  # a count past 127 wrapped


@pytest.mark.parametrize("at,bt", SIDES, ids=["nt", "nn", "tt", "tn"])
def test_counts_against_sets(at, bt):
    """masked_dot_counts on the CPU: each mask entry's count of k that A's
    row and B's column both store, 0 where the value mask fails."""
    (ai, ak), (bk, bj), (mi, mj, mv) = _effective(7)
    a_rows = [set(ak[ai == i]) for i in range(NR)]
    b_cols = [set(bk[bj == j]) for j in range(NC)]
    want = [len(a_rows[i] & b_cols[j]) if v else 0
            for i, j, v in zip(mi, mj, mv)]
    a, b, m = operands(at, bt)
    (a_side, b_side, ia, ib, _, _, _, cnt) = spx._dot_degrees(
        a, b, m, gb.dtypes.BOOL, False, at, bt, NR, NC)
    total = int(cnt.sum())
    got = spx.masked_dot_counts(a_side, b_side, ia, ib, m.rows, m.cols, cnt,
                                total, KD)
    assert got.dtype == torch.int64
    assert got.tolist() == want
    assert max(want) > 127 and 0 in want


def test_counts_of_an_empty_mask_and_no_terms():
    a, b, m = operands(False, True)
    e = torch.zeros(0, dtype=torch.int64)
    (a_side, b_side, ia, ib, *_) = spx._dot_degrees(
        a, b, m, gb.dtypes.BOOL, True, False, True, NR, NC)
    assert spx.masked_dot_counts(a_side, b_side, ia, ib, e, e, e, 0,
                                 KD).shape == (0,)
    zeros = torch.zeros(m.nvals(), dtype=torch.int64)
    got = spx.masked_dot_counts(a_side, b_side, ia, ib, m.rows, m.cols,
                                zeros, 0, KD)
    assert torch.equal(got, zeros)


def _ring(name):
    if name == "user_plus_pair":  # a monoid of the user's, named plus
        mono = gb.monoid.register_anonymous(gb.binary.plus, 0, "plus")
        return gb.semiring.register_anonymous(mono, gb.binary.pair)["INT64"]
    if name == "min_firsti":
        return gb.semiring.ss.min_firsti["INT64"]
    return getattr(gb.semiring, name)["INT64" if name != "lxor_pair"
                                      else "BOOL"]


@pytest.mark.parametrize("name,takes", [
    ("plus_pair", True), ("any_pair", True), ("plus_times", False),
    ("lxor_pair", False), ("min_firsti", False), ("user_plus_pair", False)])
def test_which_rings_count(name, takes):
    assert spx.dot_by_counts(_ring(name)) is takes


def test_counters_add_up():
    """masked_dot.entries counts the mask entries of every masked dot,
    masked_dot.kernel_entries those of the dots the count mode ran, and
    the benchmark's reader gives their ratio in %."""
    (ai, ak), (bk, bj), (mi, mj, mv) = _effective(3)
    with gb.config.set(device="cpu", auto_sparse_limit=0):
        A = gb.Matrix.from_coo(ai, ak, 1, dtype="INT64", nrows=NR, ncols=KD)
        B = gb.Matrix.from_coo(bj, bk, 1, dtype="INT64", nrows=NC, ncols=KD)
        M = gb.Matrix.from_coo(mi, mj, mv, dtype="BOOL", nrows=NR, ncols=NC)
        before = dict(trace.counts)
        for ring in ("plus_pair", "plus_times", "any_pair"):
            A.mxm(B.T, getattr(gb.semiring, ring)).new(mask=M.V,
                                                       axb_method="dot")
    added = {k: trace.counts[k] - before.get(k, 0)
             for k in ("masked_dot.entries", "masked_dot.kernel_entries")}
    assert added == {"masked_dot.entries": 3 * M.nvals,
                     "masked_dot.kernel_entries": 2 * M.nvals}
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        from gbbench import harness, spec
    finally:
        sys.path.pop(0)
    reader = spec.metric("masked_dot.kernel_pct")
    assert reader.read(harness.Run(cuda=False, program=gb)) == \
        pytest.approx(100.0 * trace.counts["masked_dot.kernel_entries"]
                      / trace.counts["masked_dot.entries"])
    from types import SimpleNamespace as NS
    fake = NS(core=NS(trace=NS(counts={"masked_dot.entries": 40,
                                       "masked_dot.kernel_entries": 30})))
    assert reader.read(harness.Run(cuda=False, program=fake)) == 75.0
    assert reader.read(harness.Run(cuda=False, program=NS())) is None
