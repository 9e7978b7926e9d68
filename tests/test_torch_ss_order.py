"""``Matrix.ss``/``Vector.ss`` order operations and scans against the JAX
package's.

``sort`` (both orders, rowwise and columnwise, values and permutation),
``selectk`` and ``compactify`` (first, last, smallest, largest; compactify
to the widest row and to a given width) and ``scan`` (plus, min, max,
times and first; rowwise and columnwise) over FP32, FP64, INT8, UINT16,
INT64 and BOOL, on a 6 x 9 matrix with ties in every row and a Vector,
the port's matrix dense-backed and sparse-backed (the JAX package runs
these on its dense store either way).  The values are small multiples of
0.25, so every sum and product is exact in both packages whatever the
order of the scan: the comparison is exact.  ``selectk("random")`` keeps
min(k, count) entries of each row.  A scan by an op that is not
associative (``minus``) folds left to right in the port, held against
numpy; the JAX package's tree scan differs there (ROADMAP.md §3).

Each reference result is computed once (a module cache), so the grid
costs one JAX compile per operation and type."""

import functools

import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt

torch.set_num_threads(1)

TYPES = ("FP32", "FP64", "INT8", "UINT16", "INT64", "BOOL")
BACKINGS = {"dense": {}, "sparse": {"auto_sparse_limit": 0}}
HOWS = ("first", "last", "smallest", "largest")
SCAN_OPS = ("plus", "min", "max", "times", "first")


def _data(dtype):
    rng = np.random.default_rng(15)
    ok = rng.random((6, 9)) < 0.55
    ok[2, :] = False  # an empty row
    ok[:, 5] = False  # an empty column
    ok[4, :] = True   # a full row
    r, c = np.nonzero(ok)
    if dtype == "BOOL":
        v = rng.random(len(r)) < 0.5
    elif dtype in ("FP32", "FP64"):
        v = rng.integers(-6, 7, len(r)) * 0.25
    elif dtype == "UINT16":
        v = rng.integers(0, 4, len(r))
    else:
        v = rng.integers(-3, 4, len(r))
    v = v.astype(gbt.dtypes.lookup_dtype(dtype).np_type)
    idx = np.flatnonzero(rng.random(13) < 0.6)
    return r, c, v, idx, v[:len(idx)] if len(v) >= len(idx) else v


def _build(gb, dtype):
    r, c, v, idx, vv = _data(dtype)
    return (gb.Matrix.from_coo(r, c, v, dtype=dtype, nrows=6, ncols=9),
            gb.Vector.from_coo(idx[:len(vv)], vv, dtype=dtype, size=13))


CASES = (
    [("sort", op, rowwise) for op in ("<", ">") for rowwise in (True, False)]
    + [("selectk", how, k) for how in HOWS for k in (1, 3)]
    + [("compactify", how, w) for how in HOWS for w in (None, 2)]
    + [("scan", op, order) for op in SCAN_OPS
       for order in ("rowwise", "columnwise")])


def _run(gb, dtype, case):
    """The case's outputs (Matrix and Vector results) as host tuples."""
    A, v = _build(gb, dtype)
    kind, a, b = case
    if kind == "sort":
        outs = list(A.ss.sort(a, rowwise=b))
        if b:
            outs += list(v.ss.sort(a))
    elif kind == "selectk":
        outs = [A.ss.selectk(a, b), v.ss.selectk(a, b)]
    elif kind == "compactify":
        outs = [A.ss.compactify(a, b), v.ss.compactify(a, b)]
    else:
        outs = [A.ss.scan(a, order=b)]
        if b == "rowwise":
            outs.append(v.ss.scan(a))
    return [(o.dtype.name, o.shape) + tuple(np.asarray(x) for x in
                                             o.to_coo()) for o in outs]


@functools.lru_cache(maxsize=None)
def _ref(dtype, case):
    return _run(gbj, dtype, case)


@pytest.mark.parametrize("backing", BACKINGS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", TYPES)
def test_order_and_scan_match(dtype, case, backing):
    want = _ref(dtype, case)
    with gbt.config.set(device="cpu", **BACKINGS[backing]):
        got = _run(gbt, dtype, case)
        A, _ = _build(gbt, dtype)
        assert (A._sparse is not None) == (backing == "sparse")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:2] == w[:2], (g[:2], w[:2])
        for x, y in zip(g[2:], w[2:]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("backing", BACKINGS)
def test_selectk_random_counts(backing):
    with gbt.config.set(device="cpu", **BACKINGS[backing]):
        A, v = _build(gbt, "FP64")
        counts = np.bincount(A.to_coo()[0].astype(np.int64), minlength=6)
        for k in (1, 3, 20):
            got = A.ss.selectk("random", k)
            r, c, vals = got.to_coo()
            np.testing.assert_array_equal(
                np.bincount(r.astype(np.int64), minlength=6),
                np.minimum(counts, k))
            # the kept entries are entries of A, at their places
            d = A.to_dicts()
            assert all(d[i][j] == x for i, j, x in zip(r.tolist(),
                                                       c.tolist(),
                                                       vals.tolist()))
        assert v.ss.selectk("random", 2).nvals == min(2, v.nvals)


@pytest.mark.parametrize("backing", BACKINGS)
@pytest.mark.parametrize("order", ["rowwise", "columnwise"])
def test_scan_not_associative_folds_left_to_right(backing, order):
    with gbt.config.set(device="cpu", **BACKINGS[backing]):
        A, _ = _build(gbt, "INT64")
        S = A.ss.scan("minus", order=order)
        r, c, v = (x.astype(np.int64) for x in A.to_coo())
    if order == "columnwise":
        r, c = c, r
    want = {}
    for i in np.unique(r):
        sel = np.flatnonzero(r == i)
        sel = sel[np.argsort(c[sel])]
        acc = None
        for e in sel:
            acc = v[e] if acc is None else acc - v[e]
            want[(r[e], c[e]) if order == "rowwise" else (c[e], r[e])] = acc
    sr, sc, sv = (x.astype(np.int64) for x in S.to_coo())
    assert dict(zip(zip(sr.tolist(), sc.tolist()), sv.tolist())) == \
        {k: int(x) for k, x in want.items()}
