"""The PyTorch port's positional operators against the JAX package's.

The eight positional binaries (``binary.ss.firsti`` ... ``secondj1``) as
the multiply of a semiring in every product: vxm and mxv, plain and on
``A.T``; mxm by Gustavson's expansion and by the masked dot (forced in the
port; the JAX package picks one), with either operand transposed; mxm by
a diagonal on either side; and the dense generic product (dense-backed
operands).  Then as a binary op: ewise mult, add and union, apply with a
bound scalar on either side, and the accumulate of the write-back and of
an assign.  The four positional unaries (``unary.ss.positioni`` ...) in
apply, on a matrix, its transpose and a vector.  The operands are
rectangular (7 x 9 and 9 x 6, FP32, from a seed), so i, j and k range
differently, and every case runs with the port's matrices dense-backed
and sparse-backed.  The JAX package's dense write-back has no positional
accumulate (it raises), so those cases hold both of the port's backings
to the JAX package's sparse-backed result.

Results must match exactly: type, structure and values.  The ``any``
monoid keeps whichever product comes first, which depends on each
engine's order: its cases check the structure against the JAX package's
and each value for membership in the set of valid answers (the index of
some product of that output entry), not equality.

``bfs_parent`` against the JAX package's on three small graphs (one of
them disconnected) and against the rule it implements: the parent of a
node is the smallest node of the level before it with an edge to it.
"""

import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt
from graphblas_tpu import algorithms as jalg

torch.set_num_threads(1)

POS_BINARY = ("firsti", "firsti1", "firstj", "firstj1", "secondi",
              "secondi1", "secondj", "secondj1")
POS_UNARY = ("positioni", "positioni1", "positionj", "positionj1")
# each binary's ring monoid (the three that give one answer)
MONOID = dict(zip(POS_BINARY, ("min", "max", "plus") * 3))
BACKINGS = {"dense": {}, "sparse": {"auto_sparse_limit": 0}}
M, K, N = 7, 9, 6


def rand_coo(seed, shape, density=0.4):
    rng = np.random.default_rng(seed)
    r, c = np.nonzero(rng.random(shape) < density)
    return r, c, (rng.random(len(r)) + 0.5).astype(np.float32), shape


def rand_vec(seed, size, density=0.6):
    rng = np.random.default_rng(seed)
    idx = np.flatnonzero(rng.random(size) < density)
    return idx, (rng.random(len(idx)) + 0.5).astype(np.float32), size


DATA = {"A": rand_coo(1, (M, K)), "At": rand_coo(2, (K, M)),
        "B": rand_coo(3, (K, N)), "Bt": rand_coo(4, (N, K)),
        "A2": rand_coo(5, (M, K)), "Mask": rand_coo(6, (M, N), 0.5),
        "uM": rand_vec(7, M), "uK": rand_vec(8, K), "dM": rand_vec(9, M),
        "dK": rand_vec(10, K)}


def operands(gb, dtype="FP32"):
    out = {}
    for name, d in DATA.items():
        if len(d) == 4:
            r, c, v, (nr, nc) = d
            out[name] = gb.Matrix.from_coo(r, c, v, dtype=dtype, nrows=nr,
                                           ncols=nc)
        else:
            idx, v, size = d
            out[name] = gb.Vector.from_coo(idx, v, dtype=dtype, size=size)
    return out


def same(got, want, where):
    assert got.dtype.name == want.dtype.name, where
    for g, w in zip(got.to_coo(), want.to_coo()):
        np.testing.assert_array_equal(g, w, err_msg=where)


PRODUCTS = {
    "vxm": lambda o, r: o["uM"].vxm(o["A"], r),
    "vxm A.T": lambda o, r: o["uM"].vxm(o["At"].T, r),
    "mxv": lambda o, r: o["A"].mxv(o["uK"], r),
    "mxv A.T": lambda o, r: o["At"].T.mxv(o["uK"], r),
    "mxm": lambda o, r: o["A"].mxm(o["B"], r),
    "mxm A.T": lambda o, r: o["At"].T.mxm(o["B"], r),
    "mxm B.T": lambda o, r: o["A"].mxm(o["Bt"].T, r),
    "mxm A.T B.T": lambda o, r: o["At"].T.mxm(o["Bt"].T, r),
    "diag left": lambda o, r: o["dM"].diag().mxm(o["A"], r),
    "diag right": lambda o, r: o["A"].mxm(o["dK"].diag(), r),
    "diag left, A.T": lambda o, r: o["dM"].diag().mxm(o["At"].T, r),
    "diag right, A.T": lambda o, r: o["At"].T.mxm(o["dK"].diag(), r),
}
MASKED = {  # (expression, mask): the masked dot or Gustavson's expansion
    "masked mxm": lambda o, r: o["A"].mxm(o["B"], r),
    "masked mxm A.T B.T": lambda o, r: o["At"].T.mxm(o["Bt"].T, r),
}


def _ring(gb, mono, op):
    return getattr(gb.semiring.ss, f"{mono}_{op}")


@pytest.mark.parametrize("op", POS_BINARY)
@pytest.mark.parametrize("backing", list(BACKINGS))
def test_positional_products(op, backing):
    mono = MONOID[op]
    with gbj.config.set(**BACKINGS[backing]):
        jo = operands(gbj)
        jr = _ring(gbj, mono, op)
        want = {k: f(jo, jr).new() for k, f in PRODUCTS.items()}
        want.update({k: f(jo, jr).new(mask=jo["Mask"].S)
                     for k, f in MASKED.items()})
    with gbt.config.set(device="cpu", **BACKINGS[backing]):
        to = operands(gbt)
        tr = _ring(gbt, mono, op)
        for k, f in PRODUCTS.items():
            got = f(to, tr).new()
            same(got, want[k], f"{op} {k}")
            if backing == "sparse" and got.ndim == 2:
                assert got._sparse is not None, k
        for k, f in MASKED.items():
            for method in ("dot", "gustavson"):
                got = f(to, tr).new(mask=to["Mask"].S, axb_method=method)
                same(got, want[k], f"{op} {k} {method}")
    assert want["mxm"].dtype.name == "INT64"


def _term_indices(key, i, j, a_rows, b_cols):
    """The answers a positional multiply can give at output (i, j): its
    index over the products' k (stored in row i of A and column j of
    B)."""
    ks = sorted(set(a_rows[i]) & set(b_cols[j]))
    return {"ai": {i}, "bj": {j}, "aj": set(ks), "bi": set(ks)}[key]


@pytest.mark.parametrize("op", POS_BINARY)
@pytest.mark.parametrize("backing", list(BACKINGS))
def test_positional_any(op, backing):
    """``any_<op>``: the structure of the JAX package's; every value one
    of the valid answers."""
    ar, ac, _, _ = DATA["A"]
    br, bc, _, _ = DATA["B"]
    a_rows = {i: ac[ar == i].tolist() for i in range(M)}
    b_cols = {j: br[bc == j].tolist() for j in range(N)}
    key, off = gbt.binary.ss.__dict__[op]._positional
    with gbj.config.set(**BACKINGS[backing]):
        jo = operands(gbj)
        jr = _ring(gbj, "any", op)
        want = [jo["A"].mxm(jo["B"], jr).new(),
                jo["A"].mxm(jo["B"], jr).new(mask=jo["Mask"].S)]
    with gbt.config.set(device="cpu", **BACKINGS[backing]):
        to = operands(gbt)
        tr = _ring(gbt, "any", op)
        got = [to["A"].mxm(to["B"], tr).new(),
               to["A"].mxm(to["B"], tr).new(mask=to["Mask"].S,
                                             axb_method="dot")]
        for g, w in zip(got, want):
            assert g.dtype.name == w.dtype.name
            gi, gj, gv = g.to_coo()
            wi, wj, _ = w.to_coo()
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gj, wj)
            for i, j, v in zip(gi.tolist(), gj.tolist(), gv.tolist()):
                ok = {x + off for x in _term_indices(key, i, j, a_rows,
                                                     b_cols)}
                assert v in ok, (op, i, j, v, ok)


ELEMENTWISE = {
    "ewise_mult": lambda o, op: o["A"].ewise_mult(o["A2"], op),
    "ewise_add": lambda o, op: o["A"].ewise_add(o["A2"], op),
    "ewise_union": lambda o, op: o["A"].ewise_union(o["A2"], op, 1.0, 2.0),
    "ewise_mult A.T": lambda o, op: o["At"].T.ewise_mult(o["A2"], op),
    "ewise_add A.T": lambda o, op: o["At"].T.ewise_add(o["A2"], op),
    "apply left": lambda o, op: o["A"].apply(op, left=3.0),
    "apply right": lambda o, op: o["A"].apply(op, right=0),
    "apply right A.T": lambda o, op: o["At"].T.apply(op, right=0),
    "apply vector": lambda o, op: o["uK"].apply(op, left=1),
}


def _accum(o, op):
    C = o["A"].dup()
    C(accum=op) << o["A2"]
    return C


def _accum_masked(o, op):
    C = o["A"].dup()
    C(o["A2"].S, accum=op) << o["At"].T
    return C


def _assign_accum(o, op, gb):
    C = o["A"].dup()
    V = gb.Matrix.from_coo([0, 1, 2, 2], [0, 2, 1, 3], [5.0, 6.0, 7.0, 8.0],
                           dtype="FP32", nrows=3, ncols=4)
    C(accum=op)[[1, 4, 6], [0, 2, 3, 8]] << V
    return C


WRITE_BACKS = {"accum": _accum, "accum masked": _accum_masked}


@pytest.mark.parametrize("op", POS_BINARY)
def test_positional_binary_ops(op):
    for backing, cfg in BACKINGS.items():
        with gbj.config.set(**cfg):
            jo = operands(gbj)
            jop = getattr(gbj.binary.ss, op)
            want = {k: f(jo, jop).new() for k, f in ELEMENTWISE.items()}
        with gbt.config.set(device="cpu", **cfg):
            to = operands(gbt)
            top = getattr(gbt.binary.ss, op)
            for k, f in ELEMENTWISE.items():
                same(f(to, top).new(), want[k], f"{op} {k} {backing}")
    # the accumulates: the JAX package's sparse-backed results
    with gbj.config.set(auto_sparse_limit=0):
        jo = operands(gbj)
        jop = getattr(gbj.binary.ss, op)
        want = {k: f(jo, jop) for k, f in WRITE_BACKS.items()}
        want["assign"] = _assign_accum(jo, jop, gbj)
    for backing, cfg in BACKINGS.items():
        with gbt.config.set(device="cpu", **cfg):
            to = operands(gbt)
            top = getattr(gbt.binary.ss, op)
            got = {k: f(to, top) for k, f in WRITE_BACKS.items()}
            got["assign"] = _assign_accum(to, top, gbt)
            for k in want:
                same(got[k], want[k], f"{op} {k} {backing}")
                assert (got[k]._sparse is not None) == (backing == "sparse")


@pytest.mark.parametrize("op", POS_UNARY)
def test_positional_unary(op):
    for backing, cfg in BACKINGS.items():
        res = []
        for gb in (gbj, gbt):
            with gbj.config.set(**cfg), \
                    gbt.config.set(device="cpu", **cfg):
                o = operands(gb)
                u = getattr(gb.unary.ss, op)
                res.append([o["A"].apply(u).new(), o["At"].T.apply(u).new(),
                            o["uK"].apply(u).new(),
                            o["A"].apply(u["INT32"]).new()])
        for k, (g, w) in enumerate(zip(*reversed(res))):
            same(g, w, f"{op} {k} {backing}")


def test_positional_types():
    """Typed lookups as in the JAX package: a positional op over another
    type is its INT64 instance; over INT32 it stays INT32, through a
    product too."""
    for t in ("BOOL", "INT32", "INT64", "UINT32", "FP32", "FP64"):
        for name in POS_BINARY:
            g = getattr(gbt.binary.ss, name)[t]
            w = getattr(gbj.binary.ss, name)[t]
            assert (g.type.name, g.return_type.name) == \
                (w.type.name, w.return_type.name)
        for name in POS_UNARY:
            g = getattr(gbt.unary.ss, name)[t]
            w = getattr(gbj.unary.ss, name)[t]
            assert g.return_type.name == w.return_type.name
        g = gbt.semiring.ss.min_secondi[t]
        w = gbj.semiring.ss.min_secondi[t]
        assert g.return_type.name == w.return_type.name
    for backing, cfg in BACKINGS.items():
        with gbj.config.set(**cfg):
            jo = operands(gbj, "INT32")
            want = jo["A"].mxm(jo["B"], gbj.semiring.ss.min_firstj).new()
        with gbt.config.set(device="cpu", **cfg):
            to = operands(gbt, "INT32")
            got = to["A"].mxm(to["B"], gbt.semiring.ss.min_firstj).new()
        assert got.dtype.name == "INT32"
        same(got, want, backing)


def test_positional_rings_skip_the_kernels():
    """A positional ring never reaches the SpMV pipelines (K1-K6)."""
    from graphblas_tpu_torch.core.engine import sortpipe

    for op in POS_BINARY:
        for mono in ("min", "max", "plus", "any"):
            ring = _ring(gbt, mono, op)["FP32"]
            assert not sortpipe.eligible_spmv(ring, gbt.dtypes.INT64,
                                              gbt.dtypes.INT64)


@pytest.mark.parametrize("red", ["amin", "amax"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32,
                                   torch.float64])
def test_two_level_scatter_matches_the_scatter(red, dtype):
    """The min/max scatter of the sparse engine's reduces (at most 256
    atomics an address where one segment holds over 1/32 of the slots, so
    a hub destination does not serialize) against one plain scatter:
    empty segments, short ones, and a segment longer than a run (one of
    1500 slots); then short segments alone, which scatter once, and no
    destination at all."""
    from graphblas_tpu_torch.core.engine import sparse as spx

    rng = np.random.default_rng(21)
    n = 40
    ident = torch.tensor(10**7 if red == "amin" else -10**7, dtype=dtype)
    hub = np.concatenate([rng.integers(0, n, 700), np.full(1500, 17),
                          np.full(300, 39)])
    for seg, size in ((hub, n), (rng.integers(0, n, 700), n),
                      (np.zeros(0, np.int64), 0)):
        seg = np.sort(seg)
        seg = torch.from_numpy(seg[(seg != 3) & (seg != 30)])
        x = torch.from_numpy(rng.integers(-10**6, 10**6,
                                          seg.numel())).to(dtype)
        bounds = torch.searchsorted(seg, torch.arange(size + 1))
        got = spx._scatter_minmax(seg, x, red, ident, size, bounds[:-1],
                                  bounds[1:])
        want = ident.expand(size).clone().scatter_reduce_(0, seg, x, red)
        assert got.dtype == want.dtype and torch.equal(got, want)
        if size:
            assert got[3] == ident and got[30] == ident


# --------------------------------------------------------------------- #
# bfs_parent
def _graphs():
    rng = np.random.default_rng(3)
    r, c = np.nonzero(rng.random((30, 30)) < 0.08)
    # two components: 0..5 and 6..11, and a node of its own
    dr = [0, 0, 1, 2, 3, 4, 6, 7, 7, 8, 10]
    dc = [1, 2, 3, 3, 4, 5, 7, 8, 9, 10, 11]
    return {"make_A": ([3, 0, 3, 5, 6, 0, 6, 1, 6, 2, 4, 1],
                       [0, 1, 2, 2, 2, 3, 3, 4, 4, 5, 5, 6], 7),
            "random": (r, c, 30),
            "disconnected": (dr, dc, 13)}


def parent_rule(src, dst, n, source):
    src, dst = np.asarray(src), np.asarray(dst)
    level = np.full(n, -1)
    level[source] = 0
    front, d = [source], 0
    while front:
        d += 1
        nxt = sorted(set(dst[np.isin(src, front)]) - set(np.flatnonzero(
            level >= 0)))
        level[nxt] = d
        front = nxt
    parent = {source: source}
    for j in np.flatnonzero(level > 0):
        parent[int(j)] = int(min(src[(dst == j) & (level[src] ==
                                                   level[j] - 1)]))
    idx = np.array(sorted(parent))
    return idx, np.array([parent[i] for i in idx])


@pytest.mark.parametrize("graph", list(_graphs()))
@pytest.mark.parametrize("backing", list(BACKINGS))
def test_bfs_parent(graph, backing):
    src, dst, n = _graphs()[graph]
    for source in (0, n - 1):
        with gbj.config.set(**BACKINGS[backing]):
            A = gbj.Matrix.from_coo(src, dst, 1.0, dtype="FP32", nrows=n,
                                    ncols=n)
            want = jalg.bfs_parent(A, source)
        with gbt.config.set(device="cpu", **BACKINGS[backing]):
            A = gbt.Matrix.from_coo(src, dst, 1.0, dtype="FP32", nrows=n,
                                    ncols=n)
            got = gbt.algorithms.bfs_parent(A, source)
        same(got, want, f"{graph} from {source}")
        idx, par = parent_rule(src, dst, n, source)
        np.testing.assert_array_equal(got.to_coo()[0], idx)
        np.testing.assert_array_equal(got.to_coo()[1], par)
