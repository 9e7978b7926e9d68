"""The complex-type grids (the tests themselves are in
test_torch_complex_fc32.py and test_torch_complex_fc64.py, one type a
file, so that the JAX compiles of one type stay in one worker).

:func:`define` puts into a test module's globals, for one complex type,
the parity of the port with the JAX package on the same inputs (numpy,
from a seed):

- every unary operator instance of the type, applied to a dense Vector
  and to a sparse-backed Matrix;
- every binary operator instance, through ewise_mult, ewise_add and
  ewise_union of two Vectors, and ewise_add of two sparse-backed
  matrices of different structure;
- the monoids (plus, times, any) through reduce, reduce_rowwise and
  reduce_columnwise on both backings;
- every semiring whose monoid and binary op take the type, through mxm
  of dense-backed matrices, and three of them (plus_times, times_plus,
  any_second) through mxv, vxm and mxm on sparse-backed matrices;
- every index-unary, select and aggregator instance;
- casts to and from every builtin type, ``unify``, and Scalar.

The values are in [-3, 3] x [-3, 3] (no zero, no value on a branch cut).
Results must have the JAX package's type and structure exactly, and
values within ``tol`` of the magnitude: |got - want| <= tol * max(|want|,
the largest |want| of the result).  FC32 takes tol 1e-5 and FC64 1e-12.
A package that refuses an (operator, type) pair must be matched by the
other refusing it too."""

import numpy as np
import pytest

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt

TOL = {"FC32": 1e-5, "FC64": 1e-12}
N = 9  # a matrix's side; a Vector has 2 * N elements
REAL = ("BOOL", "INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16",
        "UINT32", "UINT64", "FP32", "FP64")


def _cvals(rng, n, dtype):
    v = rng.uniform(-3, 3, n) + 1j * rng.uniform(-3, 3, n)
    return v.astype(gbt.dtypes.lookup_dtype(dtype).np_type)


def data(dtype, seed=21):
    """(vector indices, values) x 2 and (rows, cols, values) x 2: two
    vectors and two matrices of different structure, overlapping."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        idx = np.flatnonzero(rng.random(2 * N) < 0.7)
        out.append((idx, _cvals(rng, len(idx), dtype)))
    for _ in range(2):
        ok = rng.random((N, N)) < 0.45
        ok[2, :] = False  # an empty row
        r, c = np.nonzero(ok)
        out.append((r, c, _cvals(rng, len(r), dtype)))
    return out


def collections(gb, dtype, sparse):
    """u, v (Vectors) and A, B (Matrices; sparse-backed when sparse)."""
    (i1, x1), (i2, x2), (r1, c1, y1), (r2, c2, y2) = data(dtype)
    u = gb.Vector.from_coo(i1, x1, dtype=dtype, size=2 * N)
    v = gb.Vector.from_coo(i2, x2, dtype=dtype, size=2 * N)
    limit = 0 if sparse else 1 << 40
    with gb.config.set(auto_sparse_limit=limit):
        A = gb.Matrix.from_coo(r1, c1, y1, dtype=dtype, nrows=N, ncols=N)
        B = gb.Matrix.from_coo(r2, c2, y2, dtype=dtype, nrows=N, ncols=N)
    return u, v, A, B


def _result(x):
    """(dtype name, structure, values) of a computed collection."""
    if x.ndim == 0:
        return x.dtype.name, (), np.asarray(x.value)
    *idx, vals = x.to_coo()
    return x.dtype.name, tuple(np.asarray(i) for i in idx), np.asarray(vals)


def run(gb, fn):
    """fn(gb) computed, as a result, or the exception's class name."""
    try:
        out = fn(gb)
        return [_result(o) for o in out] if isinstance(out, tuple) else \
            _result(out)
    except Exception as exc:  # noqa: BLE001 - the class is compared
        return type(exc).__name__


def close(got, want, tol):
    if isinstance(want, str) or isinstance(got, str):
        assert got == want
        return
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, tol)
        return
    (gt, gi, gv), (wt, wi, wv) = got, want
    assert gt == wt
    assert len(gi) == len(wi)
    for a, b in zip(gi, wi):
        np.testing.assert_array_equal(a, b)
    assert gv.dtype == wv.dtype, (gv.dtype, wv.dtype)
    gv, wv = gv.astype(np.complex128), wv.astype(np.complex128)
    if wv.size == 0:
        assert gv.size == 0
        return
    scale = np.abs(wv[np.isfinite(wv)]).max(initial=0.0)
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    err = np.abs(gv[fin] - wv[fin])
    bound = tol * np.maximum(np.abs(wv[fin]), scale)
    assert np.all(err <= bound), (err.max(), bound.min())


def both(fn, tol):
    want = run(gbj, fn)
    with gbt.config.set(device="cpu"):
        got = run(gbt, fn)
    close(got, want, tol)
    return want


def _names(ns, dtype):
    out = []
    for name in sorted(dir(ns)):
        op = getattr(ns, name, None)
        if name.startswith("_") or not hasattr(op, "types"):
            continue
        try:
            op[dtype]
        except Exception:  # noqa: BLE001 - the type is not in its domain
            continue
        out.append(name)
    return out


def _semirings(dtype):
    mults = _names(gbj.binary, dtype)
    out = []
    for mono in ("plus", "times", "any"):
        for mult in mults:
            try:
                gbj.semiring.get_semiring(getattr(gbj.monoid, mono),
                                          getattr(gbj.binary, mult))[dtype]
            except Exception:  # noqa: BLE001 - no instance of the type
                continue
            out.append((mono, mult))
    return out


def _ring(gb, mono, mult):
    return gb.semiring.get_semiring(getattr(gb.monoid, mono),
                                    getattr(gb.binary, mult))


def define(dtype, namespace):
    tol = TOL[dtype]
    unary = _names(gbj.unary, dtype)
    binary = _names(gbj.binary, dtype)
    indexunary = _names(gbj.indexunary, dtype)
    select = _names(gbj.select, dtype)
    aggs = [n for n in dir(gbj.agg) if n[0].islower()
            and n not in ("from_string", "ss")] + \
        [f"ss.{n}" for n in ("argmin", "argmax", "first", "last",
                             "first_index", "last_index")]
    rings = _semirings(dtype)
    assert len(unary) > 30 and len(binary) > 15 and len(rings) > 30

    @pytest.mark.parametrize("name", unary)
    def test_unary(name):
        def fn(gb):
            u, _, _, B = collections(gb, dtype, True)
            op = getattr(gb.unary, name)[dtype]
            return u.apply(op).new(), B.apply(op).new()

        both(fn, tol)

    @pytest.mark.parametrize("name", binary)
    def test_binary(name):
        def fn(gb):
            u, v, A, B = collections(gb, dtype, True)
            op = getattr(gb.binary, name)[dtype]
            return (u.ewise_mult(v, op).new(), u.ewise_add(v, op).new(),
                    u.ewise_union(v, op, 1 + 2j, -0.5j).new(),
                    A.ewise_add(B, op).new())

        both(fn, tol)

    @pytest.mark.parametrize("sparse", [False, True],
                             ids=["dense", "sparse"])
    @pytest.mark.parametrize("name", ["plus", "times", "any"])
    def test_monoid(name, sparse):
        def fn(gb):
            u, _, A, _ = collections(gb, dtype, sparse)
            mono = getattr(gb.monoid, name)[dtype]
            return (u.reduce(mono).new(), A.reduce_rowwise(mono).new(),
                    A.reduce_columnwise(mono).new(),
                    A.reduce_scalar(mono).new())

        want = both(fn, tol)
        assert not isinstance(want, str)

    @pytest.mark.parametrize("mono,mult", rings,
                             ids=[f"{a}_{b}" for a, b in rings])
    def test_semiring_dense(mono, mult):
        def fn(gb):
            _, _, A, B = collections(gb, dtype, False)
            return A.mxm(B, _ring(gb, mono, mult)[dtype]).new()

        both(fn, tol)

    picked = [("plus", "times"), ("times", "plus"), ("any", "second")]

    @pytest.mark.parametrize("mono,mult", picked,
                             ids=[f"{a}_{b}" for a, b in picked])
    def test_semiring_products(mono, mult):
        def fn(gb):
            u, _, A, B = collections(gb, dtype, True)
            x = u[list(range(N))].new()
            ring = _ring(gb, mono, mult)[dtype]
            return (A.mxv(x, ring).new(), x.vxm(A, ring).new(),
                    A.mxm(B, ring).new())

        both(fn, tol)

    @pytest.mark.parametrize("name", indexunary)
    def test_indexunary(name):
        def fn(gb):
            _, _, A, _ = collections(gb, dtype, False)
            op = getattr(gb.indexunary, name)[dtype]
            thunk = 1 if "value" not in name else A.to_coo()[2][0]
            return A.apply(op, right=thunk).new()

        both(fn, tol)

    @pytest.mark.parametrize("name", select)
    def test_select(name):
        def fn(gb):
            _, _, A, B = collections(gb, dtype, True)
            op = getattr(gb.select, name)[dtype]
            thunk = 1 if "value" not in name else A.to_coo()[2][0]
            return A.select(op, thunk).new(), B.select(op, thunk).new()

        both(fn, tol)

    @pytest.mark.parametrize("name", aggs)
    def test_aggregator(name):
        def fn(gb):
            u, _, A, _ = collections(gb, dtype, False)
            agg = gb.agg
            for part in name.split("."):
                agg = getattr(agg, part)
            return u.reduce(agg).new(), A.reduce_rowwise(agg).new()

        both(fn, tol)

    @pytest.mark.parametrize("other", REAL + (("FC32", "FC64")))
    def test_casts(other):
        def fn(gb):
            u, _, A, _ = collections(gb, dtype, True)
            w = gb.Vector.from_coo([0, 1, 3, 4], [0, 1, 7, 2], dtype=other,
                                   size=5)
            return u.dup(other), A.dup(other), w.dup(dtype)

        both(fn, tol)

    def test_unify_and_scalar():
        for gb in (gbj, gbt):
            d = gb.dtypes
            for name in REAL + ("FC32",):
                t = d.unify(getattr(d, name), getattr(d, dtype))
                assert t.name == gbj.dtypes.unify(
                    getattr(gbj.dtypes, name),
                    getattr(gbj.dtypes, dtype)).name
        for left in (True, False):
            for name in REAL:
                kw = {"is_left_scalar": left, "is_right_scalar": not left}
                want = gbj.dtypes.unify(gbj.dtypes.lookup_dtype(dtype),
                                        getattr(gbj.dtypes, name), **kw)
                got = gbt.dtypes.unify(gbt.dtypes.lookup_dtype(dtype),
                                       getattr(gbt.dtypes, name), **kw)
                assert got.name == want.name

        def fn(gb):
            s = gb.Scalar.from_value(1.5 - 2j, dtype=dtype)
            t = gb.Scalar.from_value(complex(s) * 2, dtype=dtype)
            u, _, _, _ = collections(gb, dtype, False)
            return (s, t, u.reduce().new(), (s + t).new(),
                    u.inner(u).new())

        both(fn, tol)
        with gbt.config.set(device="cpu"):
            s = gbt.Scalar.from_value(1.5 - 2j, dtype=dtype)
            assert complex(s) == 1.5 - 2j
            assert s.value == np.complex128(1.5 - 2j)
            assert s.dtype.name == dtype

    @pytest.mark.parametrize("name", sorted(EDGE_UNARY) + sorted(EDGE_BINARY))
    def test_edge_values_against_numpy(name):
        """Zeros of both signs, infinities, NaN and the branch cuts'
        signed zeros: the port against numpy (where the JAX package
        differs, ROADMAP.md lists a reference quirk)."""
        np_t = gbt.dtypes.lookup_dtype(dtype).np_type
        x, y = EDGE_X.astype(np_t), EDGE_Y.astype(np_t)
        with gbt.config.set(device="cpu"):
            u = gbt.Vector.from_coo(np.arange(len(x)), x, size=len(x))
            if name in EDGE_UNARY:
                got = u.apply(getattr(gbt.unary, name)[dtype]).new()
                want = EDGE_UNARY[name](x)
            else:
                v = gbt.Vector.from_coo(np.arange(len(y)), y, size=len(y))
                got = u.ewise_mult(v, getattr(gbt.binary, name)[dtype]).new()
                want = EDGE_BINARY[name](x, y)
        g = got.to_coo()[1].astype(np.complex128)
        w = np.asarray(want).astype(np.complex128)
        fin = np.isfinite(w)
        assert np.array_equal(np.isfinite(g), fin), name
        # a non-finite value: each part's NaN, and its infinities, exactly
        for part in (np.real, np.imag):
            gp, wp = part(g[~fin]), part(w[~fin])
            assert np.array_equal(np.isnan(gp), np.isnan(wp)), name
            assert np.array_equal(gp[~np.isnan(gp)], wp[~np.isnan(wp)]), name
        assert np.all(np.abs(g[fin] - w[fin]) <= tol * np.abs(w[fin])), name

    def test_hub_sums_against_numpy():
        """A column reduce and a vxm into a hub of 900 entries (over 256
        and 1/32 of the entries: the sum in two levels) and the same on
        short segments, against numpy in complex128."""
        rng = np.random.default_rng(23)
        n = 1024
        r = np.concatenate([rng.integers(0, n, 1500), np.arange(900)])
        c = np.concatenate([rng.integers(0, n, 1500), np.full(900, 5)])
        lin = np.unique(r * n + c)
        r, c = lin // n, lin % n
        assert (c == 5).sum() > max(256, len(r) // 32)
        v = _cvals(rng, len(r), dtype)
        x = _cvals(rng, n, dtype)
        with gbt.config.set(device="cpu", auto_sparse_limit=0):
            A = gbt.Matrix.from_coo(r, c, v, dtype=dtype, nrows=n, ncols=n)
            u = gbt.Vector.from_dense(x, dtype=dtype)
            got = [A.reduce_columnwise().new(), A.reduce_rowwise().new(),
                   u.vxm(A, gbt.semiring.plus_times[dtype]).new()]
        v128, x128 = v.astype(np.complex128), x.astype(np.complex128)
        want = [np.bincount(c, v128.real, n) + 1j * np.bincount(
                    c, v128.imag, n),
                np.bincount(r, v128.real, n) + 1j * np.bincount(
                    r, v128.imag, n)]
        p = v128 * x128[r]
        want.append(np.bincount(c, p.real, n) + 1j * np.bincount(c, p.imag,
                                                                  n))
        for g, w in zip(got, want):
            idx, vals = g.to_coo()
            w = w[idx.astype(np.int64)]
            assert np.all(np.abs(vals - w) <= tol * np.maximum(
                np.abs(w), np.abs(w).max()))

    for fn in (test_unary, test_binary, test_monoid, test_semiring_dense,
               test_semiring_products, test_indexunary, test_select,
               test_aggregator, test_casts, test_unify_and_scalar,
               test_edge_values_against_numpy, test_hub_sums_against_numpy):
        namespace[fn.__name__] = fn


_INF, _NAN = np.inf, np.nan
EDGE_X = np.array([0, -0.0, 1, -1, 1j, -1j, -1 + 0j, complex(-1, -0.0),
                   complex(_INF, 0), complex(0, _INF), complex(_NAN, 0),
                   complex(_INF, _INF), 2 - 3j])
EDGE_Y = np.array([0, 0, 0, complex(-0.0, 0), 0, 1, 2, 0.5, 1, 0, 1, 1, 0])
EDGE_UNARY = {
    "sqrt": np.sqrt, "log": np.log, "exp": np.exp, "exp2": np.exp2,
    "log10": np.log10, "log1p": np.log1p, "expm1": np.expm1,
    "sin": np.sin, "tan": np.tan, "asin": np.arcsin, "acos": np.arccos,
    "atan": np.arctan, "asinh": np.arcsinh, "acosh": np.arccosh,
    "atanh": np.arctanh, "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh,
    "minv": lambda x: 1 / x, "abs": np.abs, "carg": np.angle,
    "conj": np.conj, "isinf": np.isinf, "isnan": np.isnan,
    "isfinite": np.isfinite}
EDGE_BINARY = {"truediv": lambda x, y: x / y, "cdiv": lambda x, y: x / y,
               "pow": lambda x, y: x ** y, "times": lambda x, y: x * y}
