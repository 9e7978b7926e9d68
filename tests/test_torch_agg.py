"""The PyTorch port's aggregators, ``kronecker`` and ``reposition`` against
the JAX package's.

Every aggregator of ``gb.agg`` and ``gb.agg.ss`` over FP32, FP64, INT64
and BOOL (``bitwise_all``/``bitwise_any`` over UINT32, the unsigned type
the port has), rowwise, columnwise, through ``A.T``, ``reduce_scalar``
and ``Vector.reduce``, with the port's matrices dense-backed and
sparse-backed (the JAX package's are dense at this size: a sparse operand
densifies there too).  Where the JAX package refuses a type, the port
must refuse it too.  Then the scenarios of the JAX package's
tests/test_agg.py through both packages (``plus_pow`` and ``log2``, which
the port lacks, become ``plus_times`` and a torch or jnp function), the
string forms (``gb.agg.from_string``, ``reduce_rowwise("count")``), the
ValueError of ``reduce_scalar`` for the index aggregators, and
``kronecker`` and ``reposition``.

Tolerances: integer, BOOL and index results exactly; FP64 within rel
1e-12; FP32 within rel 1e-5.  The variance family (varp, vars, stdp,
stds) is s2/n - mean**2 in float64 in both packages, whose cancellation
leaves an absolute error near eps * mean**2 where the variance is 0 (a
single element, equal elements): the JAX package's compiled form, with a
fused multiply-add, can even make it negative, and its std NaN.  There
the two are held to an absolute 1e-7, and a NaN of the JAX package's to
a port value within 1e-7 of 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt

torch.set_num_threads(1)

DTYPES = ("FP32", "FP64", "INT64", "BOOL")
REL = {"FP32": 1e-5, "FP64": 1e-12}
AGGS = sorted(n for n in gbt.agg.__all__ if n not in
              ("Aggregator", "TypedAggregator", "from_string", "ss"))
SS_AGGS = sorted(vars(gbt.agg.ss))
BACKINGS = {"dense": {}, "sparse": {"auto_sparse_limit": 0}}


def values(rng, dtype, n):
    if dtype == "BOOL":
        return rng.random(n) < 0.6
    if dtype in ("INT64", "UINT32"):
        return rng.integers(0, 9, n)
    return rng.choice([0.0, 0.5, 1.25, 2.0, 3.0], n) + \
        np.where(rng.random(n) < 0.5, rng.random(n), 0)


def matrix_data(dtype, seed=7, shape=(6, 9)):
    """A 6 x 9 matrix, about 60% stored, one row and one column empty."""
    rng = np.random.default_rng(seed)
    ok = rng.random(shape) < 0.6
    ok[2, :] = False
    ok[:, 4] = False
    r, c = np.nonzero(ok)
    v = values(rng, dtype, len(r)).astype(gbt.dtypes.lookup_dtype(dtype)
                                          .np_type)
    return r, c, v, shape


def vector_data(dtype, seed=8, size=23):
    rng = np.random.default_rng(seed)
    idx = np.flatnonzero(rng.random(size) < 0.6)
    v = values(rng, dtype, len(idx)).astype(gbt.dtypes.lookup_dtype(dtype)
                                            .np_type)
    return idx, v, size


def build(gb, dtype, mdata, vdata):
    r, c, v, (nr, nc) = mdata
    idx, vv, size = vdata
    return (gb.Matrix.from_coo(r, c, v, dtype=dtype, nrows=nr, ncols=nc),
            gb.Vector.from_coo(idx, vv, dtype=dtype, size=size))


VARIANCE = ("varp", "vars", "stdp", "stds")
VAR_ATOL = 1e-7


def same(got, want, where, near_zero=False):
    """A port result (collection or Scalar) against the JAX package's;
    near_zero: the variance family's absolute tolerance (see above)."""
    assert got.dtype.name == want.dtype.name, where
    if hasattr(want, "to_coo"):
        g, w = got.to_coo(), want.to_coo()
        for a, b in zip(g[:-1], w[:-1]):
            np.testing.assert_array_equal(a, b, err_msg=where)
        g, w = g[-1], w[-1]
    else:
        assert got.is_empty == want.is_empty, where
        if want.is_empty:
            return
        assert type(got.value) is type(want.value), where
        g, w = np.asarray(got.value), np.asarray(want.value)
    rel = REL.get(got.dtype.name)
    if rel is None:
        np.testing.assert_array_equal(g, w, err_msg=where)
    elif near_zero:
        w = np.where(np.isnan(w), 0.0, w)
        np.testing.assert_allclose(g, w, rtol=rel, atol=VAR_ATOL,
                                   err_msg=where)
    else:
        np.testing.assert_allclose(g, w, rtol=rel, atol=0, err_msg=where)


FORMS = {
    "rowwise": lambda A, v, a: A.reduce_rowwise(a),
    "columnwise": lambda A, v, a: A.reduce_columnwise(a),
    "scalar": lambda A, v, a: A.reduce_scalar(a),
    "vector": lambda A, v, a: v.reduce(a),
}
# the port's A.T forms, held against the JAX package's plain ones
T_FORMS = {"rowwise": lambda A, a: A.T.reduce_columnwise(a),
           "columnwise": lambda A, a: A.T.reduce_rowwise(a)}


def outcome(fn):
    try:
        return fn().new()
    except Exception as exc:  # noqa: BLE001 - the kind is compared
        return exc


def check_agg(name, ss, dtypes):
    for dtype in dtypes:
        mdata, vdata = matrix_data(dtype), vector_data(dtype)
        jA, jv = build(gbj, dtype, mdata, vdata)
        ja = getattr(gbj.agg.ss if ss else gbj.agg, name)
        want = {k: outcome(lambda: f(jA, jv, ja)) for k, f in FORMS.items()}
        for backing, cfg in BACKINGS.items():
            with gbt.config.set(device="cpu", **cfg):
                tA, tv = build(gbt, dtype, mdata, vdata)
                ta = getattr(gbt.agg.ss if ss else gbt.agg, name)
                for form, fn in FORMS.items():
                    where = f"{name} {dtype} {form} {backing}"
                    got = outcome(lambda: fn(tA, tv, ta))
                    calls = [got]
                    if form in T_FORMS:
                        calls.append(outcome(lambda: T_FORMS[form](tA, ta)))
                    for g in calls:
                        if isinstance(want[form], Exception):
                            assert isinstance(g, Exception), \
                                (where, want[form], g)
                            continue
                        assert not isinstance(g, Exception), (where, g)
                        same(g, want[form], where, name in VARIANCE)


@pytest.mark.parametrize("name", AGGS)
def test_aggregator_matches_jax(name):
    dtypes = ("UINT32",) if name.startswith("bitwise") else DTYPES
    check_agg(name, False, dtypes)


@pytest.mark.parametrize("name", SS_AGGS)
def test_ss_aggregator_matches_jax(name):
    check_agg(name, True, DTYPES + ("INT32",))


def test_namespaces_and_types():
    assert sorted(AGGS) == sorted(
        n for n in dir(gbj.agg) if not n.startswith("_") and n not in
        ("Aggregator", "from_string", "ss"))
    assert SS_AGGS == sorted(n for n in dir(gbj.agg.ss)
                             if not n.startswith("_"))
    assert len(AGGS) + len(SS_AGGS) == 37
    with pytest.raises(AttributeError, match="gb.agg.ss.argmin"):
        gbt.agg.argmin
    with pytest.raises(AttributeError):
        gbt.agg.nosuch
    for name in AGGS:
        ta, ja = getattr(gbt.agg, name), getattr(gbj.agg, name)
        for dtype in DTYPES + ("INT32", "UINT32"):
            assert (dtype in ta) == (dtype in ja), (name, dtype)
            if dtype in ta:
                assert ta[dtype].return_type.name == \
                    ja[dtype].return_type.name, (name, dtype)
    assert repr(gbt.agg.mean) == repr(gbj.agg.mean) == "agg.mean"


@pytest.mark.parametrize("string", ["count", "mean", "+", "*", "&", "|",
                                    "exists", "count_zero[INT64]",
                                    "sum[FP32]", "hypot[INT64]"])
def test_from_string(string):
    got, want = gbt.agg.from_string(string), gbj.agg.from_string(string)
    assert repr(got) == repr(want)
    with gbt.config.set(device="cpu"):
        tA, _ = build(gbt, "FP64", matrix_data("FP64"), vector_data("FP64"))
        jA, _ = build(gbj, "FP64", matrix_data("FP64"), vector_data("FP64"))
        same(tA.reduce_rowwise(got).new(), jA.reduce_rowwise(want).new(),
             string)


def test_string_reduce():
    """A reduce by an aggregator's name (the "binary|aggregator" kind);
    a monoid's or binary op's name still means the monoid."""
    with gbt.config.set(device="cpu"):
        tA, tv = build(gbt, "FP64", matrix_data("FP64"), vector_data("FP64"))
        jA, jv = build(gbj, "FP64", matrix_data("FP64"), vector_data("FP64"))
        for string, ja in (("count", gbj.agg.count), ("mean", gbj.agg.mean),
                           ("ss.argmax", gbj.agg.ss.argmax)):
            same(tA.reduce_rowwise(string).new(),
                 jA.reduce_rowwise(ja).new(), string)
            same(tA.reduce_columnwise(string).new(),
                 jA.reduce_columnwise(ja).new(), string)
            same(tv.reduce(string).new(), jv.reduce(ja).new(), string)
        same(tA.reduce_scalar("count").new(),
             jA.reduce_scalar(gbj.agg.count).new(), "count")
        same(tA.reduce_rowwise("min").new(),
             jA.reduce_rowwise("min").new(), "min")
        with pytest.raises(ValueError):
            tA.reduce_rowwise("nosuch")
        for gb in (gbj, gbt):  # the parsers lower the case
            for string in ("argmin", "L2norm"):
                with pytest.raises(ValueError):
                    gb.agg.from_string(string)
        # the port also walks into agg.ss, as its other parsers walk
        # binary.ss
        assert gbt.agg.from_string("ss.argmin") is gbt.agg.ss.argmin


@pytest.mark.parametrize("name", ["argmin", "argmax", "first_index",
                                  "last_index"])
def test_reduce_scalar_refuses_index_aggregators(name):
    for gb in (gbj, gbt):
        with gbt.config.set(device="cpu"):
            A = gb.Matrix.from_coo([0, 1], [1, 0], [1.0, 2.0])
            with pytest.raises(ValueError, match=name):
                A.reduce_scalar(getattr(gb.agg.ss, name))
    with gbt.config.set(device="cpu"):
        A = gbt.Matrix.from_coo([0, 1], [1, 0], [1.0, 2.0])
        for ok in ("first", "last"):
            A.reduce_scalar(getattr(gbt.agg.ss, ok)).new()


# --------------------------------------------------------------------- #
# the scenarios of the JAX package's tests/test_agg.py
def _log2(gb):
    return jnp.log2 if gb is gbj else torch.log2


def _int_data(shape, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(1, 9, shape)
    ok = rng.random(shape) < 0.6
    return vals, ok


def _from_pair(gb, vals, ok):
    idx = np.nonzero(ok)
    if vals.ndim == 1:
        return gb.Vector.from_coo(idx[0], vals[ok], size=vals.shape[0])
    return gb.Matrix.from_coo(idx[0], idx[1], vals[ok], nrows=vals.shape[0],
                              ncols=vals.shape[1])


def _make_A(gb):
    """The reference's 7 x 7 example matrix (tests/helpers.make_A)."""
    return gb.Matrix.from_coo(
        [3, 0, 3, 5, 6, 0, 6, 1, 6, 2, 4, 1],
        [0, 1, 2, 2, 2, 3, 3, 4, 4, 5, 5, 6],
        [3, 2, 3, 1, 5, 3, 7, 8, 3, 1, 7, 4], nrows=7, ncols=7)


def sc_scalar_reduce(gb):
    v = _from_pair(gb, *_int_data((23,), 1))
    return [v.reduce(getattr(gb.agg, n)) for n in (
        "sum", "prod", "min", "max", "count", "count_nonzero", "count_zero",
        "sum_of_squares", "L0norm", "L1norm", "L2norm", "Linfnorm", "mean",
        "peak_to_peak", "varp", "vars", "stdp", "stds", "hypot", "logaddexp",
        "logaddexp2", "geometric_mean", "harmonic_mean", "root_mean_square",
        "sum_of_inverses", "exists")]


def sc_rowwise(gb):
    A = _from_pair(gb, *_int_data((6, 9), 2))
    return [A.reduce_rowwise(getattr(gb.agg, n)) for n in (
        "sum", "prod", "min", "max", "count", "count_nonzero", "count_zero",
        "sum_of_squares", "L0norm", "L1norm", "L2norm", "Linfnorm", "mean",
        "peak_to_peak")]


def sc_ss_positional(gb):
    v = gb.Vector.from_dense(np.array([5, 2, 9, 2]))
    w = gb.Vector.from_coo([2, 5], [7, 3], size=9)
    return [v.reduce(getattr(gb.agg.ss, n)) for n in (
        "argmin", "argmax", "first", "last", "first_index", "last_index")] + \
        [w.reduce(gb.agg.ss.first), w.reduce(gb.agg.ss.last_index),
         w.reduce(gb.agg.ss.argmin)]


def sc_bitwise(gb):
    v = gb.Vector.from_dense(np.array([0b1100, 0b1010], np.uint32))
    return [v.reduce(gb.agg.bitwise_all), v.reduce(gb.agg.bitwise_any)]


def sc_callable(gb):
    v = gb.Vector.from_dense(np.array([1, 2, 3]))
    A = gb.Matrix.from_dense(np.array([[1, 2], [3, 4]]))
    return [gb.agg.sum(v), gb.agg.sum(A)]


def sc_custom_monoid(gb):
    my_sum = gb.agg.Aggregator("my_sum", monoid=gb.monoid.plus)
    v = gb.Vector.from_coo([0, 1, 3], [1.0, 2.0, 3.0], size=5)
    return [v.reduce(my_sum)]


def sc_custom_semiring_initval(gb):
    twice = gb.agg.Aggregator("twice", initval=2,
                              semiring=gb.semiring.plus_times,
                              semiring2=gb.semiring.plus_first)
    v = gb.Vector.from_coo([0, 1, 2, 3], [1.0, 2.0, 3.0, 4.0], size=6)
    A = gb.Matrix.from_coo([0, 0, 1], [0, 1, 1], [1.0, 3.0, 5.0], nrows=2,
                           ncols=2)
    return [v.reduce(twice), A.reduce_rowwise(twice)]


def sc_custom_switch_finalize(gb):
    agg = gb.agg.Aggregator("twice_log2", initval=2,
                            semiring=gb.semiring.plus_times, switch=True,
                            semiring2=gb.semiring.plus_first,
                            finalize=_log2(gb))
    v = gb.Vector.from_coo([0, 1, 2, 3], [1.0, 2.0, 3.0, 4.0], size=6)
    return [v.reduce(agg)]


def sc_custom_applybegin(gb):
    l1 = gb.agg.Aggregator("l1", applybegin=gb.unary.abs,
                           semiring=gb.semiring.plus_first,
                           semiring2=gb.semiring.plus_first)
    w = gb.Vector.from_coo([0, 1], [-3.0, 4.0], size=3)
    return [w.reduce(l1)]


def sc_custom_composite(gb):
    my_mean = gb.agg.Aggregator("my_mean",
                                composite=[gb.agg.count, gb.agg.sum],
                                finalize=lambda c, s: s / c)
    v = gb.Vector.from_coo([0, 1, 3, 4], [1.0, 2.0, 3.0, 4.0], size=6)
    return [v.reduce(my_mean)]


def sc_custom_errors(gb):
    out = []
    for parts in ({}, {"composite": [gb.agg.count]},
                  {"monoid": gb.binary.plus}):
        try:
            gb.agg.Aggregator("bad", **parts)
            out.append(None)
        except TypeError:
            out.append(TypeError)
    return out


def sc_argminmax_matrix(gb):
    A = _make_A(gb)
    a = gb.agg.ss
    out = [A.reduce_rowwise(a.argmin), A.T.reduce_columnwise(a.argmin),
           A.reduce_rowwise(a.argmax), A.T.reduce_columnwise(a.argmax),
           A.reduce_columnwise(a.argmin), A.T.reduce_rowwise(a.argmin),
           A.reduce_columnwise(a.argmax), A.T.reduce_rowwise(a.argmax)]
    try:
        A.reduce_scalar(a.argmin)
        out.append(None)
    except ValueError:
        out.append(ValueError)
    return out


def sc_firstlast_matrix(gb):
    A = _make_A(gb)
    a = gb.agg.ss
    return [A.reduce_rowwise(a.first), A.T.reduce_columnwise(a.first),
            A.reduce_rowwise(a.last), A.T.reduce_columnwise(a.last)]


def sc_firstlast_index_matrix(gb):
    A = _make_A(gb)
    return [A.reduce_rowwise(gb.agg.ss.first_index),
            A.reduce_rowwise(gb.agg.ss.last_index)]


def sc_empty_matrix(gb):
    A = gb.Matrix(int, 3, 4)
    out = []
    for name in ("sum", "prod", "min", "max", "count", "mean", "varp",
                 "L2norm", "peak_to_peak"):
        a = getattr(gb.agg, name)
        out += [A.reduce_rowwise(a), A.reduce_columnwise(a),
                A.reduce_scalar(a)]
    return out


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_scalar_reduce, sc_rowwise, sc_ss_positional, sc_bitwise, sc_callable,
    sc_custom_monoid, sc_custom_semiring_initval, sc_custom_switch_finalize,
    sc_custom_applybegin, sc_custom_composite, sc_custom_errors,
    sc_argminmax_matrix, sc_firstlast_matrix, sc_firstlast_index_matrix,
    sc_empty_matrix)}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("backing", list(BACKINGS))
def test_jax_agg_scenarios(scenario, backing):
    with gbj.config.set(**BACKINGS[backing]):
        want = SCENARIOS[scenario](gbj)
    with gbt.config.set(device="cpu", **BACKINGS[backing]):
        got = SCENARIOS[scenario](gbt)
        assert len(got) == len(want)
        for k, (g, w) in enumerate(zip(got, want)):
            if w is None or isinstance(w, type):
                assert g is w, (scenario, k)
                continue
            same(g.new(), w.new(), f"{scenario} {k}")


# --------------------------------------------------------------------- #
# kronecker and reposition
def kron_operands(gb, dtype="FP32"):
    rng = np.random.default_rng(12)
    out = []
    for shape in ((3, 4), (4, 2)):
        ok = rng.random(shape) < 0.5
        r, c = np.nonzero(ok)
        v = values(rng, dtype, len(r)).astype(
            gbt.dtypes.lookup_dtype(dtype).np_type)
        out.append(gb.Matrix.from_coo(r, c, v, dtype=dtype, nrows=shape[0],
                                      ncols=shape[1]))
    return out


KRON = {
    "times": lambda gb, A, B: A.kronecker(B),
    "plus": lambda gb, A, B: A.kronecker(B, gb.binary.plus),
    "monoid max": lambda gb, A, B: A.kronecker(B, gb.monoid.max),
    "string -": lambda gb, A, B: A.kronecker(B, "-"),
    "A.T x B": lambda gb, A, B: A.T.kronecker(B),
    "A x B.T": lambda gb, A, B: A.kronecker(B.T, gb.binary.times),
    "A.T x B.T": lambda gb, A, B: A.T.kronecker(B.T, gb.binary.first),
    "string min": lambda gb, A, B: A.kronecker(B, "min"),
}


@pytest.mark.parametrize("case", list(KRON))
@pytest.mark.parametrize("backing", list(BACKINGS))
@pytest.mark.parametrize("dtype", ["FP32", "INT64", "BOOL"])
def test_kronecker(case, backing, dtype):
    want = KRON[case](gbj, *kron_operands(gbj, dtype)).new()
    with gbt.config.set(device="cpu", **BACKINGS[backing]):
        got = KRON[case](gbt, *kron_operands(gbt, dtype)).new()
        same(got, want, case)


REPOSITION = {
    "+1 -1": dict(args=(1, -1)),
    "-2 +3": dict(args=(-2, 3)),
    "out of range": dict(args=(9, 0)),
    "far negative": dict(args=(0, -20)),
    "new shape": dict(args=(2, 1), nrows=9, ncols=4),
    "smaller shape": dict(args=(-1, -1), nrows=3, ncols=3),
}


@pytest.mark.parametrize("case", list(REPOSITION))
@pytest.mark.parametrize("backing", list(BACKINGS))
def test_reposition(case, backing):
    spec = REPOSITION[case]
    kw = {k: spec[k] for k in ("nrows", "ncols") if k in spec}
    mdata, vdata = matrix_data("INT64"), vector_data("INT64")
    jA, jv = build(gbj, "INT64", mdata, vdata)
    want = [jA.reposition(*spec["args"], **kw).new(),
            jA.T.reposition(*spec["args"]).new(),
            jv.reposition(spec["args"][0]).new(),
            jv.reposition(spec["args"][1], size=7).new()]
    with gbt.config.set(device="cpu", **BACKINGS[backing]):
        tA, tv = build(gbt, "INT64", mdata, vdata)
        got = [tA.reposition(*spec["args"], **kw).new(),
               tA.T.reposition(*spec["args"]).new(),
               tv.reposition(spec["args"][0]).new(),
               tv.reposition(spec["args"][1], size=7).new()]
        for k, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape, (case, k)
            same(g, w, f"{case} {k}")
