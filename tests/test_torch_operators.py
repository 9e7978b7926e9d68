"""The PyTorch port's operator namespaces against the JAX package's.

Lookups: every (operator name, dtype) pair of the port's namespaces
resolves in both packages to the same operator (name, input and return
type; for a semiring its monoid and binary op too), or raises in both.
This holds SuiteSparse's boolean renaming (``monoid.min["BOOL"]`` is
``land[BOOL]``, ``plus_times["BOOL"]`` reduces with ``lor``) and the BOOL
cast of the logical monoids (``lor_land["FP32"]`` reduces with
``lor[BOOL]``).  The one allowed difference: where the JAX package takes a
type the port lacks (signed inputs of a bitwise ring become UINT64), the
port raises NotImplementedError naming ROADMAP queue 1, item 12.

Engine: vxm, mxv and reduces with the renamed and cast operators through
both public APIs, on dense- and sparse-backed matrices, on the CPU:
values, type and structure exact; ``land``/``lor`` as the multiplies of an
arithmetic monoid over FP32 and INT32 too (``plus_land["FP32"]``).  Names the
JAX package has and the port lacks raise NotImplementedError; ``ss.iterate``
refuses a state that is not a Vector or a Matrix.
"""

import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt

torch.set_num_threads(1)


@pytest.fixture
def cpu():
    with gbt.config.set(device="cpu"):
        yield


DTYPES = ("BOOL", "INT32", "INT64", "UINT32", "FP32", "FP64")
PORT_TYPES = set(DTYPES)
N = 12


def _typed_names(ns, opclass):
    return sorted(k for k, v in vars(ns).items()
                  if not k.startswith("_") and getattr(v, "opclass", None)
                  == opclass and not isinstance(v, type))


BINARY = _typed_names(gbt.binary, "BinaryOp")
MONOID = _typed_names(gbt.monoid, "Monoid")
UNARY = _typed_names(gbt.unary, "UnaryOp")
INDEXUNARY = _typed_names(gbt.indexunary, "IndexUnaryOp")
SELECT = _typed_names(gbt.select, "SelectOp")
LOOKUPS = ([("binary", n) for n in BINARY] + [("monoid", n) for n in MONOID]
           + [("unary", n) for n in UNARY]
           + [("indexunary", n) for n in INDEXUNARY]
           + [("select", n) for n in SELECT]
           + [("semiring", f"{m}_{b}") for m in MONOID for b in BINARY])


def normal_form(op):
    out = (op.name, op.type.name, op.return_type.name)
    if op.opclass == "Semiring":
        out += (normal_form(op.monoid), normal_form(op.binaryop))
    return out


def resolve(gb, namespace, name, dtype):
    """The normal form of gb.<namespace>.<name>[dtype], or the exception
    class that the lookup raised."""
    try:
        return normal_form(getattr(getattr(gb, namespace), name)[dtype])
    except (AttributeError, KeyError, NotImplementedError) as exc:
        return type(exc)


def types_of(form):
    if isinstance(form, tuple) and len(form) == 5:
        return {form[1], form[2]} | types_of(form[3]) | types_of(form[4])
    return {form[1], form[2]}


@pytest.mark.parametrize("namespace,name", LOOKUPS,
                         ids=[f"{a}.{b}" for a, b in LOOKUPS])
def test_lookup_resolves_as_in_jax(namespace, name):
    for dtype in DTYPES:
        want = resolve(gbj, namespace, name, dtype)
        got = resolve(gbt, namespace, name, dtype)
        if got is NotImplementedError and isinstance(want, tuple):
            assert types_of(want) - PORT_TYPES, (name, dtype, want)
            with pytest.raises(NotImplementedError, match="item 12"):
                getattr(getattr(gbt, namespace), name)[dtype]
            continue
        assert got == want, (namespace, name, dtype)


@pytest.mark.parametrize("lookup,want", [
    (lambda gb: gb.monoid.min["BOOL"], ("land", "BOOL", "BOOL")),
    (lambda gb: gb.monoid.max["BOOL"], ("lor", "BOOL", "BOOL")),
    (lambda gb: gb.monoid.times["BOOL"], ("land", "BOOL", "BOOL")),
    (lambda gb: gb.monoid.lor["FP32"], ("lor", "BOOL", "BOOL")),
    (lambda gb: gb.monoid.land["INT64"], ("land", "BOOL", "BOOL")),
    (lambda gb: gb.binary.land["FP32"], ("land", "FP32", "FP32")),
    (lambda gb: gb.semiring.plus_times["BOOL"],
     ("plus_times", "BOOL", "BOOL", ("lor", "BOOL", "BOOL"),
      ("times", "BOOL", "BOOL"))),
    (lambda gb: gb.semiring.lor_land["FP32"],
     ("lor_land", "FP32", "BOOL", ("lor", "BOOL", "BOOL"),
      ("land", "FP32", "FP32"))),
], ids=["min_bool", "max_bool", "times_bool", "lor_fp32", "land_int64",
        "binary_land_fp32", "plus_times_bool", "lor_land_fp32"])
def test_renamed_and_cast_lookups(lookup, want):
    assert normal_form(lookup(gbj)) == want
    assert normal_form(lookup(gbt)) == want


@pytest.mark.parametrize("path", [
    "binary.rminus", "binary.lxor", "binary.numpy", "binary.ss.register_new",
    "monoid.lxor", "monoid.eq", "unary.ainv", "unary.ss.erf",
    "semiring.plus_rminus", "semiring.lxor_land", "semiring.min_div",
    "semiring.ss.lxor_firsti1"])
def test_missing_operator_names_item_12(path):
    def walk(gb):
        obj = gb
        for part in path.split("."):
            obj = getattr(obj, part)
        return obj

    assert walk(gbj) is not None
    with pytest.raises(NotImplementedError, match="queue 1, item 12"):
        walk(gbt)


def test_unknown_names_and_refused_types():
    for gb in (gbj, gbt):
        for ns, name in ((gb.binary, "nosuch"), (gb.monoid, "nosuch"),
                         (gb.unary, "nosuch"), (gb.semiring, "foo_bar"),
                         (gb.semiring, "min_firsti")):
            with pytest.raises(AttributeError):
                getattr(ns, name)
        for op, dtype in ((gb.monoid.plus, "BOOL"), (gb.binary.band, "FP32"),
                          (gb.monoid.band, "FP32")):
            with pytest.raises(KeyError):
                op[dtype]


def test_iterate_refuses_other_state(cpu):
    for gb in (gbj, gbt):
        v = gb.Vector.from_dense(np.ones(3, np.float32))
        for bad in (3, np.ones(3), gb.Scalar.from_value(1.0)):
            with pytest.raises(TypeError, match="Vector or Matrix"):
                gb.ss.iterate(lambda s, i: None, {"v": v, "x": bad},
                              max_iter=2)
        assert int(gb.ss.iterate(lambda s, i: None, {"v": v}, max_iter=2)) == 2


# --------------------------------------------------------------------- #
# the engines, through both public APIs
def _data(dtype, seed):
    """A 12x12 matrix with some zero values, and a sparse vector."""
    rng = np.random.default_rng(seed)
    r, c = np.nonzero(rng.random((N, N)) < 0.3)
    if dtype == "BOOL":
        v, x = rng.random(len(r)) < 0.6, rng.random(N) < 0.6
    elif dtype in ("INT32", "INT64"):
        v, x = rng.integers(-2, 3, len(r)), rng.integers(-2, 3, N)
    else:
        v = rng.choice(np.float32([0, -1.5, 0.25, 2, np.nan]), len(r))
        x = rng.choice(np.float32([0, -1, 0.5, 3]), N)
    keep = np.flatnonzero(rng.random(N) < 0.7)
    return r, c, v, keep, x[keep]


def _both(dtype, seed, sparse):
    r, c, v, xi, xv = _data(dtype, seed)
    out = []
    for gb in (gbj, gbt):
        limit = 0 if sparse and gb is gbt else gb.config["auto_sparse_limit"]
        with gb.config.set(auto_sparse_limit=limit):
            A = gb.Matrix.from_coo(r, c, v, dtype=dtype, nrows=N, ncols=N)
        x = gb.Vector.from_coo(xi, xv, dtype=dtype, size=N)
        out.append((A, x))
    assert (out[1][0]._sparse is not None) == sparse
    return out


def _same(got, want):
    """Two Vectors: type, structure and values equal."""
    assert got.dtype.name == want.dtype.name
    (gi, gv), (wi, wv) = got.to_coo(), want.to_coo()
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gv, wv)


ENGINE_CASES = [("BOOL", r, k) for r in ("plus_times", "min_plus", "max_times")
                for k in ("vxm", "mxv")] + \
               [(dt, "lor_land", k) for dt in ("FP32", "INT64")
                for k in ("vxm", "mxv")] + \
               [(dt, r, k) for dt, r in (("FP32", "plus_land"),
                                         ("INT32", "min_lor"),
                                         ("FP32", "max_lor"),
                                         ("INT32", "plus_land"))
                for k in ("vxm", "mxv")]


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("dtype,ring,kind", ENGINE_CASES,
                         ids=[f"{d}-{r}-{k}" for d, r, k in ENGINE_CASES])
def test_products_with_renamed_and_cast_rings(cpu, dtype, ring, kind, sparse):
    (jA, jx), (tA, tx) = _both(dtype, 7, sparse)
    if kind == "vxm":
        want = jx.vxm(jA, getattr(gbj.semiring, ring)[dtype]).new()
        got = tx.vxm(tA, getattr(gbt.semiring, ring)[dtype]).new()
    else:
        want = jA.mxv(jx, getattr(gbj.semiring, ring)[dtype]).new()
        got = tA.mxv(tx, getattr(gbt.semiring, ring)[dtype]).new()
    # a logical monoid reduces BOOL; land and lor as multiplies of an
    # arithmetic monoid give 1 or 0 in their own type
    logical = dtype == "BOOL" or ring.startswith(("lor_", "land_"))
    assert want.dtype.name == ("BOOL" if logical else dtype)
    assert want.nvals > 0
    _same(got, want)


REDUCE_CASES = [(m, dt) for m in ("lor", "land") for dt in ("FP32", "INT64")] \
    + [(m, "BOOL") for m in ("min", "max", "times")]


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("mono,dtype", REDUCE_CASES,
                         ids=[f"{m}-{d}" for m, d in REDUCE_CASES])
def test_reduces_with_renamed_and_cast_monoids(cpu, mono, dtype, sparse):
    (jA, jx), (tA, tx) = _both(dtype, 11, sparse)
    jm, tm = getattr(gbj.monoid, mono), getattr(gbt.monoid, mono)
    for allow_empty in (True, False):
        want = jx.reduce(jm, allow_empty=allow_empty).new()
        got = tx.reduce(tm, allow_empty=allow_empty).new()
        assert got.dtype.name == want.dtype.name == "BOOL"
        assert got.is_empty == want.is_empty
        assert got.value == want.value
    _same(tA.reduce_rowwise(tm).new(), jA.reduce_rowwise(jm).new())
    _same(tA.T.reduce_rowwise(tm).new(), jA.T.reduce_rowwise(jm).new())


def _entries(store):
    return [e for plans in (store._lanepipe_plans, store._sortpipe_plans)
            for e in plans.values() if e is not None]


def test_bool_twin_is_cached(cpu):
    """A logical ring over FP32 values runs on the matrix's own plan: the
    truth values are made once and kept in its entry, beside the values.
    A 64-bit matrix, which no pipeline takes itself, runs on the plans of
    its BOOL twin, made once."""
    (_, _), (tA, tx) = _both("FP32", 3, True)
    ring = gbt.semiring.lor_land["FP32"]
    tx.vxm(tA, gbt.semiring.plus_times["FP32"]).new()
    (entry,) = _entries(tA._sparse)
    tx.vxm(tA, ring).new()
    truth = entry["truth"][gbt.dtypes.FP32]
    tx.vxm(tA, ring).new()
    assert _entries(tA._sparse) == [entry] and not tA._sparse._bool_twins
    assert entry["truth"][gbt.dtypes.FP32] is truth
    assert truth.dtype == torch.int32 and set(truth.unique().tolist()) == {0, 1}
    (_, _), (tB, ty) = _both("INT64", 3, True)
    ty.vxm(tB, gbt.semiring.lor_land["INT64"]).new()
    twin = tB._sparse._bool_twins[gbt.dtypes.INT64]
    ty.vxm(tB, gbt.semiring.lor_land["INT64"]).new()
    assert tB._sparse._bool_twins[gbt.dtypes.INT64] is twin
    assert twin.dtype is gbt.dtypes.BOOL and not _entries(tB._sparse)
    assert ring.bool_twin() is gbt.semiring.lor_land["BOOL"]
    # a multiply that does not commute with the cast keeps its own type
    assert gbt.semiring.lor_times["FP32"].bool_twin() is None
