"""The port's operator namespaces against the JAX package's (the twin of
tests/test_op.py): the builtins, typed lookups, identities, the lazy
semirings, from_string, user operators (register_new, parameterized),
commutation and monoid links, C integer division, the numpy namespaces,
``gb.op``, positional operators and dir().  Every case runs through both
packages (the port on the CPU) and, where a value is computed, compares
them."""

import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt

torch.set_num_threads(1)
BOTH = pytest.mark.parametrize("gb", [gbj, gbt], ids=["jax", "torch"])


@pytest.fixture(autouse=True)
def cpu():
    with gbt.config.set(device="cpu"):
        yield


def values(v):
    return v.to_coo()[1].tolist()


@BOTH
def test_builtin_unary_exist(gb):
    for name in ["identity", "ainv", "minv", "abs", "lnot", "one", "sqrt",
                 "exp", "log", "sin", "floor", "isnan", "isinf"]:
        assert hasattr(gb.unary, name), name
    for name in ["erf", "erfc", "lgamma", "tgamma", "positioni", "positionj1"]:
        assert hasattr(gb.unary.ss, name), name
    with pytest.raises(AttributeError, match="unary.ss"):
        gb.unary.erf  # noqa: B018


@BOTH
def test_builtin_binary_exist(gb):
    for name in ["first", "second", "plus", "minus", "times", "cdiv", "rdiv",
                 "truediv", "min", "max", "pow", "pair", "any", "lor", "land",
                 "eq", "ne", "gt", "atan2", "floordiv", "absfirst", "binom",
                 "isclose"]:
        assert hasattr(gb.binary, name), name
    for name in ["firsti", "firstj1", "secondi", "secondj"]:
        assert hasattr(gb.binary.ss, name), name


@BOTH
def test_typed_lookup(gb):
    d = gb.dtypes
    t = gb.binary.plus[d.INT64]
    assert t.type is d.INT64 and t.return_type is d.INT64
    assert gb.binary.eq[d.FP64].return_type is d.BOOL
    assert gb.unary.sqrt[d.INT64].return_type is d.FP64
    assert d.INT64 in gb.binary.plus and d.INT64 in gb.unary.sqrt
    with pytest.raises(KeyError, match="does not work with"):
        gb.unary.bnot[d.FP64]


@BOTH
def test_monoid_identities(gb):
    d, m = gb.dtypes, gb.monoid
    assert m.plus[d.INT64].identity == 0
    assert m.times[d.INT64].identity == 1
    assert m.min[d.INT8].identity == 127
    assert m.max[d.INT8].identity == -128
    assert m.min[d.FP64].identity == np.inf
    assert m.lor[d.BOOL].identity is False
    assert m.land[d.BOOL].identity is True
    assert m.band[d.UINT8].identity == 255
    assert m.band[d.UINT64].identity == 2**64 - 1
    assert m.lxnor[d.BOOL].identity is True and m.eq[d.BOOL].identity is True
    assert d.BOOL in set(m.lor.identities)
    assert m.lor[d.INT64].type == d.BOOL


@BOTH
def test_semiring_lazy_build(gb):
    d = gb.dtypes
    ring = gb.semiring.min_plus
    assert ring.monoid.name == "min" and ring.binaryop.name == "plus"
    assert gb.semiring.min_plus is ring
    assert ring[d.INT64].return_type is d.INT64
    assert gb.semiring.plus_pair[d.FP64].return_type is d.FP64
    assert gb.semiring.lor_land[d.BOOL].return_type is d.BOOL
    with pytest.raises(AttributeError, match="semiring.ss"):
        gb.semiring.min_firsti  # noqa: B018
    assert gb.semiring.ss.min_firsti.is_positional
    for bad in ("bogus_name", "min_bogus"):
        with pytest.raises(AttributeError):
            getattr(gb.semiring, bad)


@BOTH
def test_get_semiring_compose(gb):
    ring = gb.semiring.get_semiring(gb.monoid.plus, gb.binary.plus)
    assert ring.monoid is gb.monoid.plus
    assert gb.semiring.get_semiring(gb.monoid.plus, gb.binary.plus) is ring


@BOTH
def test_from_string(gb):
    assert gb.unary.from_string("abs") is gb.unary.abs
    assert gb.unary.from_string("-") is gb.unary.ainv
    assert gb.binary.from_string("+") is gb.binary.plus
    assert gb.binary.from_string("+[int]").type is gb.dtypes.INT64
    assert gb.monoid.from_string("*") is gb.monoid.times
    ring = gb.semiring.from_string("min.+")
    assert (ring.monoid.name, ring.binaryop.name) == ("min", "plus")
    assert gb.semiring.from_string("min_plus") is gb.semiring.min_plus
    assert gb.op.from_string("abs") is gb.unary.abs
    assert gb.select.from_string("<").name == "valuelt"
    with pytest.raises(ValueError):
        gb.binary.from_string("bogus_not_an_op")


@BOTH
def test_register_new_unary(gb):
    op_ = gb.unary.register_new("plus_one_twin", lambda x: x + 1)
    assert gb.unary.plus_one_twin is op_
    assert gb.dtypes.INT64 in op_
    v = gb.Vector.from_coo([0, 2], [10, 20])
    assert values(v.apply(op_).new()) == [11, 21]
    with pytest.raises(AttributeError, match="already defined"):
        gb.unary.register_new("plus_one_twin", lambda x: x)


@BOTH
def test_register_new_binary_monoid_semiring(gb):
    bop = gb.binary.register_new("absdiff_twin", lambda x, y: abs(x - y))
    mono = gb.monoid.register_new("maxabs_twin", bop, 0)
    assert gb.monoid.maxabs_twin is mono
    ring = gb.semiring.register_new("plus_absdiff_twin", gb.monoid.plus, bop)
    assert gb.semiring.plus_absdiff_twin is ring
    assert gb.op.absdiff_twin is bop
    v = gb.Vector.from_coo([0, 1], [3, -4])
    w = gb.Vector.from_coo([0, 1], [1, 1])
    assert values(v.ewise_mult(w, bop).new()) == [2, 5]
    assert v.inner(w, ring).new().value == 7
    assert v.reduce(mono).new().value == 7  # |0 - 3| then |3 - (-4)|


def _make(n=1):
    def inner(x):
        return x + n

    return inner


@BOTH
def test_parameterized_op(gb):
    p = gb.unary.register_anonymous(_make, parameterized=True)
    v = gb.Vector.from_coo([0], [1])
    assert v.apply(p(n=5)).new().to_coo()[1][0] == 6
    assert v.apply(p).new().to_coo()[1][0] == 2


@BOTH
def test_commutes_to(gb):
    b = gb.binary
    assert b.plus.commutes_to is b.plus
    assert b.minus.commutes_to is b.rminus
    assert b.lt.commutes_to is b.gt
    assert b.first.commutes_to is b.second
    assert b.pow.commutes_to is b.rpow
    assert b.plus["INT8"].commutes_to is b.plus["INT8"]


@BOTH
def test_binary_monoid_link(gb):
    assert gb.binary.plus.monoid is gb.monoid.plus
    assert gb.binary.lxor.monoid is gb.monoid.lxor
    assert gb.binary.minus.monoid is None
    assert gb.binary.bxor["UINT8"].monoid is gb.monoid.bxor["UINT8"]


@BOTH
def test_int_division_semantics(gb):
    d = gb.dtypes
    v = gb.Vector.from_coo([0, 1, 2], [-7, 7, -7], dtype=d.INT64)
    w = gb.Vector.from_coo([0, 1, 2], [2, -2, -2], dtype=d.INT64)
    assert values(v.ewise_mult(w, gb.binary.cdiv).new()) == [-3, -3, 3]
    for dt, top, bottom in (("INT32", 2**31 - 1, -(2**31)),
                            ("INT8", 127, -128), ("INT16", 2**15 - 1, -(2**15))):
        z = gb.Vector.from_coo([0, 1, 2], [0, 5, -5], dtype=dt)
        zero = gb.Vector.from_coo([0, 1, 2], [0, 0, 0], dtype=dt)
        assert values(z.ewise_mult(zero, gb.binary.cdiv).new()) == \
            [0, top, bottom]
    u = gb.Vector.from_coo([0, 1, 2], [0, 5, 2**64 - 1], dtype="UINT64")
    zu = gb.Vector.from_coo([0, 1, 2], [0, 0, 2**63], dtype="UINT64")
    assert values(u.ewise_mult(zu, gb.binary.cdiv).new()) == [0, 2**64 - 1, 1]


@BOTH
def test_truediv_promotes(gb):
    v = gb.Vector.from_coo([0, 1], [1, 3], dtype=gb.dtypes.INT64)
    w = gb.Vector.from_coo([0, 1], [2, 2], dtype=gb.dtypes.INT64)
    r = v.ewise_mult(w, gb.binary.truediv).new()
    assert r.dtype == gb.dtypes.FP64
    assert values(r) == [0.5, 1.5]


@BOTH
def test_numpy_namespace(gb):
    assert gb.unary.numpy.exp is not None
    assert gb.binary.numpy.mod is not None
    v = gb.Vector.from_coo([0, 1], [5, -3], dtype=gb.dtypes.INT64)
    assert values(v.apply(gb.binary.numpy.mod, right=3).new()) == [2, 0]


@BOTH
def test_aggregators_exist(gb):
    for name in ["sum", "prod", "all", "any", "min", "max", "count",
                 "count_nonzero", "mean", "varp", "stdp", "L2norm",
                 "logaddexp", "hypot", "peak_to_peak"]:
        assert hasattr(gb.agg, name), name
    for name in ["argmin", "argmax", "first", "last", "first_index"]:
        assert hasattr(gb.agg.ss, name), name


@BOTH
def test_op_namespace_combined(gb):
    assert gb.op.plus is gb.binary.plus
    assert gb.op.abs is gb.unary.abs
    assert gb.op.min_plus is gb.semiring.min_plus


def _plus_x(x=0):
    def inner(val):
        return val + x

    return inner


@BOTH
def test_unaryop_parameterized_full(gb):
    op = gb.unary.register_anonymous(_plus_x, parameterized=True)
    v = gb.Vector.from_coo([0, 1, 3], [1, 2, -4], dtype=gb.dtypes.INT32)
    assert v.isequal(v.apply(op).new(), check_dtype=True)
    assert v.isequal(v.apply(op(0)).new(), check_dtype=True)
    r10 = gb.Vector.from_coo([0, 1, 3], [11, 12, 6], dtype=gb.dtypes.INT32)
    assert r10.isequal(v.apply(op(x=10)).new(), check_dtype=True)


def _plus_plus_x(x=0):
    def inner(left, right):
        return left + right + x

    return inner


@BOTH
def test_binaryop_parameterized_full(gb):
    op = gb.binary.register_anonymous(_plus_plus_x, parameterized=True)
    v = gb.Vector.from_coo([0, 1, 3], [1, 2, -4], dtype=gb.dtypes.INT32)
    r0 = gb.Vector.from_coo([0, 1, 3], [2, 4, -8], dtype=gb.dtypes.INT32)
    assert v.ewise_mult(v, op).new().isequal(r0, check_dtype=True)
    r1 = gb.Vector.from_coo([0, 1, 3], [3, 5, -7], dtype=gb.dtypes.INT32)
    assert v.ewise_add(v, op(1)).new().isequal(r1, check_dtype=True)
    v(op) << v
    assert v.isequal(r0)
    r11 = gb.Vector.from_coo([0, 1, 3], [13, 15, 3])
    assert v.apply(op(1), left=10).new().isequal(r11, check_dtype=False)


@BOTH
def test_monoid_and_semiring_parameterized(gb):
    bin_op = gb.binary.register_anonymous(_plus_plus_x, parameterized=True)
    mono = gb.monoid.register_anonymous(bin_op, lambda x=0: -x,
                                        name="plus_plus_x_monoid")
    v = gb.Vector.from_coo([0, 1, 3], [1, 2, -4], dtype=gb.dtypes.INT64)
    assert v.reduce(mono(0)).new().value == -1
    assert v.reduce(mono(1)).new().value == 1
    ring = gb.semiring.register_anonymous(mono, gb.binary.times,
                                          name="plus_plus_x_times")
    A = gb.Matrix.from_coo([0, 0], [0, 1], [2, 3], nrows=2, ncols=2)
    u = gb.Vector.from_coo([0, 1], [5, 7])
    assert A.mxv(u, ring(0)).new().to_coo()[1][0] == 2 * 5 + 3 * 7


@BOTH
def test_get_semiring_caches(gb):
    ring1 = gb.semiring.get_semiring(gb.monoid.plus, gb.binary.times)
    assert gb.semiring.get_semiring(gb.monoid.plus, gb.binary.times) is ring1
    assert ring1.monoid.name == "plus"


@BOTH
def test_commutes_tables(gb):
    b = gb.binary
    for name in ["plus", "times", "min", "max", "lor", "land", "eq", "ne",
                 "lxor", "lxnor", "bxor", "hypot"]:
        op = getattr(b, name)
        assert op.commutes_to is op, name
    for a, c in (("lt", "gt"), ("gt", "lt"), ("le", "ge"), ("first", "second"),
                 ("minus", "rminus"), ("cdiv", "rdiv"), ("isgt", "islt"),
                 ("truediv", "rtruediv"), ("floordiv", "rfloordiv"),
                 ("absfirst", "abssecond")):
        assert getattr(b, a).commutes_to.name == c
    assert b.atan2.commutes_to is None


@BOTH
def test_positional_ops(gb):
    A = gb.Matrix.from_coo([0, 1, 2], [2, 0, 1], [9, 9, 9], nrows=3, ncols=3)
    rr, cc, vv = A.apply(gb.indexunary.rowindex).new().to_coo()
    np.testing.assert_array_equal(vv, rr.astype(np.int64))
    rr, cc, vv = A.apply(gb.indexunary.colindex).new().to_coo()
    np.testing.assert_array_equal(vv, cc.astype(np.int64))
    u = gb.Vector.from_coo([0, 1, 2], [1, 1, 1])
    got = A.mxv(u, gb.semiring.ss.min_secondi).new()
    np.testing.assert_array_equal(got.to_coo()[1], [2, 0, 1])


@BOTH
def test_is_idempotent(gb):
    m = gb.monoid
    assert m.min.is_idempotent and m.max.is_idempotent
    assert m.lor.is_idempotent and m.band.is_idempotent
    assert not (m.plus.is_idempotent or m.times.is_idempotent
                or m.lxor.is_idempotent or m.bxor.is_idempotent)


@BOTH
def test_dir_namespaces(gb):
    assert "plus" in dir(gb.binary)
    assert "min_plus" in dir(gb.semiring)
    assert "sqrt" in dir(gb.unary)
    assert "numpy" in dir(gb.binary)
    assert "exp" in dir(gb.unary.numpy)
    assert "add_multiply" in dir(gb.semiring.numpy)


@BOTH
def test_jit_register_new(gb):
    """``<namespace>.ss.register_new`` with a callable (the JAX package's
    engine-JIT registration, which takes Python, not C)."""
    op = gb.binary.ss.register_new("jit_absdiff_twin", lambda x, y: abs(x - y))
    assert gb.binary.ss.jit_absdiff_twin is op
    v = gb.Vector.from_coo([0, 1], [3, -4])
    w = gb.Vector.from_coo([0, 1], [1, 1])
    assert values(v.ewise_mult(w, op).new()) == [2, 5]
    uop = gb.unary.ss.register_new("jit_twice_twin", lambda x: x * 2)
    assert values(v.apply(uop).new()) == [6, -8]
