"""The port's data types against the JAX package's (the twin of
tests/test_dtype.py): the eleven real types, lookups by every key,
equality and ordering, ``unify`` (numpy's promotion, with the scalar
asymmetry), pickling, and the storage of the types torch lacks kernels
for (UINT16 in int32, UINT32 in int64, UINT64 as int64 bits), the
complex types and the user-defined types (``register_new``,
``register_anonymous``, struct and subarray dtypes, a dict of fields)."""

import itertools
import pickle

import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt
from graphblas_tpu_torch.core import dtypes as core_dtypes

NAMES = ("BOOL", "INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16",
         "UINT32", "UINT64", "FP32", "FP64")
NAMES13 = NAMES + ("FC32", "FC64")


def test_builtin_dtypes():
    for name in NAMES:
        assert getattr(gbt.dtypes, name).np_type == \
            getattr(gbj.dtypes, name).np_type
    for name in ("FC32", "FC64"):
        assert getattr(gbj.dtypes, name).is_complex
        got = getattr(gbt.dtypes, name)
        assert got.is_complex and not got.is_float
        assert got.np_type == getattr(gbj.dtypes, name).np_type
    assert gbt.dtypes.FC32.torch_type is torch.complex64
    assert gbt.dtypes.FC64.torch_type is torch.complex128


def test_lookup():
    for gb in (gbj, gbt):
        d, look = gb.dtypes, gb.dtypes.lookup_dtype
        assert look("INT64") is d.INT64
        assert look("int64") is d.INT64
        assert look(int) is d.INT64
        assert look(float) is d.FP64
        assert look(bool) is d.BOOL
        assert look(np.dtype(np.int32)) is d.INT32
        assert look(d.FP32) is d.FP32
        with pytest.raises(TypeError, match="Bad dtype"):
            look(None)
        with pytest.raises(ValueError, match="Unknown dtype"):
            look("not_a_dtype")
    # a Python int that INT64 cannot hold is UINT64
    assert gbt.dtypes.lookup_dtype(int, 2**63) is gbt.dtypes.UINT64
    assert gbt.dtypes.lookup_dtype(int, 2**63 - 1) is gbt.dtypes.INT64


def test_dtype_eq():
    for d in (gbj.dtypes, gbt.dtypes):
        assert d.INT64 == "INT64"
        assert d.INT64 == np.int64
        assert d.INT64 != d.INT32
        with pytest.raises(TypeError):
            d.INT64 == "garbage_dtype"  # noqa: B015


def test_unify():
    for d in (gbj.dtypes, gbt.dtypes):
        assert d.unify(d.INT32, d.INT64) is d.INT64
        assert d.unify(d.INT8, d.UINT16) is d.INT32
        assert d.unify(d.BOOL, d.UINT16) is d.UINT16
        assert d.unify(d.FP32, d.INT32) is d.FP64
        assert d.unify(d.FP32, d.FP32) is d.FP32
        assert d.unify(d.INT8, d.INT64, is_left_scalar=True) is d.INT64
    # the collection module takes the one owner's unify
    from graphblas_tpu_torch.core import collection

    assert collection.unify is core_dtypes.unify


def test_dtype_attrs():
    d = gbt.dtypes
    assert d.INT8.is_signed_int and d.UINT8.is_unsigned_int
    assert d.FP32.is_float and d.BOOL.is_bool and not d.FP64.is_int
    assert not any(getattr(d, n).is_complex for n in NAMES)


def test_register_udt():
    """register_anonymous and register_new as in the JAX package: one type
    a dtype, a name's checks, the default names."""
    for gb in (gbj, gbt):
        d = gb.dtypes
        udt = d.register_anonymous(np.dtype([("x", np.float64),
                                             ("y", np.float64)]))
        assert udt._is_udt
        assert d.register_anonymous(np.dtype([("x", np.float64),
                                              ("y", np.float64)])) is udt
        sub = d.register_anonymous(np.dtype("(3,)float64"))
        assert sub._is_udt
        with pytest.raises(ValueError, match="identifier"):
            d.register_new("not an identifier", np.dtype("(2,)int8"))
        with pytest.raises(ValueError, match="unavailable"):
            d.register_new("INT64", np.dtype("(2,)int8"))
        with pytest.raises(ValueError, match="struct or subarray"):
            d.register_anonymous(np.float16)
    for nt in (np.dtype([("x", np.float64), ("y", np.int32)]),
               np.dtype("(3,)float64"), np.dtype("(2,2)int8")):
        assert gbt.dtypes.register_anonymous(nt).name == \
            gbj.dtypes.register_anonymous(nt).name
    named = gbt.dtypes.register_new("PortDtypeTestT",
                                    np.dtype([("a", np.int16)]))
    assert gbt.dtypes.PortDtypeTestT is named
    assert pickle.loads(pickle.dumps(named)) is named


def test_dtype_to_string_roundtrip():
    """The port's types pickle by name (the JAX package round-trips
    through its own _dtype_to_string)."""
    from graphblas_tpu.core.dtypes import _dtype_to_string, _string_to_dtype

    for name in ("BOOL", "INT32", "FP64"):
        dj = getattr(gbj.dtypes, name)
        assert _string_to_dtype(_dtype_to_string(dj)) is dj
        dt = getattr(gbt.dtypes, name)
        assert gbt.dtypes.lookup_dtype(dt.__reduce__()) is dt


def test_unify_dtypes_exact():
    for d in (gbj.dtypes, gbt.dtypes):
        assert d.unify(d.BOOL, d.BOOL) == d.BOOL
        assert d.unify(d.BOOL, d.INT16) == d.INT16
        assert d.unify(d.INT16, d.BOOL) == d.INT16
        assert d.unify(d.INT16, d.INT8) == d.INT16
        assert d.unify(d.UINT32, d.UINT8) == d.UINT32
        assert d.unify(d.UINT32, d.FP32) == d.FP64
        assert d.unify(d.INT32, d.FP32) == d.FP64
        assert d.unify(d.FP64, d.UINT8) == d.FP64
        assert d.unify(d.FP64, d.FP32) == d.FP64
        assert d.unify(d.INT16, d.UINT16) == d.INT32
        assert d.unify(d.UINT64, d.INT8) == d.FP64


@pytest.mark.parametrize("scalar", ["none", "left", "right"])
def test_unify_matches_numpy(scalar):
    kw = {"none": {}, "left": {"is_left_scalar": True},
          "right": {"is_right_scalar": True}}[scalar]
    for a, b in itertools.product(NAMES13, NAMES13):
        want = gbj.dtypes.unify(getattr(gbj.dtypes, a),
                                getattr(gbj.dtypes, b), **kw)
        got = gbt.dtypes.unify(getattr(gbt.dtypes, a),
                               getattr(gbt.dtypes, b), **kw)
        assert got.name == want.name, (a, b, scalar)


def test_auto_register_subarray():
    np_type = np.dtype("(17,)int16")
    assert gbj.dtypes.lookup_dtype(np_type).np_type == np_type
    assert gbt.dtypes.lookup_dtype(np_type).np_type == np_type
    assert gbt.dtypes.lookup_dtype(np_type)._is_udt


def test_record_dtype_from_dict():
    want = gbj.dtypes.lookup_dtype({"x": int, "y": float}).np_type
    assert want.names == ("x", "y")
    assert gbt.dtypes.lookup_dtype({"x": int, "y": float}).np_type == want
    for key in ("FC64", "GxB_FC64", "complex128", "c16", np.complex128,
                complex, "complex", torch.complex128):
        assert gbt.dtypes.lookup_dtype(key) is gbt.dtypes.FC64
    for key in ("FC32", "GxB_FC32", np.complex64, "c8", torch.complex64):
        assert gbt.dtypes.lookup_dtype(key) is gbt.dtypes.FC32


def test_dtype_bad_comparison():
    for d in (gbj.dtypes, gbt.dtypes):
        with pytest.raises(TypeError):
            d.BOOL == object()  # noqa: B015


def test_pickle_all_builtins():
    for name in NAMES13:
        val = getattr(gbt.dtypes, name)
        assert pickle.loads(pickle.dumps(val)) is val


def test_lookup_by_many_keys():
    for name in NAMES13:
        dj, dt = getattr(gbj.dtypes, name), getattr(gbt.dtypes, name)
        for key in (name, name.lower(), dj.gb_name, dj.np_type,
                    dj.np_type.name, dj.np_type.str, dj.np_type.type):
            assert gbj.dtypes.lookup_dtype(key) is dj
            assert gbt.dtypes.lookup_dtype(key) is dt
    assert sorted(gbt.dtypes.lookup_dtype(n) for n in NAMES13) == \
        [gbt.dtypes.lookup_dtype(d.name)
         for d in sorted(gbj.dtypes.lookup_dtype(n) for n in NAMES13)]


STORE = [(-(2**63), "UINT64"), (2**64 - 1, "UINT64"), (2**63, "UINT64"),
         (65535, "UINT16"), (-1, "UINT16"), (2**32 - 1, "UINT32"),
         (-128, "INT8"), (300, "INT8"), (255, "UINT8"), (-32768, "INT16")]


@pytest.mark.parametrize("value,name", STORE,
                         ids=[f"{n}-{v}" for v, n in STORE])
def test_storage_round_trip(value, name):
    """A value of each type survives storage and comes back as numpy
    casts it (wrapping), through from_coo/to_coo and Scalar."""
    dt = getattr(gbt.dtypes, name)
    want = np.array([value]).astype(object).astype(np.int64 if value < 2**63
                                                   else np.uint64) \
        .astype(dt.np_type)
    with gbt.config.set(device="cpu"):
        v = gbt.Vector.from_coo([0], want, dtype=name, size=1)
        assert v.to_coo()[1].dtype == dt.np_type
        assert v.to_coo()[1][0] == want[0]
        assert gbt.Scalar.from_value(want[0], dtype=name).value == want[0]
    t = core_dtypes.to_tensor(want, dt, "cpu")
    assert t.dtype == dt.torch_type
    assert core_dtypes.to_numpy(t, dt)[0] == want[0]


CASTS = [("FP32", "INT8", [300.7, -5.5, np.nan, np.inf, -np.inf, 1e30, 3e9]),
         ("FP64", "UINT8", [300.7, -5.5, np.nan, np.inf, -np.inf, 1e30]),
         ("FP64", "INT64", [1e19, -1e19, np.nan, 12.9, -12.9]),
         ("FP64", "UINT64", [1e19, 2e19, -3.0, np.nan, 9.3e18]),
         ("FP32", "UINT32", [3e9, 5e9, -1.0, 42.5]),
         ("UINT64", "FP64", [2**63, 2**64 - 1, 12345, 2**53 + 1]),
         ("UINT64", "FP32", [2**63, 2**64 - 1, 7]),
         ("INT32", "UINT16", [-1, 70000, 65535]),
         ("UINT64", "INT8", [2**64 - 1, 255, 2**63 + 129])]


@pytest.mark.parametrize("src,dst,vals", CASTS,
                         ids=[f"{s}-{d}" for s, d, _ in CASTS])
def test_casts_as_in_jax(src, dst, vals):
    """apply(identity[dst]) casts as the JAX package's XLA converts: floats
    truncate and saturate to the target's range, NaN -> 0; integers wrap;
    UINT64 reads as unsigned."""
    a = np.array(vals, dtype=np.dtype(src.lower().replace("fp", "float")))
    out = []
    for gb in (gbj, gbt):
        with gbt.config.set(device="cpu"):
            v = gb.Vector.from_coo(np.arange(len(a)), a, dtype=src,
                                   size=len(a))
            out.append(v.apply(gb.unary.identity[dst]).new().to_coo()[1])
    want, got = out
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_storage_types():
    d = gbt.dtypes
    assert (d.UINT16.torch_type, d.UINT32.torch_type, d.UINT64.torch_type) \
        == (torch.int32, torch.int64, torch.int64)
    assert (d.INT8.torch_type, d.INT16.torch_type, d.UINT8.torch_type) \
        == (torch.int8, torch.int16, torch.uint8)
