"""The committed pickles of the JAX package load into the port.

tests/data/pickles_v1.pkl holds Matrices, a Vector, Scalars, operators,
an aggregator and dtypes pickled by the JAX package.  An Unpickler whose
``find_class`` reads every ``graphblas_tpu`` module as the port's loads
it: each entry equals what the JAX package loads, the user-defined type
among ``dtypes`` and the ``udt_vector`` of that type included.  A
port-to-port round trip keeps names and backings."""

import pathlib
import pickle

import numpy as np
import pytest

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt

DATA = pathlib.Path(__file__).parent / "data" / "pickles_v1.pkl"


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "graphblas_tpu" or module.startswith("graphblas_tpu."):
            module = "graphblas_tpu_torch" + module[len("graphblas_tpu"):]
        return super().find_class(module, name)


@pytest.fixture(scope="module")
def loaded():
    with gbt.config.set(device="cpu"):
        port = _PortUnpickler(open(DATA, "rb")).load()
    return port, pickle.loads(DATA.read_bytes())


def _same(a, b):
    assert a.name == b.name
    assert a.dtype.name == b.dtype.name
    assert a.shape == b.shape
    for x, y in zip(a.to_coo(), b.to_coo()):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("key", ["matrix", "sparse_matrix", "vector"])
def test_collections_load(loaded, key):
    port, ref = loaded
    assert isinstance(port[key], (gbt.Matrix, gbt.Vector))
    _same(port[key], ref[key])


def test_scalars_load(loaded):
    port, ref = loaded
    for key in ("scalar", "empty_scalar"):
        assert isinstance(port[key], gbt.Scalar)
        assert port[key].name == ref[key].name
        assert port[key].dtype.name == ref[key].dtype.name
        assert port[key].is_empty == ref[key].is_empty
        assert port[key].value == ref[key].value
    assert port["scalar"].value == 2**40


def test_ops_load_as_the_ports_singletons(loaded):
    port, ref = loaded
    assert set(port["ops"]) == set(ref["ops"])
    for key, op in port["ops"].items():
        want = ref["ops"][key]
        assert repr(op) == repr(want)
    assert port["ops"]["binary.plus"] is gbt.binary.plus
    assert port["ops"]["monoid.lor"] is gbt.monoid.lor
    assert port["ops"]["agg.mean"] is gbt.agg.mean
    assert port["ops"]["semiring.min_plus"] is gbt.semiring.min_plus
    assert port["ops"]["unary.ainv_typed"] is gbt.unary.ainv["INT32"]


def test_dtypes_load(loaded):
    port, _ = loaded
    i64, f32, udt = port["dtypes"]
    assert i64 is gbt.dtypes.INT64
    assert f32 is gbt.dtypes.FP32
    want = ref_udt = loaded[1]["dtypes"][2]
    assert udt._is_udt and udt.np_type == want.np_type
    assert udt.name == ref_udt.name


def test_udt_vector_equals_jax(loaded):
    port, ref = loaded
    got, want = port["udt_vector"], ref["udt_vector"]
    assert want.dtype._is_udt and got.dtype._is_udt
    assert got.dtype.np_type == want.dtype.np_type
    _same(got, want)
    (gi, gv), (wi, wv) = got.to_coo(), want.to_coo()
    assert np.array_equal(gi, wi) and np.array_equal(gv, wv)
    assert gv.dtype == wv.dtype
    assert repr(got) == repr(want)
    with gbt.config.set(device="cpu"):
        back = pickle.loads(pickle.dumps(got))
    assert back.dtype is got.dtype and back.isequal(got)


def test_meta_loads(loaded):
    port, ref = loaded
    assert port["meta"] == ref["meta"]


def test_port_round_trip(loaded):
    port, _ = loaded
    with gbt.config.set(device="cpu"):
        keep = {k: port[k] for k in ("matrix", "sparse_matrix", "vector",
                                     "scalar", "empty_scalar", "ops")}
        again = pickle.loads(pickle.dumps(keep))
    for key in ("matrix", "sparse_matrix", "vector"):
        _same(again[key], keep[key])
        assert (again[key]._sparse is None) == (keep[key]._sparse is None)
    assert again["scalar"].value == 2**40
    assert again["empty_scalar"].is_empty
    assert all(again["ops"][k] is keep["ops"][k] for k in keep["ops"])


def test_jax_loads_the_ports_pickles(loaded):
    """The port's pickles name the port's classes; read with the modules
    mapped back, the JAX package loads them."""
    port, ref = loaded

    class _RefUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.startswith("graphblas_tpu_torch"):
                module = "graphblas_tpu" + module[len("graphblas_tpu_torch"):]
            return super().find_class(module, name)

    import io

    with gbt.config.set(device="cpu"):
        data = pickle.dumps([port["matrix"], port["vector"], port["scalar"],
                             port["ops"]["agg.mean"]])
    got = _RefUnpickler(io.BytesIO(data)).load()
    _same(got[0], ref["matrix"])
    _same(got[1], ref["vector"])
    assert got[2].value == ref["scalar"].value
    assert got[3] is gbj.agg.mean
