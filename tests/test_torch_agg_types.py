"""The aggregators over INT8, INT16, UINT8, UINT16 and UINT64 against the
JAX package's.

Every aggregator of ``gb.agg`` and ``gb.agg.ss``, over each of the five
types, through ``reduce_rowwise``, ``reduce_columnwise``,
``reduce_scalar`` and ``Vector.reduce``, on the same inputs (a numpy
seed) in both packages.  The port once took these aggregators only over
six types and raised ``KeyError`` for these five.  The result's type
must be the JAX package's; integer and BOOL results must be equal, FP64
results within rel 1e-12 (small integer inputs: no sum loses a digit).
Where the JAX package refuses a pair (``bitwise_all`` over a signed type,
``argmin`` through ``reduce_scalar``), the port must refuse it too.

Each (aggregator, type) computes its four reduces once in each package
(a module cache), so the grid costs one JAX compile per reduce."""

import functools

import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt

torch.set_num_threads(1)

TYPES = ("INT8", "INT16", "UINT8", "UINT16", "UINT64")
METHODS = ("reduce_rowwise", "reduce_columnwise", "reduce_scalar",
           "vector_reduce")
AGGS = sorted(n for n in gbt.agg.__all__ if n not in
              ("Aggregator", "TypedAggregator", "from_string", "ss"))
SS_AGGS = sorted(vars(gbt.agg.ss))


def _data(dtype):
    rng = np.random.default_rng(15)
    ok = rng.random((5, 7)) < 0.6
    ok[1, :] = False  # an empty row
    ok[:, 3] = False  # an empty column
    r, c = np.nonzero(ok)
    np_t = gbt.dtypes.lookup_dtype(dtype).np_type
    v = rng.integers(0, 9, len(r)).astype(np_t)
    idx = np.flatnonzero(rng.random(11) < 0.6)
    vv = rng.integers(0, 9, len(idx)).astype(np_t)
    return r, c, v, idx, vv


def _run(gb, agg, dtype):
    """{method: (dtype name, indices or None, values) or the exception's
    type} for one aggregator over one type in package gb."""
    r, c, v, idx, vv = _data(dtype)
    A = gb.Matrix.from_coo(r, c, v, dtype=dtype, nrows=5, ncols=7)
    u = gb.Vector.from_coo(idx, vv, dtype=dtype, size=11)
    calls = {
        "reduce_rowwise": lambda: A.reduce_rowwise(agg).new(),
        "reduce_columnwise": lambda: A.reduce_columnwise(agg).new(),
        "reduce_scalar": lambda: A.reduce_scalar(agg).new(),
        "vector_reduce": lambda: u.reduce(agg).new(),
    }
    out = {}
    for method, call in calls.items():
        try:
            res = call()
        except (KeyError, TypeError, ValueError) as exc:
            out[method] = type(exc).__name__
            continue
        if hasattr(res, "to_coo"):
            i, vals = res.to_coo()
            out[method] = (res.dtype.name, np.asarray(i, np.int64),
                           np.asarray(vals))
        else:
            out[method] = (res.dtype.name, None, np.asarray(
                [] if res.is_empty else [res.value]))
    return out


def _agg(gb, name):
    return getattr(gb.agg.ss, name) if name in SS_AGGS else \
        getattr(gb.agg, name)


@functools.lru_cache(maxsize=None)
def _both(name, dtype):
    ref = _run(gbj, _agg(gbj, name), dtype)
    with gbt.config.set(device="cpu"):
        port = _run(gbt, _agg(gbt, name), dtype)
    return ref, port


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("name", AGGS + SS_AGGS)
def test_aggregator_over_new_types(name, dtype, method):
    ref, port = (d[method] for d in _both(name, dtype))
    if isinstance(ref, str):
        assert port == ref, (name, dtype, method, port)
        return
    assert not isinstance(port, str), (name, dtype, method, port)
    assert port[0] == ref[0], (port[0], ref[0])
    if ref[1] is not None:
        np.testing.assert_array_equal(port[1], ref[1])
    if ref[0] == "FP64":
        np.testing.assert_allclose(port[2].astype(np.float64),
                                   ref[2].astype(np.float64), rtol=1e-12)
    else:
        np.testing.assert_array_equal(port[2], ref[2])
