"""Row, column and vector reduces over the new monoids and types through
both public APIs, dense- and sparse-backed, against the JAX package on the
same seeded inputs, exactly (the UINT64 min and max read their values as
unsigned)."""

import numpy as np
import pytest
import torch

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt

from .test_torch_type_products import _both, _same

torch.set_num_threads(1)


@pytest.fixture
def cpu():
    with gbt.config.set(device="cpu"):
        yield


REDUCE_CASES = [("lxor", "BOOL"), ("eq", "BOOL"), ("lxnor", "BOOL"),
                ("bxor", "UINT16"), ("bxnor", "UINT8"), ("max", "INT8"),
                ("min", "UINT64"), ("max", "UINT64"), ("plus", "INT16"),
                ("times", "UINT8")]


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("mono,t", REDUCE_CASES,
                         ids=[f"{m}-{t}" for m, t in REDUCE_CASES])
def test_reduces_through_both_apis(cpu, mono, t, sparse):
    (jA, jx), (tA, tx) = _both(np.random.default_rng(5), t, t, sparse)
    jm, tm = getattr(gbj.monoid, mono)[t], getattr(gbt.monoid, mono)[t]
    _same(tA.reduce_rowwise(tm).new(), jA.reduce_rowwise(jm).new())
    _same(tA.reduce_columnwise(tm).new(), jA.reduce_columnwise(jm).new())
    assert tx.reduce(tm).new().value == jx.reduce(jm).new().value
