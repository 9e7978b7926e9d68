"""``graphblas_tpu_torch.algorithms`` against ``graphblas_tpu.algorithms``.

``sssp`` (Bellman-Ford over min_plus, whose one-entry distance vector runs
the sparse-vector branch of the SpMV) and ``bfs_level`` run on both
packages from the same numpy graph.  Each graph runs twice on the port:
through the lanepipe (the JAX side under ``lane_on``, with destinations
split at 64 edges on both, as tests/test_torch_frontend.py does) and
through the sort pipeline, with PACK_LIMIT set so that the lanepipe turns
every matrix down.  Structure, BOOL and integer
results must match exactly; FP32 distances to rel 1e-5.
"""

import numpy as np
import pytest
import torch

import bench
import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt
from graphblas_tpu import algorithms as jalg
from graphblas_tpu.core.engine import lanepipe as jlp
from graphblas_tpu_torch import algorithms as talg
from graphblas_tpu_torch.core.engine import lanepipe as tlp

from .test_lanepipe import lane_on, random_graph  # noqa: F401
from .test_torch_lanepipe import assert_values_match, both_matrices

torch.set_num_threads(1)

N = 600


@pytest.fixture
def cpu():
    """The CPU, and every Matrix sparse-backed: these tests hold the SpMV
    engines, which a matrix under ``auto_sparse_limit`` would bypass."""
    with gbt.config.set(device="cpu", auto_sparse_limit=0):
        yield


@pytest.fixture(params=["lanepipe", "sortpipe"])
def engine(request, monkeypatch):
    """lanepipe: split destinations at 64 edges so the small zipf graph
    packs.  sortpipe: no plan fits under PACK_LIMIT, as for a hypersparse
    matrix, so every vxm falls to the sort pipeline."""
    if request.param == "lanepipe":
        monkeypatch.setattr(jlp, "SPLIT_DEG", 64)
        monkeypatch.setattr(tlp, "SPLIT_DEG", 64)
    else:
        monkeypatch.setattr(jlp, "PACK_LIMIT", -1e9)
        monkeypatch.setattr(tlp, "PACK_LIMIT", -1e9)
    return request.param


def check_engine(tA, engine):
    plans = tA._sparse._lanepipe_plans
    assert plans, "no vxm ran"
    took_lanepipe = all(p is not None for p in plans.values())
    assert took_lanepipe == (engine == "lanepipe")
    assert bool(tA._sparse._sortpipe_plans) == (engine == "sortpipe")


def test_sssp_zipf(engine, lane_on, cpu, rng):
    src, dst = bench.build_graph(N, 8)
    w = (rng.random(len(src)) + 0.1).astype(np.float32)
    jA, tA = both_matrices(src, dst, w, "FP32", N)
    want = jalg.sssp(jA, 0)
    got = talg.sssp(tA, 0)
    check_engine(tA, engine)
    assert got.dtype.name == want.dtype.name == "FP32"
    assert got.nvals == N  # the ring edges reach every node
    assert_values_match(got.to_coo(), want.to_coo(), "FP32")


@pytest.mark.parametrize("dtype", ["FP32", "INT32"])
def test_sssp_unreachable_and_max_iters(dtype, cpu, rng):
    """A sparse random graph leaves nodes unreached; max_iters cuts the
    relaxation short on both packages alike."""
    n = 300
    r, c, v = random_graph(rng, n, 450, dtype)
    source = int(np.bincount(r).argmax())
    jA, tA = both_matrices(r, c, v, dtype, n)
    for kw in ({}, {"max_iters": 2}):
        want = jalg.sssp(jA, source, **kw)
        got = talg.sssp(tA, source, **kw)
        assert 1 < got.nvals < n
        assert_values_match(got.to_coo(), want.to_coo(), dtype)
    assert got[source].new().value == 0


def test_bfs_level_zipf(engine, lane_on, cpu):
    src, dst = bench.build_graph(N, 8)
    jA, tA = both_matrices(src, dst, np.ones(len(src), bool), "BOOL", N)
    want = jalg.bfs_level(jA, 0)
    got = talg.bfs_level(tA, 0)
    check_engine(tA, engine)
    assert got.dtype.name == want.dtype.name == "INT64"
    assert got.nvals == N and got[0].new().value == 1
    assert_values_match(got.to_coo(), want.to_coo(), "INT64")


def test_bfs_level_unreachable(cpu, rng):
    n = 200
    r, c, _ = random_graph(rng, n, 260, "BOOL")
    jA, tA = both_matrices(r, c, np.ones(len(r), bool), "BOOL", n)
    source = int(np.bincount(r).argmax())
    want = jalg.bfs_level(jA, source)
    got = talg.bfs_level(tA, source)
    assert 1 < got.nvals < n
    assert_values_match(got.to_coo(), want.to_coo(), "INT64")


def test_what_waits_is_not_stubbed():
    assert talg.__all__ == ["bfs_level", "bfs_parent", "sssp"]
    for name in ("pagerank", "connected_components", "triangle_count"):
        assert not hasattr(talg, name)
    with pytest.raises(NotImplementedError, match="queue 1, item 9"):
        talg.bfs_parent(None)
