"""The generators against their spec's properties, and the references
against brute force, at small scales on the CPU."""

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.csgraph as csgraph
import torch

from gbbench import gen, spec
from gbbench.drivers import bfs
from gbbench.reference import bfs as ref_bfs
from gbbench.reference import tc as ref_tc


def graph(name, scale, seed=7):
    """The generator itself, a graph for each seed, at a small scale."""
    cfg = dict(spec.config(name), scale=scale)
    cfg.pop("graph_seed", None)
    return gen.build(cfg, seed, "cpu")


@pytest.mark.parametrize("name", ["urand19", "kron18"])
@pytest.mark.parametrize("scale", [10, 12])
def test_undirected_simple_sorted(name, scale):
    g = graph(name, scale)
    r, c = g.rows.numpy(), g.cols.numpy()
    assert g.n == 1 << scale and g.pairs == 16 * g.n
    assert not np.any(r == c)
    key = r * g.n + c
    assert np.all(np.diff(key) > 0)          # sorted, no duplicate
    assert np.array_equal(np.sort(c * g.n + r), key)   # both directions
    vals = g.values.numpy()
    W = sps.csr_matrix((vals.astype(np.int64), (r, c)), shape=(g.n, g.n))
    assert (W != W.T).nnz == 0               # one value per edge


@pytest.mark.parametrize("scale", [10, 12])
def test_urand_degree_and_spread(scale):
    g = graph("urand19", scale)
    deg = np.bincount(g.rows.numpy(), minlength=g.n)
    # 16 n pairs, each stored twice, few duplicates at these sizes
    assert 31.0 < deg.mean() <= 32.0
    assert deg.max() < 3 * deg.mean()
    assert g.dtype == "BOOL" and bool(g.values.all())


@pytest.mark.parametrize("scale", [10, 12])
def test_kron_skew(scale):
    g = graph("kron18", scale)
    deg = np.bincount(g.rows.numpy(), minlength=g.n)
    # duplicates and self-loops fall away; the initiator makes hubs and
    # leaves many vertices without an edge
    assert 16.0 < deg.mean() < 32.0
    assert deg.max() > 15 * deg.mean()
    assert (deg == 0).mean() > 0.1
    v = g.values.numpy()
    assert g.dtype == "INT32" and v.dtype == np.int32
    assert v.min() >= 1 and v.max() <= 255


def test_kron_initiator_bits():
    """Before the permutation, a pair's top bits follow A, B, C, D."""
    cfg = dict(spec.config("kron18"), scale=12)
    g = gen.generator(3, "cpu")
    from gbbench.gen import kron

    n = 1 << 12
    saved = torch.randperm
    try:
        torch.randperm = lambda n, generator, device: torch.arange(n)
        i, j = kron.pairs(cfg, n, g, "cpu")
    finally:
        torch.randperm = saved
    top_i, top_j = (i >> 11).numpy(), (j >> 11).numpy()
    share = [np.mean((top_i == a) & (top_j == b))
             for a, b in ((0, 0), (0, 1), (1, 0), (1, 1))]
    assert np.allclose(share, [0.57, 0.19, 0.19, 0.05], atol=0.01)


def test_same_seed_same_graph():
    a, b, c = graph("kron18", 10, 5), graph("kron18", 10, 5), \
        graph("kron18", 10, 6)
    assert torch.equal(a.rows, b.rows) and torch.equal(a.values, b.values)
    assert not (a.nnz == c.nnz and torch.equal(a.rows, c.rows))


def test_fixed_graph_seed():
    """urand19 draws one graph for every run; the run's seed draws the
    sources."""
    cfg = dict(spec.config("urand19"), scale=10)
    a, b = gen.build(cfg, 5, "cpu"), gen.build(cfg, 2**31 + 6, "cpu")
    assert torch.equal(a.rows, b.rows) and torch.equal(a.cols, b.cols)
    trf = spec.traffic("bfs")
    assert bfs.prepare(a, trf, 5)["sources"] != \
        bfs.prepare(b, trf, 2**31 + 6)["sources"]


def test_large_seed():
    g = graph("urand19", 8, seed=2**31 + 12345)
    assert g.nnz > 0


def dense(g):
    D = np.zeros((g.n, g.n), np.int64)
    D[g.rows.numpy(), g.cols.numpy()] = 1
    return D


@pytest.mark.parametrize("name", ["urand19", "kron18"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_tc_reference_brute_force(name, seed):
    g = graph(name, 7, seed)
    D = dense(g)
    assert ref_tc.count(g.rows, g.cols, g.n) == int(np.trace(D @ D @ D)) // 6


def test_tc_reference_in_blocks(monkeypatch):
    g = graph("kron18", 9, 4)
    whole = ref_tc.count(g.rows, g.cols, g.n)
    monkeypatch.setattr(ref_tc, "BLOCK", 97)
    assert ref_tc.count(g.rows, g.cols, g.n) == whole


@pytest.mark.parametrize("name", ["urand19", "kron18"])
@pytest.mark.parametrize("source", [0, 5, 100])
def test_bfs_reference_brute_force(name, source):
    g = graph(name, 8)
    dist = csgraph.shortest_path(sps.csr_matrix(dense(g)), unweighted=True,
                                 indices=source)
    want = np.where(np.isinf(dist), 0, dist + 1).astype(np.int64)
    got = ref_bfs.levels(g.rows, g.cols, g.n, source).numpy()
    assert np.array_equal(got, want)
