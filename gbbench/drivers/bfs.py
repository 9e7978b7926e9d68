"""Breadth-first search as GAP's bfs and Graph500's kernel 2 run it: each
trial is one ``algorithms.bfs_level`` call from a source drawn from the
seed among the vertices with at least ``min_degree`` neighbours, a new one
each trial, cycling through ``sources`` of them.  A trial returns the
level vector read back to the host (0 where a vertex was not reached)."""

import numpy as np
import torch

from . import rng
from ..reference import bfs as ref_bfs

LIMIT = 0  # levels are integers: an exact comparison


def prepare(graph, params, seed):
    deg = torch.bincount(graph.rows, minlength=graph.n).cpu().numpy()
    eligible = np.flatnonzero(deg >= int(params["min_degree"]))
    k = min(int(params["sources"]), eligible.size)
    sources = rng(seed, 1).choice(eligible, size=k, replace=False)
    return {"sources": [int(s) for s in sources]}


def source(state, i):
    return state["sources"][i % len(state["sources"])]


def trial(program, A, state, i):
    lev = program.algorithms.bfs_level(A, source(state, i))
    return lev.to_dense(fill_value=0)


def check(graph, state, kept, device):
    rows, cols = graph.rows.to(device), graph.cols.to(device)
    refs, mismatches, failed = {}, 0, 0
    for i, got in kept:
        src = source(state, i)
        if src not in refs:
            refs[src] = ref_bfs.levels(rows, cols, graph.n, src).cpu().numpy()
        bad = int(np.count_nonzero(np.asarray(got) != refs[src]))
        mismatches += bad
        failed += bad > 0
    return {"level_mismatches": {"value": mismatches, "limit": LIMIT}}, failed


def control(graph, state, i, device):
    """Levels over each edge in one direction only (the entries with
    row < column), as a program that stored half of a symmetric matrix
    and forgot the other half would give: the guarantee broken is
    ``undirected``."""
    up = graph.rows < graph.cols
    lev = ref_bfs.levels(graph.rows[up].to(device), graph.cols[up].to(device),
                         graph.n, source(state, i))
    return lev.cpu().numpy()
