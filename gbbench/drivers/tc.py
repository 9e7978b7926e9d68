"""Triangle counting as GAP's tc runs it: each trial is one
``algorithms.triangle_count`` call on the whole graph, which returns a
Python int; every trial's count is compared with the plain count."""

from ..reference import tc as ref_tc

LIMIT = 0  # a count: an exact comparison


def prepare(graph, params, seed):
    return {}


def trial(program, A, state, i):
    return program.algorithms.triangle_count(A)


def check(graph, state, kept, device):
    want = ref_tc.count(graph.rows.to(device), graph.cols.to(device), graph.n)
    gaps = [abs(int(got) - want) for _, got in kept]
    return ({"count_gap": {"value": max(gaps, default=0), "limit": LIMIT}},
            sum(g > 0 for g in gaps))


def control(graph, state, i, device):
    """The plain count over each edge in one direction only (the entries
    with row < column), as a program that stored half of a symmetric
    matrix and forgot the other half would give: the guarantee broken is
    ``undirected``.  (The count's own precision, int64, has no step below
    that fails reliably: int32 holds counts below 2**31, and a float32
    sum of the per-edge counts may round to the exact count.)"""
    up = graph.rows < graph.cols
    return ref_tc.count(graph.rows[up].to(device), graph.cols[up].to(device),
                        graph.n)
