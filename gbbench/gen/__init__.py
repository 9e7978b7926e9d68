"""The graph generators, frozen: ``gen/<generator>.py`` makes the edge
pairs of a configuration from a seed, and :func:`build` turns them into
the undirected graph both the program and the references read.

Everything runs on the given torch device with a ``torch.Generator`` of
that device, in a few calls over whole arrays.  The same seed on the same
device type gives the same graph.
"""

import dataclasses
import importlib

import torch

# values a configuration may ask for: GraphBLAS type name -> torch dtype
VALUE_TYPES = {"BOOL": torch.bool, "INT32": torch.int32, "INT64": torch.int64,
               "FP32": torch.float32, "FP64": torch.float64}


@dataclasses.dataclass
class Graph:
    """An undirected graph as stored entries, both directions of every
    edge, sorted by (row, column), no self-loop and no duplicate."""

    n: int
    rows: torch.Tensor     # int64
    cols: torch.Tensor     # int64
    values: torch.Tensor   # one value per entry, the same in both directions
    dtype: str             # GraphBLAS type name of the values
    pairs: int             # pairs the generator drew

    @property
    def nnz(self):
        return int(self.rows.numel())


def generator(seed, device):
    """A torch.Generator of ``device`` seeded with ``seed`` (any integer;
    it is taken modulo 2**64)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def symmetrize(i, j, n):
    """Stored entries of the undirected graph of the pairs (i, j): both
    directions, self-loops and duplicates dropped, sorted by key
    ``row * n + col``.  Returns (rows, cols)."""
    keep = i != j
    i, j = i[keep], j[keep]
    key = torch.unique(torch.cat([i * n + j, j * n + i]), sorted=True)
    return key // n, key % n


def edge_values(rows, cols, n, spec, g):
    """One value per undirected edge, drawn uniformly from
    [low, high] for the upper entry (row < col) and mirrored to the lower,
    or True for a BOOL pattern."""
    dt = VALUE_TYPES[spec["dtype"]]
    if spec["dtype"] == "BOOL":
        return torch.ones(rows.numel(), dtype=dt, device=rows.device)
    upper = rows < cols
    ukey = rows[upper] * n + cols[upper]          # sorted: a subsequence
    w = torch.randint(int(spec["low"]), int(spec["high"]) + 1,
                      (ukey.numel(),), generator=g, device=rows.device)
    mirror = torch.where(upper, rows * n + cols, cols * n + rows)
    return w[torch.searchsorted(ukey, mirror)].to(dt)


def graph_seed(config, seed):
    """The seed the graph is drawn from: the configuration's
    ``graph_seed`` where it fixes one (one graph for every run, as GAP and
    Graph500 time every search on one generated graph), else the run's."""
    return int(config.get("graph_seed", seed))


def build(config, seed, device):
    """The configuration's graph for ``seed`` on ``device``."""
    mod = importlib.import_module(f"{__name__}.{config['generator']}")
    g = generator(graph_seed(config, seed), device)
    n = 1 << int(config["scale"])
    i, j = mod.pairs(config, n, g, device)
    rows, cols = symmetrize(i, j, n)
    values = edge_values(rows, cols, n, config["values"], g)
    return Graph(n, rows, cols, values, config["values"]["dtype"],
                 int(i.numel()))
