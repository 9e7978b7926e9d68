"""Visualization (graphblas_tpu/viz.py): ``draw`` (networkx and
matplotlib), ``spy`` (matplotlib) and ``datashade`` (datashader and
hvplot); each imports its packages when called and names the missing one
as the JAX package does."""

import numpy as np

__all__ = ["draw", "spy", "datashade"]


def _require(modname, fn):
    try:
        __import__(modname)
    except ImportError as e:
        raise ImportError(f"`{fn}` requires {modname} to be installed") from e


def draw(m):
    """Draw the graph of adjacency matrix m with networkx."""
    _require("networkx", "draw")
    _require("matplotlib", "draw")
    import networkx as nx

    from .io import to_networkx

    g = to_networkx(m)
    pos = nx.spring_layout(g)
    edge_labels = {(i, j): d["weight"] for i, j, d in g.edges(data=True)}
    nx.draw_networkx(g, pos, node_color="red", node_size=500)
    nx.draw_networkx_edge_labels(g, pos, edge_labels=edge_labels)


def spy(m, *, show=True, figure=None, axes=None, figsize=None, **kwargs):
    """Plot the sparsity pattern with matplotlib."""
    _require("matplotlib", "spy")
    import matplotlib.pyplot as plt

    import scipy.sparse as ss

    rows, cols, _ = m.to_coo(values=False)
    pattern = ss.coo_array((np.ones(len(rows), bool),
                            (rows.astype(np.int64), cols.astype(np.int64))),
                           shape=m.shape)
    if axes is None:
        figure = plt.figure(figsize=figsize) if figure is None else figure
        axes = figure.gca()
    axes.spy(pattern, **kwargs)
    if show:
        plt.show()
    return axes


def datashade(m, agg="count", *, width=None, height=None, **kwargs):
    """Interactive spy plot via datashader/hvplot."""
    _require("datashader", "datashade")
    _require("hvplot", "datashade")
    import pandas as pd
    import hvplot.pandas  # noqa: F401

    rows, cols, vals = m.to_coo()
    df = pd.DataFrame({"row": rows.astype(np.int64),
                       "col": cols.astype(np.int64), "val": vals})
    return df.hvplot.scatter("col", "row", rasterize=True, aggregator=agg,
                             width=width, height=height, **kwargs)
