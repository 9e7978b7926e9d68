"""GAP's "urand" generator (Erdos-Renyi): ``degree * n`` pairs whose two
ends are drawn uniformly from the n vertices."""

import torch


def pairs(config, n, g, device):
    m = int(config["degree"]) * n
    ij = torch.randint(0, n, (2, m), generator=g, device=device)
    return ij[0], ij[1]
