"""Graph500's Kronecker generator (the reference code's
``kronecker_generator``, as GAP's "kron" uses it): ``degree * n`` pairs,
each of whose ``scale`` bits picks a quadrant with the initiator's
probabilities A, B, C (D = 1 - A - B - C), then one random permutation of
the vertex ids.  The spec's final shuffle of the pair list is left out:
it only orders the list, which :func:`gen.symmetrize` sorts."""

import torch


def pairs(config, n, g, device):
    scale, m = int(config["scale"]), int(config["degree"]) * n
    a, b, c = (float(x) for x in config["initiator"])
    ab = a + b
    c_norm, a_norm = c / (1.0 - ab), a / ab
    i = torch.zeros(m, dtype=torch.int64, device=device)
    j = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        ibit = torch.rand(m, generator=g, device=device,
                          dtype=torch.float64) > ab
        thresh = a_norm + (c_norm - a_norm) * ibit.to(torch.float64)
        jbit = torch.rand(m, generator=g, device=device,
                          dtype=torch.float64) > thresh
        i |= ibit.to(torch.int64) << bit
        j |= jbit.to(torch.int64) << bit
    perm = torch.randperm(n, generator=g, device=device)
    return perm[i], perm[j]
