"""Plain references in PyTorch, written from the definitions of the
algorithms.  They import nothing of the program and read only the
coordinates the benchmark generated (``gen.Graph``), on any torch device,
in blocks so that they fit beside whatever the process still holds."""

import torch


def csr(rows, cols, n):
    """Row offsets of entries sorted by row: (indptr, cols)."""
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return indptr, cols


def expand(starts, counts):
    """Positions ``starts[k] .. starts[k] + counts[k] - 1`` for every k, in
    order, and the k each came from."""
    owner = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)
    first = torch.cumsum(counts, 0) - counts
    pos = torch.arange(owner.numel(), device=counts.device) - first[owner] \
        + starts[owner]
    return pos, owner
