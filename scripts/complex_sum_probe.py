#!/usr/bin/env python3
"""Probe: three ways to sum complex values per segment on the GPU, timed
in one call on the zipf graph of chip_smoke.py (n = 2**19, degree 8),
over its destination-sorted entries (the segments of a vxm: one hub of
about half a million entries) and its row-sorted ones (a reduce_rowwise,
short segments).

    python3 scripts/complex_sum_probe.py

1. torch.segment_reduce over the (slots, 2) float64 view of the values;
2. two 1-d float64 torch.segment_reduce calls, real and imaginary parts;
3. sparse._complex_sums: (1), in two levels where one segment is long.

Each is checked against (3) within 1e-12 of the largest sum and timed with
CUDA events (chip_smoke.cuda_ms: median of 20 behind a spin kernel).
It prints the card's name and power limit and one JSON line."""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from graphblas_tpu_torch.core.engine import sparse as spx  # noqa: E402


def two_dim(seg, x, bounds, start, end, n):
    parts = torch.view_as_real(x)
    return torch.view_as_complex(torch.segment_reduce(
        parts, "sum", offsets=bounds, unsafe=True, initial=0.0).contiguous())


def two_one_dim(seg, x, bounds, start, end, n):
    parts = torch.view_as_real(x)
    re, im = (torch.segment_reduce(parts[:, k].contiguous(), "sum",
                                   offsets=bounds, unsafe=True, initial=0.0)
              for k in (0, 1))
    return torch.complex(re, im)


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    print(f"gpu: {cs.gpu_line()}", flush=True)
    n = 1 << 19
    src, dst = cs.build_graph(n, 8)
    rng = np.random.default_rng(cs.SEED + 17)
    theta = rng.uniform(0, 2 * np.pi, len(src))
    vals = np.exp(1j * theta)
    dev = torch.device("cuda")
    out = {"gpu": cs.gpu_line(), "slots": int(len(src))}
    for tag, key in (("vxm (by destination)", dst), ("rows", src)):
        order = np.argsort(key, kind="stable")
        seg = torch.from_numpy(key[order]).to(dev)
        x = torch.from_numpy(vals[order]).to(dev)
        bounds = torch.searchsorted(seg, torch.arange(n + 1, device=dev))
        args = (seg, x, bounds, bounds[:-1], bounds[1:], n)
        want = spx._complex_sums(*args)
        scale = float(want.abs().max())
        row = {"longest": int((bounds[1:] - bounds[:-1]).max())}
        for name, fn in (("2d", two_dim), ("two_1d", two_one_dim),
                         ("two_level", spx._complex_sums)):
            got = fn(*args)
            err = float((got - want).abs().max())
            if err > 1e-12 * scale:
                cs.fail(f"{tag} {name}: max abs err {err}")
            row[name] = cs.cuda_ms(torch, lambda: fn(*args))
        out[tag] = row
        print(f"{tag}: " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                                     else f"{k} {v}" for k, v in row.items())
              + " ms", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
