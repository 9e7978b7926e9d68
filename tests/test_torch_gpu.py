"""Tests of the PyTorch port that need a CUDA device.

A CUDA kernel has no interpret mode, so on a machine without a card these
skip; ``chip_smoke.py`` runs the full comparisons there.  The file imports
torch and the port only, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from graphblas_tpu_torch.core.engine import kernels as K
from graphblas_tpu_torch.core.engine import tropical as ttr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    return torch.device("cuda")


def same(got, want):
    return bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("red,comb", [("min", "plus"), ("max", "times"),
                                      ("max", "min")])
def test_tropical_kernel_matches_plain(cuda, red, comb, dtype):
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.standard_normal((300, 260))).to(cuda, dtype)
    b = torch.from_numpy(rng.standard_normal((260, 200))).to(cuda, dtype)
    before = K.launches["tropical_matmul"]
    got = ttr.tropical_matmul(a, b, red, comb)
    assert K.launches["tropical_matmul"] == before + 1
    assert same(got, ttr.tropical_matmul_plain(a, b, red, comb))


@pytest.mark.gpu
@pytest.mark.parametrize("red,comb", ttr.MASKED_PAIRS)
def test_tropical_kernel_with_validity_planes(cuda, red, comb):
    rng = np.random.default_rng(10)
    a = rng.standard_normal((130, 70)).astype(np.float32)
    b = rng.standard_normal((70, 90)).astype(np.float32)
    a[rng.random(a.shape) < 0.05] = np.inf
    b[rng.random(b.shape) < 0.05] = -np.inf
    b[rng.random(b.shape) < 0.02] = np.nan
    a, b = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    aok = torch.from_numpy(rng.random((130, 70)) < 0.6).to(cuda)
    bok = torch.from_numpy(rng.random((70, 90)) < 0.6).to(cuda)
    got = ttr.tropical_matmul(a, b, red, comb, aok, bok)
    assert same(got, ttr.tropical_matmul_plain(a, b, red, comb, aok, bok))


@pytest.mark.gpu
def test_tropical_wrapper_refuses_strided_operands(cuda):
    a = torch.zeros((8, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ttr.tropical_matmul(a.t()[:, :4], a[:4], "min", "plus")
