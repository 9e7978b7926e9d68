"""The reference's ``ss`` extension tests against the port (the twin of
tests/test_ss.py), run on the CPU: formats, import and export, pack and
unpack, split and concat, flatten and reshape, selectk, compactify, sort,
serialize, scan, the iterators, iso, the live sparsity control, the
global config, ``gb.ss.diag`` and ``Context``.

``test_global_config_about`` checks that ``gb.ss.about`` names JAX's
version; the port's names torch's and CUDA's, so its counterpart here,
``test_global_config_about_port``, checks those instead."""

import pytest

import graphblas_tpu_torch as gbt
from tests.test_torch_operator_grids import _port_module, twin

_NAMES = [n for n in vars(_port_module("test_ss"))
          if n.startswith("test_") and n != "test_global_config_about"]
twin("test_ss", globals(), only=_NAMES)


def test_global_config_about_port():
    assert "format" in gbt.ss.config
    assert gbt.ss.config["burble"] is False
    assert gbt.ss.burble() is False
    with pytest.raises(KeyError):
        gbt.ss.config["bogus"] = 1
    about = gbt.ss.about
    assert about["library_name"] == "graphblas_tpu_torch"
    assert "torch_version" in about and "cuda_version" in about
    assert "jax_version" not in about
