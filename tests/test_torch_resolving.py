"""The reference's resolving cases against the port (the twin of
tests/test_resolving.py: extract and assign contexts, the updater's
arguments and their errors, per-call descriptor options), run on the
CPU; and the descriptors of core/descriptor.py and the options of
core/opts.py against the JAX package's."""

import itertools

import pytest

from graphblas_tpu.core import descriptor as jdesc
from graphblas_tpu.core import opts as jopts
from graphblas_tpu_torch.core import descriptor as tdesc
from graphblas_tpu_torch.core import opts as topts
from tests.test_torch_operator_grids import twin

twin("test_resolving", globals())


def test_descriptor_lookup():
    """The 32 flag combinations name the same descriptors, each cached;
    options make a new one."""
    for flags in itertools.product([False, True], repeat=5):
        j, t = jdesc.lookup(*flags), tdesc.lookup(*flags)
        assert t.name == j.name and repr(t) == repr(j)
        assert tdesc.lookup(*flags) is t
    t = tdesc.lookup(replace=True, nthreads=4)
    assert t.opts == {"nthreads": 4} and t is not tdesc.lookup(replace=True)
    assert tdesc.Descriptor(name="mine").name == "mine"


@pytest.mark.parametrize("opts", [
    {}, {"nthreads": 4}, {"chunk": 1e4}, {"axb_method": "dot"},
    {"axb_method": "bogus"}, {"sort": True}, {"secure_import": 1},
    {"compression": "zstd"}, {"compression": "gzip"},
    {"compression_level": 3}, {"nthreads": "many"}, {"sort": "yes"},
    {"bogus": 1}, {"nthreads": None, "axb_method": False}])
def test_validate_opts(opts):
    def outcome(mod):
        try:
            return mod.validate_opts(dict(opts)) or {}
        except ValueError:
            return "ValueError"

    assert outcome(topts) == outcome(jopts)
