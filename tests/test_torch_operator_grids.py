"""The reference's operator x type grids against the port (the twin of
tests/test_operator_grids.py): every case of that module, run on the
port on the CPU with the same inputs and the same expected values the
JAX package meets there.

:func:`twin` makes such a twin of any reference module; the twins of
test_dup_op.py, test_coercions.py and test_numpyops.py use it too."""

import functools
import os
import re
import sys
import types

import pytest

import graphblas_tpu_torch as gbt


def _on_port(fn):
    @functools.wraps(fn)
    def test(*args, **kwargs):
        with gbt.config.set(device="cpu"):
            fn(*args, **kwargs)

    return test


def _port_module(ref_name):
    """tests/<ref_name>.py run with its graphblas_tpu imports taken from
    graphblas_tpu_torch (and ``from .helpers import`` from the same twin
    of tests/helpers.py)."""
    modname = f"tests.port_twin_of_{ref_name}"
    if modname in sys.modules:
        return sys.modules[modname]
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{ref_name}.py")
    with open(path) as f:
        src = re.sub(r"\bgraphblas_tpu\b", "graphblas_tpu_torch", f.read())
    src = src.replace("from .helpers import",
                      "from tests.port_twin_of_helpers import")
    if "port_twin_of_helpers" in src:
        _port_module("helpers")
    mod = types.ModuleType(modname)
    mod.__file__ = path
    sys.modules[modname] = mod
    with gbt.config.set(device="cpu"):
        exec(compile(src, path, "exec"), mod.__dict__)  # noqa: S102
    return mod


def twin(ref_name, namespace, only=None):
    """Define in `namespace` (a test module's globals) every test of
    tests/<ref_name>.py (or those named in `only`), run against the port
    on the CPU: the module's source with its graphblas_tpu imports taken
    from graphblas_tpu_torch."""
    mod = _port_module(ref_name)
    names = [n for n, fn in vars(mod).items()
             if n.startswith("test_") and callable(fn)]
    if only is not None:
        assert set(only) <= set(names), set(only) - set(names)
        names = [n for n in names if n in only]
    for name in names:
        namespace[name] = _on_port(getattr(mod, name))
    fixtures = {n: fn for n, fn in vars(mod).items()
                if type(fn).__name__ == "FixtureFunctionDefinition"
                or hasattr(fn, "_pytestfixturefunction")}
    if fixtures:
        # the module's fixtures, made on the CPU too
        namespace.update(fixtures)
        namespace["_port_fixtures_on_cpu"] = pytest.fixture(
            autouse=True, name="_port_fixtures_on_cpu")(_cpu_config)
    return names


def _cpu_config():
    with gbt.config.set(device="cpu"):
        yield


twin("test_operator_grids", globals())
