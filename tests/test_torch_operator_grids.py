"""The reference's operator x type grids against the port (the twin of
tests/test_operator_grids.py): every case of that module, run on the
port on the CPU with the same inputs and the same expected values the
JAX package meets there.

:func:`twin` makes such a twin of any reference module; the twins of
test_dup_op.py, test_coercions.py and test_numpyops.py use it too."""

import ast
import functools
import os
import re
import sys
import types

import pytest

import graphblas_tpu_torch as gbt


def _on_port(fn, not_ported):
    @functools.wraps(fn)
    def test(*args, **kwargs):
        with gbt.config.set(device="cpu"):
            if not_ported:
                with pytest.raises(NotImplementedError, match="item 12"):
                    fn(*args, **kwargs)
            else:
                fn(*args, **kwargs)

    return test


class Deferred:
    """What a fixture statement binds when the port raises
    NotImplementedError building it: every use (repr, attribute, item,
    call) raises that error again, so the tests that use it are the
    not-ported ones and the others run."""

    def __init__(self, exc):
        object.__setattr__(self, "_exc", exc)

    def _raise(self, *args, **kwargs):
        raise object.__getattribute__(self, "_exc")

    __repr__ = __call__ = __setitem__ = __getitem__ = _raise

    def __getattr__(self, name):
        self._raise()


class _DeferFixtures(ast.NodeTransformer):
    """Wrap each statement of the named fixture functions (and of their
    ``with`` blocks) in ``try: ... except NotImplementedError``, binding
    an assignment's name to a :class:`Deferred`."""

    def __init__(self, functions):
        self.functions = set(functions)

    def _wrap(self, body):
        out = []
        for stmt in body:
            if isinstance(stmt, ast.With):
                stmt.body = self._wrap(stmt.body)
                out.append(stmt)
                continue
            if isinstance(stmt, ast.Return):
                out.append(stmt)
                continue
            handler = [ast.Pass()]
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                handler = [ast.Assign(
                    targets=[ast.Name(stmt.targets[0].id, ast.Store())],
                    value=ast.Call(ast.Name("_Deferred", ast.Load()),
                                   [ast.Name("_exc", ast.Load())], []))]
            out.append(ast.Try(body=[stmt], handlers=[ast.ExceptHandler(
                type=ast.Name("NotImplementedError", ast.Load()),
                name="_exc", body=handler)], orelse=[], finalbody=[]))
        return out

    def visit_FunctionDef(self, node):
        if node.name in self.functions:
            node.body = self._wrap(node.body)
        return node


def _port_module(ref_name, defer=()):
    """tests/<ref_name>.py run with its graphblas_tpu imports taken from
    graphblas_tpu_torch (and ``from .helpers import`` from the same twin
    of tests/helpers.py); the functions named in defer build their
    fixtures through :class:`_DeferFixtures`."""
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
    code = ast.fix_missing_locations(_DeferFixtures(defer).visit(
        ast.parse(src))) if defer else src
    mod = types.ModuleType(modname)
    mod.__file__ = path
    mod._Deferred = Deferred
    sys.modules[modname] = mod
    with gbt.config.set(device="cpu"):
        exec(compile(code, path, "exec"), mod.__dict__)  # noqa: S102
    return mod


def twin(ref_name, namespace, not_ported=(), only=None, defer=()):
    """Define in `namespace` (a test module's globals) every test of
    tests/<ref_name>.py (or those named in `only`), run against the port
    on the CPU: the module's source with its graphblas_tpu imports taken
    from graphblas_tpu_torch.  The tests named in not_ported need what the
    port lacks (complex types, user-defined types) and must raise
    NotImplementedError naming ROADMAP.md queue 1, item 12; `defer` names
    fixture functions that build such objects among others (see
    :class:`_DeferFixtures`)."""
    mod = _port_module(ref_name, defer)
    names = [n for n, fn in vars(mod).items()
             if n.startswith("test_") and callable(fn)]
    if only is not None:
        assert set(only) <= set(names), set(only) - set(names)
        names = [n for n in names if n in only]
    assert set(not_ported) <= set(names), set(not_ported) - set(names)
    for name in names:
        namespace[name] = _on_port(getattr(mod, name), name in not_ported)
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
