"""Every name of the JAX package's operator namespaces, with their
``numpy`` and ``ss`` namespaces, against the port's, over the thirteen
builtin types: the same normal form (name, input and return type; for a
semiring its monoid and binary op too), or the same exception.

One difference is allowed and asserted as such.  Where the JAX package's lookup of a
positional semiring under a bitwise or logical monoid never returns (it
recurses until Python's limit: its positional fallback asks for the INT64
instance, which the monoid refuses in turn), the port raises KeyError."""

import pytest

import graphblas_tpu as gbj
import graphblas_tpu_torch as gbt

TYPES = ("BOOL", "INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16",
         "UINT32", "UINT64", "FP32", "FP64", "FC32", "FC64")


def normal_form(op):
    out = (op.name, op.type.name, op.return_type.name)
    if type(op).__name__.endswith("Semiring"):
        out += (normal_form(op.monoid), normal_form(op.binaryop))
    return out


def resolve(gb, path, dtype):
    obj = gb
    try:
        for part in path.split("."):
            obj = getattr(obj, part)
        return normal_form(obj[dtype])
    except RecursionError:
        return "RecursionError"
    except Exception as exc:  # noqa: BLE001 - the class is compared
        return type(exc).__name__


def _operators(ns):
    return sorted(n for n in dir(ns) if not n.startswith("_")
                  and hasattr(getattr(ns, n, None), "types"))


def _paths():
    out = []
    for name in ("binary", "unary", "monoid", "indexunary", "select"):
        ns = getattr(gbj, name)
        out += [f"{name}.{n}" for n in _operators(ns)]
        for sub in ("ss", "numpy"):
            if hasattr(ns, sub):
                out += [f"{name}.{sub}.{n}" for n in _operators(getattr(ns, sub))]
    return out


PATHS = _paths()
MONOIDS = ("min", "max", "plus", "times", "any", "lor", "land", "lxor",
           "lxnor", "eq", "band", "bor", "bxor", "bxnor")
POSITIONAL = ("firsti", "firsti1", "firstj", "firstj1", "secondi",
              "secondi1", "secondj", "secondj1")


def _check(path):
    for dtype in TYPES:
        want, got = resolve(gbj, path, dtype), resolve(gbt, path, dtype)
        if want == "RecursionError":
            assert got == "KeyError", (path, dtype)
        else:
            assert got == want, (path, dtype)


@pytest.mark.parametrize("path", PATHS)
def test_reference_operator_resolves_as_in_jax(path):
    _check(path)


def test_every_namespace_is_walked():
    spaces = {p.rsplit(".", 1)[0] for p in PATHS}
    assert spaces >= {"binary", "binary.ss", "binary.numpy", "unary",
                      "unary.ss", "unary.numpy", "monoid", "monoid.numpy",
                      "indexunary", "select"}
    assert len(PATHS) > 250


@pytest.mark.parametrize("monoid", MONOIDS)
def test_reference_semirings_resolve_as_in_jax(monoid):
    """``semiring.<monoid>_<binary op>`` for every binary op of the JAX
    package's namespace (``div`` for ``cdiv``, and ``select1st``), and the
    positional ones under ``semiring.ss``."""
    binaries = [n for n in _operators(gbj.binary)] + ["div", "select1st"]
    for mult in binaries:
        _check(f"semiring.{monoid}_{mult}")
    for mult in POSITIONAL:
        _check(f"semiring.ss.{monoid}_{mult}")


NUMPY_MONOIDS = sorted(gbj.monoid.numpy.__all__)


@pytest.mark.parametrize("monoid", NUMPY_MONOIDS)
def test_reference_numpy_semirings_resolve_as_in_jax(monoid):
    """``semiring.numpy.<monoid>_<binary op>`` over the JAX package's name
    set, which leaves out the families whose types do not meet."""
    from graphblas_tpu.semiring import numpy as jsn

    names = sorted(n for n in jsn._all_names() if n.startswith(monoid + "_")
                   and not any(n.startswith(m + "_") for m in NUMPY_MONOIDS
                               if len(m) > len(monoid) and m.startswith(monoid)))
    assert names
    for name in names:
        _check(f"semiring.numpy.{name}")
    assert set(names) <= set(dir(gbt.semiring.numpy))


def test_semiring_names_match():
    """The port's dir() of the semiring namespace lists the JAX package's
    builtin grammar, its common semirings and the subnamespaces."""
    jax_names = gbj.semiring._grammar_names() | {
        k for k in gbj.semiring._COMMON if "select" not in k} | {"ss", "numpy"}
    assert jax_names <= set(dir(gbt.semiring))
