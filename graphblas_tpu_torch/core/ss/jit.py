"""Engine-JIT registration (graphblas_tpu/core/ss/jit.py):
``<namespace>.ss.register_new`` takes the operator's function as a
callable over tensors or as Python source (a ``lambda`` or a ``def``) run
with ``torch``, ``np`` and ``math`` in scope, and ``jnp`` standing for
``torch``, so that a source written for the JAX package runs wherever
torch has the function of the same name.  C source, the form SuiteSparse
compiles, raises TypeError.  The types given are checked and not used:
the function is typed for every type it takes."""

import importlib

from ..dtypes import lookup_dtype


def _compile_definition(defn, name):
    if callable(defn):
        return defn
    if not isinstance(defn, str):
        raise TypeError(f"jit definition must be a callable over tensors or "
                        f"Python source; got {type(defn)}")
    import math

    import numpy as np
    import torch

    ns = {"torch": torch, "jnp": torch, "np": np, "math": math}
    src = defn.strip()
    if ("{" in src.split("\n")[0] or src.startswith("void ")
            or "*z" in src or "GB_DECLARE" in src):
        raise TypeError(
            "jit definitions of the PyTorch port are PYTHON source over "
            "tensors (a 'lambda ...' or 'def ...'), not C source.  Got what "
            f"looks like a C definition: {src[:60]!r}.")
    if src.startswith("lambda"):
        return eval(src, ns)  # noqa: S307 - the caller's operator
    before = set(ns)
    try:
        exec(src, ns)  # noqa: S102 - the caller's operator
    except SyntaxError as exc:
        raise TypeError("jit definition is not valid Python source; the "
                        "port takes Python over tensors (a 'lambda ...' or "
                        "'def ...'), not C") from exc
    funcs = {k: v for k, v in ns.items() if k not in before and callable(v)}
    if name in funcs:
        return funcs[name]
    if len(funcs) == 1:
        return next(iter(funcs.values()))
    raise ValueError(f"could not find a function named {name!r} in the jit "
                     f"definition")


def jit_register(modname, name, defn, *types):
    """Register the operator at ``<modname>.ss.<name>`` and return it."""
    from ..operator.binary import BinaryOp
    from ..operator.indexunary import IndexUnaryOp, SelectOp
    from ..operator.unary import UnaryOp

    cls = {"unary": UnaryOp, "binary": BinaryOp, "indexunary": IndexUnaryOp,
           "select": SelectOp}[modname]
    short = name[3:] if name.startswith("ss.") else name
    for t in types:
        if t is not None:
            lookup_dtype(t)
    op = cls.register_anonymous(_compile_definition(defn, short),
                                name=f"ss.{short}")
    module = importlib.import_module(f"graphblas_tpu_torch.{modname}")
    setattr(module.ss, short, op)
    return op
