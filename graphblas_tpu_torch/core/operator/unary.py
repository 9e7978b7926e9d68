"""Unary operators (graphblas_tpu/core/operator/unary.py): the builtin
table over the eleven real types, the positional ``positioni``,
``positioni1``, ``positionj`` and ``positionj1`` (the row or column of
each element, plus 0 or 1: the engine fills them from positions; on a
type other than INT32 and INT64 they are their INT64 instance), and user
functions over tensors (:meth:`UnaryOp.register_anonymous`, which the JAX
package takes over jnp arrays).

``minv`` follows SuiteSparse on the integers (C-truncated 1/x, and 1/0 is
the type's maximum), ``ainv`` wraps on the unsigned, and ``round`` rounds
half away from zero.  The complex-only ``conj``, ``creal``, ``cimag`` and
``carg`` wait for the complex types."""

import torch

from ... import exceptions
from .. import dtypes as _dt
from . import ufuncs as uf
from .base import OpBase, ParameterizedUdf, TypedOpBase, check_arity
from .binary import ALL11, FP, INTS8, infer_return


class TypedUnaryOp(TypedOpBase):
    opclass = "UnaryOp"

    def __init__(self, parent, name, type_, return_type, func):
        super().__init__(parent, name, type_, return_type)
        self.func = func
        self._positional = parent._positional

    def __call__(self, x):
        """On a storage tensor of self.type, the result in return_type; on
        a collection, an apply (call_op_unary)."""
        if not isinstance(x, torch.Tensor):
            from .utils import call_op_unary

            return call_op_unary(self, x)
        out = self.func(x)
        if not isinstance(out, torch.Tensor):
            out = torch.as_tensor(out, device=x.device).expand(x.shape)
        return _dt.normalize(out, self.return_type)


def _const(fn):
    return lambda dt: fn


def _same(fn):
    """A float function that keeps its operand's type."""
    return lambda dt: (lambda x: fn(x).to(x.dtype))


def _tgamma(x):
    # |gamma| = exp(lgamma); gamma < 0 where x < 0 and floor(x) is odd
    odd = torch.remainder(torch.floor(x), 2) == 1
    return torch.lgamma(x).exp() * torch.where((x < 0) & odd, -1.0, 1.0)


_BOOL = _dt.BOOL
_FLOAT = {name: fn for name, fn in (
    ("sqrt", torch.sqrt), ("log", torch.log), ("exp", torch.exp),
    ("log2", torch.log2), ("sin", torch.sin), ("cos", torch.cos),
    ("tan", torch.tan), ("acos", torch.acos), ("asin", torch.asin),
    ("atan", torch.atan), ("sinh", torch.sinh), ("cosh", torch.cosh),
    ("tanh", torch.tanh), ("acosh", torch.acosh), ("asinh", torch.asinh),
    ("atanh", torch.atanh), ("ceil", torch.ceil), ("floor", torch.floor),
    ("round", uf.c_round), ("trunc", torch.trunc), ("exp2", torch.exp2),
    ("expm1", torch.expm1), ("log10", torch.log10), ("log1p", torch.log1p))}

# name -> (domains, make(dt) -> torch function, return rule)
_BUILTIN = {
    "identity": (ALL11, _const(lambda x: x), None),
    "ainv": (ALL11, uf.ainv, None),
    "minv": (ALL11, uf.minv, None),
    "abs": (ALL11, uf.absolute, None),
    "bnot": (INTS8, uf.bnot, None),
    "lnot": (ALL11, uf.lnot, None),
    "one": (ALL11, _const(torch.ones_like), None),
    **{name: (FP, _same(fn), None) for name, fn in _FLOAT.items()},
    "signum": (ALL11, uf.signum, None),
    "lgamma": (FP, _same(torch.lgamma), None),
    "tgamma": (FP, _same(_tgamma), None),
    "erf": (FP, _same(torch.erf), None),
    "erfc": (FP, _same(torch.erfc), None),
    "frexpx": (FP, _const(uf.frexpx), None),
    "frexpe": (FP, _const(uf.frexpe), None),
    "cbrt": (FP, _same(lambda x: torch.sign(x) * x.abs().pow(1.0 / 3)),
             None),
    "isinf": (FP, _const(torch.isinf), _BOOL),
    "isnan": (FP, _const(torch.isnan), _BOOL),
    "isfinite": (FP, _const(torch.isfinite), _BOOL),
}

# name -> (which index of the element, offset)
POSITIONAL = {"positioni": ("i", 0), "positioni1": ("i", 1),
              "positionj": ("j", 0), "positionj1": ("j", 1)}


class UnaryOp(OpBase):
    opclass = "UnaryOp"
    _modname = "unary"

    def __init__(self, name, *, anonymous=False, positional=None):
        super().__init__(name, anonymous=anonymous)
        self._positional = positional
        self._udf = None

    @classmethod
    def _builtin(cls, name, domains, make, ret_rule):
        op = cls(name)
        for dt in domains:
            ret = dt if ret_rule is None else (
                ret_rule(dt) if callable(ret_rule) else ret_rule)
            op._typed_ops[dt] = TypedUnaryOp(op, name, dt, ret, make(dt))
        return op

    def _build_typed(self, dt):
        if self._positional is not None:
            return self[_dt.INT64]
        if self._udf is None:
            return None
        try:
            ret = infer_return(self._udf, dt, 1)
        except Exception:  # noqa: BLE001 - the function refuses the type
            return None
        return TypedUnaryOp(self, self.name, dt, ret, self._udf)

    @classmethod
    def register_anonymous(cls, func, name=None, *, parameterized=False,
                           is_udt=False):
        """A UnaryOp from a Python function over tensors, typed for each of
        the eleven types it accepts."""
        if is_udt:
            raise NotImplementedError(
                "user-defined types are not in the PyTorch port yet "
                "(ROADMAP.md queue 1, item 12)")
        if parameterized:
            return ParameterizedUnaryOp(name, func, anonymous=True)
        check_arity(func, 1, "UnaryOp")
        op = cls(name if name is not None
                 else getattr(func, "__name__", "unary_op"), anonymous=True)
        op._udf = func
        op._refusal = exceptions.UdfParseError
        for dt in ALL11:
            typed = op._build_typed(dt)
            if typed is not None:
                op._typed_ops[dt] = typed
        return op

    @classmethod
    def register_new(cls, name, func, *, parameterized=False, is_udt=False,
                     lazy=False):
        from .utils import register_into_namespace

        op = cls.register_anonymous(func, name, parameterized=parameterized,
                                    is_udt=is_udt)
        op._anonymous = False
        register_into_namespace("unary", name, op)
        return op


class ParameterizedUnaryOp(ParameterizedUdf):
    def __init__(self, name, func, *, anonymous=False):
        super().__init__(name if name is not None
                         else getattr(func, "__name__", "unary_op"),
                         anonymous)
        self.func = func

    def __call__(self, *args, **kwargs):
        return UnaryOp.register_anonymous(self.func(*args, **kwargs),
                                          self.name)


BUILTINS = {name: UnaryOp._builtin(name, *spec)
            for name, spec in _BUILTIN.items()}
for _name, _pos in POSITIONAL.items():
    _op = UnaryOp(_name, positional=_pos)
    for _d in (_dt.INT32, _dt.INT64):
        _op._typed_ops[_d] = TypedUnaryOp(_op, _name, _d, _d, None)
    BUILTINS[_name] = _op
del _name, _pos, _op, _d
