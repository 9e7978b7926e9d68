"""Unary operators (graphblas_tpu/core/operator/unary.py): the builtin
table over the thirteen builtin types, the positional ``positioni``,
``positioni1``, ``positionj`` and ``positionj1`` (the row or column of
each element, plus 0 or 1: the engine fills them from positions; on a
type other than INT32 and INT64 they are their INT64 instance), and user
functions over tensors (:meth:`UnaryOp.register_anonymous`, which the JAX
package takes over jnp arrays; with ``is_udt=True``, over the fields of a
user-defined type).

``minv`` follows SuiteSparse on the integers (C-truncated 1/x, and 1/0 is
the type's maximum), ``ainv`` wraps on the unsigned, and ``round`` rounds
half away from zero.  The complex types take the float functions, and
the complex-only ``conj``, ``creal``, ``cimag`` and ``carg``; ``abs``,
``creal``, ``cimag`` and ``carg`` of FC32 and FC64 are FP32 and FP64;
``ceil``, ``floor`` and ``trunc`` of a complex value are those of its
real part, and ``round`` rounds its magnitude, as in the JAX package."""

import torch

from ... import exceptions
from .. import dtypes as _dt
from .. import trace as _trace
from ..engine import store as st
from . import ufuncs as uf
from .base import OpBase, ParameterizedUdf, TypedOpBase, check_arity
from .binary import (ALL11, ALL13, FC, FP, FPFC, INTS8, infer_return,
                     real_of)


class TypedUnaryOp(TypedOpBase):
    opclass = "UnaryOp"

    def __init__(self, parent, name, type_, return_type, func,
                 builtin_udt=False):
        super().__init__(parent, name, type_, return_type)
        self.func = func
        self._positional = parent._positional
        # a builtin that moves a user-defined type's values as they are
        self._builtin_udt = builtin_udt

    def __call__(self, x):
        """On a storage tensor of self.type (a Tree for a user-defined
        type), the result in return_type; on a collection, an apply
        (call_op_unary)."""
        if isinstance(x, st.Tree):
            if self._builtin_udt:
                return self.func(x)
            return st.from_user(self.func(x.user_view()), self.return_type,
                                x)
        if not isinstance(x, torch.Tensor):
            from .utils import call_op_unary

            return call_op_unary(self, x)
        out = self.func(x)
        if isinstance(out, dict):
            raise TypeError(f"{self.parent.name} returns a struct: it takes "
                            f"a user-defined type")
        if not isinstance(out, torch.Tensor):
            out = _trace.read("operator.user_result", torch.as_tensor, out,
                              device=x.device).expand(x.shape)
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


def _on_real(fn):
    """ceil, floor and trunc of a complex value: of its real part, cast
    back to the complex type, as in the JAX package."""
    def make(dt):
        if dt.is_complex:
            return lambda x: fn(x.real).to(x.dtype)
        return fn

    return make


def _round(dt):
    """round half away from zero; of a complex value, its magnitude's,
    in its direction (the JAX package's sign(x) * floor(|x| + 0.5))."""
    if not dt.is_complex:
        return uf.c_round
    return lambda x: torch.where(
        torch.isfinite(x), torch.sgn(x) * torch.floor(x.abs() + 0.5), x)


def _exp2(x):
    if x.is_complex():  # each part times ln 2: inf + 0j stays inf + 0j
        return torch.exp(torch.complex(x.real * _LN2, x.imag * _LN2))
    return torch.exp2(x)


_LN2 = 0.6931471805599453


def _expm1(x):
    """expm1, of a complex value too: Re = expm1(a) cos b - 2 sin(b/2)**2
    keeps the precision of a small argument, as XLA's does."""
    if not x.is_complex():
        return torch.expm1(x)
    a, b = x.real, x.imag
    re = torch.expm1(a) * torch.cos(b) - 2 * torch.sin(b / 2) ** 2
    return torch.complex(re, torch.exp(a) * torch.sin(b))


_BOOL = _dt.BOOL
_FLOAT = {name: fn for name, fn in (
    ("sqrt", torch.sqrt), ("log", torch.log), ("exp", torch.exp),
    ("log2", torch.log2), ("sin", torch.sin), ("cos", torch.cos),
    ("tan", torch.tan), ("acos", torch.acos), ("asin", torch.asin),
    ("atan", torch.atan), ("sinh", torch.sinh), ("cosh", torch.cosh),
    ("tanh", torch.tanh), ("acosh", torch.acosh), ("asinh", torch.asinh),
    ("atanh", torch.atanh), ("exp2", _exp2), ("expm1", _expm1),
    ("log10", torch.log10), ("log1p", torch.log1p))}
_ROUNDING = {"ceil": torch.ceil, "floor": torch.floor, "trunc": torch.trunc}

# name -> (domains, make(dt) -> torch function, return rule)
_BUILTIN = {
    "identity": (ALL13, _const(lambda x: x), None),
    "ainv": (ALL13, uf.ainv, None),
    "minv": (ALL13, uf.minv, None),
    "abs": (ALL13, uf.absolute, real_of),
    "bnot": (INTS8, uf.bnot, None),
    "lnot": (ALL11, uf.lnot, None),
    "one": (ALL13, _const(torch.ones_like), None),
    **{name: (FPFC, _same(fn), None) for name, fn in _FLOAT.items()},
    **{name: (FPFC, _on_real(fn), None) for name, fn in _ROUNDING.items()},
    "round": (FPFC, _round, None),
    "signum": (ALL11, uf.signum, None),
    "lgamma": (FP, _same(torch.lgamma), None),
    "tgamma": (FP, _same(_tgamma), None),
    "erf": (FP, _same(torch.erf), None),
    "erfc": (FP, _same(torch.erfc), None),
    "frexpx": (FP, _const(uf.frexpx), None),
    "frexpe": (FP, _const(uf.frexpe), None),
    "cbrt": (FP, _same(lambda x: torch.sign(x) * x.abs().pow(1.0 / 3)),
             None),
    "isinf": (FPFC, _const(torch.isinf), _BOOL),
    "isnan": (FPFC, _const(torch.isnan), _BOOL),
    "isfinite": (FPFC, _const(torch.isfinite), _BOOL),
    "conj": (FC, _const(torch.conj_physical), None),
    "creal": (FC, _const(lambda x: x.real.contiguous()), real_of),
    "cimag": (FC, _const(lambda x: x.imag.contiguous()), real_of),
    "carg": (FC, _const(torch.angle), real_of),
}
# the builtins that take a user-defined type: its values pass through
_UDT_CAPABLE = frozenset(("identity",))

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
        if dt._is_udt:
            if self.name in _UDT_CAPABLE and not self._anonymous:
                return TypedUnaryOp(self, self.name, dt, dt,
                                    _BUILTIN[self.name][1](dt),
                                    builtin_udt=True)
            if self._udf is None:
                return None
            return TypedUnaryOp(self, self.name, dt, dt, self._udf)
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
        the thirteen types it accepts; with ``is_udt``, typed on demand
        (a user-defined type gets its fields)."""
        if parameterized:
            return ParameterizedUnaryOp(name, func, anonymous=True,
                                        is_udt=is_udt)
        check_arity(func, 1, "UnaryOp")
        op = cls(name if name is not None
                 else getattr(func, "__name__", "unary_op"), anonymous=True)
        op._udf = func
        op._refusal = exceptions.UdfParseError
        if is_udt:
            return op
        for dt in ALL13:
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
    def __init__(self, name, func, *, anonymous=False, is_udt=False):
        super().__init__(name if name is not None
                         else getattr(func, "__name__", "unary_op"),
                         anonymous)
        self.func = func
        self._is_udt = is_udt

    def __call__(self, *args, **kwargs):
        return UnaryOp.register_anonymous(self.func(*args, **kwargs),
                                          self.name, is_udt=self._is_udt)


BUILTINS = {name: UnaryOp._builtin(name, *spec)
            for name, spec in _BUILTIN.items()}
for _name, _pos in POSITIONAL.items():
    _op = UnaryOp(_name, positional=_pos)
    for _d in (_dt.INT32, _dt.INT64):
        _op._typed_ops[_d] = TypedUnaryOp(_op, _name, _d, _d, None)
    BUILTINS[_name] = _op
del _name, _pos, _op, _d
