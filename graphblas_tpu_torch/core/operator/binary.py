"""Binary operators (graphblas_tpu/core/operator/binary.py): the builtin
table over the thirteen builtin types, the positional operators, the
Python binaries of the JAX package (``absfirst``, ``binom``,
``floordiv``, ...), the parameterized ``isclose``, and user functions
over tensors (:meth:`BinaryOp.register_anonymous`,
:meth:`BinaryOp.register_new`; with ``is_udt=True``, over the fields of a
user-defined type).

Each builtin's function is made for its type by a factory of
core/operator/ufuncs.py (C semantics: truncated integer division,
SuiteSparse's x / 0, unsigned UINT64).  ``min`` and ``max`` on floats are
``fmin``/``fmax`` (GraphBLAS ``min`` ignores a NaN operand); they, the
order comparisons and the logical and bitwise operators have no complex
instance, as in the JAX package.  ``cmplx`` makes FC32 of two FP32 (FC64
of two FP64).  The eight
positional operators (``firsti`` ... ``secondj1``) return an index of the
pair they are applied to, plus 0 or 1; the engine computes them from
positions (core/engine/dense.py ``positional_value``), so they have no
function here, and on a type other than INT32 and INT64 they are their
INT64 instance."""

import torch

from ... import exceptions
from .. import dtypes as _dt
from ..engine import store as st
from . import ufuncs as uf
from .base import OpBase, ParameterizedUdf, TypedOpBase, check_arity

ALL11 = _dt.ALL
ALL13 = _dt.ALL13
INTS8 = ALL11[1:9]  # INT8 .. UINT64
FP = (_dt.FP32, _dt.FP64)
FC = _dt.COMPLEX
FPFC = FP + FC
_POS = (_dt.INT32, _dt.INT64)


class TypedBinaryOp(TypedOpBase):
    opclass = "BinaryOp"

    def __init__(self, parent, name, type_, return_type, func, type2=None,
                 builtin_udt=False):
        super().__init__(parent, name, type_, return_type, type2)
        self.func = func
        self._positional = parent._positional
        # a builtin that moves a user-defined type's values as they are
        self._builtin_udt = builtin_udt

    def __call__(self, left, right=None, *, left_default=None,
                 right_default=None):
        """On storage tensors of self.type (Trees for a user-defined type),
        the result in return_type; on collections and infix expressions,
        an expression (call_op)."""
        if isinstance(left, st.Tree) or isinstance(right, st.Tree):
            if self._builtin_udt:
                return self.func(left, right)
            like = left if isinstance(left, st.Tree) else right
            out = self.func(*(x.user_view() if isinstance(x, st.Tree)
                              else x for x in (left, right)))
            return st.from_user(out, self.return_type, like)
        if isinstance(left, torch.Tensor):
            out = self.func(left, right)
            if isinstance(out, dict):
                raise TypeError(f"{self.parent.name} returns a struct: it "
                                f"takes a user-defined type")
            return _dt.normalize(out, self.return_type)
        from .utils import call_op

        return call_op(self, left, right, left_default=left_default,
                       right_default=right_default)

    @property
    def monoid(self):
        mono = self.parent.monoid
        if mono is not None and self.type in mono._typed_ops:
            return mono._typed_ops[self.type]
        return None

    @property
    def commutes_to(self):
        c = self.parent.commutes_to
        if c is not None and self.type in c._typed_ops:
            return c._typed_ops[self.type]
        return None


def _is_wrap(cmp):
    """An ``is*`` comparison: the result in the operands' type."""
    def make(dt):
        f = cmp(dt)
        return f if dt.is_bool else (lambda x, y: f(x, y).to(x.dtype))

    return make


def _eq(dt):
    return lambda x, y: x == y


def _ne(dt):
    return lambda x, y: x != y


def _truediv(dt):
    if dt.is_float or dt.is_complex:
        return lambda x, y: x / y
    return lambda x, y: uf.to_float64(x, dt) / uf.to_float64(y, dt)


def _truediv_ret(dt):
    return dt if dt.is_float or dt.is_complex else _dt.FP64


def _cmplx(dt):
    return torch.complex


_CMPLX_RET = {_dt.FP32: _dt.FC32, _dt.FP64: _dt.FC64}
_FC_TO_FP = {_dt.FC32: _dt.FP32, _dt.FC64: _dt.FP64}


def real_of(dt):
    """The real type of a complex one (abs, creal, ...); dt otherwise."""
    return _FC_TO_FP.get(dt, dt)


def _swap(make):
    def swapped(dt):
        f = make(dt)
        return lambda x, y: f(y, x)

    return swapped


def _const(fn):
    return lambda dt: fn


def _fmod(dt):
    return torch.fmod


def _remainder(dt):
    # IEEE remainder: x - round_half_even(x / y) * y
    return lambda x, y: x - torch.round(x / y) * y


def _bxnor(dt):
    return lambda x, y: ~(x ^ y)


_BOOL = _dt.BOOL

# name -> (domains, make(dt) -> torch function, return rule)
_BUILTIN = {
    "first": (ALL13, _const(lambda x, y: x), None),
    "second": (ALL13, _const(lambda x, y: y), None),
    "pair": (ALL13, _const(lambda x, y: torch.ones_like(x)), None),
    "any": (ALL13, _const(lambda x, y: x), None),  # either will do: the first
    "plus": (ALL13, uf.plus, None),
    "minus": (ALL13, uf.minus, None),
    "rminus": (ALL13, _swap(uf.minus), None),
    "times": (ALL13, uf.times, None),
    "cdiv": (ALL13, uf.div, None),
    "rdiv": (ALL13, _swap(uf.div), None),
    "truediv": (ALL13, _truediv, _truediv_ret),
    "rtruediv": (ALL13, _swap(_truediv), _truediv_ret),
    "min": (ALL11, uf.minimum, None),
    "max": (ALL11, uf.maximum, None),
    "pow": (ALL13, uf.power, None),
    "iseq": (ALL13, _is_wrap(_eq), None),
    "isne": (ALL13, _is_wrap(_ne), None),
    "isgt": (ALL11, _is_wrap(uf.gt), None),
    "islt": (ALL11, _is_wrap(uf.lt), None),
    "isge": (ALL11, _is_wrap(uf.ge), None),
    "isle": (ALL11, _is_wrap(uf.le), None),
    "lor": (ALL11, uf.lor, None),
    "land": (ALL11, uf.land, None),
    "lxor": (ALL11, uf.lxor, None),
    "lxnor": (ALL11, uf.lxnor, None),
    "bor": (INTS8, _const(lambda x, y: x | y), None),
    "band": (INTS8, _const(lambda x, y: x & y), None),
    "bxor": (INTS8, _const(lambda x, y: x ^ y), None),
    "bxnor": (INTS8, _bxnor, None),
    "bget": (INTS8, uf.bget, None),
    "bset": (INTS8, uf.bset, None),
    "bclr": (INTS8, uf.bclr, None),
    "bshift": (INTS8, uf.bshift, None),
    "atan2": (FP, _const(torch.atan2), None),
    "hypot": (FP, _const(torch.hypot), None),
    "fmod": (FP, _fmod, None),
    "remainder": (FP, _remainder, None),
    "ldexp": (FP, uf.ldexp, None),
    "copysign": (FP, _const(torch.copysign), None),
    "eq": (ALL13, _eq, _BOOL),
    "ne": (ALL13, _ne, _BOOL),
    "gt": (ALL11, uf.gt, _BOOL),
    "lt": (ALL11, uf.lt, _BOOL),
    "ge": (ALL11, uf.ge, _BOOL),
    "le": (ALL11, uf.le, _BOOL),
    "cmplx": (FP, _cmplx, _CMPLX_RET.get),
}
# the builtins that take a user-defined type: they move its values
_UDT_CAPABLE = frozenset(("first", "second", "any"))

# the Python binaries of the JAX package (its binary/__init__.py), which
# it types by tracing: the same table here


def _absfirst(dt):
    a = uf.absolute(dt)
    return lambda x, y: a(x)


def _binom(dt):
    def fn(x, y):
        if dt.is_complex:  # of the real parts, as the JAX package casts
            x, y = x.real, y.real
        xf, yf = uf.to_float64(x, dt), uf.to_float64(y, dt)
        r = torch.exp(torch.lgamma(xf + 1) - torch.lgamma(yf + 1)
                      - torch.lgamma(xf - yf + 1))
        return torch.round(r)

    return fn


def _floordiv(dt):
    if dt.is_bool:
        return uf.div(dt)
    if dt.is_unsigned:
        return uf.idiv(dt)  # floor and truncation agree
    if dt.is_int:
        d = uf.idiv(dt)

        def fn(x, y):
            ys = torch.where(y == 0, torch.ones_like(y), y)
            return torch.where(y == 0, d(x, y),
                               torch.div(x, ys, rounding_mode="floor"))

        return fn
    return lambda x, y: uf.float_divmod(x, y)[0]


_EXTRA = {
    "absfirst": (ALL13, _absfirst, real_of),
    "abssecond": (ALL13, _swap(_absfirst), real_of),
    "binom": (ALL13, _binom, lambda dt: _dt.INT64 if dt.is_bool else dt),
    "floordiv": (ALL11, _floordiv, None),
    "rfloordiv": (ALL11, _swap(_floordiv), None),
    "rpow": (ALL13, _swap(uf.power), None),
}

_POSITIONAL = {"firsti": ("ai", 0), "firsti1": ("ai", 1),
               "firstj": ("aj", 0), "firstj1": ("aj", 1),
               "secondi": ("bi", 0), "secondi1": ("bi", 1),
               "secondj": ("bj", 0), "secondj1": ("bj", 1)}

COMMUTES = {
    "plus": "plus", "times": "times", "min": "min", "max": "max",
    "lor": "lor", "land": "land", "lxor": "lxor", "lxnor": "lxnor",
    "eq": "eq", "ne": "ne", "iseq": "iseq", "isne": "isne", "pair": "pair",
    "any": "any", "hypot": "hypot", "bor": "bor", "band": "band",
    "bxor": "bxor", "bxnor": "bxnor", "first": "second", "second": "first",
    "gt": "lt", "lt": "gt", "ge": "le", "le": "ge", "isgt": "islt",
    "islt": "isgt", "isge": "isle", "isle": "isge", "minus": "rminus",
    "rminus": "minus", "cdiv": "rdiv", "rdiv": "cdiv", "truediv": "rtruediv",
    "rtruediv": "truediv", "firsti": "secondi", "firsti1": "secondi1",
    "firstj": "secondj", "firstj1": "secondj1", "secondi": "firsti",
    "secondi1": "firsti1", "secondj": "firstj", "secondj1": "firstj1",
    "absfirst": "abssecond", "abssecond": "absfirst", "floordiv": "rfloordiv",
    "rfloordiv": "floordiv", "pow": "rpow", "rpow": "pow",
    "isclose": "isclose",
}

# names whose builtin reduces with the monoid of the same name
HAS_MONOID = frozenset(("plus", "times", "min", "max", "lor", "land", "lxor",
                        "lxnor", "eq", "any", "bor", "band", "bxor", "bxnor"))


def infer_return(func, dt, nargs):
    """The DataType func makes of operands of dt: its result on a probe of
    dt's storage type (a result in that storage type is dt itself)."""
    probe = torch.ones(1, dtype=dt.torch_type)
    out = func(*([probe] * nargs))
    if not isinstance(out, torch.Tensor):
        out = torch.as_tensor(out)
    if out.dtype == dt.torch_type:
        return dt
    return _dt.natural(out)


class BinaryOp(OpBase):
    opclass = "BinaryOp"
    _modname = "binary"

    def __init__(self, name, *, anonymous=False, positional=None):
        super().__init__(name, anonymous=anonymous)
        self._positional = positional
        self._udf = None  # a user function over tensors, typed on demand

    @classmethod
    def _builtin(cls, name, domains, make, ret_rule):
        op = cls(name)
        for dt in domains:
            ret = dt if ret_rule is None else (
                ret_rule(dt) if callable(ret_rule) else ret_rule)
            op._typed_ops[dt] = TypedBinaryOp(op, name, dt, ret, make(dt))
        return op

    def _build_typed(self, dt):
        if self._positional is not None:
            return self[_dt.INT64]
        if dt._is_udt:
            if self.name in _UDT_CAPABLE and not self._anonymous:
                return TypedBinaryOp(self, self.name, dt, dt,
                                     _BUILTIN[self.name][1](dt),
                                     builtin_udt=True)
            if self._udf is None:
                return None
            return TypedBinaryOp(self, self.name, dt, dt, self._udf)
        if self._udf is None:
            return None
        try:
            ret = infer_return(self._udf, dt, 2)
        except Exception:  # noqa: BLE001 - the function refuses the type
            return None
        return TypedBinaryOp(self, self.name, dt, ret, self._udf)

    @property
    def _domains(self):
        return tuple(self._typed_ops)

    @property
    def monoid(self):
        """The monoid of the same name, which a reduce by this op uses
        (the JAX package's ``_HAS_MONOID``); None where there is none."""
        if self._anonymous or self.name not in HAS_MONOID:
            return None
        from .monoid import BUILTINS as monoids

        return monoids.get(self.name)

    @property
    def commutes_to(self):
        name = COMMUTES.get(self.name)
        return None if name is None else BUILTINS.get(name)

    @classmethod
    def register_anonymous(cls, func, name=None, *, parameterized=False,
                           is_udt=False):
        """A BinaryOp from a Python function over tensors (torch
        operations on storage tensors of one type), typed for each of the
        thirteen types it accepts; with ``is_udt``, typed on demand (a
        user-defined type gets its fields)."""
        if parameterized:
            return ParameterizedBinaryOp(name, func, anonymous=True,
                                         is_udt=is_udt)
        check_arity(func, 2, "BinaryOp")
        op = cls(name if name is not None
                 else getattr(func, "__name__", "binary_op"), anonymous=True)
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
        register_into_namespace("binary", name, op)
        return op


class ParameterizedBinaryOp(ParameterizedUdf):
    def __init__(self, name, func, *, anonymous=False, is_udt=False):
        super().__init__(name if name is not None
                         else getattr(func, "__name__", "binary_op"),
                         anonymous)
        self.func = func
        self._is_udt = is_udt

    def __call__(self, *args, **kwargs):
        return BinaryOp.register_anonymous(self.func(*args, **kwargs),
                                           self.name, is_udt=self._is_udt)


def _isclose(rel_tol=1e-7, abs_tol=0.0):
    def isclose(x, y):
        return (x - y).abs() <= abs_tol + rel_tol * y.abs()

    return isclose


BUILTINS = {name: BinaryOp._builtin(name, *spec)
            for name, spec in {**_BUILTIN, **_EXTRA}.items()}
for _name in _EXTRA:  # Python functions in the JAX package: a failed trace
    BUILTINS[_name]._refusal = exceptions.UdfParseError
BUILTINS["oneb"] = BUILTINS["pair"]
for _name, _pos in _POSITIONAL.items():
    _op = BinaryOp(_name, positional=_pos)
    for _d in _POS:
        _op._typed_ops[_d] = TypedBinaryOp(_op, _name, _d, _d, None)
    BUILTINS[_name] = _op
del _name, _pos, _op, _d
BUILTINS["isclose"] = ParameterizedBinaryOp("isclose", _isclose)
