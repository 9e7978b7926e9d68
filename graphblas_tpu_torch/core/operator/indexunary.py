"""Index-unary and select operators: f(value, row, col, thunk)
(graphblas_tpu/core/operator/{indexunary,select}.py).

The structural operators (``tril``, ``triu``, ``diag``, ``offdiag``,
``rowle``/``rowgt``, ``colle``/``colgt``, and the index-valued
``rowindex``, ``colindex``, ``diagindex``) read only the position and take
the thunk as INT64; the value comparisons (``valueeq`` ... ``valuele``)
compare the value, cast to the operator's type, with the thunk (UINT64
unsigned).  A SelectOp is an IndexUnaryOp that returns BOOL; the select
namespace holds those.  User functions ``f(x, i, j, thunk)`` over tensors
register with :meth:`IndexUnaryOp.register_anonymous` (with
``is_udt=True``, over a user-defined type's fields).  The structural
operators and ``valueeq``/``valuene`` take FC32 and FC64 too, and the
structural ones every user-defined type, as in the JAX package."""

import torch

from ... import exceptions
from .. import dtypes as _dt
from ..engine import store as st
from . import ufuncs as uf
from .base import OpBase, ParameterizedUdf, TypedOpBase, check_arity
from .binary import ALL11, ALL13


def _index_only(fn):
    def op(x, i, j, t):
        return fn(i, j, t.to(i.dtype))

    return lambda dt: op


def _value_only(cmp):
    def make(dt):
        f = cmp(dt)
        return lambda x, i, j, t: f(x, t)

    return make


def _eq(dt):
    return lambda x, t: x == t


def _ne(dt):
    return lambda x, t: x != t


_BOOL = _dt.BOOL
# name -> (make(dt) -> func, return type: a DataType, or None for INT64
# index values)
_BUILTIN = {
    "rowindex": (_index_only(lambda i, j, t: i + t), None),
    "colindex": (_index_only(lambda i, j, t: j + t), None),
    "diagindex": (_index_only(lambda i, j, t: j - i + t), None),
    "tril": (_index_only(lambda i, j, t: j <= i + t), _BOOL),
    "triu": (_index_only(lambda i, j, t: j >= i + t), _BOOL),
    "diag": (_index_only(lambda i, j, t: j == i + t), _BOOL),
    "offdiag": (_index_only(lambda i, j, t: j != i + t), _BOOL),
    "colle": (_index_only(lambda i, j, t: j <= t), _BOOL),
    "colgt": (_index_only(lambda i, j, t: j > t), _BOOL),
    "rowle": (_index_only(lambda i, j, t: i <= t), _BOOL),
    "rowgt": (_index_only(lambda i, j, t: i > t), _BOOL),
    "valueeq": (_value_only(_eq), _BOOL),
    "valuene": (_value_only(_ne), _BOOL),
    "valuegt": (_value_only(uf.gt), _BOOL),
    "valuege": (_value_only(uf.ge), _BOOL),
    "valuelt": (_value_only(uf.lt), _BOOL),
    "valuele": (_value_only(uf.le), _BOOL),
}
_EQ = frozenset(("valueeq", "valuene"))
_POSITIONAL = frozenset(("rowindex", "colindex", "diagindex", "tril", "triu",
                         "diag", "offdiag", "colle", "colgt", "rowle",
                         "rowgt"))


class TypedIndexUnaryOp(TypedOpBase):
    opclass = "IndexUnaryOp"

    def __init__(self, parent, name, type_, return_type, func):
        super().__init__(parent, name, type_, return_type)
        self.func = func
        self._positional = parent._positional

    def __call__(self, x, i=None, j=None, thunk=None):
        """Apply to storage tensors: values of self.type, int64 rows and
        cols, a 0-d thunk; the result in return_type, shaped like x.  On a
        collection (``select.tril(A, -1)``), an expression
        (call_indexunary; the second argument is the thunk)."""
        if isinstance(x, st.Tree):
            if self._positional is not None:
                out = self.func(x, i, j, thunk)
                return _dt.normalize(out.expand(x.shape), self.return_type)
            return st.from_user(self.func(x.user_view(), i, j, thunk),
                                self.return_type, x)
        if not isinstance(x, torch.Tensor):
            from .utils import call_indexunary

            return call_indexunary(self, x, i if thunk is None else thunk)
        out = self.func(x, i, j, thunk)
        if not isinstance(out, torch.Tensor):
            out = torch.as_tensor(out, device=x.device)
        return _dt.normalize(out.expand(x.shape), self.return_type)


class TypedSelectOp(TypedIndexUnaryOp):
    opclass = "SelectOp"


class IndexUnaryOp(OpBase):
    opclass = "IndexUnaryOp"
    _modname = "indexunary"
    _typed_class = TypedIndexUnaryOp

    def __init__(self, name, *, anonymous=False):
        super().__init__(name, anonymous=anonymous)
        self._positional = name if name in _POSITIONAL and not anonymous \
            else None
        self._udf = None

    @classmethod
    def _builtin(cls, name, make, ret):
        op = cls(name)
        domains = ALL13 if name in _POSITIONAL or name in _EQ else ALL11
        for dt in domains:
            op._typed_ops[dt] = cls._typed_class(
                op, name, dt, _dt.INT64 if ret is None else ret, make(dt))
        return op

    def _build_typed(self, dt):
        if dt._is_udt:
            if self._positional is not None:
                ret = _BUILTIN[self.name][1] or _dt.INT64
                return self._typed_class(self, self.name, dt, ret,
                                         _BUILTIN[self.name][0](dt))
            if self._udf is None:
                return None
            return self._typed_class(self, self.name, dt, dt, self._udf)
        if self._udf is None:
            return None
        try:
            probe = torch.ones(1, dtype=dt.torch_type)
            idx = torch.zeros(1, dtype=torch.int64)
            out = self._udf(probe, idx, idx, probe)
            out = out if isinstance(out, torch.Tensor) else torch.as_tensor(out)
        except Exception:  # noqa: BLE001 - the function refuses the type
            return None
        ret = dt if out.dtype == dt.torch_type else _dt.natural(out)
        if self.opclass == "SelectOp" and ret is not _BOOL:
            return None
        return self._typed_class(self, self.name, dt, ret, self._udf)

    @classmethod
    def register_anonymous(cls, func, name=None, *, parameterized=False,
                           is_udt=False):
        """An operator from a Python function f(x, i, j, thunk) over
        tensors, typed for each of the thirteen types it accepts (a
        SelectOp for those where it returns BOOL); with ``is_udt``, typed
        on demand."""
        if parameterized:
            return ParameterizedIndexUnaryOp(cls, name, func, is_udt=is_udt)
        check_arity(func, 4, cls.opclass)
        op = cls(name if name is not None
                 else getattr(func, "__name__", "indexunary_op"),
                 anonymous=True)
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
        register_into_namespace(cls._modname, name, op)
        if cls is IndexUnaryOp and not parameterized and op.types and all(
                rt is _BOOL for rt in op.types.values()):
            # a BOOL-valued one is a SelectOp too, as in the JAX package
            register_into_namespace(
                "select", name, SelectOp.register_anonymous(func, name))
        return op


class SelectOp(IndexUnaryOp):
    opclass = "SelectOp"
    _modname = "select"
    _typed_class = TypedSelectOp


class ParameterizedIndexUnaryOp(ParameterizedUdf):
    def __init__(self, cls, name, func, is_udt=False):
        super().__init__(name if name is not None
                         else getattr(func, "__name__", "indexunary_op"), True)
        self._cls = cls
        self.func = func
        self._is_udt = is_udt

    def __call__(self, *args, **kwargs):
        return self._cls.register_anonymous(self.func(*args, **kwargs),
                                            self.name, is_udt=self._is_udt)


INDEXUNARY = {name: IndexUnaryOp._builtin(name, make, ret)
              for name, (make, ret) in _BUILTIN.items()}
SELECT = {name: SelectOp._builtin(name, make, ret)
          for name, (make, ret) in _BUILTIN.items() if ret is _BOOL}
