"""Infix expressions and Python arithmetic (graphblas_tpu/core/infix.py).

``x | y``, ``x & y`` and ``x @ y`` make typed infix expressions whose
operator is given later (``monoid.plus(x | y)``,
``semiring.min_plus(A @ B)``); computed without one, ``x | y`` and
``x & y`` take ``lor`` and ``land`` on BOOL operands and raise TypeError on
any other type, and ``@`` takes the method's default ring.  Python's
arithmetic and comparison operators are GraphBLAS calls: two collections
give an ``ewise_mult`` (``+`` an ``ewise_add``, ``-`` an ``ewise_union``
with 0 defaults), a collection and a scalar a bound ``apply``, two
Scalars a Scalar ``ewise_*``.  ``bool(s == 3)`` is the truth of the
computed comparison.  An expression used as a value is computed once
(autocompute).  Installing the operators is this module's import."""

from .base import BaseExpression
from .dtypes import BOOL
from .expr import AmbiguousAssignOrExtract, InfixExprBase
from .mask import Mask
from .matrix import Matrix, TransposedMatrix
from .scalar import Scalar
from .utils import _output_types, output_type
from .vector import Vector

_COLLECTIONS = (Vector, Matrix, TransposedMatrix)


def _ewise_add_to_expr(self):
    if self._expr is None:
        if self.left.dtype != BOOL or self.right.dtype != BOOL:
            raise TypeError(
                f"Bad dtypes for `x | y`!  Automatic computation of `x | y` "
                f"infix expressions is only valid for BOOL dtypes.  The "
                f"argument dtypes are {self.left.dtype} and "
                f"{self.right.dtype}.\n\nWhen auto-computed for boolean "
                f"dtypes, `x | y` performs ewise_add (union) using LOR.\n\n"
                f"Typical usage is to create an ewise_add expression such as "
                f"`monoid.plus(x | y)`.")
        from ..monoid import lor

        self._expr = self.left.ewise_add(self.right, lor)
    return self._expr


def _ewise_mult_to_expr(self):
    if self._expr is None:
        if self.left.dtype != BOOL or self.right.dtype != BOOL:
            raise TypeError(
                f"Bad dtypes for `x & y`!  Automatic computation of `x & y` "
                f"infix expressions is only valid for BOOL dtypes.  The "
                f"argument dtypes are {self.left.dtype} and "
                f"{self.right.dtype}.\n\nWhen auto-computed for boolean "
                f"dtypes, `x & y` performs ewise_mult (intersection) using "
                f"LAND.\n\nTypical usage is to create an ewise_mult "
                f"expression such as `monoid.times(x & y)`.")
        from ..monoid import land

        self._expr = self.left.ewise_mult(self.right, land)
    return self._expr


class ScalarInfixExpr(InfixExprBase):
    ndim = 0
    shape = ()
    _is_scalar = True
    output_type = Scalar

    @property
    def is_cscalar(self):
        return False

    @property
    def is_grbscalar(self):
        return True


class ScalarEwiseAddExpr(ScalarInfixExpr):
    method_name = "ewise_add"
    _example_op = "plus"
    _infix = "|"
    _to_expr = _ewise_add_to_expr


class ScalarEwiseMultExpr(ScalarInfixExpr):
    method_name = "ewise_mult"
    _example_op = "times"
    _infix = "&"
    _to_expr = _ewise_mult_to_expr


class ScalarMatMulExpr(ScalarInfixExpr):
    method_name = "inner"
    _example_op = "plus_times"
    _infix = "@"


class VectorInfixExpr(InfixExprBase):
    ndim = 1
    output_type = Vector

    def __init__(self, left, right, size=None):
        super().__init__(left, right)
        self._size = left.shape[0] if size is None else size

    @property
    def size(self):
        return self._size

    @property
    def shape(self):
        return (self._size,)


class VectorEwiseAddExpr(VectorInfixExpr):
    method_name = "ewise_add"
    _example_op = "plus"
    _infix = "|"
    _to_expr = _ewise_add_to_expr


class VectorEwiseMultExpr(VectorInfixExpr):
    method_name = "ewise_mult"
    _example_op = "times"
    _infix = "&"
    _to_expr = _ewise_mult_to_expr


class VectorMatMulExpr(VectorInfixExpr):
    _example_op = "plus_times"
    _infix = "@"

    def __init__(self, left, right, *, method_name, size):
        super().__init__(left, right, size)
        self.method_name = method_name


class MatrixInfixExpr(InfixExprBase):
    ndim = 2
    output_type = Matrix

    def __init__(self, left, right, shape=None):
        super().__init__(left, right)
        if shape is None:
            shape = left.shape if len(left.shape) == 2 else right.shape
        self._nrows, self._ncols = shape

    @property
    def nrows(self):
        return self._nrows

    @property
    def ncols(self):
        return self._ncols

    @property
    def shape(self):
        return (self._nrows, self._ncols)


class MatrixEwiseAddExpr(MatrixInfixExpr):
    method_name = "ewise_add"
    _example_op = "plus"
    _infix = "|"
    _to_expr = _ewise_add_to_expr


class MatrixEwiseMultExpr(MatrixInfixExpr):
    method_name = "ewise_mult"
    _example_op = "times"
    _infix = "&"
    _to_expr = _ewise_mult_to_expr


class MatrixMatMulExpr(MatrixInfixExpr):
    method_name = "mxm"
    _example_op = "plus_times"
    _infix = "@"


_EWISE_CLASSES = {
    (Scalar, "ewise_add"): ScalarEwiseAddExpr,
    (Scalar, "ewise_mult"): ScalarEwiseMultExpr,
    (Vector, "ewise_add"): VectorEwiseAddExpr,
    (Vector, "ewise_mult"): VectorEwiseMultExpr,
    (Matrix, "ewise_add"): MatrixEwiseAddExpr,
    (Matrix, "ewise_mult"): MatrixEwiseMultExpr,
}


def _ewise_infix_expr(left, right, *, method, within):
    from ..binary import any as binary_any

    left_type, right_type = output_type(left), output_type(right)
    if left_type in _COLLECTIONS and right_type in _COLLECTIONS:
        expr = getattr(left, method)(right, binary_any)  # dimension check
        return _EWISE_CLASSES[expr.output_type, method](left, right)
    if isinstance(right, Mask):
        return right.__ror__(left) if within == "__or__" else \
            right.__rand__(left)
    if left_type in _COLLECTIONS:
        left._expect_type(right, _COLLECTIONS, within=within,
                          argname="right")
    elif right_type in _COLLECTIONS:
        right._expect_type(left, _COLLECTIONS, within=within,
                           argname="left")
    elif left_type is Scalar:
        getattr(left, method)(right, binary_any)
        return _EWISE_CLASSES[Scalar, method](left, right)
    elif right_type is Scalar:
        getattr(right, method)(left, binary_any)
        return _EWISE_CLASSES[Scalar, method](right, left)
    raise TypeError(f"Bad types for ewise infix: {type(left).__name__}, "
                    f"{type(right).__name__}")


def _matmul_infix_expr(left, right, *, within):
    from ..semiring import any_pair

    left_type, right_type = output_type(left), output_type(right)
    mats = (Matrix, TransposedMatrix)
    if left_type is Vector:
        if right_type in mats:
            method = "vxm"
        elif right_type is Vector:
            method = "inner"
        else:
            left._expect_type(right, mats, within=within, argname="right")
    elif left_type in mats:
        if right_type is Vector:
            method = "mxv"
        elif right_type in mats:
            method = "mxm"
        else:
            left._expect_type(right, (Vector, *mats), within=within,
                              argname="right")
    elif right_type is Vector:
        right._expect_type(left, mats, within=within, argname="left")
    elif right_type in mats:
        right._expect_type(left, (Vector, *mats), within=within,
                           argname="left")
    else:
        raise TypeError(f"Bad types for matmul infix: {type(left).__name__}, "
                        f"{type(right).__name__}")
    # the dimension check, with a ring that takes every type
    expr = getattr(left, method)(right, any_pair["BOOL"])
    if expr.output_type is Vector:
        return VectorMatMulExpr(left, right, method_name=method,
                                size=expr.shape[0])
    if expr.output_type is Matrix:
        return MatrixMatMulExpr(left, right, expr.shape)
    return ScalarMatMulExpr(left, right)


def __or__(self, other):
    return _ewise_infix_expr(self, other, method="ewise_add", within="__or__")


def __ror__(self, other):
    return _ewise_infix_expr(other, self, method="ewise_add", within="__or__")


def __and__(self, other):
    return _ewise_infix_expr(self, other, method="ewise_mult",
                             within="__and__")


def __rand__(self, other):
    return _ewise_infix_expr(other, self, method="ewise_mult",
                             within="__and__")


def __matmul__(self, other):
    return _matmul_infix_expr(self, other, within="__matmul__")


def __rmatmul__(self, other):
    return _matmul_infix_expr(other, self, within="__rmatmul__")


def _scalar_matmul(self, other):
    raise TypeError("Scalar objects not supported for matmul: @")


# --------------------------------------------------------------------- #
# Python arithmetic and comparisons
def _call_binop(self, other, op, *, outer=False, union=False, reverse=False):
    if isinstance(op, str):
        from .. import binary

        op = getattr(binary, op)
    left, right = (other, self) if reverse else (self, other)
    type1, type2 = output_type(left), output_type(right)
    if type1 in _COLLECTIONS:
        if type2 in _COLLECTIONS:
            if outer:
                return left.ewise_add(right, op)
            if union:
                return left.ewise_union(right, op, False, False)
            return left.ewise_mult(right, op)
        return op(left, right)
    if type2 in _COLLECTIONS:
        return op(left, right)
    if type1 is Scalar:
        scalar, other_arg = left, right
    elif type2 is Scalar:
        # the Scalar takes the operator's commuted form
        scalar, other_arg = right, left
        op = op.commutes_to or op
    else:
        raise TypeError(f"Bad types for operation: {type(left).__name__}, "
                        f"{type(right).__name__}")
    if outer:
        return scalar.ewise_add(other_arg, op)
    if union:
        return scalar.ewise_union(other_arg, op, False, False)
    return scalar.ewise_mult(other_arg, op)


_ARITH = {
    "__add__": ("plus", {"outer": True}, False),
    "__radd__": ("plus", {"outer": True}, True),
    "__sub__": ("minus", {"union": True}, False),
    "__rsub__": ("minus", {"union": True}, True),
    "__mul__": ("times", {}, False),
    "__rmul__": ("times", {}, True),
    "__truediv__": ("truediv", {}, False),
    "__rtruediv__": ("truediv", {}, True),
    "__floordiv__": ("floordiv", {}, False),
    "__rfloordiv__": ("floordiv", {}, True),
    "__pow__": ("pow", {}, False),
    "__rpow__": ("pow", {}, True),
    "__eq__": ("eq", {}, False),
    "__ne__": ("ne", {}, False),
    "__lt__": ("lt", {}, False),
    "__le__": ("le", {}, False),
    "__gt__": ("gt", {}, False),
    "__ge__": ("ge", {}, False),
}


def _make_arith(opname, kwargs, reverse):
    def method(self, other):
        return _call_binop(self, other, opname, reverse=reverse, **kwargs)

    method.__name__ = opname
    return method


def _mod_op():
    from .. import binary

    return binary.numpy.mod


def __mod__(self, other):
    return _call_binop(self, other, _mod_op())


def __rmod__(self, other):
    return _call_binop(self, other, _mod_op(), reverse=True)


def __divmod__(self, other):
    return (_call_binop(self, other, "floordiv"), __mod__(self, other))


def __rdivmod__(self, other):
    return (_call_binop(self, other, "floordiv", reverse=True),
            __rmod__(self, other))


def __neg__(self):
    from ..unary import ainv

    return ainv(self)


def __abs__(self):
    from .. import unary

    return unary.abs(self)


def _bool_xor(expr):
    if expr.dtype != BOOL:
        raise TypeError(f"The __xor__ infix operator, `x ^ y`, is not "
                        f"supported for {expr.dtype.name} dtype.  It is only "
                        f"supported for BOOL dtype (and it uses "
                        f"ewise_add--the union).")
    return expr


def __xor__(self, other):
    return _bool_xor(_call_binop(self, other, "lxor", outer=True))


def __rxor__(self, other):
    return _bool_xor(_call_binop(self, other, "lxor", outer=True,
                                 reverse=True))


_TARGETS = (Vector, Matrix, Scalar, TransposedMatrix, BaseExpression,
            InfixExprBase, AmbiguousAssignOrExtract)

for _cls in _TARGETS:
    for _name, (_opname, _kw, _rev) in _ARITH.items():
        if _cls is AmbiguousAssignOrExtract and _name in ("__eq__", "__ne__"):
            continue  # it compares its extracted value
        setattr(_cls, _name, _make_arith(_opname, _kw, _rev))
    _cls.__mod__ = __mod__
    _cls.__rmod__ = __rmod__
    _cls.__divmod__ = __divmod__
    _cls.__rdivmod__ = __rdivmod__
    _cls.__neg__ = __neg__
    _cls.__abs__ = __abs__
    _cls.__xor__ = __xor__
    _cls.__rxor__ = __rxor__
    # a Scalar compares by value and is unhashable; collections and
    # expressions keep identity hashing
    _cls.__hash__ = None if _cls is Scalar else object.__hash__

for _cls in (Vector, Matrix, TransposedMatrix, BaseExpression, InfixExprBase):
    _cls.__or__ = __or__
    _cls.__ror__ = __ror__
    _cls.__and__ = __and__
    _cls.__rand__ = __rand__
    _cls.__matmul__ = __matmul__
    _cls.__rmatmul__ = __rmatmul__
Scalar.__or__ = __or__
Scalar.__ror__ = __ror__
Scalar.__and__ = __and__
Scalar.__rand__ = __rand__
Scalar.__matmul__ = Scalar.__rmatmul__ = _scalar_matmul


# expressions: conversions and iteration of the computed value
def _make_delegate(name):
    def method(self, *args, **kwargs):
        return getattr(self._get_value(), name)(*args, **kwargs)

    method.__name__ = name
    return method


for _cls in (BaseExpression, InfixExprBase):
    for _name in ("__int__", "__float__", "__complex__", "__index__",
                  "__bool__", "__iter__", "__contains__", "__array__",
                  "__invert__"):
        setattr(_cls, _name, _make_delegate(_name))

_output_types[BaseExpression] = BaseExpression
_output_types[AmbiguousAssignOrExtract] = AmbiguousAssignOrExtract
