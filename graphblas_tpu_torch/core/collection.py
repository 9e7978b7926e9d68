"""The expression builders Vector, Matrix and ``A.T`` share (the JAX
package's core/_collection.py): element-wise operations (with a vector
broadcast along a matrix's rows), ``apply`` with a unary op, a bound
scalar or an index-unary op, and ``select``."""

import numpy as np
import torch

from . import dtypes as _dt
from ..exceptions import DimensionMismatch, EmptyObject
from .base import BaseExpression
from .operator.base import OpBase, TypedOpBase, typed


def unify(a, b, *, left_scalar=False, right_scalar=False):
    """A type that holds both (graphblas_tpu/core/dtypes.py unify): numpy's
    promotion, with a scalar operand taken as a 0-d array."""
    if a == b:
        return a
    if left_scalar and not right_scalar:
        return _dt.lookup_dtype(np.result_type(np.array(0, a.np_type),
                                               b.np_type))
    if right_scalar:
        return _dt.lookup_dtype(np.result_type(a.np_type,
                                               np.array(0, b.np_type)))
    return _dt.lookup_dtype(np.promote_types(a.np_type, b.np_type))


def untranspose(x):
    """(collection, transposed?) of a Matrix, Vector or TransposedMatrix."""
    from .matrix import TransposedMatrix

    if isinstance(x, TransposedMatrix):
        return x._matrix, True
    return x, False


def _shape(x, transposed):
    return tuple(reversed(x.shape)) if transposed else tuple(x.shape)


def scalar_dtype(value):
    """DataType of a scalar operand: a Scalar's, an array's, or a Python
    value's (bool BOOL, int INT64, float FP64)."""
    from .scalar import Scalar

    if isinstance(value, Scalar):
        return value.dtype
    if isinstance(value, (np.generic, np.ndarray, torch.Tensor)):
        return _dt.lookup_dtype(value.dtype)
    return _dt.lookup_dtype(type(value))


def scalar_tensor(value, dtype, device):
    """A scalar operand as a 0-d storage tensor of dtype on device."""
    from .scalar import Scalar

    if isinstance(value, Scalar):
        if value.is_empty:
            raise EmptyObject(
                "Empty Scalar is not allowed as a bound scalar operand")
        return _dt.normalize(value._vals.to(device), dtype)
    return _dt.to_tensor(np.asarray(value), dtype, device)


def ewise_expr(self, other, op, variant, ldef=None, rdef=None):
    """ewise_add/mult/union of two collections of one shape, or of a
    Matrix and a Vector broadcast along its rows."""
    from .matrix import Matrix
    from .scalar import Scalar
    from .vector import Vector

    a, at = untranspose(self)
    b, bt = untranspose(other)
    if not isinstance(b, (Matrix, Vector)):
        raise TypeError(f"Bad type for argument `other` in ewise_{variant}: "
                        f"{type(other).__name__}")
    sa, sb = _shape(a, at), _shape(b, bt)
    a_bc = len(sa) == 1 and len(sb) == 2
    b_bc = len(sa) == 2 and len(sb) == 1
    if a_bc or b_bc:
        m_shape, v_shape = (sb, sa) if a_bc else (sa, sb)
        if m_shape[1] != v_shape[0]:
            raise DimensionMismatch(
                f"Shapes not compatible for broadcast in ewise_{variant}: "
                f"{sa} vs {sb}")
        out_shape, out_cls = m_shape, Matrix
    else:
        if sa != sb:
            raise DimensionMismatch(
                f"Shapes do not match in ewise_{variant}: {sa} != {sb}")
        out_shape, out_cls = sa, type(a)
    op = op.binaryop if getattr(op, "opclass", None) == "Monoid" else op
    bop = typed(op, unify(a.dtype, b.dtype), "BinaryOp")
    lv = rv = None
    if variant == "union":
        lv, rv = (Scalar.from_value(_scalar_value(x), t)
                  for x, t in ((ldef, bop.type), (rdef, bop.type2)))
    return BaseExpression(f"ewise_{variant}", bop, [a, b], bop.return_type,
                          out_shape, out_cls, (variant, at, bt, a_bc, b_bc,
                                               lv, rv))


def _scalar_value(x):
    from .scalar import Scalar

    if isinstance(x, Scalar):
        if x.is_empty:
            raise EmptyObject("a default of ewise_union is an empty Scalar")
        return x.value
    return x


def _lookup(op, namespaces):
    """An operator by name, from the first namespace that has it."""
    for ns in namespaces:
        found = vars(ns).get(op)
        if isinstance(found, OpBase):
            return found
    raise ValueError(f"Unknown op string for apply: {op!r}")


def _is_indexunary(op):
    return getattr(op, "opclass", None) in ("IndexUnaryOp", "SelectOp")


def apply_expr(self, op, right=None, left=None):
    """A unary op; a binary op with a bound scalar (``right=``/``left=``);
    or an index-unary op with its thunk (``right=``)."""
    from .. import indexunary, select, unary

    src, tflag = untranspose(self)
    shape = _shape(src, tflag)
    if isinstance(op, str):
        op = _lookup(op, (unary, indexunary, select))
    if _is_indexunary(op):
        return _indexunary_expr(self, op, False if right is None else right,
                                "apply_indexunary")
    if left is None and right is None:
        unop = typed(op, src.dtype, "UnaryOp")
        return BaseExpression("apply", unop, [src], unop.return_type, shape,
                              type(src), (tflag,))
    if left is not None and right is not None:
        raise TypeError("Cannot provide both `left` and `right`")
    is_left = left is not None
    bound = left if is_left else right
    if hasattr(bound, "ndim") and getattr(bound, "ndim", 0):
        raise TypeError(f"Bad type for keyword argument "
                        f"`{'left' if is_left else 'right'}`: "
                        f"{type(bound).__name__}; expected a scalar")
    bdt = scalar_dtype(bound)
    if getattr(op, "opclass", None) == "Monoid":
        op = op.binaryop
    if isinstance(op, TypedOpBase):
        bop = typed(op, None, "BinaryOp")
    elif is_left:
        bop = typed(op, unify(bdt, src.dtype, left_scalar=True), "BinaryOp")
    else:
        bop = typed(op, unify(src.dtype, bdt, right_scalar=True), "BinaryOp")
    s_val = scalar_tensor(bound, bop.type if is_left else bop.type2,
                          src.device)
    return BaseExpression("apply_bound", bop, [src], bop.return_type, shape,
                          type(src), (s_val, is_left, tflag))


def _indexunary_expr(self, op, thunk, method):
    src, tflag = untranspose(self)
    if hasattr(thunk, "ndim") and getattr(thunk, "ndim", 0):
        raise TypeError(f"thunk must be a scalar; got {type(thunk).__name__}")
    tdt = scalar_dtype(thunk)
    iop = op if isinstance(op, TypedOpBase) else op[unify(src.dtype, tdt)]
    if method == "select" and iop.return_type is not _dt.BOOL:
        raise TypeError("select operator must return BOOL")
    t_val = scalar_tensor(thunk, tdt, src.device)
    out_dt = src.dtype if method == "select" else iop.return_type
    return BaseExpression(method, iop, [src], out_dt, _shape(src, tflag),
                          type(src), (t_val, tdt, src.ndim == 2, tflag))


def select_expr(self, op, thunk=None):
    """Keep the entries where a select operator (or a BOOL index-unary
    operator) holds."""
    from .. import select

    if isinstance(op, str):
        op = _lookup(op, (select,))
    if not _is_indexunary(op):
        raise TypeError(f"select requires a SelectOp; got {op!r}")
    return _indexunary_expr(self, op, False if thunk is None else thunk,
                            "select")
