"""What Vector, Matrix and ``A.T`` share (the JAX package's
core/_collection.py): the expressions they make (element-wise operations,
with a vector broadcast along a matrix's rows; ``apply`` with a unary op,
a bound scalar or an index-unary op; ``select``), and the indexing
protocol of ``Collection`` (extract, assign and delete by index,
membership and ``get``)."""

import numpy as np
import torch

from . import dtypes as _dt
from .dtypes import unify
from ..exceptions import DimensionMismatch, EmptyObject
from .base import BaseExpression, BaseType, is_scalar_like
from .operator.base import TypedOpBase, typed, unparameterized
from .operator.utils import op_from_string, select_from_string


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
    return _dt.to_tensor(np.asarray(value), dtype, device).reshape(())


def ewise_expr(self, other, op, variant, ldef=None, rdef=None):
    """ewise_add/mult/union of two collections of one shape, or of a
    Matrix and a Vector broadcast along its rows."""
    from .matrix import Matrix
    from .scalar import Scalar
    from .vector import Vector

    from .matrix import TransposedMatrix

    if isinstance(other, BaseExpression):
        other = self._expect_type(other, (Matrix, Vector, TransposedMatrix),
                                  within=f"ewise_{variant}",
                                  argname="other")
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


def _lookup(op, opclasses):
    """An operator string, parsed as the first of opclasses that knows it
    (the JAX package's ``apply``)."""
    for opclass in opclasses:
        try:
            return op_from_string(op, opclass)
        except ValueError:
            continue
    raise ValueError(f"Unknown op string for apply: {op!r}.  Example "
                     f"usage: 'abs[int]' or 'rowindex'")


def _is_indexunary(op):
    return getattr(op, "opclass", None) in ("IndexUnaryOp", "SelectOp")


def apply_expr(self, op, right=None, left=None):
    """A unary op; a binary op with a bound scalar (``right=``/``left=``);
    or an index-unary op with its thunk (``right=``)."""
    src, tflag = untranspose(self)
    shape = _shape(src, tflag)
    op = unparameterized(op)
    if isinstance(op, str):
        op = _lookup(op, ("UnaryOp", "IndexUnaryOp", "SelectOp"))
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
        bop = typed(op, unify(bdt, src.dtype, is_left_scalar=True), "BinaryOp")
    else:
        bop = typed(op, unify(src.dtype, bdt, is_right_scalar=True), "BinaryOp")
    s_val = scalar_tensor(bound, bop.type if is_left else bop.type2,
                          src.device)
    expr = BaseExpression("apply_bound", bop, [src], bop.return_type, shape,
                          type(src), (s_val, is_left, tflag),
                          public_name="apply")
    expr._bound = bound  # for select.value(A > t) and the positional forms
    return expr


def _indexunary_expr(self, op, thunk, method):
    src, tflag = untranspose(self)
    if hasattr(thunk, "ndim") and getattr(thunk, "ndim", 0):
        raise TypeError(f"thunk must be a scalar; got {type(thunk).__name__}")
    tdt = scalar_dtype(thunk)
    if isinstance(op, TypedOpBase):
        iop = op
    elif src.dtype._is_udt and (op._positional is not None
                                or op._udf is not None):
        iop = op[src.dtype]  # a user-defined type's own instance
    else:
        iop = op[unify(src.dtype, tdt)]
    if method == "select" and iop.return_type is not _dt.BOOL:
        raise TypeError("select operator must return BOOL")
    t_val = scalar_tensor(thunk, tdt, src.device)
    out_dt = src.dtype if method == "select" else iop.return_type
    return BaseExpression(method, iop, [src], out_dt, _shape(src, tflag),
                          type(src), (t_val, tdt, src.ndim == 2, tflag))


def select_expr(self, op, thunk=None):
    """Keep the entries where a select operator (or a BOOL index-unary
    operator) holds."""
    from .mask import Mask, ValueMask

    if isinstance(op, BaseType) and op.dtype == _dt.BOOL and op.ndim:
        op = ValueMask(op)  # a BOOL collection selects by its values
    if isinstance(op, Mask):
        if thunk is not None and thunk is not False:
            raise TypeError("thunk argument not allowed when selecting "
                            "with a mask")
        if op.parent.ndim != self.ndim:
            raise TypeError(f"Mask used as a select operator must have the "
                            f"same rank as the input; got "
                            f"{op.parent.ndim}-d mask for {self.ndim}-d "
                            f"input")
        from .. import binary

        return self.ewise_mult(op.new(), binary.first)
    if isinstance(op, BaseExpression):
        from ..select import match_expr

        src, _ = untranspose(self)
        match = match_expr(src, op)
        if match is None:
            raise TypeError("Unable to interpret select expression; use a "
                            "SelectOp, e.g. A.select('>', 5) or "
                            "select.valuegt(A, 5)")
        op, thunk = match
    op = unparameterized(op)
    if isinstance(op, str):
        op = select_from_string(op)
    if not _is_indexunary(op):
        raise TypeError(f"select requires a SelectOp; got {op!r}")
    return _indexunary_expr(self, op, False if thunk is None else thunk,
                            "select")


# --------------------------------------------------------------------- #
# the indexing protocol (graphblas_tpu/core/_collection.py)
class Collection(BaseType):
    """A Matrix or Vector: extract, assign and delete by index, and
    membership."""

    def __getitem__(self, keys):
        from .expr import AmbiguousAssignOrExtract, IndexerResolver

        return AmbiguousAssignOrExtract(self, IndexerResolver(self, keys))

    def __setitem__(self, keys, value):
        from .expr import IndexerResolver

        self._assign_at(IndexerResolver(self, keys), value, mask=None,
                        accum=None, replace=False, is_submask=False)

    def __delitem__(self, keys):
        from .expr import IndexerResolver

        self._delete_at(IndexerResolver(self, keys), mask=None)

    def __contains__(self, index):
        """``i in v``, ``(i, j) in A``: is an element stored there?"""
        from .expr import IndexerResolver

        if not IndexerResolver(self, index).is_single_element:
            raise TypeError(f"Invalid index to Matrix/Vector contains: "
                            f"{index!r}")
        return not self[index].new().is_empty

    def get(self, *index, default=None):
        """One element as a Python value, or default where none is stored:
        ``A.get(i, j)``, ``v.get(i)``; the default may follow the indices
        (``v.get(i, 0)``)."""
        if len(index) == 1 and isinstance(index[0], tuple):
            index = index[0]
        if len(index) == self.ndim + 1:
            default = index[self.ndim]
            index = index[:self.ndim]
        key = tuple(index) if self.ndim == 2 else index[0]
        v = self[key].new().value
        return default if v is None else v

    def _assign_at(self, resolver, value, *, mask, accum, replace,
                   is_submask):
        """GrB_assign (and GxB_subassign where is_submask) of a scalar or a
        collection of the region's shape into the region."""
        from . import execute
        from .expr import AmbiguousAssignOrExtract
        from .matrix import Matrix, TransposedMatrix
        from .scalar import Scalar
        from .vector import Vector

        if isinstance(value, (AmbiguousAssignOrExtract, BaseExpression,
                              TransposedMatrix)):
            value = value.new()
        axes = resolver.indices
        region_ndim = sum(not ix.is_scalar for ix in axes)
        # the mask's rank (graphblas_tpu/core/_collection.py _assign_at):
        # a submask has the region's rank; a Vector mask on a Matrix is a
        # row or column assignment's (GrB_Row_assign / GrB_Col_assign)
        cmask_vec = None
        if mask is not None:
            m_ndim = mask.parent.ndim
            if is_submask:
                if region_ndim == 0:
                    raise TypeError("Single element assign does not accept "
                                    "a submask")
                if m_ndim != region_ndim:
                    if m_ndim == 2:
                        raise TypeError("Indices for subassign imply Vector "
                                        "submask, but got Matrix mask "
                                        "instead")
                    raise TypeError("Indices for subassign imply Matrix "
                                    "submask, but got Vector mask instead")
            elif self.ndim == 2 and m_ndim == 1:
                if region_ndim == 0:
                    raise TypeError("Unable to use Vector mask on single "
                                    "element assignment to a Matrix")
                if region_ndim == 2:
                    raise TypeError("Unable to use Vector mask on Matrix "
                                    "assignment to a Matrix")
                cmask_vec = "row" if axes[0].is_scalar else "col"
                need = self.shape[1] if cmask_vec == "row" else self.shape[0]
                if mask.parent.shape[0] != need:
                    raise DimensionMismatch(
                        f"mask size {mask.parent.shape[0]} does not match "
                        f"{'ncols' if cmask_vec == 'row' else 'nrows'} "
                        f"{need}")
        kw = dict(mask=mask, accum=accum, replace=replace,
                  is_submask=is_submask, cmask_vec=cmask_vec)
        if (isinstance(value, tuple) and self.dtype._is_udt
                and self.dtype.np_type.names is not None):
            # a struct element from a tuple, by numpy's struct rule
            value = np.array(value, dtype=self.dtype.np_type)[()]
        if isinstance(value, Scalar) or is_scalar_like(value):
            if not isinstance(value, Scalar):
                value = Scalar.from_value(value)
            execute.assign_update(self, axes, value, value_is_scalar=True,
                                  **kw)
            return
        if not isinstance(value, BaseType):
            if not isinstance(value, (list, np.ndarray)):
                raise TypeError(f"Bad type for assignment value: "
                                f"{type(value)}")
            arr = np.asarray(value)
            value = (Vector if arr.ndim == 1 else Matrix).from_dense(arr)
        region_shape = resolver.out_shape
        if value.ndim != len(region_shape):
            raise TypeError(f"Assignment value has wrong rank: {value.ndim} "
                            f"for region rank {len(region_shape)}")
        if tuple(value.shape) != region_shape:
            raise DimensionMismatch(
                f"Assignment value shape {value.shape} does not match region "
                f"shape {region_shape}")
        if self.ndim == 2 and value.ndim == 1:
            # a row (or column) of the region: a 1 x C (or R x 1) matrix
            row = axes[0].is_scalar
            value = Matrix._from_planes(
                value.dtype, value._vals[None, :] if row else
                value._vals[:, None],
                value._valid[None, :] if row else value._valid[:, None])
        execute.assign_update(self, axes, value, value_is_scalar=False, **kw)

    def _delete_at(self, resolver, mask=None):
        from . import execute

        execute.delete_region(self, resolver.indices, mask=mask)
