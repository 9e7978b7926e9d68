"""The funnel every operation goes through: compute an expression, then
write it back into its target under mask, accum and replace
(graphblas_tpu/core/execute.py ``materialize``/``update_into``,
``_format_plan``, ``_sparse_out_run``, ``_spgemm_run``, ``assign_update``,
``delete_region`` and the trace implementations ``T_*``).  A dense result
is a (values, valid) pair; a sparse one, of an operation on sparse-backed
matrices, is a SparseStore, merged into a sparse target at coordinates
(``sparse.write_back_sparse``).  Each dispatch writes one line to an
active Recorder (core/recorder.py) where the JAX package writes it, and
waits for the card after ``init(blocking=True)``.  PyTorch runs eagerly,
so there is no jit cache; the distributed branches of the JAX package are
ROADMAP.md queue 1, item 13."""

import torch

from . import config as _config
from . import dtypes as _dt
from .engine import dense, lanepipe, sortpipe
from .engine import sparse as spx
from .engine import store as st
from .operator.base import typed
from .opts import validate_opts
from .recorder import record


def as_expr(obj):
    """An expression, a collection to copy (``c << v``, ``C << A.T``) or an
    extract (``c << v[idx]``)."""
    from .base import BaseExpression, BaseType
    from .expr import AmbiguousAssignOrExtract
    from .matrix import TransposedMatrix

    if isinstance(obj, BaseExpression):
        return obj
    if isinstance(obj, AmbiguousAssignOrExtract):
        return obj._as_extract_expr()
    if isinstance(obj, TransposedMatrix):
        m = obj._matrix
        return BaseExpression("transpose", None, [m], m.dtype, obj.shape,
                              type(m))
    if isinstance(obj, BaseType) and obj.ndim:
        return BaseExpression("identity", None, [obj], obj.dtype, obj.shape,
                              type(obj))
    raise TypeError(f"cannot assign {type(obj).__name__} with <<")


def materialize(expr, out_dtype, *, mask=None, name=None, opts=None):
    opts = validate_opts(opts)
    if mask is None and _format_plan(expr) == "sparse":
        record(lambda: _record_line(None, expr, None, None, False))
        sp = _sparse_out_run(expr, out_dtype, opts=opts)
        _wait(sp.vals)
        return expr.output_type._from_sparse(out_dtype, sp, name=name)
    out = expr.output_type._empty(out_dtype, expr.shape, name=name)
    update_into(out, expr, mask=mask, opts=opts)
    return out


def update_into(target, expr, *, mask=None, accum=None, replace=False,
                opts=None):
    if tuple(target.shape) != tuple(expr.shape):
        from ..exceptions import DimensionMismatch

        raise DimensionMismatch(
            f"shape mismatch: {target.shape} << {expr.shape}")
    if mask is not None and tuple(mask.parent.shape) != tuple(target.shape):
        from ..exceptions import DimensionMismatch

        raise DimensionMismatch(
            f"mask shape {mask.parent.shape} does not match output shape "
            f"{target.shape}")
    opts = validate_opts(opts)
    plan = _format_plan(expr)
    typed_accum = None if accum is None else typed(accum, target.dtype,
                                                   "BinaryOp")
    record(lambda: _record_line(target, expr, mask, accum, replace))
    if plan == "sparse":
        _update_sparse(target, expr, mask, typed_accum, replace, opts)
    else:
        z_vals, z_valid = compute(expr, plan)
        mask_arr = None if mask is None else mask._as_array()
        target._set_store(*dense.write_back(
            target._vals, target._valid, target.dtype, z_vals, z_valid,
            expr.dtype, mask_arr, typed_accum, replace))
    _wait(target._d_valid if target._sparse is None else target._sparse.vals)


def _wait(t):
    """After init(blocking=True), wait for the card to finish."""
    from . import _blocking

    if _blocking and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _record_line(target, expr, mask, accum, replace):
    """The Recorder's line for one dispatch (the JAX package's text):
    ``method(target, mask=M.S, accum=plus, replace=True, op=..., args)``;
    a mask prints by its parent's name, never by its repr."""
    from .base import BaseType

    tname = getattr(target, "name", None) or (
        type(target).__name__ if target is not None else "_")
    opname = getattr(expr.op, "name", expr.op) if expr.op is not None \
        else None
    parts = [f"{expr.method_name}({tname}"]
    if mask is not None:
        pname = getattr(mask.parent, "name", None) or "M"
        kind = "S" if mask.structure else "V"
        parts.append(f"mask={'~' if mask.complement else ''}{pname}.{kind}")
    if accum is not None:
        parts.append(f"accum={getattr(accum, 'name', accum)}")
    if replace:
        parts.append("replace=True")
    if opname is not None:
        parts.append(f"op={opname}")
    for a in expr.args:
        if isinstance(a, BaseType):
            parts.append(getattr(a, "name", None) or type(a).__name__)
    return ", ".join(parts) + ")"


def _update_sparse(target, expr, mask, accum, replace, opts):
    """Write a sparse result into its target (graphblas_tpu/core/
    execute.py update_into, the "sparse" plan): a sparse target is merged
    at the union of the coordinates, with the mask evaluated there; a
    dense-backed target takes the densified result."""
    c_dt = target.dtype
    if mask is None and accum is None:
        target._set_sparse_store(_sparse_out_run(expr, c_dt, opts=opts))
        return
    z_dt = c_dt if accum is None else expr.dtype
    z_sp = _sparse_out_run(expr, z_dt, mask=mask, opts=opts)
    if target._sparse is not None:
        target._set_sparse_store(spx.write_back_sparse(
            target._sparse, z_sp, c_dt, z_dt, accum, replace,
            _coord_mask_fn(mask)))
        return
    z_vals, z_valid = spx.densify(z_sp, z_dt, target.device)
    mask_arr = None if mask is None else mask._as_array()
    vals, valid = dense.write_back(target._vals, target._valid, c_dt, z_vals,
                                   z_valid, z_dt, mask_arr, accum, replace)
    target._set_store(vals, valid)


# --------------------------------------------------------------------- #
# assign and delete by index lists (graphblas_tpu/core/execute.py
# assign_update, _assign_sparse_target, delete_region)
def _index_tensors(axes, device):
    return [torch.from_numpy(ix.array()).to(device) for ix in axes]


def _assign_accum(accum, c_dt, v_dt):
    """An assign's accum, typed for both operands' types (numpy's
    promotion, as the JAX package's ``get_typed_op``)."""
    return None if accum is None else typed(accum, _dt.unify(c_dt, v_dt),
                                            "BinaryOp")


def assign_update(target, axes, value, *, mask=None, accum=None,
                  replace=False, is_submask=False, value_is_scalar=False,
                  cmask_vec=None):
    """``target(mask, accum, replace)[axes] << value``: GrB_assign, or
    GxB_subassign (is_submask: the mask is shaped like the region, and it
    and replace act inside the region only).  axes: the target's resolved
    AxisIndex list; value: a Scalar (value_is_scalar) or a collection of
    the region's shape.  A sparse target stays sparse (_assign_sparse_
    target) except for a Vector mask on a row or column, an index list with
    duplicates and a dense value over ``dense_limit`` elements, which take
    the dense path as in the JAX package."""
    if target._sparse is not None and cmask_vec is None and \
            _assign_sparse_target(target, axes, value, mask=mask,
                                  accum=accum, replace=replace,
                                  is_submask=is_submask,
                                  value_is_scalar=value_is_scalar):
        return
    c_dt, v_dt = target.dtype, value.dtype
    typed_accum = _assign_accum(accum, c_dt, v_dt)
    c_vals, c_valid = target._vals, target._valid
    dev = c_valid.device
    shape = tuple(target.shape)
    z_vals = st.cast_values(value._vals.to(dev), v_dt, c_dt)
    z_valid = value._valid.to(dev)
    mask_arr = None if mask is None else mask._as_array()
    if all(ix.is_full for ix in axes):
        # the region is the whole target: no scatter, and the assign is
        # the subassign of the whole (one pass, as the BFS level needs)
        region = torch.ones((), dtype=torch.bool, device=dev)
        s_vals, s_valid = z_vals.expand(shape), z_valid.expand(shape)
        if mask_arr is not None and mask_arr.shape != shape:
            mask_arr = mask_arr.reshape(shape)  # a Vector mask on one row
        vals, valid = dense.subassign(c_vals, c_valid, c_dt, s_vals, s_valid,
                                      c_dt, region, mask_arr, typed_accum,
                                      replace)
        target._set_store(vals, valid)
        return
    idx = _index_tensors(axes, dev)
    if len(idx) == 2:
        s_vals, s_valid, region = dense.scatter_matrix(
            shape, idx[0], idx[1], z_vals, z_valid, c_dt)
    else:
        s_vals, s_valid, region = dense.scatter_vector(
            shape[0], idx[0], z_vals, z_valid, c_dt)
    if is_submask:
        sm = None
        if mask_arr is not None:  # the region's mask, placed in C
            sm = torch.zeros(shape, dtype=torch.bool, device=dev)
            if len(idx) == 2:
                sm[idx[0][:, None], idx[1][None, :]] = mask_arr.reshape(
                    len(idx[0]), len(idx[1]))
            else:
                sm[idx[0]] = mask_arr
        vals, valid = dense.subassign(c_vals, c_valid, c_dt, s_vals, s_valid,
                                      c_dt, region, sm, typed_accum, replace)
        target._set_store(vals, valid)
        return
    # a mask shaped like C: the region's update first, then the mask over
    # C; a Vector mask on a row or column assign (GrB_Row_assign,
    # GrB_Col_assign) acts on that row or column only
    vals, valid = dense.subassign(c_vals, c_valid, c_dt, s_vals, s_valid,
                                  c_dt, region, None, typed_accum, False)
    if mask_arr is not None or replace:
        full = mask_arr
        if mask_arr is None or cmask_vec is not None:
            full = torch.ones(shape, dtype=torch.bool, device=dev)
            if cmask_vec == "row":
                full[idx[0][0], :] = mask_arr
            elif cmask_vec == "col":
                full[:, idx[1][0]] = mask_arr
        vals, valid = dense.write_back(c_vals, c_valid, c_dt, vals, valid,
                                       c_dt, full, None, replace)
    target._set_store(vals, valid)


def _submask_fn(mask, rows, cols, nrows, ncols):
    """A region-shaped mask (GxB_subassign) evaluated at C's coordinates:
    each coordinate's place in the region from inverse maps; False outside
    the region."""
    n_r, n_c = rows.numel(), cols.numel()
    dev = rows.device
    inv_r = torch.full((nrows,), n_r, dtype=torch.int64, device=dev)
    inv_r[rows] = torch.arange(n_r, dtype=torch.int64, device=dev)
    inv_c = torch.full((ncols,), n_c, dtype=torch.int64, device=dev)
    inv_c[cols] = torch.arange(n_c, dtype=torch.int64, device=dev)
    if mask.parent.ndim == 2:
        at = _coord_mask_fn(mask)
    else:
        arr = mask._as_array()

        def at(rr, cc):
            # a Vector submask runs along the region's one long axis
            return arr[rr if n_c == 1 else cc]

    def fn(r, c):
        rr, cc = inv_r[r], inv_c[c]
        inside = (rr < n_r) & (cc < n_c)
        return at(rr.clamp(max=n_r - 1), cc.clamp(max=n_c - 1)) & inside

    return fn


def _assign_sparse_target(target, axes, value, *, mask, accum, replace,
                          is_submask, value_is_scalar):
    """GrB_assign / GxB_subassign onto a sparse-backed Matrix on the
    sparse engine: the region's content as a store at C's coordinates,
    merged into C.  Returns False, for the dense path, where an index list
    repeats or a dense value would span more than ``dense_limit``
    elements (one device read of each count: the region's content and the
    result)."""
    rix, cix = axes
    if not (rix.is_unique and cix.is_unique):
        return False
    n_r, n_c = len(rix.array()), len(cix.array())
    limit = int(_config.config.get("dense_limit", 1 << 26))
    value_sparse = not value_is_scalar and value._sparse is not None
    if not value_sparse and n_r * n_c > limit:
        return False
    c_sp = target._sparse
    c_dt, v_dt = target.dtype, value.dtype
    typed_accum = _assign_accum(accum, c_dt, v_dt)
    dev = c_sp.device
    rows, cols = _index_tensors(axes, dev)
    in_order = rix.is_increasing and cix.is_increasing
    nrows, ncols = c_sp.nrows, c_sp.ncols
    if value_sparse:
        z = spx.placed_store(value._sparse, rows, cols, nrows, ncols,
                             in_order)
    else:
        z = spx.region_store(rows, cols, value._vals.to(dev),
                             value._valid.to(dev), nrows, ncols, v_dt,
                             in_order)
    if mask is None:
        mask_fn = None
    elif is_submask:
        mask_fn = _submask_fn(mask, rows, cols, nrows, ncols)
    else:
        mask_fn = _coord_mask_fn(mask)
    target._set_sparse_store(spx.assign_sparse(
        c_sp, z, c_dt, v_dt, typed_accum, bool(replace), mask_fn,
        spx.membership_fn(rows, cols, nrows, ncols), bool(is_submask)))
    return True


def delete_region(target, axes, *, mask=None):
    """``del C[axes]`` and ``del C(mask)[axes]``: the elements of the
    region (where the mask holds) are removed; a sparse target stays
    sparse."""
    if target._sparse is not None:
        c_sp = target._sparse
        rows, cols = _index_tensors(axes, c_sp.device)
        region = spx.membership_fn(rows, cols, c_sp.nrows, c_sp.ncols)(
            c_sp.rows, c_sp.cols)
        if mask is not None:
            region = region & _coord_mask_fn(mask)(c_sp.rows, c_sp.cols)
        target._set_sparse_store(spx.delete_where(c_sp, region))
        return
    valid = target._valid
    idx = _index_tensors(axes, valid.device)
    region = torch.zeros(valid.shape, dtype=torch.bool, device=valid.device)
    if len(idx) == 2:
        region[idx[0][:, None], idx[1][None, :]] = True
    else:
        region[idx[0]] = True
    if mask is not None:
        region = region & mask._as_array()
    target._set_store(target._vals, valid & ~region)


# --------------------------------------------------------------------- #
# sparse-format planning (graphblas_tpu/core/execute.py _format_plan)
def _sp_args(expr):
    return [a for a in expr.args if getattr(a, "_sparse", None) is not None]


_INLINE = ("mxv", "vxm", "reduce_rowwise", "reduce_columnwise", "reduce",
           "extract_element")
_SPARSE_OUT = ("identity", "transpose", "apply", "apply_bound",
               "apply_indexunary", "select", "mxm")


def _format_plan(expr):
    """How to execute given the operands' current backings.

    None      -- all dense, the normal path.
    "inline"  -- a sparse matrix operand, dense result: the lanepipe, the
                 sort pipeline or the generic sparse engine.
    "sparse"  -- the result is itself a sparse store.
    "densify" -- no sparse path (``power``, ``diag``, an element-wise add
                 or union with a dense operand, whose result is dense-sized
                 anyway, an extract by index lists that repeat or under an
                 input mask); densify the sparse operands and go dense.

    The JAX package also sends ``mxm`` with a traced dense operand (loop
    state inside its ``ss.iterate``) to "densify"; nothing is traced here,
    so that branch has no counterpart.
    """
    m = expr._kind
    if m == "outer":  # of dense vectors: sparse where the result is large
        n = expr.shape[0] * expr.shape[1]
        return "sparse" if n > int(_config.config.get(
            "auto_sparse_limit", 1 << 22)) else None
    if not _sp_args(expr):
        return None
    if m in _INLINE:
        return "inline"
    if m in _SPARSE_OUT:
        return "sparse"
    if m == "extract":
        pattern, axes, input_mask, _ = expr._statics
        if input_mask is not None:
            return "densify"
        if pattern == "mat":
            # duplicate-free lists take the sparse extract
            return "sparse" if all(ix.is_unique for ix in axes) else \
                "densify"
        return "inline"  # a row or column into a dense vector
    if m in ("ewise_mult", "ewise_add", "ewise_union"):
        a_bc, b_bc = expr._statics[3:5]
        if m == "ewise_mult":
            return "sparse"  # broadcast, sparse .* dense, or a merge
        if a_bc or b_bc:
            return "densify"
        if all(a._sparse is not None for a in expr.args):
            return "sparse"
    return "densify"


def compute(expr, plan=None):
    """(values, valid) of an expression whose result is dense, in
    expr.dtype."""
    plan = _format_plan(expr) if plan is None else plan
    m = expr._kind
    if plan == "inline":
        return _INLINE_IMPL[m](expr)
    if plan == "densify":
        for a in _sp_args(expr):
            a._densify()
    impl = _DENSE_IMPL.get(m)
    if impl is None:
        raise NotImplementedError(f"{m} is not in the PyTorch port yet")
    return impl(expr)


def _store(obj, transposed=False):
    if transposed:
        return dense.transpose(obj._vals, obj._valid)
    return obj._vals, obj._valid


def T_copy(expr):
    a = expr.args[0]
    vals, valid = _store(a, expr._kind == "transpose")
    return st.cast_values(vals, a.dtype, expr.dtype), valid


def _pos_for(op, valid):
    """The positions of valid's elements where op is positional (the JAX
    package's _pos_for), else None: no index tensor for the others."""
    if op._positional is None:
        return None
    return dense.pos_for(valid.shape, valid.device)


def T_apply(expr):
    a = expr.args[0]
    vals, valid = _store(a, expr._statics[-1])
    return dense.apply_op(vals, valid, expr.op, a.dtype,
                          pos=_pos_for(expr.op, valid))


def T_apply_bound(expr):
    a = expr.args[0]
    s_val, left, tflag = expr._statics
    vals, valid = _store(a, tflag)
    s_dt = expr.op.type if left else expr.op.type2
    return dense.apply_bound(vals, valid, expr.op, a.dtype, s_val, s_dt, left,
                             pos=_pos_for(expr.op, valid))


def T_apply_indexunary(expr):
    a = expr.args[0]
    thunk, _, is_matrix, tflag = expr._statics
    vals, valid = _store(a, tflag)
    return dense.apply_indexunary(vals, valid, expr.op, a.dtype, thunk,
                                  is_matrix)


def T_select(expr):
    a = expr.args[0]
    thunk, _, is_matrix, tflag = expr._statics
    vals, valid = _store(a, tflag)
    return dense.select_op(vals, valid, expr.op, a.dtype, thunk, is_matrix,
                           expr.dtype)


def _allow_empty(expr, vals, valid):
    if not expr._statics[0]:  # allow_empty=False: identity when empty
        ident = st.identity_value_array(expr.op, expr.op.type, vals.device)
        if ident is not None:
            vals = torch.where(valid, vals, ident)
        valid = torch.ones((), dtype=torch.bool, device=valid.device)
    return vals, valid


def T_reduce_scalar(expr):
    a = expr.args[0]
    return _allow_empty(expr, *dense.reduce_monoid(a._vals, a._valid,
                                                   expr.op, a.dtype))


def T_reduce_axis(expr):
    a = expr.args[0]
    axis, tflag = expr._statics
    vals, valid = _store(a, tflag)
    return dense.reduce_monoid(vals, valid, expr.op, a.dtype, axis)


def input_mask_axis(pattern, parent, input_mask):
    """Check an extract's input mask (graphblas_tpu/core/execute.py
    apply_input_mask); returns "row" or "col" for a Vector mask on a row or
    column of a Matrix, else None."""
    if pattern == "element":
        raise ValueError("There is no need to use `input_mask` for single "
                         "element extraction")
    m_shape = tuple(input_mask.parent.shape)
    if parent.ndim == 2 and len(m_shape) == 1:
        if pattern == "row":
            if m_shape[0] != parent.shape[1]:
                raise ValueError("Size of `input_mask` Vector does not match "
                                 "ncols of Matrix")
            return "row"
        if pattern == "col":
            if m_shape[0] != parent.shape[0]:
                raise ValueError("Size of `input_mask` Vector does not match "
                                 "nrows of Matrix")
            return "col"
        raise TypeError("Got Vector `input_mask` when extracting a submatrix "
                        "from a Matrix")
    if parent.ndim == 1 and len(m_shape) == 2:
        raise TypeError("Mask object must be type Vector")
    if m_shape != tuple(parent.shape):
        raise ValueError(f"Shape of `input_mask` does not match shape of "
                         f"input: {m_shape} vs {tuple(parent.shape)}")
    return None


def T_extract(expr):
    """Extract by index lists from a dense store ("mat", "row", "col",
    "vec"), after the input mask, if any, filters the source."""
    a = expr.args[0]
    pattern, axes, input_mask, vec_axis = expr._statics
    vals, valid = a._vals, a._valid
    if input_mask is not None:
        arr = input_mask._as_array()
        if vec_axis == "row":
            arr = arr[None, :]
        elif vec_axis == "col":
            arr = arr[:, None]
        valid = valid & arr
    idx = _index_tensors(axes, valid.device)
    if pattern == "vec":
        return dense.extract_vector(vals, valid, idx[0])
    v, ok = dense.extract_matrix(vals, valid, idx[0], idx[1])
    if pattern == "row":
        return v[0], ok[0]
    if pattern == "col":
        return v[:, 0], ok[:, 0]
    return v, ok


def T_extract_element(expr):
    a = expr.args[0]
    i = expr._statics[0]
    return a._vals[i], a._valid[i]


def T_matmul(expr):
    """mxm, and mxv/vxm/inner of dense-backed operands as products with a
    one-column or one-row matrix."""
    kind = expr._kind
    a, b = expr.args
    ring = expr.op
    if kind == "mxm":
        at, bt = expr._statics
        a_vals, a_valid = _store(a, at)
        b_vals, b_valid = _store(b, bt)
        return dense.semiring_matmul(a_vals, a_valid, b_vals, b_valid, ring,
                                     a.dtype, b.dtype)
    if kind == "mxv":
        a_vals, a_valid = _store(a, expr._statics[0])
        v, ok = dense.semiring_matmul(a_vals, a_valid, b._vals[:, None],
                                      b._valid[:, None], ring, a.dtype,
                                      b.dtype)
        return v[:, 0], ok[:, 0]
    if kind == "vxm":
        b_vals, b_valid = _store(b, expr._statics[0])
        v, ok = dense.semiring_matmul(a._vals[None, :], a._valid[None, :],
                                      b_vals, b_valid, ring, a.dtype, b.dtype)
        return v[0], ok[0]
    v, ok = dense.semiring_matmul(a._vals[None, :], a._valid[None, :],
                                  b._vals[:, None], b._valid[:, None], ring,
                                  a.dtype, b.dtype)
    return v[0, 0], ok[0, 0]


def T_power(expr):
    """Exponentiation by repeated squaring."""
    a = expr.args[0]
    ring = expr.op
    dt = expr.dtype
    result = None
    base = (st.cast_values(a._vals, a.dtype, dt), a._valid)
    e = expr._statics[0]
    while e > 0:
        if e & 1:
            result = base if result is None else dense.semiring_matmul(
                *result, *base, ring, dt, dt)
        e >>= 1
        if e:
            base = dense.semiring_matmul(*base, *base, ring, dt, dt)
    return result


def T_ewise(expr):
    variant, at, bt, a_bc, b_bc, ldef, rdef = expr._statics
    a, b = expr.args
    a_vals, a_valid = _store(a, at)
    b_vals, b_valid = _store(b, bt)
    if b_bc:  # a vector broadcast along the rows of the matrix operand
        b_vals, b_valid = b_vals.expand(a_valid.shape), \
            b_valid.expand(a_valid.shape)
    elif a_bc:
        a_vals, a_valid = a_vals.expand(b_valid.shape), \
            a_valid.expand(b_valid.shape)
    pos = _pos_for(expr.op, a_valid)
    if variant == "mult":
        return dense.ewise_mult(a_vals, a_valid, b_vals, b_valid, expr.op,
                                a.dtype, b.dtype, pos=pos)
    if variant == "add":
        return dense.ewise_add(a_vals, a_valid, b_vals, b_valid, expr.op,
                               a.dtype, b.dtype, expr.dtype, pos=pos)
    dev = a_valid.device
    return dense.ewise_union(a_vals, a_valid, b_vals, b_valid, expr.op,
                             a.dtype, b.dtype, ldef._vals.to(dev),
                             rdef._vals.to(dev), pos=pos)


def T_outer(expr):
    a, b = expr.args
    shape = expr.shape
    return dense.ewise_mult(
        a._vals[:, None].expand(shape), a._valid[:, None].expand(shape),
        b._vals[None, :].expand(shape), b._valid[None, :].expand(shape),
        expr.op, a.dtype, b.dtype,
        pos=None if expr.op._positional is None else
        dense.pos_for(shape, a._valid.device))


def T_diag_extract(expr):
    a = expr.args[0]
    k, tflag = expr._statics
    vals, valid = _store(a, tflag)
    return dense.diag_extract(vals, valid, k)


def T_diag_build(expr):
    v = expr.args[0]
    k, n = expr._statics
    return dense.diag_build(v._vals, v._valid, k, n)


def T_reduce_agg(expr):
    a = expr.args[0]
    agg = expr.op
    return dense.reduce_agg(a._vals, a._valid, agg.spec, a.dtype,
                            agg.return_type, expr._statics[0])


def T_kron(expr):
    a, b = expr.args
    at, bt = expr._statics
    return dense.kron(*_store(a, at), *_store(b, bt), expr.op, a.dtype,
                      b.dtype)


def T_reposition(expr):
    a = expr.args[0]
    return dense.reposition(a._vals, a._valid, expr._statics[0], expr.shape)


_DENSE_IMPL = {
    "identity": T_copy, "transpose": T_copy, "apply": T_apply,
    "apply_bound": T_apply_bound, "apply_indexunary": T_apply_indexunary,
    "select": T_select,
    "reduce": T_reduce_scalar, "reduce_rowwise": T_reduce_axis,
    "reduce_columnwise": T_reduce_axis,
    "extract_element": T_extract_element, "extract": T_extract,
    "mxm": T_matmul, "mxv": T_matmul,
    "vxm": T_matmul, "inner": T_matmul, "power": T_power,
    "ewise_mult": T_ewise, "ewise_add": T_ewise, "ewise_union": T_ewise,
    "diag": T_diag_extract, "diag_build": T_diag_build,
    "reduce_agg": T_reduce_agg, "kronecker": T_kron,
    "reposition": T_reposition, "outer": T_outer,
}


def _empty_result(expr, dev):
    n_out = expr.shape[0]
    return (st.zeros_values((n_out,), expr.dtype, dev),
            torch.zeros(n_out, dtype=torch.bool, device=dev))


def _inline_sparse_impl(expr):
    """mxv/vxm of a sparse matrix and a dense vector: through the lanepipe,
    or through the sort pipeline when the matrix packs over
    ``lanepipe.PACK_LIMIT``; the generic sparse engine takes every ring and
    type those two decline (FP64, INT64, monoids without a scan)."""
    m = expr._kind
    tflag = expr._statics[0]
    mat, vec = (expr.args[0], expr.args[1]) if m == "mxv" else \
        (expr.args[1], expr.args[0])
    sp = mat._sparse
    ring = expr.op
    if sp.nvals() == 0:
        return _empty_result(expr, vec.device)
    a_dt, u_dt, u_vals = mat.dtype, vec.dtype, vec._vals
    truth_of = None
    twin = ring.bool_twin()
    if twin is not None:  # lor_land["FP32"]: the BOOL ring on truth values
        mult = ring.binaryop
        truth_of = mult.type
        u_vals = dense.truthy(st.cast_values(u_vals, u_dt, mult.type),
                              mult.type)
        ring, u_dt = twin, _dt.BOOL
    k_dt = a_dt if truth_of is None else _dt.BOOL  # the matrix's, as computed
    if not lanepipe.eligible(ring, k_dt, u_dt):
        return spx.spmv(sp, bool(tflag), m, vec._vals, vec._valid, expr.op,
                        a_dt, vec.dtype)
    where = dict(dest_is_row=m == "mxv", at=bool(tflag), device=vec.device)
    entry, dyn = _plan(lanepipe, sp, a_dt, truth_of, **where)
    if entry is None:
        entry, dyn = _plan(sortpipe, sp, a_dt, truth_of, **where)
        return sortpipe.spmv_pipeline(
            dyn, u_vals, vec._valid, ring, k_dt, u_dt, kind=m,
            n_in=entry["n_in"], L=entry["L"])
    return lanepipe.spmv_pipeline(dyn, entry, u_vals, vec._valid, ring, k_dt,
                                  u_dt, kind=m)


# where plan_dyn_tuple puts the matrix's values
_VALS_AT = {lanepipe: 4, sortpipe: 5}


def _plan(pipe, sp, a_dt, truth_of, *, dest_is_row, at, device):
    """(entry, plan_dyn) of the matrix's plan in `pipe` (lanepipe or
    sortpipe); (None, None) where the lanepipe declines it.

    truth_of: for a logical ring or monoid over values of another type,
    the type whose truth values (after a cast of the matrix's values to
    it) take the place of the values, as BOOL.  They are computed once from
    the matrix's own plan and kept in its entry, so the plan's structure
    is shared.  No pipeline takes a 64-bit matrix itself, and its plan
    would carry its values on 32 bits: there the store's BOOL twin, made on
    the host, holds the only plans."""
    if truth_of is not None and a_dt.np_type.itemsize > 4:
        sp, truth_of = sp.bool_twin(truth_of), None
    entry = pipe.get_plan(sp, dest_is_row, at=at, device=device)
    if entry is None:
        return None, None
    dyn = pipe.plan_dyn_tuple(entry)
    if truth_of is None:
        return entry, dyn
    i = _VALS_AT[pipe]
    truth = entry.setdefault("truth", {})
    if truth_of not in truth:
        vals = st.cast_values(sortpipe.from_carrier(dyn[i], a_dt), a_dt,
                              truth_of)
        truth[truth_of] = (vals != 0).to(torch.int32)
    return entry, dyn[:i] + (truth[truth_of],) + dyn[i + 1:]


def _reduce_axis_impl(expr):
    """Row/column monoid reduce of a sparse matrix through the sort
    pipeline's destination side, or the generic sparse engine where that
    declines."""
    mat = expr.args[0]
    axis, tflag = expr._statics
    sp = mat._sparse
    mono = expr.op
    dev = mat._device
    in_dt = mat.dtype
    if sp.nvals() == 0:
        return _empty_result(expr, dev)
    # lor/land of another type: of the values' truth
    truth_of = in_dt if mono.type is _dt.BOOL and not in_dt.is_bool else None
    k_dt = in_dt if truth_of is None else _dt.BOOL
    if not sortpipe.eligible_reduce(mono, k_dt):
        return spx.reduce_axis(sp, bool(tflag), axis, mono, in_dt)
    # axis=1 reduces rows (dest=row); axis=0 reduces columns
    _, dyn = _plan(sortpipe, sp, in_dt, truth_of, dest_is_row=axis == 1,
                   at=bool(tflag), device=dev)
    return sortpipe.reduce_pipeline(dyn, mono, k_dt)


def _reduce_scalar_impl(expr):
    """reduce_scalar of a sparse matrix: the monoid over its values."""
    mat = expr.args[0]
    vals = mat._sparse.vals
    ok = torch.ones(vals.shape, dtype=torch.bool, device=vals.device)
    return _allow_empty(expr, *dense.reduce_monoid(vals, ok, expr.op,
                                                   mat.dtype))


def _extract_element_impl(expr):
    mat = expr.args[0]
    return spx.extract_element(mat._sparse, False, *expr._statics[0])


def _extract_rowcol_impl(expr):
    """A row or column of a sparse matrix into a dense vector."""
    mat = expr.args[0]
    pattern, (rix, cix), _, _ = expr._statics
    sp = mat._sparse
    (idx,) = _index_tensors([cix if pattern == "row" else rix], sp.device)
    fixed = rix.index if pattern == "row" else cix.index
    return spx.extract_rowcol_dense(sp, fixed, idx, pattern == "row")


_INLINE_IMPL = {"mxv": _inline_sparse_impl, "vxm": _inline_sparse_impl,
                "extract": _extract_rowcol_impl,
                "reduce_rowwise": _reduce_axis_impl,
                "reduce_columnwise": _reduce_axis_impl,
                "reduce": _reduce_scalar_impl,
                "extract_element": _extract_element_impl}


# --------------------------------------------------------------------- #
# sparse results (graphblas_tpu/core/execute.py _sparse_out_run,
# _spgemm_run; the distributed branches are ROADMAP.md queue 1, item 13)
def _sparsify(mat):
    """Give a dense-backed matrix a sparse backing (to meet a sparse
    operand of mxm)."""
    mat._set_sparse_store(spx.from_dense(mat._vals, mat._valid, mat.dtype))


def _coord_mask_fn(mask):
    """mask_fn(rows, cols) -> bool for evaluating a mask at sparse
    coordinates, or None.  A sparse parent is searched at the coordinates,
    never densified."""
    if mask is None:
        return None
    parent = mask.parent
    structure, complement, m_dt = mask.structure, mask.complement, \
        parent.dtype
    if parent._sparse is not None:
        msp = parent._sparse

        def fn(rows, cols):
            return spx.mask_at(msp, m_dt, structure, complement, rows, cols)

        return fn
    arr = mask._as_array()

    def fn(rows, cols):
        return spx.dense_mask_at(arr, rows, cols)

    return fn


def _sparse_out_run(expr, out_dtype, mask=None, opts=None):
    """Execute a "sparse"-plan expression; returns its SparseStore in
    out_dtype.  Only mxm reads the mask (it filters products before they
    are combined); the write-back applies it."""
    m = expr._kind
    z_dt = expr.dtype

    def cast(sp):
        return spx.cast_copy(sp, z_dt, out_dtype)

    if m == "mxm":
        return _mxm_run(expr, cast, mask, opts)
    if m.startswith("ewise_"):
        return cast(_ewise_run(expr))
    if m == "outer":
        a, b = expr.args
        return cast(spx.outer(a._vals, a._valid, b._vals, b._valid, expr.op,
                              a.dtype, b.dtype))
    src = expr.args[0]
    if m == "extract":
        axes = expr._statics[1]
        rows, cols = _index_tensors(axes, src.device)
        return cast(spx.extract_submatrix(
            src._sparse, rows, cols,
            all(ix.is_increasing for ix in axes)))
    sp = src._sparse
    tflag = m == "transpose" or (m != "identity" and expr._statics[-1])
    a = spx.transpose(sp) if tflag else sp
    if m in ("identity", "transpose"):
        return spx.cast_copy(a, src.dtype, out_dtype)
    if m == "apply":
        return cast(spx.apply_unary(a, expr.op, src.dtype))
    if m == "apply_bound":
        s_val, left, _ = expr._statics
        s_dt = expr.op.type if left else expr.op.type2
        return cast(spx.apply_bound(a, expr.op, src.dtype, s_val, s_dt, left))
    thunk = expr._statics[0]
    if m == "apply_indexunary":
        return cast(spx.apply_indexunary(a, expr.op, src.dtype, thunk))
    return spx.select_op(a, expr.op, src.dtype, thunk, out_dtype)


def _ewise_run(expr):
    """Element-wise operations with a sparse result, in expr.dtype."""
    variant, at, bt, a_bc, b_bc, ldef, rdef = expr._statics
    a, b = expr.args
    op, z_dt = expr.op, expr.dtype
    if a_bc or b_bc:  # a sparse matrix .* a vector broadcast along its rows
        mat, vec, mt = (a, b, at) if b_bc else (b, a, bt)
        m_sp = spx.transpose(mat._sparse) if mt else mat._sparse
        return spx.ewise_mult_vector_bcast(m_sp, op, mat.dtype, vec._vals,
                                           vec._valid, vec.dtype,
                                           vector_left=a_bc)
    a_sp, b_sp = a._sparse, b._sparse
    if a_sp is None or b_sp is None:  # sparse .* dense
        sparse_left = a_sp is not None
        s, d, st_, dt_ = (a, b, at, bt) if sparse_left else (b, a, bt, at)
        s_sp = spx.transpose(s._sparse) if st_ else s._sparse
        d_vals, d_valid = _store(d, dt_)
        return spx.ewise_mult_sparse_dense(s_sp, op, s.dtype, d_vals, d_valid,
                                           d.dtype, sparse_left=sparse_left)
    if a_sp.struct is b_sp.struct and at == bt:
        # one structure: element by element, the structure kept
        out = spx.ewise_same_structure(a_sp, b_sp, op, a.dtype, b.dtype,
                                       z_dt, transposed=at)
        return spx.transpose(out) if at else out
    ax = spx.transpose(a_sp) if at else a_sp
    bx = spx.transpose(b_sp) if bt else b_sp
    lr = None
    if variant == "union":
        lr = (ldef._vals.to(ax.device), rdef._vals.to(ax.device))
    return spx.merge_ewise(ax, bx, variant, op, a.dtype, b.dtype, z_dt, lr)


def _mxm_run(expr, cast, mask, opts):
    at, bt = expr._statics
    a, b = expr.args
    a_sp, b_sp = a._sparse, b._sparse
    left_diag = a_sp is not None and a_sp.is_diag
    if left_diag or (b_sp is not None and b_sp.is_diag):
        # row or column scaling by a diagonal
        other = b if left_diag else a
        if other._sparse is None:
            _sparsify(other)
        o_sp = other._sparse
        if bt if left_diag else at:
            o_sp = spx.transpose(o_sp)
        d_sp, d_dt = (a_sp, a.dtype) if left_diag else (b_sp, b.dtype)
        return cast(spx.mxm_diag(o_sp, d_sp, left_diag, expr.op, other.dtype,
                                 d_dt))
    return cast(_spgemm_run(expr, mask, opts))


_SPGEMM_RANGE = "spgemm:{}:terms={}:gustavson={}:dot={}"


def spgemm_record(name):
    """The choice that one of _spgemm_run's profiler ranges names, as a
    dict (formulation, terms, gustavson_terms, dot_terms; dot_terms is
    None where the dot was not a candidate); None for any other range."""
    parts = name.split(":")
    if len(parts) != 5 or parts[0] != "spgemm":
        return None
    nums = [None if v == "None" else int(v)
            for v in (p.split("=")[1] for p in parts[2:])]
    return dict(formulation=parts[1], terms=nums[0], gustavson_terms=nums[1],
                dot_terms=nums[2])


def _spgemm_run(expr, mask, opts):
    """Sparse x sparse mxm with the mask pushed down, in expr.dtype.  A
    mask that is sparse and not complemented can take the masked dot,
    whose work is bounded by the mask: one device read brings both
    expansion totals and the smaller wins, unless ``axb_method`` forces
    one.  The product runs inside a profiler range that names the choice
    (see spgemm_record)."""
    at, bt = expr._statics
    a, b = expr.args
    for x in (a, b):
        if x._sparse is None:
            _sparsify(x)
    a_sp, b_sp = a._sparse, b._sparse
    out_nrows = a_sp.ncols if at else a_sp.nrows
    out_ncols = b_sp.nrows if bt else b_sp.ncols
    k_dim = a_sp.nrows if at else a_sp.ncols
    ring, z_dt = expr.op, expr.dtype
    if 0 in (a_sp.nvals(), b_sp.nvals(), out_nrows, out_ncols):
        return spx.empty_store(out_nrows, out_ncols, z_dt, a_sp.device)
    method = ((opts or {}).get("axb_method") or "default").lower()
    dot = None
    if (mask is not None and not mask.complement
            and mask.parent._sparse is not None
            and method in ("default", "dot")):
        msp, m_dt = mask.parent._sparse, mask.parent.dtype
        gus, dot = spx.spgemm_dot_total(
            a_sp, b_sp, msp, m_dt, mask.structure, at, bt, out_nrows,
            out_ncols, k_dim).tolist()
        if method == "dot" or dot <= gus:
            with torch.profiler.record_function(
                    _SPGEMM_RANGE.format("dot", dot, gus, dot)):
                return spx.spgemm_masked_dot(
                    a_sp, b_sp, msp, at, bt, ring, a.dtype, b.dtype, m_dt,
                    mask.structure, out_nrows, out_ncols, k_dim, dot)
    else:
        gus = int(spx.spgemm_total(a_sp, b_sp, at, bt, k_dim))
    with torch.profiler.record_function(
            _SPGEMM_RANGE.format("gustavson", gus, gus, dot)):
        return spx.spgemm(a_sp, b_sp, at, bt, ring, a.dtype, b.dtype,
                          out_nrows, out_ncols, k_dim, gus,
                          _coord_mask_fn(mask))
