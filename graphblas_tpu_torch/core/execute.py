"""The funnel every operation goes through: compute an expression's
(values, valid), then write it back into its target under mask, accum and
replace (graphblas_tpu/core/execute.py ``materialize``/``update_into`` and
the mxv/vxm and row/column reduce branches of ``_inline_sparse_impl``).  PyTorch runs eagerly, so
there is no jit cache and no recorder."""

import torch

from .engine import dense, lanepipe, sortpipe
from .operator.base import typed


def as_expr(obj):
    """An expression, or a collection to copy (``c << v``)."""
    from .base import BaseExpression

    if isinstance(obj, BaseExpression):
        return obj
    from .vector import Vector

    if isinstance(obj, Vector):
        return BaseExpression("identity", None, [obj], obj.dtype, obj.shape,
                              Vector)
    raise TypeError(f"cannot assign {type(obj).__name__} with <<")


def materialize(expr, out_dtype, *, mask=None, name=None):
    out = expr.output_type._empty(out_dtype, expr.shape, name=name)
    update_into(out, expr, mask=mask)
    return out


def update_into(target, expr, *, mask=None, accum=None, replace=False):
    if tuple(target.shape) != tuple(expr.shape):
        raise ValueError(f"shape mismatch: {target.shape} << {expr.shape}")
    z_vals, z_valid = compute(expr)
    mask_arr = None if mask is None else mask._as_array()
    typed_accum = None if accum is None else typed(accum, target.dtype,
                                                   "BinaryOp")
    vals, valid = dense.write_back(target._vals, target._valid, target.dtype,
                                   z_vals, z_valid, expr.dtype, mask_arr,
                                   typed_accum, replace)
    target._set_store(vals, valid)


def assign_scalar(target, value, *, mask=None, accum=None, replace=False):
    """``target(mask, accum, replace)[:] = value`` for a Python value or a
    Scalar (an empty Scalar deletes the elements it is assigned to)."""
    from .scalar import Scalar

    dev = target.device
    if isinstance(value, Scalar):
        z_dt, z_val, z_ok = value.dtype, value._vals, value._valid
    else:
        s = Scalar.from_value(value, target.dtype)
        z_dt, z_val, z_ok = s.dtype, s._vals, s._valid
    shape = target._valid.shape
    z_vals = z_val.to(dev).expand(shape)
    z_valid = z_ok.to(dev).expand(shape)
    region = torch.ones(shape, dtype=torch.bool, device=dev)
    typed_accum = None if accum is None else typed(accum, target.dtype,
                                                   "BinaryOp")
    vals, valid = dense.subassign(
        target._vals, target._valid, target.dtype, z_vals, z_valid, z_dt,
        region, None if mask is None else mask._as_array(), typed_accum,
        replace)
    target._set_store(vals, valid)


def compute(expr):
    """(values, valid) of an expression, in expr.dtype."""
    m = expr.method_name
    a = expr.args[0]
    if m in ("mxv", "vxm"):
        return _inline_sparse_impl(expr)
    if m in ("reduce_rowwise", "reduce_columnwise"):
        return _reduce_axis_impl(expr)
    if m == "identity":
        return a._vals, a._valid
    if m == "apply":
        return dense.apply_op(a._vals, a._valid, expr.op, a.dtype)
    if m == "reduce":
        vals, valid = dense.reduce_monoid(a._vals, a._valid, expr.op,
                                          a.dtype)
        if not expr._statics[0]:  # allow_empty=False: identity when empty
            valid = torch.ones((), dtype=torch.bool, device=valid.device)
        return vals, valid
    if m == "extract_element":
        i = expr._statics[0]
        return a._vals[i], a._valid[i]
    raise NotImplementedError(f"{m} is not in the PyTorch port yet")


def _empty_result(expr, dev):
    n_out = expr.shape[0]
    return (torch.zeros(n_out, dtype=expr.dtype.torch_type, device=dev),
            torch.zeros(n_out, dtype=torch.bool, device=dev))


def _inline_sparse_impl(expr):
    """mxv/vxm of a sparse matrix and a dense vector: through the lanepipe,
    or through the sort pipeline when the matrix packs over
    ``lanepipe.PACK_LIMIT``."""
    m = expr.method_name
    tflag = expr._statics[0]
    mat, vec = (expr.args[0], expr.args[1]) if m == "mxv" else \
        (expr.args[1], expr.args[0])
    sp = mat._sparse
    ring = expr.op
    if sp.nvals() == 0:
        return _empty_result(expr, vec.device)
    if not lanepipe.eligible(ring, mat.dtype, vec.dtype):
        raise NotImplementedError(
            f"{m} with {ring!r} on {mat.dtype}/{vec.dtype} needs the generic "
            f"SpMV engine (FP64, UDT and other monoids): ROADMAP.md queue 1, "
            f"item 9")
    entry = lanepipe.get_plan(sp, m == "mxv", at=bool(tflag),
                              device=vec.device)
    if entry is None:
        entry = sortpipe.get_plan(sp, m == "mxv", at=bool(tflag),
                                  device=vec.device)
        return sortpipe.spmv_pipeline(
            sortpipe.plan_dyn_tuple(entry), vec._vals, vec._valid, ring,
            mat.dtype, vec.dtype, kind=m, n_in=entry["n_in"], L=entry["L"])
    return lanepipe.spmv_pipeline(
        lanepipe.plan_dyn_tuple(entry), entry, vec._vals, vec._valid, ring,
        mat.dtype, vec.dtype, kind=m)


def _reduce_axis_impl(expr):
    """Row/column monoid reduce of a sparse matrix through the sort
    pipeline's destination side."""
    mat = expr.args[0]
    axis, tflag = expr._statics
    sp = mat._sparse
    mono = expr.op
    dev = mat._device
    if sp.nvals() == 0:
        return _empty_result(expr, dev)
    if not sortpipe.eligible_reduce(mono, mat.dtype):
        raise NotImplementedError(
            f"{expr.method_name} with {mono!r} on {mat.dtype} needs the "
            f"generic sparse.reduce_axis (FP64, UDT and other monoids): "
            f"ROADMAP.md queue 1, item 9")
    # axis=1 reduces rows (dest=row); axis=0 reduces columns
    entry = sortpipe.get_plan(sp, axis == 1, at=bool(tflag), device=dev)
    return sortpipe.reduce_pipeline(sortpipe.plan_dyn_tuple(entry), mono,
                                    mat.dtype)
