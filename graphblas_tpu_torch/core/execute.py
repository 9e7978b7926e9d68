"""The funnel every operation goes through: compute an expression's
(values, valid), then write it back into its target under mask, accum and
replace (graphblas_tpu/core/execute.py ``materialize``/``update_into``,
``_format_plan`` and the trace implementations ``T_*``).  PyTorch runs
eagerly, so there is no jit cache and no recorder."""

import torch

from . import dtypes as _dt
from .engine import dense, lanepipe, sortpipe
from .engine import store as st
from .operator.base import typed


def as_expr(obj):
    """An expression, or a collection to copy (``c << v``, ``C << A.T``)."""
    from .base import BaseExpression, BaseType
    from .matrix import TransposedMatrix

    if isinstance(obj, BaseExpression):
        return obj
    if isinstance(obj, TransposedMatrix):
        m = obj._matrix
        return BaseExpression("transpose", None, [m], m.dtype, obj.shape,
                              type(m))
    if isinstance(obj, BaseType) and obj.ndim:
        return BaseExpression("identity", None, [obj], obj.dtype, obj.shape,
                              type(obj))
    raise TypeError(f"cannot assign {type(obj).__name__} with <<")


def materialize(expr, out_dtype, *, mask=None, name=None):
    out = expr.output_type._empty(out_dtype, expr.shape, name=name)
    update_into(out, expr, mask=mask)
    return out


def update_into(target, expr, *, mask=None, accum=None, replace=False):
    if tuple(target.shape) != tuple(expr.shape):
        from ..exceptions import DimensionMismatch

        raise DimensionMismatch(
            f"shape mismatch: {target.shape} << {expr.shape}")
    if mask is not None and tuple(mask.parent.shape) != tuple(target.shape):
        from ..exceptions import DimensionMismatch

        raise DimensionMismatch(
            f"mask shape {mask.parent.shape} does not match output shape "
            f"{target.shape}")
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


# --------------------------------------------------------------------- #
# sparse-format planning.  Sparse-backed operands take the SpMV engines
# for mxv, vxm and the row/column reduces; everything else densifies them
# first, guarded by the dense_limit config in BaseType._densify.
def _sp_args(expr):
    return [a for a in expr.args if getattr(a, "_sparse", None) is not None]


def _format_plan(expr):
    """How to execute given the operands' current backings.

    None      -- all dense, the normal path.
    "inline"  -- a sparse matrix operand, dense result: the lanepipe or the
                 sort pipeline.
    "sparse"  -- the result is itself sparse: SpGEMM, not ported.
    "densify" -- no sparse path; densify the sparse operands and go dense.

    The JAX package also sends ``mxm`` with a traced dense operand (loop
    state inside its ``ss.iterate``) to "densify"; nothing is traced here,
    so that branch has no counterpart.
    """
    if not _sp_args(expr):
        return None
    m = expr.method_name
    if m in ("mxv", "vxm", "reduce_rowwise", "reduce_columnwise"):
        return "inline"
    if m == "mxm":
        return "sparse"
    return "densify"


def compute(expr):
    """(values, valid) of an expression, in expr.dtype."""
    plan = _format_plan(expr)
    m = expr.method_name
    if plan == "sparse":
        raise NotImplementedError(
            "mxm with a sparse-backed operand is SpGEMM, which is not in "
            "the PyTorch port yet (ROADMAP.md queue 1, item 10); a Matrix "
            "of at most auto_sparse_limit elements is dense-backed and "
            "multiplies through the dense engine")
    if plan == "inline":
        if m in ("mxv", "vxm"):
            return _inline_sparse_impl(expr)
        return _reduce_axis_impl(expr)
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
    vals, valid = _store(a, expr.method_name == "transpose")
    return st.cast_values(vals, a.dtype, expr.dtype), valid


def T_apply(expr):
    a = expr.args[0]
    return dense.apply_op(a._vals, a._valid, expr.op, a.dtype)


def T_reduce_scalar(expr):
    a = expr.args[0]
    vals, valid = dense.reduce_monoid(a._vals, a._valid, expr.op, a.dtype)
    if not expr._statics[0]:  # allow_empty=False: identity when empty
        ident = st.identity_value_array(expr.op, expr.op.type, vals.device)
        if ident is not None:
            vals = torch.where(valid, vals, ident)
        valid = torch.ones((), dtype=torch.bool, device=valid.device)
    return vals, valid


def T_reduce_axis(expr):
    a = expr.args[0]
    axis, tflag = expr._statics
    vals, valid = _store(a, tflag)
    return dense.reduce_monoid(vals, valid, expr.op, a.dtype, axis)


def T_extract_element(expr):
    a = expr.args[0]
    i = expr._statics[0]
    return a._vals[i], a._valid[i]


def T_matmul(expr):
    """mxm, and mxv/vxm/inner of dense-backed operands as products with a
    one-column or one-row matrix."""
    kind = expr.method_name
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
    variant, at, bt = expr._statics[:3]
    a, b = expr.args
    a_vals, a_valid = _store(a, at)
    b_vals, b_valid = _store(b, bt)
    if variant == "mult":
        return dense.ewise_mult(a_vals, a_valid, b_vals, b_valid, expr.op,
                                a.dtype, b.dtype)
    if variant == "add":
        return dense.ewise_add(a_vals, a_valid, b_vals, b_valid, expr.op,
                               a.dtype, b.dtype, expr.dtype)
    ldef, rdef = expr._statics[3:]
    dev = a_valid.device
    return dense.ewise_union(a_vals, a_valid, b_vals, b_valid, expr.op,
                             a.dtype, b.dtype, ldef._vals.to(dev),
                             rdef._vals.to(dev))


def T_diag_extract(expr):
    a = expr.args[0]
    k, tflag = expr._statics
    vals, valid = _store(a, tflag)
    return dense.diag_extract(vals, valid, k)


def T_diag_build(expr):
    v = expr.args[0]
    k, n = expr._statics
    return dense.diag_build(v._vals, v._valid, k, n)


_DENSE_IMPL = {
    "identity": T_copy, "transpose": T_copy, "apply": T_apply,
    "reduce": T_reduce_scalar, "reduce_rowwise": T_reduce_axis,
    "reduce_columnwise": T_reduce_axis,
    "extract_element": T_extract_element, "mxm": T_matmul, "mxv": T_matmul,
    "vxm": T_matmul, "inner": T_matmul, "power": T_power,
    "ewise_mult": T_ewise, "ewise_add": T_ewise, "ewise_union": T_ewise,
    "diag": T_diag_extract, "diag_build": T_diag_build,
}


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
        raise NotImplementedError(
            f"{m} with {ring!r} on {k_dt}/{u_dt} needs the generic "
            f"SpMV engine (FP64, UDT and other monoids): ROADMAP.md queue 1, "
            f"item 9")
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
    pipeline's destination side."""
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
        raise NotImplementedError(
            f"{expr.method_name} with {mono!r} on {in_dt} needs the "
            f"generic sparse.reduce_axis (FP64, UDT and other monoids): "
            f"ROADMAP.md queue 1, item 9")
    # axis=1 reduces rows (dest=row); axis=0 reduces columns
    _, dyn = _plan(sortpipe, sp, in_dt, truth_of, dest_is_row=axis == 1,
                   at=bool(tflag), device=dev)
    return sortpipe.reduce_pipeline(dyn, mono, k_dt)
