"""Bitmap (values, valid) helpers over tensors: the parts of
graphblas_tpu/core/engine/dense.py that PageRank and BFS touch (masks,
apply, reduce and the mask/accum/replace write-back)."""

import torch

from .. import dtypes as _dt
from . import store as st


def truthy(vals, dtype):
    return vals if dtype.is_bool else vals != 0


def mask_array(m_vals, m_valid, m_dtype, structure, complement):
    arr = m_valid if structure else m_valid & truthy(m_vals, m_dtype)
    return ~arr if complement else arr


def apply_binop(op, x_vals, x_dt, y_vals, y_dt):
    """Apply a typed BinaryOp with casting; result in op.return_type."""
    x = st.cast_values(x_vals, x_dt, op.type)
    y = st.cast_values(y_vals, y_dt, op.type2)
    return op(x, y)


def apply_unop(op, x_vals, x_dt):
    return op(st.cast_values(x_vals, x_dt, op.type))


def apply_op(a_vals, a_valid, op, a_dt):
    return apply_unop(op, a_vals, a_dt), a_valid


def reduce_monoid(vals, valid, mono, in_dt):
    """Monoid-reduce a vector to a 0-d (value, valid) pair."""
    x = st.cast_values(vals, in_dt, mono.type)
    ident = st.identity_value_array(mono, mono.type, x.device)
    x = torch.where(valid, x, ident)
    name = mono.parent.name
    if name == "plus":
        red = x.sum()
    elif name == "times":
        red = x.prod()
    elif name in ("min", "land"):
        red = x.min() if x.numel() else ident
    elif name in ("max", "lor"):
        red = x.max() if x.numel() else ident
    else:
        # band/bor have no torch reduction: halve with the monoid
        red = x
        while red.numel() > 1:
            if red.numel() % 2:
                red = torch.cat([red, ident.reshape(1)])
            red = mono.binaryop(red[0::2], red[1::2])
        red = red[0] if red.numel() else ident
    return _dt.normalize(red, mono.type), valid.any()


def write_back(c_vals, c_valid, c_dt, z_vals, z_valid, z_dt, mask_arr, accum,
               replace):
    """GraphBLAS write-back of z into c under mask, accum and replace."""
    if accum is not None:
        both = c_valid & z_valid
        cz = st.cast_values(c_vals, c_dt, accum.type)
        zz = st.cast_values(z_vals, z_dt, accum.type2)
        merged = st.cast_values(accum(cz, zz), accum.return_type, c_dt)
        z_cast = st.cast_values(z_vals, z_dt, c_dt)
        new_vals = torch.where(both, merged, torch.where(z_valid, z_cast, c_vals))
        new_valid = c_valid | z_valid
    else:
        new_vals = torch.where(z_valid, st.cast_values(z_vals, z_dt, c_dt),
                               c_vals)
        new_valid = z_valid
    if mask_arr is None:
        return new_vals, new_valid
    if replace:
        out_valid = mask_arr & new_valid
    else:
        out_valid = torch.where(mask_arr, new_valid, c_valid)
    out_vals = torch.where(mask_arr & new_valid, new_vals, c_vals)
    return out_vals, out_valid


def subassign(c_vals, c_valid, c_dt, z_vals, z_valid, z_dt, region,
              submask_arr, accum, replace):
    """GxB_subassign semantics: mask & replace scoped to the region."""
    z_cast = st.cast_values(z_vals, z_dt, c_dt)
    if accum is not None:
        both = c_valid & z_valid
        cz = st.cast_values(c_vals, c_dt, accum.type)
        zz = st.cast_values(z_vals, z_dt, accum.type2)
        merged = st.cast_values(accum(cz, zz), accum.return_type, c_dt)
        new_vals = torch.where(both, merged, torch.where(z_valid, z_cast, c_vals))
        new_valid = torch.where(region, c_valid | z_valid, c_valid)
    else:
        new_vals = torch.where(z_valid, z_cast, c_vals)
        new_valid = torch.where(region, z_valid, c_valid)
    write = region if submask_arr is None else region & submask_arr
    out_vals = torch.where(write, new_vals, c_vals)
    out_valid = torch.where(write, new_valid, c_valid)
    if replace and submask_arr is not None:
        out_valid = torch.where(region & ~submask_arr, False, out_valid)
    return out_vals, out_valid
