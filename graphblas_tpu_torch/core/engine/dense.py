"""Bitmap (values, valid) engine over tensors
(graphblas_tpu/core/engine/dense.py): masks, apply, element-wise
operations, monoid and aggregator reduces, the semiring matmul family,
the Kronecker product, transpose, diagonals and reposition, extract and
scatter by index lists, and the mask/accum/replace write-back and
subassign.

A positional operator takes its value from positions, given as the
``pos`` dict of int64 tensors that broadcast against the values: an
element's ``i`` and ``j`` (apply, element-wise operations, the
write-back's accum), or a product's ``i``, ``k`` and ``j`` for the pair
``a(i, k) b(k, j)``.  PyTorch runs eagerly, so the blocked product is a
Python loop where the JAX package traces a ``lax.scan``.
"""

import numpy as np
import torch

from .. import dtypes as _dt
from .. import trace as _trace
from . import store as st
from . import tropical


def truthy(vals, dtype):
    """The truth of each value; a user-defined type's value is true, as
    the JAX package's ``!= 0`` of a pytree is (a value mask over one acts
    as its structure)."""
    if dtype._is_udt:
        return torch.ones(vals.shape, dtype=torch.bool, device=vals.device)
    return vals if dtype.is_bool else vals != 0


def mask_array(m_vals, m_valid, m_dtype, structure, complement):
    arr = m_valid if structure else m_valid & truthy(m_vals, m_dtype)
    return ~arr if complement else arr


def _iota(shape, dim, device, start=0):
    """int64 index along `dim`, shaped to broadcast against `shape`."""
    view = [1] * len(shape)
    view[dim] = shape[dim]
    return torch.arange(start, start + shape[dim], dtype=torch.int64,
                        device=device).reshape(view)


def pos_for(shape, device):
    """The ``i`` and ``j`` of every element of a store of shape, as
    broadcast views (the JAX package's execute._pos_for): a vector's j is
    0, and so are a scalar's i and j."""
    zero = torch.zeros((), dtype=torch.int64, device=device)
    if len(shape) == 0:
        return {"i": zero, "j": zero}
    return {"i": _iota(shape, 0, device),
            "j": _iota(shape, 1, device) if len(shape) > 1 else zero}


# the index a positional op's key names: of an element, or of a product's
# pair a(i, k) b(k, j)
EWISE_MAP = {"ai": "i", "aj": "j", "bi": "i", "bj": "j", "i": "i", "j": "j"}
MATMUL_MAP = {"ai": "i", "aj": "k", "bi": "k", "bj": "j"}


def positional_value(op, pos, shape, context_map=EWISE_MAP):
    """A positional op's result over shape: the index its key names, plus
    its offset, in its return type."""
    key, off = op._positional
    out = (pos[context_map[key]] + off).expand(shape).contiguous()
    return _dt.normalize(out, op.return_type)


def apply_binop(op, x_vals, x_dt, y_vals, y_dt, pos=None,
                context_map=EWISE_MAP):
    """Apply a typed BinaryOp with casting; result in op.return_type.  A
    positional op reads `pos` (see positional_value) and not the values."""
    if op._positional is not None:
        shape = torch.broadcast_shapes(x_vals.shape, y_vals.shape)
        return positional_value(op, pos, shape, context_map)
    x = st.cast_values(x_vals, x_dt, op.type)
    y = st.cast_values(y_vals, y_dt, op.type2)
    return op(x, y)


def apply_unop(op, x_vals, x_dt, pos=None):
    if op._positional is not None:
        return positional_value(op, pos, x_vals.shape)
    return op(st.cast_values(x_vals, x_dt, op.type))


def apply_op(a_vals, a_valid, op, a_dt, pos=None):
    return apply_unop(op, a_vals, a_dt, pos=pos), a_valid


def bound_vals(a_vals, op, a_dt, scalar_val, scalar_dt, left, pos=None):
    """op(s, a) (left) or op(a, s) for a 0-d scalar tensor s of scalar_dt."""
    s = scalar_val.to(a_vals.device).expand(a_vals.shape)
    if left:
        return apply_binop(op, s, scalar_dt, a_vals, a_dt, pos=pos)
    return apply_binop(op, a_vals, a_dt, s, scalar_dt, pos=pos)


def apply_bound(a_vals, a_valid, op, a_dt, scalar_val, scalar_dt, left,
                pos=None):
    return bound_vals(a_vals, op, a_dt, scalar_val, scalar_dt, left,
                      pos=pos), a_valid


def indexunary_vals(a_vals, i, j, op, a_dt, thunk_val):
    """op(value, row, col, thunk) elementwise; i and j are int64 tensors
    broadcast against a_vals.  A positional op reads the raw values (it
    ignores them)."""
    x = a_vals if op._positional else st.cast_values(a_vals, a_dt, op.type)
    return op(x, i, j, thunk_val.to(a_vals.device))


def apply_indexunary(a_vals, a_valid, op, a_dt, thunk_val, is_matrix):
    shape = a_valid.shape
    dev = a_valid.device
    if not shape:  # a Scalar: row and column 0
        i = j = torch.zeros((), dtype=torch.int64, device=dev)
        return indexunary_vals(a_vals, i, j, op, a_dt, thunk_val), a_valid
    i = _iota(shape, 0, dev).expand(shape)
    j = _iota(shape, 1, dev).expand(shape) if is_matrix else \
        torch.zeros_like(i)
    return indexunary_vals(a_vals, i, j, op, a_dt, thunk_val), a_valid


def select_op(a_vals, a_valid, op, a_dt, thunk_val, is_matrix, out_dt):
    pred, _ = apply_indexunary(a_vals, a_valid, op, a_dt, thunk_val,
                               is_matrix)
    return st.cast_values(a_vals, a_dt, out_dt), a_valid & pred


def ewise_mult(a_vals, a_valid, b_vals, b_valid, op, a_dt, b_dt, pos=None):
    return apply_binop(op, a_vals, a_dt, b_vals, b_dt, pos=pos), \
        a_valid & b_valid


def ewise_add(a_vals, a_valid, b_vals, b_valid, op, a_dt, b_dt, out_dt,
              pos=None):
    both = a_valid & b_valid
    combined = st.cast_values(apply_binop(op, a_vals, a_dt, b_vals, b_dt,
                                          pos=pos),
                              op.return_type, out_dt)
    a_pass = st.cast_values(a_vals, a_dt, out_dt)
    b_pass = st.cast_values(b_vals, b_dt, out_dt)
    vals = torch.where(both, combined,
                           torch.where(a_valid, a_pass, b_pass))
    return vals, a_valid | b_valid


def ewise_union(a_vals, a_valid, b_vals, b_valid, op, a_dt, b_dt, ldef, rdef,
                pos=None):
    """ldef/rdef: 0-d tensors of op.type / op.type2 standing in for the
    missing side."""
    x = torch.where(a_valid, st.cast_values(a_vals, a_dt, op.type), ldef)
    y = torch.where(b_valid, st.cast_values(b_vals, b_dt, op.type2), rdef)
    return apply_binop(op, x, op.type, y, op.type2, pos=pos), \
        a_valid | b_valid


def _fold(x, name, dim, mono, ident):
    """Reduce the identity-filled tensor x along `dim` (None: all of it)
    with the monoid called `name`."""
    dims = tuple(range(x.dim())) if dim is None else (dim,)
    if any(x.shape[d] == 0 for d in dims):
        keep = [s for d, s in enumerate(x.shape) if d not in dims]
        return ident.expand(keep).clone()
    if name == "plus":
        red = x.sum(dim=dims)
    elif name == "times":
        red = x
        for d in sorted(dims, reverse=True):
            red = red.prod(dim=d)
    elif name == "land":
        red = x.all(dim=dims[0]) if len(dims) == 1 else x.all()
    elif name == "lor":
        red = x.any(dim=dims[0]) if len(dims) == 1 else x.any()
    elif name in ("min", "max") and mono.type is _dt.UINT64:
        s = -(1 << 63)  # unsigned: flip the sign bit around it
        red = ((x ^ s).amin if name == "min" else (x ^ s).amax)(dim=dims) ^ s
    elif name == "min":
        red = x.amin(dim=dims)
    elif name == "max":
        red = x.amax(dim=dims)
    else:
        # band/bor have no torch reduction: halve with the monoid
        red = x.reshape(-1).unsqueeze(1) if dim is None else x.movedim(dim, 0)
        while red.shape[0] > 1:
            if red.shape[0] % 2:
                red = torch.cat([red, ident.expand(red.shape[1:]).unsqueeze(0)])
            red = mono.binaryop(red[0::2], red[1::2])
        red = red[0, 0] if dim is None else red[0]
    return _dt.normalize(red, mono.type)


def reduce_monoid(vals, valid, mono, in_dt, axis=None):
    """Monoid-reduce along `axis` (None: to a 0-d pair).  Returns
    (values, valid); the ``any`` monoid takes the first stored element in
    row-major order."""
    x = st.cast_values(vals, in_dt, mono.type)
    name = mono.parent.name
    if axis is None:
        out_valid = valid.any()
    else:
        out_valid = valid.any(dim=axis)
    if name == "any":
        ok = valid.to(torch.uint8)
        if axis is None:
            if x.numel() == 0:
                return x.new_zeros(()), out_valid
            return x.reshape(-1)[ok.reshape(-1).argmax()], out_valid
        if x.shape[axis] == 0:
            return x.new_zeros(out_valid.shape), out_valid
        first = ok.argmax(dim=axis, keepdim=True)
        return torch.take_along_dim(x, first, dim=axis).squeeze(axis), out_valid
    ident = st.identity_value_array(mono, mono.type, x.device)
    x = torch.where(valid, x, ident)
    return _fold(x, name, axis, mono, ident), out_valid


def reduce_agg(vals, valid, spec, in_dt, ret_dt, axis=None):
    """Aggregator reduce along `axis` (None: to a 0-d pair): map, monoid
    reduce, finalize (core/operator/agg.py), with the JAX package's
    formulas: variance as s2/n - mean**2 in float64, peak_to_peak as
    max - min.  Returns (values in ret_dt, valid)."""
    from ..operator.monoid import BUILTINS as monoids

    name = spec.monoid_name
    out_valid = valid.any() if axis is None else valid.any(dim=axis)
    count = (valid.sum() if axis is None else valid.sum(dim=axis)).to(
        torch.float64)
    if spec.custom is not None:
        return _dt.normalize(spec.custom(vals, valid, axis), ret_dt), \
            out_valid
    if spec.composite is not None:
        # the children on the same input, then finalize of their results
        accs = []
        for child in spec.composite:
            rr = child.ret_rule
            child_ret = in_dt if rr is None else (rr(in_dt) if callable(rr)
                                                  else rr)
            accs.append(reduce_agg(vals, valid, child, in_dt, child_ret,
                                   axis)[0])
        return _dt.normalize(spec.finalize_fn(*accs, count), ret_dt), \
            out_valid
    if spec.index_kind is not None:
        return _reduce_agg_index(vals, valid, spec.index_kind, in_dt, ret_dt,
                                 axis), out_valid
    if name == "minmax":  # peak_to_peak
        mx, _ = reduce_monoid(vals, valid, monoids["max"][in_dt], in_dt, axis)
        mn, _ = reduce_monoid(vals, valid, monoids["min"][in_dt], in_dt, axis)
        return _dt.normalize(mx - mn, ret_dt), out_valid
    if name in ("var_p", "var_s", "std_p", "std_s"):
        xf = torch.where(valid, st.cast_values(vals, in_dt, _dt.FP64), 0.0)
        dims = tuple(range(xf.dim())) if axis is None else (axis,)
        s1 = xf.sum(dim=dims)
        s2 = (xf * xf).sum(dim=dims)
        mean = s1 / count
        var = s2 / count - mean * mean
        if name.endswith("_s"):
            var = var * count / torch.clamp(count - 1, min=1)
        res = torch.sqrt(var) if name.startswith("std") else var
        return _dt.normalize(res, ret_dt), out_valid
    mapped = spec.map_fn(vals)
    # an identity map keeps the input's type (UINT32 is stored as int64)
    mdt = in_dt if mapped is vals else _dt.lookup_dtype(mapped.dtype)
    mono = (monoids[name] if isinstance(name, str) else name)[mdt]
    acc, _ = reduce_monoid(mapped, valid, mono, mdt, axis)
    if spec.finalize_fn is not None:
        acc = spec.finalize_fn(acc, count)
    return _dt.normalize(acc, ret_dt), out_valid


def _reduce_agg_index(vals, valid, kind, in_dt, ret_dt, axis):
    """first, last, their indices, argmin and argmax along axis: where an
    extremum repeats, the smallest index.  argmin and argmax refuse BOOL
    (np.iinfo raises), as in the JAX package."""
    if axis is None:
        return _reduce_agg_index(vals.reshape(-1), valid.reshape(-1), kind,
                                 in_dt, ret_dt, 0)
    shape = valid.shape
    n = shape[axis]
    out_shape = shape[:axis] + shape[axis + 1:]
    if n == 0:
        return torch.zeros(out_shape, dtype=ret_dt.torch_type,
                           device=valid.device)
    idx = _iota(shape, axis, valid.device)
    if kind in ("first", "first_index"):
        sel = torch.where(valid, idx, n).amin(dim=axis)
    elif kind in ("last", "last_index"):
        sel = torch.where(valid, idx, -1).amax(dim=axis)
    else:
        low = kind == "argmin"
        if in_dt.is_float:
            fill = float("inf") if low else float("-inf")
        else:
            info = np.iinfo(in_dt.np_type)
            fill = int(info.max if low else info.min)
        if in_dt is _dt.UINT64:  # unsigned order on the int64 bits
            vals = vals ^ torch.iinfo(torch.int64).min
            fill = fill - (1 << 63)
        masked = torch.where(valid, vals, fill)
        ext = (masked.amin if low else masked.amax)(dim=axis, keepdim=True)
        sel = torch.where(valid & (masked == ext), idx, n).amin(dim=axis)
        return _dt.normalize(sel, ret_dt)
    if kind.endswith("_index"):
        return _dt.normalize(sel, ret_dt)
    picked = torch.take_along_dim(vals, sel.clamp(0, n - 1).unsqueeze(axis),
                                  dim=axis).squeeze(axis)
    return st.cast_values(picked, in_dt, ret_dt)


# --------------------------------------------------------------------- #
# semiring matmul family
# (reduce, combine) of csrc/tropical.cu for the semirings K7 takes: the
# four whose missing-as-identity encoding is sound
_TROPICAL = {("min", "plus"): "plus", ("max", "plus"): "plus",
             ("min", "max"): "fmax", ("max", "min"): "fmin"}


def _matmul_block_size(m, k, n):
    budget = 1 << 22  # elements in the (m, kb, n) intermediate
    return int(max(1, min(k, budget // max(1, m * n))))


def _f32_product(x, y):
    """0/1 planes multiplied in float32: exact up to 2**24 terms."""
    return torch.matmul(x.to(torch.float32), y.to(torch.float32))


def semiring_matmul(a_vals, a_valid, b_vals, b_valid, ring, a_dt, b_dt):
    """C = A (ring) B over bitmap stores.  A: (m,k), B: (k,n).

    As in the JAX package the structure is a float32 product of the
    validity planes, ``pair`` rings and float ``plus_times`` and
    ``lor_land`` are library products, and everything else is the blocked
    generic product; but the floating-point tropical rings min_plus,
    max_plus, min_max and max_min go to kernel K7 (its plain version on
    the CPU) with both validity planes.  A logical monoid over products
    of another type (``lor_land["FP32"]``) casts the operands to BOOL and
    runs the ring's BOOL instance, where that computes the same."""
    twin = ring.bool_twin()
    if twin is not None:
        mult = ring.binaryop
        a_vals = truthy(st.cast_values(a_vals, a_dt, mult.type), mult.type)
        b_vals = truthy(st.cast_values(b_vals, b_dt, mult.type2), mult.type2)
        ring, a_dt, b_dt = twin, _dt.BOOL, _dt.BOOL
    mult = ring.binaryop
    mono = ring.monoid
    m, k = a_valid.shape
    n = b_valid.shape[1]
    mono_name = mono.parent.name
    mult_name = mult.parent.name
    dev = a_valid.device

    counts = _f32_product(a_valid, b_valid)
    out_valid = counts > 0.5

    if mult_name == "pair":
        if mono_name == "plus":
            return _dt.normalize(counts, mono.type), out_valid
        # all products are 1: the result is 1 wherever present
        return torch.ones((m, n), dtype=mono.type.torch_type,
                         device=dev), out_valid
    if mono_name == "plus" and mult_name == "times":
        av = st.cast_values(a_vals, a_dt, mult.type)
        bv = st.cast_values(b_vals, b_dt, mult.type2)
        if a_dt.is_bool:
            cnt = _f32_product(a_valid & truthy(av, mult.type),
                               b_valid & truthy(bv, mult.type2))
            return _dt.normalize(cnt > 0.5, mono.type), out_valid
        # torch.matmul has no integer kernel on CUDA: integers take the
        # generic product there (exact), never a float cast; a complex
        # product is a library product, as jnp.matmul in the JAX package
        if mult.type.is_float or mult.type.is_complex or dev.type == "cpu":
            av = torch.where(a_valid, av, torch.zeros((), dtype=av.dtype,
                                                      device=dev))
            bv = torch.where(b_valid, bv, torch.zeros((), dtype=bv.dtype,
                                                      device=dev))
            return _dt.normalize(torch.matmul(av, bv), mono.type), out_valid
    if mono_name == "lor" and mult_name == "land" and mult.type.is_bool:
        av = a_valid & truthy(st.cast_values(a_vals, a_dt, mult.type), mult.type)
        bv = b_valid & truthy(st.cast_values(b_vals, b_dt, mult.type2),
                              mult.type2)
        return _f32_product(av, bv) > 0.5, out_valid
    comb = _TROPICAL.get((mono_name, mult_name))
    if comb is not None and mult.type.is_float:
        av = st.cast_values(a_vals, a_dt, mult.type).contiguous()
        bv = st.cast_values(b_vals, b_dt, mult.type2).contiguous()
        with _trace.span("gb.engine:tropical"):
            vals = tropical.tropical_matmul(av, bv, mono_name, comb,
                                            a_valid.contiguous(),
                                            b_valid.contiguous())
        return vals, out_valid
    return _generic_matmul(a_vals, a_valid, b_vals, b_valid, ring, a_dt, b_dt,
                           out_valid)


def _generic_matmul(a_vals, a_valid, b_vals, b_valid, ring, a_dt, b_dt,
                    out_valid):
    """Any semiring, positional multiplies included: k in blocks of kb, a
    (m, kb, n) tensor of products per block, reduced along k and merged
    into the running result.  At m*n >= 2**22 a block is one k: it is the
    path that is always right, not a fast one."""
    mult = ring.binaryop
    mono = ring.monoid
    m, k = a_valid.shape
    n = b_valid.shape[1]
    dev = a_valid.device
    kb = _matmul_block_size(m, k, n)
    positional = mult._positional is not None
    if positional:
        av, bv = a_vals, b_vals
    else:
        av = st.cast_values(a_vals, a_dt, mult.type)
        bv = st.cast_values(b_vals, b_dt, mult.type2)
    name = mono.parent.name
    is_any = name == "any"
    if is_any:
        ident = st.zeros_values((), mono.type, dev)
    else:
        ident = st.identity_value_array(mono, mono.type, dev)
    acc_vals = ident.expand(m, n).clone()
    acc_valid = torch.zeros((m, n), dtype=torch.bool, device=dev)
    for k0 in range(0, k, kb):
        a_blk, b_blk = av[:, k0:k0 + kb], bv[k0:k0 + kb, :]
        shape = (m, a_blk.shape[1], n)
        pvalid = a_valid[:, k0:k0 + kb, None] & b_valid[None, k0:k0 + kb, :]
        if positional:
            pos = {"i": _iota(shape, 0, dev), "k": _iota(shape, 1, dev, k0),
                   "j": _iota(shape, 2, dev)}
            pv = positional_value(mult, pos, shape, MATMUL_MAP)
        else:
            pv = mult(a_blk[:, :, None].expand(shape),
                      b_blk[None, :, :].expand(shape))
        pv = st.cast_values(pv, mult.return_type, mono.type)
        has = pvalid.any(dim=1)
        if is_any:
            # first stored product in k order
            first = pvalid.to(torch.uint8).argmax(dim=1, keepdim=True)
            picked = torch.take_along_dim(pv, first, dim=1)[:, 0, :]
            acc_vals = torch.where(acc_valid | ~has, acc_vals, picked)
        else:
            blk = _fold(torch.where(pvalid, pv, ident), name, 1, mono, ident)
            acc_vals = torch.where(
                acc_valid & has, mono.binaryop(acc_vals, blk),
                torch.where(has, blk, acc_vals))
        acc_valid = acc_valid | has
    return acc_vals, out_valid


def kron(a_vals, a_valid, b_vals, b_valid, op, a_dt, b_dt):
    """The Kronecker product: out[i*p + k, j*q + l] = op(a[i, j], b[k, l])
    where both are stored."""
    m, n = a_valid.shape
    p, q = b_valid.shape
    shape = (m, p, n, q)
    x = st.cast_values(a_vals, a_dt, op.type)[:, None, :, None].expand(shape)
    y = st.cast_values(b_vals, b_dt, op.type2)[None, :, None, :].expand(shape)
    out = op(x, y)
    valid = a_valid[:, None, :, None] & b_valid[None, :, None, :]
    return out.reshape(m * p, n * q), valid.reshape(m * p, n * q)


def reposition(vals, valid, offsets, out_shape):
    """Every element moved by offsets into a store of out_shape; what falls
    outside is dropped."""
    out_vals = vals.new_zeros(out_shape)
    out_valid = torch.zeros(out_shape, dtype=torch.bool, device=vals.device)
    src, dst = [], []
    for off, n_in, n_out in zip(offsets, valid.shape, out_shape):
        lo, hi = max(0, -off), min(n_in, n_out - off)
        if hi <= lo:
            return out_vals, out_valid
        src.append(slice(lo, hi))
        dst.append(slice(lo + off, hi + off))
    out_vals[tuple(dst)] = vals[tuple(src)]
    out_valid[tuple(dst)] = valid[tuple(src)]
    return out_vals, out_valid


def transpose(vals, valid):
    """The transposed store, materialised once (``.t()`` is a view; the
    kernels and reduces downstream take row-major tensors)."""
    return vals.t().contiguous(), valid.t().contiguous()


def diag_extract(a_vals, a_valid, k):
    return (torch.diagonal(a_vals, offset=k).clone(),
            torch.diagonal(a_valid, offset=k).clone())


def diag_build(v_vals, v_valid, k, n):
    """(n, n) store with v on diagonal k."""
    vals = v_vals.new_zeros((n, n))
    valid = torch.zeros((n, n), dtype=torch.bool, device=v_vals.device)
    torch.diagonal(vals, offset=k).copy_(v_vals)
    torch.diagonal(valid, offset=k).copy_(v_valid)
    return vals, valid


def _accum_vals(accum, c_vals, c_dt, z_vals, z_dt):
    """accum(c, z) in c's type; a positional accum reads each element's
    position."""
    shape = torch.broadcast_shapes(c_vals.shape, z_vals.shape)
    pos = None if accum._positional is None else \
        pos_for(shape, c_vals.device)
    return st.cast_values(apply_binop(accum, c_vals, c_dt, z_vals, z_dt,
                                      pos=pos), accum.return_type, c_dt)


def write_back(c_vals, c_valid, c_dt, z_vals, z_valid, z_dt, mask_arr, accum,
               replace):
    """GraphBLAS write-back of z into c under mask, accum and replace."""
    if accum is not None:
        both = c_valid & z_valid
        merged = _accum_vals(accum, c_vals, c_dt, z_vals, z_dt)
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


def extract_matrix(a_vals, a_valid, rows, cols):
    """A[rows, cols] of a bitmap store (index lists may repeat)."""
    return a_vals[rows][:, cols], a_valid[rows][:, cols]


def extract_vector(a_vals, a_valid, idx):
    return a_vals[idx], a_valid[idx]


def scatter_matrix(shape, rows, cols, z_vals, z_valid, dtype):
    """A region's (values, valid) placed at rows x cols of a plane of
    shape, and the region itself.  Where an index repeats, which of its
    elements lands is unspecified, as in the JAX package."""
    dev = z_valid.device
    out_vals = st.zeros_values(shape, dtype, dev)
    out_valid = torch.zeros(shape, dtype=torch.bool, device=dev)
    region = torch.zeros(shape, dtype=torch.bool, device=dev)
    r, c = rows[:, None], cols[None, :]
    out_vals[r, c] = z_vals.expand(len(rows), len(cols))
    out_valid[r, c] = z_valid.expand(len(rows), len(cols))
    _trace.put("dense.scatter", region, (r, c), True)
    return out_vals, out_valid, region


def scatter_vector(size, idx, z_vals, z_valid, dtype):
    dev = z_valid.device
    out_vals = st.zeros_values((size,), dtype, dev)
    out_valid = torch.zeros(size, dtype=torch.bool, device=dev)
    region = torch.zeros(size, dtype=torch.bool, device=dev)
    out_vals[idx] = z_vals.expand(len(idx))
    out_valid[idx] = z_valid.expand(len(idx))
    _trace.put("dense.scatter", region, idx, True)
    return out_vals, out_valid, region


def subassign(c_vals, c_valid, c_dt, z_vals, z_valid, z_dt, region,
              submask_arr, accum, replace):
    """GxB_subassign semantics: mask & replace scoped to the region."""
    z_cast = st.cast_values(z_vals, z_dt, c_dt)
    if accum is not None:
        both = c_valid & z_valid
        merged = _accum_vals(accum, c_vals, c_dt, z_vals, z_dt)
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


# --------------------------------------------------------------------- #
# rowwise order kernels: sort / compactify / selectk (the last axis of a
# bitmap store; a vector is one row)
def _row_order(vals, valid, dtype, how, rng_keys=None):
    """Permutation ordering each row's stored elements by ``how``
    (sparse.order_key), ties by column; missing elements order last."""
    from .sparse import argsort_key, order_key

    n = valid.shape[-1]
    colid = torch.arange(n, dtype=torch.int64, device=valid.device)
    order = colid.expand(valid.shape)
    if how == "last":
        order = torch.flip(order, (-1,))
    else:
        key = order_key(vals, dtype, how, rng_keys)
        if key is not None:
            order = argsort_key(key)
    missing = torch.gather((~valid).to(torch.int8), -1, order)
    return torch.gather(order, -1, torch.sort(missing, dim=-1,
                                              stable=True)[1])


def _packed_valid(valid):
    counts = valid.sum(dim=-1, keepdim=True)
    colid = torch.arange(valid.shape[-1], dtype=torch.int64,
                         device=valid.device)
    return colid < counts


def rowwise_compactify(vals, valid, dtype, how, width, rng_keys=None):
    """Stored values packed left per row in ``how`` order, as (nrows,
    width) planes (padded where width exceeds the row length)."""
    order = _row_order(vals, valid, dtype, how, rng_keys)
    packed = torch.gather(vals, -1, order)
    out_ok = _packed_valid(valid)
    n = valid.shape[-1]
    if width <= n:
        return packed[..., :width], out_ok[..., :width]
    pad = [(0, 0)] * (valid.dim() - 1) + [(0, width - n)]
    flat = [p for pair in reversed(pad) for p in pair]
    return (torch.nn.functional.pad(packed, flat),
            torch.nn.functional.pad(out_ok, flat))


def rowwise_sort(vals, valid, dtype, descending=False):
    """(sorted values packed left, source column of each as int64,
    validity) of each row."""
    order = _row_order(vals, valid, dtype, "desc" if descending else "asc")
    return torch.gather(vals, -1, order), order, _packed_valid(valid)


def rowwise_selectk(vals, valid, dtype, how, k, rng_keys=None):
    """At most k stored elements per row, at their places."""
    order = _row_order(vals, valid, dtype, how, rng_keys)
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(
        order.shape[-1], dtype=torch.int64,
        device=order.device).expand(order.shape).contiguous())
    return vals, valid & (rank < k)
