"""Sort-pipeline SpMV and row/column reduce on PyTorch and CUDA: the port
of graphblas_tpu/core/engine/sortpipe.py, and the scan combines and
carrier types it shares with the lanepipe.

The matvec  w[i] = monoid_j mult(A[i, j], u[j])  runs without any lookup
by a computed edge address, on a plan built once per structure and
direction on the device (:func:`build_plan_device`):

1. *merge*: the dense u is moved in between the edges ordered
   contraction-major (a fixed permutation of the plan);
2. *fill*: a segmented scan with the combine ``first`` copies each u
   entry forward onto its edges (K6, :func:`segscan`);
3. *multiply*: the typed binary op, edge by edge (torch);
4. *route*: a fixed permutation moves the products into a
   destination-major layout where one identity slot leads every output;
5. *reduce*: a segmented scan folds each destination with the monoid, and
   a second channel counts its valid contributions (K6 again);
6. *extract*: the last slot of every destination is read out.

The JAX package moves data with ``lax.sort`` by fixed rank arrays, outside
any kernel; here the plan keeps the inverse of each rank array, and a move
is one ``torch.index_select``.  It takes every matrix the lanepipe turns
down (plans over ``lanepipe.PACK_LIMIT``: hypersparse matrices, small
graphs with one hub) and every row/column reduce
(:func:`reduce_pipeline`).  Positional multiplies (``plan_positions``) are
not ported.

Values ride the engine as 32-bit carriers: float32 for FP32, int32 for
BOOL (0/1) and the integers of at most 32 bits (INT8, INT16 and INT32
sign-extended, UINT8 and UINT16 zero-extended), and int32 bits for
UINT32, whose min/max compare with the sign bit flipped.  Every product
is narrowed to its multiply's type before the monoid sees it, and the
result back to the monoid's type at the end.  A multiply that K1 does
not take (a user function, a numpy ufunc, the JAX package's Python
binaries: ``kernels.k1_code``) is refused here as well as in the
lanepipe, so the CPU takes the route the card takes: the generic sparse
engine.
"""

import ctypes
import time
from collections import namedtuple

import numpy as np
import torch

from .. import dtypes as _dt
from .. import trace as _trace
from . import dense
from . import kernels as K
from . import store as st

_SIGN = -(1 << 31)


def _umin(a, b):
    return torch.minimum(a ^ _SIGN, b ^ _SIGN) ^ _SIGN


def _umax(a, b):
    return torch.maximum(a ^ _SIGN, b ^ _SIGN) ^ _SIGN


_SCAN_MONOIDS = {
    "plus": lambda a, b: a + b,
    "times": lambda a, b: a * b,
    "min": torch.minimum,
    "max": torch.maximum,
    # booleans carried as int32 0/1
    "lor": torch.maximum,
    "land": lambda a, b: a * b,
    "lxor": lambda a, b: a ^ b,
    "lxnor": lambda a, b: (a ^ b) ^ 1,
    "eq": lambda a, b: (a ^ b) ^ 1,
    "band": lambda a, b: a & b,
    "bor": lambda a, b: a | b,
    "bxor": lambda a, b: a ^ b,
}


def monoid_scan_fn(name, dt):
    """The combine of monoid `name` on dt's carrier, or None."""
    if dt.is_unsigned and name in ("min", "max"):
        return _umin if name == "min" else _umax
    return _SCAN_MONOIDS.get(name)


def eligible_dtype(dt):
    """32-bit-representable, non-UDT dtype."""
    return (not dt._is_udt and dt.np_type.kind in "biuf"
            and dt.np_type.itemsize <= 4)


def carrier_dtype(dt):
    """torch dtype values are carried as through the kernels."""
    return torch.float32 if dt.is_float else torch.int32


def kernel_dtype(dt):
    """The carrier type code of csrc/common.cuh."""
    if dt.is_float:
        return "f32"
    if dt.is_bool:
        return "bool"
    return "u32" if dt.is_unsigned else "i32"


def to_carrier(t, dt):
    """Storage tensor of dt -> carrier tensor (UINT32 wraps to int32 bits)."""
    return t.to(carrier_dtype(dt))


def from_carrier(t, dt):
    """Carrier tensor -> storage tensor of dt (the narrow types wrap)."""
    return _dt.normalize(t, dt)


def carrier_scalar(value, dt):
    """A Python value of dt as its carrier's Python number (UINT32 as the
    signed int32 with the same bits)."""
    if dt.is_float:
        return float(value)
    v = int(value) & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def eligible_spmv(ring, a_dt, u_dt):
    """Can the lanepipe or the sort pipeline execute this (ring, dtypes)
    combination?  Its multiply is one K1 computes (``kernels.k1_code``:
    a builtin over types of at most 32 bits, each operand in its own
    type), and its monoid has an identity and a scan combine."""
    mono = ring.monoid
    return (K.k1_code(ring.binaryop, a_dt, u_dt, mono.type) is not None
            and monoid_scan_fn(mono.parent.name, mono.type) is not None
            and mono.identity is not None)


def eligible_reduce(mono, in_dt):
    """Can :func:`reduce_pipeline` fold rows or columns with this monoid?"""
    if mono.type._is_udt or not eligible_dtype(mono.type):
        return False
    if not eligible_dtype(in_dt):
        return False
    if monoid_scan_fn(mono.parent.name, mono.type) is None:
        return False
    if mono.identity is None:
        return False
    return True


def np_carrier(vals, dt):
    """Host values of dt -> numpy array on the 32-bit carrier."""
    if dt.is_float:
        return vals.astype(np.float32)
    return vals.astype(np.uint32 if dt.is_unsigned else np.int32).view(np.int32)


def norm_device(device):
    """torch.device with its index filled in, so ``cuda`` and ``cuda:0``
    key one plan."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def multiply(mult, a_c, g_c, a_dt, u_dt, z_dt, kind):
    """Typed multiply of matrix values a_c and vector values g_c, both on
    their carriers; result on z_dt's carrier."""
    a_in = from_carrier(a_c, a_dt)
    x_in = from_carrier(g_c, u_dt)
    if kind == "mxv":
        p = dense.apply_binop(mult, a_in, a_dt, x_in, u_dt)
    else:
        p = dense.apply_binop(mult, x_in, u_dt, a_in, a_dt)
    return to_carrier(st.cast_values(p, mult.return_type, z_dt), z_dt)


# --------------------------------------------------------------------- #
# K6: flat segmented scan
# fn: torch combine on carriers (left, right); monoid/dt/packed select the
# CUDA combine ("first" keeps the left operand and has no type)
Combine = namedtuple("Combine", "fn monoid dt packed")
FIRST = Combine(lambda a, b: a, "first", None, False)
COUNT = Combine(lambda a, b: a + b, "plus", _dt.INT32, False)
SEG_BLOCK = 4096  # elements per tile of csrc/segscan.cu


def monoid_combine(mono):
    """The scan combine of a typed monoid on its carrier."""
    return Combine(monoid_scan_fn(mono.parent.name, mono.type),
                   mono.parent.name, mono.type, False)


def segscan_plain(barrier, vals, fn):
    """Inclusive segmented scan along dimension 0, restarting where barrier
    is set (log-step form on whole arrays).  A 1-D array is scanned flat, a
    (R,128) array down the rows of every lane."""
    b = barrier != 0
    v = vals
    R = v.shape[0]
    s = 1
    while s < R:
        v = torch.cat([v[:s], torch.where(b[s:], v[s:], fn(v[:-s], v[s:]))])
        b = torch.cat([b[:s], b[s:] | b[:-s]])
        s <<= 1
    return v


def segscan_channels_plain(barrier, vals, combines):
    """Plain version of K6 (see :func:`segscan`): every channel scanned
    flat with its own combine."""
    return [segscan_plain(barrier, v, c.fn) for v, c in zip(vals, combines)]


def _combine_code(c):
    if c.monoid == "first":
        return K.SEG_FIRST
    if c.packed or c.monoid not in K.MONOID_OP:
        raise NotImplementedError(f"combine {c.monoid} has no CUDA scan")
    return (K.DT[kernel_dtype(c.dt)] << 4) | K.MONOID_OP[c.monoid]


def segscan(barrier, vals, combines):
    """Flat inclusive segmented scan (kernel K6); segments restart where
    barrier != 0, and element 0 starts one either way.

    barrier: int32[L]; vals: list of 32-bit [L] tensors; combines: one
    :class:`Combine` per tensor, applied as combine(left, right).  On CUDA
    L must be a multiple of 4096 and the scan is one launch per group of
    up to four channels, a single pass with a decoupled look-back; see
    csrc/segscan.cu."""
    vals = list(vals)
    if barrier.device.type == "cpu":
        return segscan_channels_plain(barrier, vals, combines)
    codes = [_combine_code(c) for c in combines]
    ins = [v if v.dtype == torch.int32 else v.view(torch.int32) for v in vals]
    K.require_cuda("segscan", [barrier] + ins)
    L = barrier.numel()
    if barrier.dim() != 1 or L % SEG_BLOCK or any(v.shape != barrier.shape
                                                  for v in ins):
        raise ValueError("segscan: arrays must be 1-D of one length, a "
                         "multiple of 4096")
    if any(t.data_ptr() % 16 for t in [barrier] + ins):
        raise ValueError("segscan: arrays must be 16-byte aligned")
    ntiles = L // SEG_BLOCK
    fn = K.lib("segscan").segscan
    outs = []
    for c0 in range(0, len(ins), K.MAXCH):
        chunk = ins[c0:c0 + K.MAXCH]
        res = [torch.empty_like(x) for x in chunk]
        # per tile and channel an aggregate and a prefix word, the counter
        scratch = torch.empty(4 * len(chunk) * ntiles + 1, dtype=torch.int32,
                              device=barrier.device)
        cc = (ctypes.c_int * K.MAXCH)(*codes[c0:c0 + K.MAXCH])
        K.check("segscan", fn(barrier.data_ptr(), K.ptr_array(chunk),
                              K.ptr_array(res), cc, len(chunk),
                              scratch.data_ptr(), L, K.stream_ptr(barrier)))
        K.launches["segscan"] += 1
        outs += res
    return [o.view(v.dtype) for o, v in zip(outs, vals)]


def sort_apply(src, vals):
    """Move every array of vals by a fixed permutation: out[j] = v[src[j]].

    src is the inverse of the JAX package's rank array (which sorts
    (rank, payload) pairs so that v[i] lands at rank[i]); the plan inverts
    each rank array once, so a move is one gather."""
    return [torch.index_select(v, 0, src) for v in vals]


# --------------------------------------------------------------------- #
# plan construction (once per structure and direction, on the device)
def _plan_len(n_in, n_out, cap):
    L = 1 << 12  # one block of the scan kernel
    need = max(n_in, n_out) + cap + 2
    while L < need:
        L <<= 1
    return L


def _free_slots(used_ranks, L, count):
    """Ascending list of the `count` positions in [0, L) not in used_ranks."""
    mark = torch.zeros(L, dtype=torch.uint8, device=used_ranks.device)
    _trace.put("sortpipe.plan", mark, used_ranks, 1)
    return torch.argsort(mark, stable=True)[:count]


def build_plan_device(rowids, cols, ok, *, cap, n_out, n_in, dest_is_row=True):
    """The plan's rank arrays and barriers, as int32 tensors of the same
    names and contents as the JAX package's ``build_plan_device``.

    rowids, cols: integer tensors [cap]; ok: bool [cap] (False marks
    padding).  One-time sorts and scatters, all on the tensors' device."""
    L = _plan_len(n_in, n_out, cap)
    dev = rowids.device
    i64 = torch.int64

    def iota(n):
        return torch.arange(n, dtype=i64, device=dev)

    dest_ids, k_ids = (rowids, cols) if dest_is_row else (cols, rowids)
    k_eff = torch.where(ok, k_ids.to(i64).clamp(max=n_in), n_in)
    dest_eff = torch.where(ok, dest_ids.to(i64).clamp(max=n_out), n_out)

    # ---- merge side (contraction-major)
    k_q, d_of_q = torch.sort(k_eff, stable=True)
    indptr_k = torch.searchsorted(k_q, iota(n_in + 1))
    rank_x = indptr_k[:n_in] + iota(n_in)
    rank_e_q = iota(cap) + k_q + 1
    merged_slot_of_d = torch.zeros(cap, dtype=i64, device=dev)
    merged_slot_of_d[d_of_q] = rank_e_q
    free_m = _free_slots(rank_x, L, L - n_in)
    rank_m = torch.cat([rank_x, free_m])
    barrier_m = torch.zeros(L, dtype=torch.int32, device=dev)
    _trace.put("sortpipe.plan", barrier_m, rank_x, 1)

    # ---- interleaved destination side
    dest_dd, dd_of = torch.sort(dest_eff, stable=True)
    indptr_d = torch.searchsorted(dest_dd, iota(n_out + 1))
    ident_pos = indptr_d[:n_out] + iota(n_out)
    inter_slot_of_d = torch.zeros(cap, dtype=i64, device=dev)
    inter_slot_of_d[dd_of] = iota(cap) + dest_dd + 1
    barrier_i = torch.zeros(L, dtype=torch.int32, device=dev)
    _trace.put("sortpipe.plan", barrier_i, ident_pos, 1)

    # rank_back: merged slot -> interleaved slot (free slots paired in order)
    free_src = _free_slots(merged_slot_of_d, L, L - cap)
    free_dst = _free_slots(inter_slot_of_d, L, L - cap)
    rank_back = torch.zeros(L, dtype=i64, device=dev)
    rank_back[merged_slot_of_d] = inter_slot_of_d
    rank_back[free_src] = free_dst

    # extraction: last slot of each out row -> rank r, everything else after
    last_pos = indptr_d[1:n_out + 1] + iota(n_out)
    ext_rank = n_out + iota(L)
    ext_rank[last_pos] = iota(n_out)

    i32 = torch.int32
    return {
        "rank_m": rank_m.to(i32),
        "barrier_m": barrier_m,
        "merged_slot_of_d": merged_slot_of_d.to(i32),
        "rank_back": rank_back.to(i32),
        "barrier_i": barrier_i,
        "ext_rank": ext_rank.to(i32),
    }


def _invert(ranks, n_keep=None):
    """src with src[ranks[i]] = i, as int32; with n_keep only the first
    n_keep positions (ranks past them need not be distinct or below L)."""
    L = ranks.numel()
    src = torch.empty(L if n_keep is None else L + n_keep, dtype=torch.int32,
                      device=ranks.device)
    src[ranks.long()] = torch.arange(L, dtype=torch.int32, device=ranks.device)
    return src if n_keep is None else src[:n_keep].clone()


def _plan_entry(plan, vals_m, ok_m, n_in, n_out):
    """The cache entry: the plan's permutations inverted for
    :func:`sort_apply`.  ext_rank's values run past L, so only its first
    n_out sorted positions are defined: exactly those are kept."""
    return {"L": int(plan["rank_m"].numel()), "n_in": n_in, "n_out": n_out,
            "src_m": _invert(plan["rank_m"]),
            "barrier_m": plan["barrier_m"],
            "src_back": _invert(plan["rank_back"]),
            "barrier_i": plan["barrier_i"],
            "ext_src": _invert(plan["ext_rank"], n_out),
            "vals_m": vals_m, "ok_m": ok_m}


def plan_from_numpy(plan, vals_m, ok_m, n_in, n_out, device):
    """The cache entry of a plan from the JAX package's arrays as numpy:
    ``entry["plan"]``, ``entry["vals_m"]`` and ``entry["ok_m"]`` of its
    ``sortpipe.get_plan`` (which hold the same values as this module's)."""
    def dev(a):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return _trace.upload("sortpipe.plan", torch.from_numpy(np.array(a)),
                             device)

    return _plan_entry({k: dev(v) for k, v in plan.items()}, dev(vals_m),
                       dev(ok_m), n_in, n_out)


def get_plan(spstore, dest_is_row, *, at=False, device):
    """Cached sort-pipeline plan entry of a SparseStore for one direction
    and device.  `at` applies the lazy transpose by swapping roles."""
    if at:
        dest_is_row = not dest_is_row
    device = norm_device(device)
    key = (dest_is_row, device)
    plans = spstore._sortpipe_plans
    if key in plans:
        return plans[key]
    t0 = time.perf_counter()
    n_out = spstore.nrows if dest_is_row else spstore.ncols
    n_in = spstore.ncols if dest_is_row else spstore.nrows
    cap = spstore.nvals()
    rows = spstore.rows.to(device)
    cols = spstore.cols.to(device)
    ok = torch.ones(cap, dtype=torch.bool, device=device)
    plan = build_plan_device(rows, cols, ok, cap=cap, n_out=n_out, n_in=n_in,
                             dest_is_row=dest_is_row)
    L = plan["rank_m"].numel()
    slot = plan["merged_slot_of_d"].long()
    vals = to_carrier(spstore.vals.to(device), spstore.dtype)
    vals_m = torch.zeros(L, dtype=vals.dtype, device=device)
    vals_m[slot] = vals
    ok_m = torch.zeros(L, dtype=torch.int32, device=device)
    _trace.put("sortpipe.plan", ok_m, slot, 1)
    plans[key] = entry = _plan_entry(plan, vals_m, ok_m, n_in, n_out)
    if device.type == "cuda":  # the plan's host seconds run until it is ready
        _trace.read("sortpipe.plan_ready", torch.cuda.synchronize, device)
    _trace.counts["plan.build_s"] += time.perf_counter() - t0
    _trace.counts["plan.bytes"] += _trace.tensor_bytes(entry)
    return entry


def plan_dyn_tuple(entry):
    return (entry["src_m"], entry["barrier_m"], entry["src_back"],
            entry["barrier_i"], entry["ext_src"], entry["vals_m"],
            entry["ok_m"])


# --------------------------------------------------------------------- #
# per-call pipelines
def _fold_rows(plan_dyn, vals_c, ok, mono):
    """Route (vals_c, ok) from the merged to the destination-major layout,
    fold every destination with the monoid and read its total out."""
    _, _, src_back, barrier_i, ext_src, _, _ = plan_dyn
    z_dt = mono.type
    ident_c = carrier_scalar(mono.identity, z_dt)
    i_v, i_h = sort_apply(src_back, [vals_c, ok.to(torch.int32)])
    i_v = torch.where((i_h != 0) & (barrier_i == 0), i_v, ident_c)
    s_v, s_h = segscan(barrier_i, [i_v, i_h], [monoid_combine(mono), COUNT])
    e_v, e_h = sort_apply(ext_src, [s_v, s_h])
    return from_carrier(e_v, z_dt), e_h > 0


def spmv_pipeline(plan_dyn, u_vals, u_valid, ring, a_dt, u_dt, *, kind, n_in,
                  L):
    """(out_vals[n_out] in the monoid's type, out_valid[n_out]).

    plan_dyn = :func:`plan_dyn_tuple` of the plan entry."""
    src_m, barrier_m, _, _, _, vals_m, ok_m = plan_dyn
    mono = ring.monoid
    z_dt = mono.type
    dev = u_vals.device
    u_c = to_carrier(u_vals, u_dt)
    pay_v = torch.cat([u_c, torch.zeros(L - n_in, dtype=u_c.dtype, device=dev)])
    pay_h = torch.cat([u_valid.to(torch.int32),
                       torch.zeros(L - n_in, dtype=torch.int32, device=dev)])
    m_v, m_h = sort_apply(src_m, [pay_v, pay_h])
    f_v, f_h = segscan(barrier_m, [m_v, m_h], [FIRST, FIRST])
    prods = multiply(ring.binaryop, vals_m, f_v, a_dt, u_dt, z_dt, kind)
    ok = (f_h != 0) & (ok_m != 0) & (barrier_m == 0)
    prods = torch.where(ok, prods, carrier_scalar(mono.identity, z_dt))
    return _fold_rows(plan_dyn, prods, ok, mono)


def reduce_pipeline(plan_dyn, mono, in_dt):
    """Row/column monoid reduction of the store itself (the destination
    side of the plan only)."""
    vals_m, ok_m = plan_dyn[5:7]
    z_dt = mono.type
    vals_c = to_carrier(st.cast_values(from_carrier(vals_m, in_dt), in_dt,
                                       z_dt), z_dt)
    ok = ok_m != 0
    vals_c = torch.where(ok, vals_c, carrier_scalar(mono.identity, z_dt))
    return _fold_rows(plan_dyn, vals_c, ok, mono)
