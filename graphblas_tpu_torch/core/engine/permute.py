"""Static-permutation executor: the 3-stage Clos network of
graphblas_tpu/core/engine/permute.py on PyTorch and CUDA.

A permutation of L = T*16384 elements, fixed at plan time, runs as

    stage A : independent within-tile permutations  (kernel K2, tile_perm)
    exchange: (T, 16384) -> (16384, T) transpose    (folded into K3)
    stage B : independent within-row permutations   (K3, mid_perm_tiles)
    exchange: transpose back                        (folded into K3)
    stage C : independent within-tile permutations  (kernel K2)

The JAX package runs the exchanges as XLA transposes around its stage-B
kernel.  Here K3 reads and writes the tile layout (T*128, 128) itself
(:func:`mid_perm_tiles`), so the main path moves no exchange; the
transposes (:func:`_exchange_in`, :func:`_exchange_out`, counted in
``exchanges``) remain in the plain versions only.  :func:`mid_perm_plain`
is stage B on the port layout (16384, T), the Pallas kernel's own.

The host plan (:func:`build_perm_plan`, a copy of the JAX package's) colors
the elements with the native Euler-split coloring and packs the stage
indices 3x7 bits per int32.  Each kernel wrapper runs its CUDA kernel on
CUDA tensors and its plain PyTorch version on CPU tensors; both compute the
same function, and the CPU tests hold the plain versions against the
Pallas kernels in interpret mode.  Values of any 32-bit type move as int32
bits.
"""

import numpy as np
import torch

from ... import native
from .. import trace as _trace
from . import kernels as K

N_TILE = 16384  # elements per Clos block = one (128,128) tile


# --------------------------------------------------------------------- #
# plan construction (host)
def build_perm_plan(pi):
    """Plan the movement out[pi[p]] = in[p] for a permutation pi of [0, L).

    L must be a multiple of 16384.  Returns a dict of host numpy arrays:
    packed_A/packed_C: (L//128, 128) i32; packed_B: (16384, T_pad) i32,
    plus static geometry.  Convert to tensors with plan_to_device.
    """
    pi = np.asarray(pi)
    L = len(pi)
    if L % N_TILE != 0:
        raise ValueError(f"L={L} not a multiple of {N_TILE}")
    n = N_TILE
    T = L // n
    p = np.arange(L, dtype=np.int64)
    q = pi.astype(np.int64)
    b = (p >> 14).astype(np.int32)
    B = (q >> 14).astype(np.int32)

    # level-1 coloring: distinct within src tile and dst tile
    if T == 1:
        # single tile: the final position is itself a valid color; stages
        # B/C degenerate to identities
        c = q.copy()
    else:
        c = native.clos_color(b, B, np.array([0, L], np.int64), T, n)
        c = c.astype(np.int64)

    # ---- stage A: within src tile b, move pos -> c
    i = (p >> 7) & 127
    j = p & 127
    ic = c >> 7
    jc = c & 127
    offs_tiles = np.arange(T + 1, dtype=np.int64) * n
    mu = native.clos_color(i.astype(np.int32), ic.astype(np.int32),
                           offs_tiles, 128, 128).astype(np.int64)
    a_idx = np.empty((T, 128, 128), np.int32)
    a_idx[b, i, mu] = j
    b_idx = np.empty((T, 128, 128), np.int32)
    b_idx[b, mu, ic] = i
    c_idx = np.empty((T, 128, 128), np.int32)
    c_idx[b, ic, jc] = mu
    packed_A = (a_idx | (b_idx << 7) | (c_idx << 14)).reshape(L // 128, 128)

    # ---- stage B: element at (row c, port b) moves to port B; rows padded
    # to T_pad ports with identity dummies
    T_pad = max(128, -(-T // 128) * 128)
    T128 = T_pad // 128
    nd = T_pad - T
    if nd:
        dummy_rows = np.repeat(np.arange(n, dtype=np.int64), nd)
        dummy_ports = np.tile(np.arange(T, T_pad, dtype=np.int64), n)
        rows_all = np.concatenate([c, dummy_rows])
        port_all = np.concatenate([b.astype(np.int64), dummy_ports])
        dest_all = np.concatenate([B.astype(np.int64), dummy_ports])
    else:
        rows_all = c
        port_all = b.astype(np.int64)
        dest_all = B.astype(np.int64)
    order = np.argsort(rows_all, kind="stable")
    rows_s = rows_all[order]
    port_s = port_all[order]
    dest_s = dest_all[order]
    a_sub = (port_s >> 7).astype(np.int32)
    l_s = (port_s & 127).astype(np.int32)
    A2 = (dest_s >> 7).astype(np.int32)
    l2 = (dest_s & 127).astype(np.int64)
    if T128 == 1:
        # one subtile per row: the port itself is a valid color (a row's
        # ports are a permutation of [0, 128))
        nu = port_s.astype(np.int64)
    else:
        offs_rows = np.arange(n + 1, dtype=np.int64) * T_pad
        nu = native.clos_color(a_sub, A2, offs_rows, T128, 128)
        nu = nu.astype(np.int64)
    a_sub = a_sub.astype(np.int64)
    A2 = A2.astype(np.int64)
    rbase = rows_s * T_pad
    b1 = np.empty((n, T128, 128), np.int32)
    b1.reshape(-1)[rbase + (a_sub << 7) + nu] = l_s
    b3 = np.empty((n, T128, 128), np.int32)
    b3.reshape(-1)[rbase + (A2 << 7) + l2] = nu
    bsel = np.empty((n, T128, 128), np.int32)
    bsel.reshape(-1)[rbase + (A2 << 7) + nu] = a_sub
    packed_B = (b1 | (b3 << 7) | (bsel << 14)).reshape(n, T_pad)

    # ---- stage C: within dst tile B, move pos c -> q % n
    order2 = np.argsort(B, kind="stable")
    BB = B[order2].astype(np.int64)
    cc = c[order2]
    qq = q[order2] & (n - 1)
    i2 = cc >> 7
    j2 = cc & 127
    i2p = qq >> 7
    j2p = qq & 127
    mu2 = native.clos_color(i2.astype(np.int32), i2p.astype(np.int32),
                            offs_tiles, 128, 128).astype(np.int64)
    cbase = BB << 14
    a2 = np.empty((T, 128, 128), np.int32)
    a2.reshape(-1)[cbase + (i2 << 7) + mu2] = j2
    b2 = np.empty((T, 128, 128), np.int32)
    b2.reshape(-1)[cbase + (mu2 << 7) + i2p] = i2
    c2 = np.empty((T, 128, 128), np.int32)
    c2.reshape(-1)[cbase + (i2p << 7) + j2p] = mu2
    packed_C = (a2 | (b2 << 7) | (c2 << 14)).reshape(L // 128, 128)

    return {"L": L, "T": T, "T_pad": T_pad, "T128": T128,
            "packed_A": packed_A, "packed_B": packed_B,
            "packed_C": packed_C}


def plan_to_device(plan, device):
    meta = {k: int(plan[k]) for k in ("L", "T", "T_pad", "T128")}
    dev = tuple(_trace.upload("permute.plan", torch.from_numpy(
        np.ascontiguousarray(plan[k], np.int32)), device)
        for k in ("packed_A", "packed_B", "packed_C"))
    return meta, dev


# --------------------------------------------------------------------- #
# K2: within-tile permutation
def _as_i32(x):
    return x if x.dtype == torch.int32 else x.view(torch.int32)


def _require_aligned(name, tensors):
    """K2 and K3 copy with 16-byte cp.async."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must be 16-byte aligned")


def tile_perm_plain(p, arrs):
    """Plain version of K2: lane gather, transpose, lane gather, transpose,
    lane gather on every (128,128) tile, as the Pallas body does."""
    T = p.shape[0] // 128
    p3 = p.reshape(T, 128, 128).long()
    outs = []
    for x in arrs:
        y = torch.gather(x.reshape(T, 128, 128), 2, p3 & 127).transpose(1, 2)
        y = torch.gather(y, 2, (p3 >> 7) & 127).transpose(1, 2)
        y = torch.gather(y, 2, (p3 >> 14) & 127)
        outs.append(y.reshape(-1, 128))
    return outs


def tile_perm(p, arrs):
    """Apply the packed within-tile permutations p ((R,128) i32) to each
    (R,128) 32-bit array in arrs; returns a list of new arrays."""
    arrs = list(arrs)
    for x in arrs:
        if x.shape != p.shape:
            raise ValueError(f"tile_perm: array {tuple(x.shape)} does not "
                             f"match index {tuple(p.shape)}")
    if p.device.type == "cpu":
        return tile_perm_plain(p, arrs)
    ins = [_as_i32(x) for x in arrs]
    K.require_cuda("tile_perm", [p] + ins)
    _require_aligned("tile_perm", [p] + ins)
    if p.dtype != torch.int32 or p.shape[0] % 128 or p.shape[1] != 128:
        raise ValueError("tile_perm: index must be (R,128) int32, R % 128 == 0")
    outs = []
    so = K.lib("tile_perm")
    per = so.tile_perm_channels()
    for c0 in range(0, len(ins), per):
        chunk = ins[c0:c0 + per]
        res = [torch.empty_like(x) for x in chunk]
        K.check("tile_perm", so.tile_perm(p.data_ptr(), K.ptr_array(chunk),
                                          K.ptr_array(res), len(chunk),
                                          p.shape[0] // 128, K.stream_ptr(p)))
        K.launches["tile_perm"] += 1
        outs += res
    return [o.view(x.dtype) for o, x in zip(outs, arrs)]


# --------------------------------------------------------------------- #
# K3: Clos stage B
def mid_perm_plain(p, arrs, T128, T_pad, out_T=None):
    """Plain version of K3 (graphblas_tpu permute._mid_perm_xla plus the
    VMEM zero padding and out_T trimming of _mid_perm_pallas)."""
    outs = []
    p3 = p.reshape(N_TILE, T128, 128).long()
    for y in arrs:
        T = y.shape[1]
        TW = T if out_T is None else min(T, out_T)
        if T < T_pad:
            y = torch.cat([y, y.new_zeros(N_TILE, T_pad - T)], dim=1)
        z = torch.gather(y.reshape(N_TILE, T128, 128), 2, p3 & 127)
        z = torch.gather(z, 1, (p3 >> 14) & 127)
        z = torch.gather(z, 2, (p3 >> 7) & 127)
        outs.append(z.reshape(N_TILE, T_pad)[:, :TW].contiguous())
    return outs


def mid_perm_tiles_plain(p, arrs, T, T128, T_pad, out_T=None):
    """Plain version of K3 on the tile layout: the exchange, the port-layout
    plain version, and the exchange back."""
    zs = mid_perm_plain(p, [_exchange_in(y, T) for y in arrs], T128, T_pad,
                        out_T)
    return [_exchange_out(z) for z in zs]


def _check_mid_index(p, T, T128, T_pad):
    if p.shape != (N_TILE, T_pad) or T128 * 128 != T_pad or T > T_pad:
        raise ValueError(f"mid_perm: bad index shape {tuple(p.shape)} for "
                         f"T={T}, T_pad={T_pad}")


def mid_perm_tiles(p, arrs, T, T128, T_pad, out_T=None):
    """K3 on the tile layout: each (T*128, 128) array x, with x[t, r] =
    y[r, t] for the port-layout y, gives the (TW*128, 128) array whose
    [j, r] is mid_perm_plain's [r, j]: exchange, stage B and exchange in
    one kernel."""
    arrs = list(arrs)
    for y in arrs:
        if y.shape != (T * 128, 128):
            raise ValueError(f"mid_perm_tiles: bad input shape "
                             f"{tuple(y.shape)} for T={T}")
    _check_mid_index(p, T, T128, T_pad)
    if p.device.type == "cpu":
        return mid_perm_tiles_plain(p, arrs, T, T128, T_pad, out_T)
    TW = T if out_T is None else min(T, out_T)
    ins = [_as_i32(y) for y in arrs]
    K.require_cuda("mid_perm", [p] + ins)
    _require_aligned("mid_perm", [p] + ins)
    so = K.lib("mid_perm")
    per = so.mid_perm_channels(T, T128, len(ins))
    if per < 0:
        K.check("mid_perm_channels", -per)
    if per == 0:
        raise ValueError(f"mid_perm_tiles: T_pad={T_pad} needs more shared "
                         f"memory than a block has")
    outs = []
    for c0 in range(0, len(ins), per):
        chunk = ins[c0:c0 + per]
        res = [torch.empty((TW * 128, 128), dtype=torch.int32, device=p.device)
               for _ in chunk]
        K.check("mid_perm_tiles", so.mid_perm_tiles(
            p.data_ptr(), K.ptr_array(chunk), K.ptr_array(res), len(chunk), T,
            T128, TW, K.stream_ptr(p)))
        K.launches["mid_perm"] += 1
        outs += res
    return [o.view(y.dtype) for o, y in zip(outs, arrs)]


# --------------------------------------------------------------------- #
# composition
exchanges = 0  # exchange transposes run (plain versions only), like K.launches


def _exchange_in(y, T):
    """(T*128, 128) tile layout -> (16384, T) port layout."""
    global exchanges
    exchanges += 1
    return y.reshape(T, N_TILE).t().contiguous()


def _exchange_out(z):
    """(16384, TW) port layout -> (TW*128, 128) tile layout."""
    global exchanges
    exchanges += 1
    return z.t().contiguous().reshape(-1, 128)


def _trimmed_tiles(meta, out_limit):
    T = meta["T"]
    return T if out_limit is None else min(T, -(-out_limit // N_TILE))


def apply_perm(meta, dev, arrs, *, out_limit=None, skip_a=False):
    """Permute each (R,128) array in arrs by the planned permutation.

    Returns a list with out[pi[p]] = in[p] flatwise.  out_limit: only the
    first out_limit flat outputs are needed; stage B skips the other port
    groups, stage C runs on the tiles that cover them, and the results have
    ceil(out_limit/16384)*128 rows.  skip_a: the caller already applied
    stage A (the lanepipe gather folds it into its output write)."""
    pa, pb, pc = dev
    ys = list(arrs) if skip_a else tile_perm(pa, arrs)
    return apply_perm_post_a(meta, dev, ys, out_limit=out_limit)


def apply_perm_pre_c(meta, dev, arrs, *, skip_a=False):
    """Stages A and B (with both exchanges): the (R,128) arrays that stage C
    would consume (the lanepipe's fused kernel applies stage C itself)."""
    T, T_pad, T128 = meta["T"], meta["T_pad"], meta["T128"]
    pa, pb, pc = dev
    ys = list(arrs) if skip_a else tile_perm(pa, arrs)
    return mid_perm_tiles(pb, ys, T, T128, T_pad)


def apply_perm_post_a(meta, dev, arrs, *, out_limit=None):
    """Stages B (with both exchanges) and C, on arrays that stage A already
    made (the lanepipe's fused kernel applies the extract's stage A)."""
    T, T_pad, T128 = meta["T"], meta["T_pad"], meta["T128"]
    TV = _trimmed_tiles(meta, out_limit)
    pa, pb, pc = dev
    zs = mid_perm_tiles(pb, arrs, T, T128, T_pad,
                        out_T=None if TV == T else TV)
    return tile_perm(pc[:TV * 128] if TV < T else pc, zs)
