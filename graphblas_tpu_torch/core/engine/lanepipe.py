"""Lane-aligned SpMV engine on PyTorch and CUDA: the PyTorch port of
graphblas_tpu/core/engine/lanepipe.py.

The matvec  out[d] = monoid_k mult(A[d,k], u[k])  runs on a static plan
built once per structure and direction on the host (:func:`build_plan`, a
copy of the JAX package's), as four kernels and a few torch ops:

1. **gather+mult** (K1, :func:`gather_mult`): edges grouped into 256-row
   blocks whose contraction indices fall in one 16384-wide window of u;
   ``u[k]`` is read through the block's column map, multiplied with the
   typed op, invalid slots get the monoid identity (BOOL: codes 0 / 1+v),
   and the route permutation's stage A is applied on the way out.
2. **route** (permute.py): the rest of a static Clos permutation (K3 and
   the exchange transposes) moves products to the S layout, where each
   destination owns a run of rows in one lane.
3. **route stage C + scan + extract stage A** (K4,
   :func:`fused_permC_scan_permA`): a per-lane segmented monoid scan folds
   each run; the carry runs down each lane across tiles.
4. **extract** (permute.py, K3 then K2): destination totals compact into
   natural order; split high-degree destinations are recombined by a small
   tree reduction in torch (:func:`spmv_pipeline`'s ``tail_two_level``).

A sparse u of a non-BOOL type takes the slow branch instead of steps 2-4
fused: K1 also writes the validity of every slot, both channels are routed
(K2, K3), scanned by :func:`lane_segscan` (K5) and extracted.

Every kernel wrapper launches its CUDA kernel for CUDA tensors and runs
its plain PyTorch version for CPU tensors, so the CPU and the card run the
same composition.  :func:`get_plan` returns None for a matrix that packs
over PACK_LIMIT or holds values wider than 32 bits; the caller then takes
the sort pipeline (sortpipe.py) or raises.
"""

import time

import numpy as np
import torch

from .. import trace as _trace
from . import kernels as K
from . import permute as pm
from . import sortpipe as sp

BR_G = 256      # gather-kernel sublanes per block (32768 edge slots)
BR_S = 128      # scan tile rows
WINDOW_K = 16384  # contraction span per gather block (128 u2 rows x 128)
SPLIT_DEG = 2048  # max edges per (virtual) destination run
PACK_LIMIT = 2.5  # max allowed padded-slots/nnz ratio before fallback


# --------------------------------------------------------------------- #
# plan construction (host numpy, one-time per structure+direction)
def _ceil_to(x, m):
    return -(-x // m) * m


def _run_index(group_ids):
    """Running index within consecutive equal groups of a sorted id array."""
    m = len(group_ids)
    if m == 0:
        return np.zeros(0, np.int64)
    starts = np.r_[0, np.flatnonzero(np.diff(group_ids)) + 1]
    lens = np.diff(np.r_[starts, m])
    return np.arange(m) - np.repeat(starts, lens)


def build_plan(d, k, vals_np, n_out, n_in):
    """Build the static lanepipe plan for edges (d[i], k[i]) with values.

    Returns a dict of numpy arrays (converted to device arrays by the
    caller) or None when packing quality is below PACK_LIMIT.
    """
    m = len(d)
    if m == 0 or n_out == 0 or n_in == 0:
        return None
    d = d.astype(np.int64)
    k = k.astype(np.int64)

    # ---- G layout (round-5 unified window-gather blocks).  Every edge
    # needs u[k]; k = w*16384 + a*128 + b (w = 16384-aligned window,
    # a = window row, b = window column).  A block covers ONE window and
    # carries a column map idx1[a, lane]: within a (block, lane) pair all
    # edges sharing window-row a must reference the SAME column b — i.e.
    # a lane hosts at most one distinct k per window row, with arbitrary
    # multiplicity and free row placement.  The kernel then reads u with
    # two lane gathers (z[a,l] = w[a, idx1[a,l]]; g[r,l] = z[arow[r,l],
    # l]).  Packing becomes layered bin-packing over (distinct-k chunks),
    # which absorbs power-law contraction skew: a hot k costs ONE column
    # slot per lane regardless of multiplicity (the round-4 design needed
    # a separate "uni" block kind for this and still rejected RMAT at a
    # 12.8x padding ratio; this layout packs it at ~1.1x).
    so = np.argsort(k, kind="stable")
    k_s = k[so]
    run_k = _run_index(k_s)
    chunk_in_k = run_k // BR_G
    # chunk boundaries: new k or new chunk within k
    is_start = np.r_[True, (np.diff(k_s) != 0) | (np.diff(chunk_in_k) != 0)]
    chunk_id = np.cumsum(is_start) - 1
    starts = np.flatnonzero(is_start)
    c_k = k_s[starts]
    c_cnt = np.diff(np.r_[starts, m])
    c_w = c_k >> 14
    c_a = (c_k >> 7) & 127
    c_b = c_k & 127
    # rank chunks within (window, a-row) by count desc -> layer j;
    # preferred lane = (j + salt[a]) % 128 spreads heavy layers across
    # lanes, and placement probes nearby lanes before opening a new page
    ordc = np.lexsort((-c_cnt, c_a, c_w))
    key_wa = (c_w[ordc] << 7) | c_a[ordc]
    j_rank = _run_index(key_wa)
    salt = np.random.default_rng(0).permutation(128)
    lane_pref = np.empty(len(c_k), np.int64)
    lane_pref[ordc] = (j_rank + salt[c_a[ordc]]) % 128
    # greedy placement, heaviest layers first within each window: each
    # lane keeps an open page (fill <= BR_G rows, at most one chunk per
    # window-row a); a chunk probes its preferred lane then neighbors,
    # and only opens a fresh page when none of the probes fit — this
    # recovers most of the fragmentation the per-lane formulaic paging
    # left (RMAT packed 1.64x before, ~1.2x with probing)
    ordp = np.lexsort((j_rank, c_w[ordc]))
    seq = ordc[ordp]  # chunk ids grouped by window, layer asc
    page = np.empty(len(c_k), np.int64)
    lane_c = np.empty(len(c_k), np.int64)
    rowfill = np.empty(len(c_k), np.int64)
    uwins, win_of_chunk = np.unique(c_w, return_inverse=True)
    blocks_per_win = np.zeros(len(uwins), np.int64)
    cw_seq = c_w[seq]
    pref_seq = lane_pref[seq]
    cnt_seq = c_cnt[seq]
    a_seq = c_a[seq]
    NPROBE = 16
    pg = fill = abits = None
    cur_w = -1
    for i in range(len(seq)):
        if cw_seq[i] != cur_w:
            cur_w = cw_seq[i]
            pg = [0] * 128
            fill = [0] * 128
            abits = [0] * 128
        cnt = int(cnt_seq[i])
        bit = 1 << int(a_seq[i])
        l0 = int(pref_seq[i])
        placed = -1
        for t in range(NPROBE):
            l = (l0 + t) & 127
            if fill[l] + cnt <= BR_G and not (abits[l] & bit):
                placed = l
                break
        if placed < 0:
            # no open page fits: open a fresh page on the lane with the
            # fewest pages so far (page count per window = max over
            # lanes, so advances must stay balanced)
            placed = min(range(128), key=lambda l_: (pg[l_], -fill[l_]))
            pg[placed] += 1
            fill[placed] = 0
            abits[placed] = 0
        ci = seq[i]
        page[ci] = pg[placed]
        lane_c[ci] = placed
        rowfill[ci] = fill[placed]
        fill[placed] += cnt
        abits[placed] |= bit
    if len(seq):
        np.maximum.at(blocks_per_win, win_of_chunk, page + 1)
    block_base_w = np.r_[0, np.cumsum(blocks_per_win)]
    nblocks_g = max(int(block_base_w[-1]), 1)
    slots_per_block = BR_G * 128
    if nblocks_g * slots_per_block > PACK_LIMIT * m + 4 * slots_per_block:
        return None
    R_g = nblocks_g * BR_G
    L_g = R_g * 128

    meta = np.zeros((nblocks_g, 3), np.int32)
    meta[:, 0] = np.repeat(uwins, blocks_per_win).astype(np.int32) \
        if len(uwins) else 0
    c_blk = block_base_w[win_of_chunk] + page

    idx1_g = np.zeros((nblocks_g * 128, 128), np.int32)
    idx1_g[c_blk * 128 + c_a, lane_c] = c_b
    locidx_g = np.zeros((R_g, 128), np.int32)
    okg = np.zeros((R_g, 128), bool)
    avals_g = np.zeros((R_g, 128), vals_np.dtype)

    # edge slots: chunk rows stacked at rowfill..rowfill+cnt-1
    e_chunk = chunk_id  # per sorted edge
    e_row_in_chunk = np.arange(m) - starts[e_chunk]
    e_sub = rowfill[e_chunk] + e_row_in_chunk
    s_g = ((c_blk[e_chunk] * BR_G + e_sub) * 128 + lane_c[e_chunk])
    gslot = np.empty(m, np.int64)
    gslot[so] = s_g
    locidx_g.reshape(-1)[s_g] = c_a[e_chunk]
    okg.reshape(-1)[gslot] = True
    avals_g.reshape(-1)[gslot] = vals_np

    # ---- S layout: virtual destinations, balanced lanes, dest-major runs.
    deg = np.bincount(d, minlength=n_out)
    nsplit = -(-np.maximum(deg, 1) // SPLIT_DEG)      # vdests per dest (>=1)
    vstart = np.r_[0, np.cumsum(nsplit)]
    V = int(vstart[-1])
    two_level = bool((nsplit > 1).any())

    # split-destination recombination (round-5): instead of a second
    # scan+permute level, split dests' partial totals extract into a tiny
    # APPENDIX region of fixed-width power-of-two groups; the caller
    # tree-reduces each group with the monoid and scatters the handful of
    # results into the output (all XLA, no extra kernel launches — the
    # r4 level-2 tail cost 4 launches on a runtime that charges ~45us
    # per launch).
    L2req = 0
    n_split = W2 = 0
    split_ids = l2_mask = None
    if two_level:
        split_mask_d = nsplit > 1
        split_ids = np.flatnonzero(split_mask_d)
        n_split = len(split_ids)
        W2 = 1 << int(np.ceil(np.log2(int(nsplit.max()))))
        grp_of_dest = np.cumsum(split_mask_d) - 1
        vid_dest = np.repeat(np.arange(n_out), nsplit)
        vid_j = _run_index(vid_dest)
        is_split_v = split_mask_d[vid_dest]
        tgt = np.where(is_split_v,
                       n_out + grp_of_dest[vid_dest] * W2 + vid_j,
                       vid_dest)
        L2req = n_out + n_split * W2
        l2_mask = np.zeros((n_split, W2), bool)
        l2_mask.reshape(-1)[grp_of_dest[vid_dest[is_split_v]] * W2
                            + vid_j[is_split_v]] = True

    # edge -> vdest: within dest, edges numbered 0.. in d-stable order
    od = np.argsort(d, kind="stable")
    run_d = _run_index(d[od])
    vid_edge = np.empty(m, np.int64)
    vid_edge[od] = vstart[d[od]] + run_d // SPLIT_DEG

    # vdest weights (leading barrier slot + its edges)
    vdeg = np.bincount(vid_edge, minlength=V)
    wt = vdeg + 1
    # balance lanes: serpentine assignment of weight-sorted vdests
    ov = np.argsort(wt, kind="stable")[::-1]
    lane_of_v = np.empty(V, np.int64)
    idx = np.arange(V)
    fwd = (idx // 128) % 2 == 0
    lane_of_v[ov] = np.where(fwd, idx % 128, 127 - idx % 128)
    # per-lane order: vdests by vid ascending (keeps dest-major runs)
    olv = np.lexsort((np.arange(V), lane_of_v))  # by lane, then vid
    lane_sorted = lane_of_v[olv]
    # start offset (sublane) of each vdest within its lane
    csum = np.cumsum(wt[olv]) - wt[olv]
    lane_first = np.r_[0, np.flatnonzero(np.diff(lane_sorted)) + 1]
    lane_csum0 = np.zeros(128, np.int64)
    lane_csum0[lane_sorted[lane_first]] = csum[lane_first]
    v_sub0 = np.empty(V, np.int64)
    v_sub0[olv] = csum - lane_csum0[lane_sorted]
    lane_len = np.bincount(lane_of_v, weights=wt, minlength=128).astype(np.int64)
    R_s = int(lane_len.max())

    # round L to 4 Clos tiles (65536) so the fused routeC+scan+extA
    # kernel can run 512-row grid steps (4x fewer steps; the extra slack
    # is < 1.5% of nnz at bench sizes and is filled with junk slots)
    L = _ceil_to(max(L_g, R_s * 128, L2req, 1), 4 * BR_S * 128)
    R_scan = L // 128
    if R_scan * 128 > PACK_LIMIT * (m + V) + 4 * BR_S * 128 * 2:
        return None

    barrier = np.ones((R_scan, 128), bool)  # junk slots isolate themselves
    oks = np.zeros((R_scan, 128), bool)
    ext_rank = np.zeros(R_scan * 128, np.int32)

    # vdest slots: barrier slot at (v_sub0, lane); edges after it
    bar_flat = v_sub0 * 128 + lane_of_v
    # mark non-barrier inside each run: first clear everything in lanes below
    # lane_len, then set barriers
    row_idx = np.arange(R_s)
    in_use = row_idx[:, None] < lane_len[None, :]
    barrier[:R_s][in_use] = False
    barrier.reshape(-1)[bar_flat] = True

    # edge slots: position = vdest start + 1 + running index within vdest
    ovv = np.lexsort((np.arange(m), vid_edge))
    run_v = _run_index(vid_edge[ovv])
    s_sub = np.empty(m, np.int64)
    s_sub[ovv] = v_sub0[vid_edge[ovv]] + 1 + run_v
    sslot = s_sub * 128 + lane_of_v[vid_edge]
    oks.reshape(-1)[sslot] = True
    assert barrier[0].all() or R_s == 0  # lane scan relies on this

    # extraction: last slot of each vdest gets a rank that PLACES the vdest
    # total for the next stage; everything else gets junk ranks above it.
    last_flat = (v_sub0 + wt - 1) * 128 + lane_of_v
    junk = np.ones(R_scan * 128, bool)
    junk[last_flat] = False
    if two_level:
        # ranks must be a full permutation of [0, L): unsplit totals land
        # at their natural dest position, split partials in the appendix,
        # junk fills the unassigned positions first
        ext_rank[last_flat] = tgt.astype(np.int32)
        unassigned = np.setdiff1d(np.arange(L2req, dtype=np.int64), tgt)
        njunk = int(junk.sum())
        fill = np.concatenate(
            [unassigned, L2req + np.arange(njunk - len(unassigned))])
        ext_rank[junk] = fill.astype(np.int32)
    else:
        ext_rank[last_flat] = np.arange(V, dtype=np.int32)
        ext_rank[junk] = V + np.arange(int(junk.sum()), dtype=np.int32)

    # route: gslot(edge) -> sslot(edge); free G slots -> free S slots
    route = np.empty(L, np.int32)
    edge_g = gslot  # already in original edge order
    route[edge_g] = sslot
    gused = np.zeros(L, bool)
    gused[edge_g] = True
    sused = np.zeros(L, bool)
    sused[sslot] = True
    route[~gused] = np.flatnonzero(~sused)

    plan = {
        "R_g": R_g, "L": L, "R_scan": R_scan, "V": V, "n_out": n_out,
        "n_in": n_in, "nblocks_g": nblocks_g, "two_level": two_level,
        "n_split": n_split, "W2": W2, "L2req": L2req,
        "out_ok": deg > 0,
        "meta": meta,
        "idx1_g": idx1_g,
        "locidx_g": locidx_g,
        "okg": okg,
        "avals_g": avals_g,
        "barrier": barrier,
        "oks": oks,
        "ext_rank": ext_rank,
        "route": route,
    }
    if two_level:
        plan.update({"l2_ids": split_ids.astype(np.int32),
                     "l2_mask": l2_mask})
    return plan


# --------------------------------------------------------------------- #
# K1: gather + multiply
def gather_mult_plain(plan_g, u2, u2ok, mult, a_dt, u_dt, mono, *, kind, R_g,
                      nblocks, packed=False, full_u=False, permA=None):
    """Plain version of K1 (see :func:`gather_mult`)."""
    wbase, idx1, locidx, okg, avals = plan_g
    z_dt = mono.type
    dev = locidx.device
    per_blk = BR_G * 128
    arow = locidx.reshape(-1).long()
    blk = torch.arange(nblocks, device=dev).repeat_interleave(per_blk)
    lanes = torch.arange(128, device=dev).repeat(R_g)
    wrow = wbase[:, 0].long().repeat_interleave(per_blk) * 128
    col = idx1.reshape(-1)[(blk * 128 + arow) * 128 + lanes].long()
    uo = (wrow + arow) * 128 + col
    g = u2.reshape(-1)[uo].reshape(R_g, 128)
    ok = okg != 0
    if not full_u:
        ok = ok & (u2ok.reshape(-1)[uo].reshape(R_g, 128) != 0)
    p = sp.multiply(mult, avals, g, a_dt, u_dt, z_dt, kind)
    if packed:
        out = torch.where(ok, p.to(torch.int32) + 1, 0).to(torch.int32)
    else:
        out = torch.where(ok, p, sp.carrier_scalar(mono.identity, z_dt))
    okp = None if (packed or full_u) else ok.to(torch.int32)
    if permA is not None:
        pa = permA[:R_g]
        out = pm.tile_perm_plain(pa, [out])[0]
        if okp is not None:
            okp = pm.tile_perm_plain(pa, [okp])[0]
    return out, okp


def _ident_bits(mono):
    z_dt = mono.type
    v = np.array(sp.carrier_scalar(mono.identity, z_dt),
                 np.float32 if z_dt.is_float else np.int32)
    return int(v.view(np.int32))


def gather_mult(plan_g, u2, u2ok, mult, a_dt, u_dt, mono, *, kind, R_g,
                nblocks, packed=False, full_u=False, permA=None):
    """Gather u through the G-layout plan and multiply (kernel K1).

    Returns (prods, okp): prods (R_g,128) on the monoid's carrier with the
    identity at invalid slots, or, with packed=True (BOOL monoids), int32
    codes 0 = invalid / 1 + value.  okp is the u-validity channel, None
    when packed or full_u (every u element valid).  permA: packed stage-A
    indices of the route permutation, applied to the output tiles (only
    the first R_g rows are read)."""
    if u2.device.type == "cpu":
        return gather_mult_plain(plan_g, u2, u2ok, mult, a_dt, u_dt, mono,
                                 kind=kind, R_g=R_g, nblocks=nblocks,
                                 packed=packed, full_u=full_u, permA=permA)
    wbase, idx1, locidx, okg, avals = plan_g
    z_dt = mono.type
    x_dt, y_dt = (a_dt, u_dt) if kind == "mxv" else (u_dt, a_dt)
    k1 = K.k1_code(mult, x_dt, y_dt, z_dt)
    if k1 is None:
        # eligibility (sortpipe.eligible_spmv) refuses these up front
        raise ValueError(f"gather_mult: K1 does not take {mult!r} over "
                         f"{x_dt} and {y_dt} into {z_dt}")
    tensors = [wbase, u2, u2ok, idx1, locidx, okg, avals]
    if permA is not None:
        tensors.append(permA)
    K.require_cuda("gather_mult", tensors)
    # the kernel moves the slot arrays 16 bytes at a time
    pm._require_aligned("gather_mult", [idx1, locidx, okg, avals]
                        + ([] if permA is None else [permA]))
    if (locidx.shape != (R_g, 128) or okg.shape != (R_g, 128)
            or avals.shape != (R_g, 128) or R_g != nblocks * BR_G
            or idx1.shape != (nblocks * 128, 128) or u2.shape != u2ok.shape
            or (permA is not None and permA.shape[0] < R_g)):
        raise ValueError("gather_mult: plan arrays do not match R_g/nblocks")
    out = torch.empty((R_g, 128), device=u2.device,
                      dtype=torch.int32 if packed else sp.carrier_dtype(z_dt))
    okp = None if (packed or full_u) else torch.empty(
        (R_g, 128), device=u2.device, dtype=torch.int32)
    rc = K.lib("gather_mult").gather_mult(
        wbase.data_ptr(), u2.data_ptr(), u2ok.data_ptr(), idx1.data_ptr(),
        locidx.data_ptr(), okg.data_ptr(), avals.data_ptr(),
        None if permA is None else permA.data_ptr(), out.data_ptr(),
        None if okp is None else okp.data_ptr(), R_g // 128, *k1,
        int(kind == "mxv"), int(packed), int(full_u),
        0 if packed else _ident_bits(mono), K.stream_ptr(u2))
    K.check("gather_mult", rc)
    K.launches["gather_mult"] += 1
    return out, okp


# --------------------------------------------------------------------- #
# segmented scans
def lane_segscan_plain(barrier, vals, ok, combine):
    """Plain version of K5 (see :func:`lane_segscan`)."""
    v = sp.segscan_plain(barrier, vals, combine.fn)
    h = None if ok is None else sp.segscan_plain(barrier, ok, torch.maximum)
    return v, h


def lane_segscan(barrier, vals, ok, combine):
    """Per-lane segmented scan down the rows (kernel K5): vals by the
    combine, and a validity channel ok (any int32) by max.  Returns
    (scanned_vals, scanned_ok), or (scanned_vals, None) with ok=None.

    All arrays (R,128), R a multiple of 128; runs restart where barrier is
    set, and row 0 starts one either way.  On CUDA this is one kernel
    launch, a single pass whose carry comes from a look-back per lane,
    after one memset that clears its scratch; the arrays must be 16-byte
    aligned.  See csrc/lane_segscan.cu."""
    if vals.device.type == "cpu":
        return lane_segscan_plain(barrier, vals, ok, combine)
    if combine.monoid not in K.MONOID_OP:
        raise NotImplementedError(f"monoid {combine.monoid} has no CUDA scan")
    v = pm._as_i32(vals)
    tensors = [barrier, v] + ([] if ok is None else [ok])
    K.require_cuda("lane_segscan", tensors)
    R = v.shape[0]
    if R % 128 or v.dim() != 2 or v.shape[1] != 128 or any(
            t.shape != v.shape for t in tensors):
        raise ValueError("lane_segscan: arrays must be (R,128), R % 128 == 0")
    if ok is not None and ok.dtype != torch.int32:
        raise TypeError("lane_segscan: ok must be int32")
    # the kernel moves 16 bytes a thread
    pm._require_aligned("lane_segscan", tensors)
    ntiles = R // 128
    nch = 1 if ok is None else 2
    # per tile, channel and lane a 64-bit published word, then the counter
    scratch = torch.empty(2 * (nch * 128 * ntiles + 1), dtype=torch.int32,
                          device=v.device)
    out = torch.empty_like(v)
    outh = None if ok is None else torch.empty_like(ok)
    rc = K.lib("lane_segscan").lane_segscan(
        barrier.data_ptr(), v.data_ptr(),
        None if ok is None else ok.data_ptr(), scratch.data_ptr(),
        out.data_ptr(), None if ok is None else outh.data_ptr(), ntiles,
        K.DT[sp.kernel_dtype(combine.dt)], K.MONOID_OP[combine.monoid],
        int(combine.packed), K.stream_ptr(v))
    K.check("lane_segscan", rc)
    K.launches["lane_segscan"] += 1
    return out.view(vals.dtype), outh


def fused_permC_scan_permA_plain(pc_route, barrier, pa_ext, vals, combine):
    """Plain version of K4 (see :func:`fused_permC_scan_permA`)."""
    v = pm.tile_perm_plain(pc_route, [vals])[0]
    v = sp.segscan_plain(barrier, v, combine.fn)
    return pm.tile_perm_plain(pa_ext, [v])[0]


def fused_permC_scan_permA(pc_route, barrier, pa_ext, vals, combine):
    """Route stage C, per-lane segmented scan, extract stage A (kernel K4).

    All arrays (R,128), R a multiple of 128; the scan carry runs down each
    lane across all tiles.  On CUDA this is one kernel launch, a single
    pass whose carry comes from a look-back, after one memset that clears
    its scratch; see csrc/fused_scan.cu."""
    if vals.device.type == "cpu":
        return fused_permC_scan_permA_plain(pc_route, barrier, pa_ext, vals,
                                            combine)
    if combine.monoid not in K.MONOID_OP:
        raise NotImplementedError(f"monoid {combine.monoid} has no CUDA scan")
    v = pm._as_i32(vals)
    K.require_cuda("fused_permC_scan_permA", [pc_route, barrier, pa_ext, v])
    R = v.shape[0]
    if (R % 128 or v.shape[1] != 128 or pc_route.shape != v.shape
            or barrier.shape != v.shape or pa_ext.shape != v.shape):
        raise ValueError("fused_permC_scan_permA: arrays must be (R,128)")
    ntiles = R // 128
    # per tile and lane a 64-bit published word, then the tile counter
    scratch = torch.empty(2 * (ntiles * 128 + 1), dtype=torch.int32,
                          device=v.device)
    out = torch.empty_like(v)
    rc = K.lib("fused_scan").fused_scan(
        pc_route.data_ptr(), barrier.data_ptr(), pa_ext.data_ptr(),
        v.data_ptr(), scratch.data_ptr(), out.data_ptr(), ntiles,
        K.DT[sp.kernel_dtype(combine.dt)], K.MONOID_OP[combine.monoid],
        int(combine.packed), K.stream_ptr(v))
    K.check("fused_permC_scan_permA", rc)
    K.launches["fused_permC_scan_permA"] += 1
    return out.view(vals.dtype)


# --------------------------------------------------------------------- #
# eligibility and plan cache
def eligible(ring, a_dt, u_dt):
    return sp.eligible_spmv(ring, a_dt, u_dt)


def plan_from_numpy(plan, perm_plans, device):
    """The cache entry of a plan: numpy dicts from :func:`build_plan` and
    :func:`permute.build_perm_plan` (or the JAX package's functions of the
    same names, which return the same arrays) -> tensors on device."""
    dev = {}
    for name in ("meta", "idx1_g", "locidx_g", "okg", "avals_g", "barrier",
                 "oks", "out_ok", "l2_ids", "l2_mask"):
        if name in plan:
            arr = np.asarray(plan[name])
            if arr.dtype == bool:
                arr = arr.astype(np.int32)
            elif arr.dtype == np.uint32:
                arr = arr.view(np.int32)
            dev[name] = _trace.upload("lanepipe.plan", torch.from_numpy(
                np.ascontiguousarray(arr)), device)
    entry = {k: v for k, v in plan.items() if not isinstance(v, np.ndarray)}
    pmeta = {}
    for pname in ("routeP", "extP"):
        pmeta[pname], dev[pname] = pm.plan_to_device(perm_plans[pname], device)
    entry["permmeta"] = pmeta
    entry["dev"] = dev
    return entry


def get_plan(spstore, dest_is_row, *, at=False, device):
    """Cached lanepipe plan entry of a SparseStore for one direction and
    device, or None when the plan would exceed PACK_LIMIT."""
    if at:
        dest_is_row = not dest_is_row
    device = sp.norm_device(device)
    key = (dest_is_row, device)
    plans = spstore._lanepipe_plans
    if key in plans:
        return plans[key]
    t0 = time.perf_counter()
    plans[key] = entry = _build_entry(spstore, dest_is_row, device)
    _trace.counts["plan.build_s"] += time.perf_counter() - t0
    if entry is not None:
        _trace.counts["plan.bytes"] += _trace.tensor_bytes(entry)
    return entry


def _build_entry(spstore, dest_is_row, device):
    """The plan entry of :func:`get_plan`'s miss, or None."""
    rows, cols, vals = spstore.host_coo()
    if vals.dtype.itemsize > 4:
        return None
    d = rows if dest_is_row else cols
    k = cols if dest_is_row else rows
    n_out = spstore.nrows if dest_is_row else spstore.ncols
    n_in = spstore.ncols if dest_is_row else spstore.nrows
    plan = build_plan(d, k, sp.np_carrier(vals, spstore.dtype), n_out, n_in)
    if plan is None:
        return None
    t0 = time.perf_counter()
    perms = {"routeP": pm.build_perm_plan(plan["route"]),
             "extP": pm.build_perm_plan(plan["ext_rank"])}
    _trace.counts["plan.perm_s"] += time.perf_counter() - t0
    return plan_from_numpy(plan, perms, device)


def plan_dyn_tuple(entry):
    d = entry["dev"]
    base = (d["meta"], d["idx1_g"], d["locidx_g"], d["okg"], d["avals_g"],
            d["barrier"], d["oks"], d["routeP"], d["extP"], d["out_ok"])
    if entry["two_level"]:
        return base + (d["l2_ids"], d["l2_mask"])
    return base


# --------------------------------------------------------------------- #
# the pipeline
def pad_u(u_vals, u_valid, u_dt, n_in):
    """Dense u -> (Ru,128) carrier and validity tables, zero-padded to whole
    16384-wide windows."""
    dev = u_vals.device
    Ru = _ceil_to(max(n_in, 1), WINDOW_K) // 128
    pad = Ru * 128 - n_in
    u2 = torch.cat([sp.to_carrier(u_vals, u_dt),
                    torch.zeros(pad, dtype=sp.carrier_dtype(u_dt), device=dev)])
    u2ok = torch.cat([u_valid.to(torch.int32),
                      torch.zeros(pad, dtype=torch.int32, device=dev)])
    return u2.reshape(Ru, 128), u2ok.reshape(Ru, 128)


def pad_rows(x, fill, L):
    """Flatten x and fill it up to L elements; returns (L//128, 128).  The
    fill tiles are constant, so a within-tile permutation leaves them be."""
    x = x.reshape(-1)
    if L > x.numel():
        x = torch.cat([x, torch.full((L - x.numel(),), fill, dtype=x.dtype,
                                     device=x.device)])
    return x.reshape(-1, 128)


def combines(mono):
    """(combine, combine_packed) scan combines of a typed monoid."""
    z_dt = mono.type
    comb = sp.monoid_scan_fn(mono.parent.name, z_dt)

    def combine_packed_fn(a, b):
        # codes: 0 = no value, 1+v = value v; 0 is the packed identity
        r = comb(a - 1, b - 1) + 1
        return torch.where(a == 0, b, torch.where(b == 0, a, r))

    return (sp.Combine(comb, mono.parent.name, z_dt, False),
            sp.Combine(combine_packed_fn, mono.parent.name, z_dt, True))


def spmv_pipeline(plan_dyn, meta, u_vals, u_valid, ring, a_dt, u_dt, *,
                  kind):
    """(out_vals[n_out] in the monoid's type, out_valid[n_out]).

    BOOL monoids pack (validity, value) into one int32 code 0 / 1+value.
    Other types check ``u_valid.all()`` on the host (one sync per call):
    a fully valid u (the PageRank shape) takes the fast branch, with one
    value channel and the plan's static output structure (deg > 0); a
    sparse u takes the slow branch, which routes and scans a validity
    channel too (:func:`lane_segscan`).
    """
    (gmeta, idx1, locidx, okg, avals, barrier, oks, routeP, extP,
     out_ok) = plan_dyn[:10]
    R_g = meta["R_g"]
    L = meta["L"]
    n_out = meta["n_out"]
    n_in = meta["n_in"]
    nblocks = meta["nblocks_g"]
    two_level = meta["two_level"]
    if two_level:
        l2_ids, l2_mask = plan_dyn[10:12]
        n_split = meta["n_split"]
        W2 = meta["W2"]
        L2req = meta["L2req"]
    lim1 = L2req if two_level else n_out
    mult = ring.binaryop
    mono = ring.monoid
    z_dt = mono.type
    ident_c = sp.carrier_scalar(mono.identity, z_dt)
    packed = z_dt.is_bool
    u2, u2ok = pad_u(u_vals, u_valid, u_dt, n_in)
    comb = sp.monoid_scan_fn(mono.parent.name, z_dt)
    combine, combine_packed = combines(mono)

    def gather(want_packed, full_u):
        return gather_mult((gmeta, idx1, locidx, okg, avals), u2, u2ok, mult,
                           a_dt, u_dt, mono, kind=kind, R_g=R_g,
                           nblocks=nblocks, packed=want_packed,
                           full_u=full_u, permA=routeP[0])

    def pad_to_L(x, fill):
        return pad_rows(x, fill, L)

    def tail_two_level(e_v, cmb, fill):
        """Recombine split-destination partials: identity-mask the appendix
        groups, tree-reduce each with the monoid, scatter the results into
        the natural-order totals."""
        app = e_v[n_out:n_out + n_split * W2].reshape(n_split, W2)
        app = torch.where(l2_mask != 0, app, fill)
        w = W2
        while w > 1:
            half = w // 2
            app = cmb(app[:, :half], app[:, half:w])
            w = half
        out = e_v[:n_out].clone()
        out[l2_ids.long()] = app[:, 0].to(out.dtype)
        return out

    def run_single(pv_flat, cmb, fill):
        """Route + scan + extract one channel; returns flat e_v."""
        preC, = pm.apply_perm_pre_c(meta["permmeta"]["routeP"], routeP,
                                    [pv_flat], skip_a=True)
        yAe = fused_permC_scan_permA(routeP[2], barrier, extP[0], preC, cmb)
        e_v, = pm.apply_perm_post_a(meta["permmeta"]["extP"], extP, [yAe],
                                    out_limit=lim1)
        e_v = e_v.reshape(-1)
        if two_level:
            e_v = tail_two_level(e_v, cmb.fn, fill)
        return e_v

    if packed:
        codes, _ = gather(True, False)
        e_v = run_single(pad_to_L(codes, 0), combine_packed, 0)
        out = torch.clamp(e_v[:n_out] - 1, min=0)
        return sp.from_carrier(out, z_dt), e_v[:n_out] > 0

    if _trace.read("lanepipe.u_valid_all", bool, u_valid.all()):
        prods, _ = gather(False, True)
        e_v = run_single(pad_to_L(prods, ident_c), combine, ident_c)
        return sp.from_carrier(e_v[:n_out], z_dt), out_ok[:n_out] != 0

    prods, okp = gather(False, False)
    pf = pad_to_L(prods, ident_c)
    hf = pad_to_L(okp, 0)
    pv2, ph_r = pm.apply_perm(meta["permmeta"]["routeP"], routeP, [pf, hf],
                              skip_a=True)
    ph2 = (ph_r != 0) & (oks != 0)
    pv2 = torch.where(ph2, pv2, ident_c)
    s_v, s_h = lane_segscan(barrier, pv2, ph2.to(torch.int32), combine)
    e_v, e_h = pm.apply_perm(meta["permmeta"]["extP"], extP, [s_v, s_h],
                             out_limit=lim1)
    e_v = e_v.reshape(-1)
    e_h = e_h.reshape(-1)
    if two_level:
        # partials with no valid contribution act as the identity; group
        # validity = any partial valid
        e_v = torch.where(e_h != 0, e_v, ident_c)
        e_v = tail_two_level(e_v, comb, ident_c)
        e_h = tail_two_level(e_h, torch.maximum, 0)
    return sp.from_carrier(e_v[:n_out], z_dt), e_h[:n_out] > 0
