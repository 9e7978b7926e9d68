#!/usr/bin/env python3
"""Smoke run of graphblas_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--out DIR]

Run from the repository root.  It builds the host native libraries and
the four CUDA kernels of the lanepipe SpMV from the sources, then:

1. kernel phase: on the plans of bench.py's zipf graph (n = 2**19, degree
   8, FP32 weights 1/outdeg, and its BOOL twin), runs each kernel and its
   plain PyTorch version on the card on the same inputs and compares them
   (bitwise for the permutations and integer paths, rel 1e-5 for the FP32
   scan), including the extract trimmed to TV=34 and to TV=1, and times
   both with CUDA events;
2. PageRank (bench.py's pr_body, 20 iterations of ss.iterate) on the zipf
   graph, checked against a float64 scipy power iteration;
3. level BFS (bench.py's bfs_body with the lor-reduce cond) on the BOOL
   graph, checked level by level against a numpy frontier BFS;
4. PageRank on bench.py's RMAT graph (scale 17), checked the same way.

Each main-path phase sets the kernels' launch counts to 0 just before it
runs and fails if a kernel was not launched.  The line before the last is
{"kernels": [...]}, the last {"ok": true, "device": {...}}.  Any failure
exits non-zero before the last line.  It uses no JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and FP32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SEED = 0
SPIN_CYCLES = 20_000_000  # ~10 ms of spinning at the H100's clock
RUNS = 5  # timed runs of each loop; the median is reported


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------- #
# graphs: copies of bench.py's generators (that file imports no torch, but
# this script must stand without the JAX side of the repository)
def build_graph(n, avg_deg, seed=SEED):
    """Power-law digraph; every node has >=1 out- and in-edge."""
    rng = np.random.default_rng(seed)
    nnz = n * avg_deg
    src = rng.integers(0, n, nnz)
    dst = (rng.zipf(1.5, nnz) - 1) % n
    keep = src != dst
    src, dst = src[keep], dst[keep]
    base = np.arange(n, dtype=np.int64)
    src = np.concatenate([src, base, base])
    dst = np.concatenate([dst, (base + 1) % n, (base * 2 + 1) % n])
    lin = np.unique(src.astype(np.int64) * n + dst)
    return (lin // n).astype(np.int64), (lin % n).astype(np.int64)


def build_rmat(scale, efactor=16, seed=1):
    """Graph500-style RMAT digraph (a,b,c,d = .57,.19,.19,.05)."""
    n = 1 << scale
    m = n * efactor
    rng = np.random.default_rng(seed)
    r = np.zeros(m, np.int64)
    c = np.zeros(m, np.int64)
    for bit in range(scale):
        u = rng.random(m)
        rbit = u >= 0.76
        cbit = ((u >= 0.57) & (u < 0.76)) | (u >= 0.95)
        r |= rbit.astype(np.int64) << bit
        c |= cbit.astype(np.int64) << bit
    keep = r != c
    r, c = r[keep], c[keep]
    base = np.arange(n, dtype=np.int64)
    r = np.concatenate([r, base])
    c = np.concatenate([c, (base + 1) % n])
    lin = np.unique(r * n + c)
    return (lin // n), (lin % n), n


# ---------------------------------------------------------------------- #
# references
def pagerank_ref(src, dst, w, n, iters):
    import scipy.sparse as sps

    M = sps.csr_matrix((w.astype(np.float64), (dst, src)), shape=(n, n))
    r = np.full(n, 1.0 / n)
    for _ in range(iters):
        r = 0.85 * (M @ r) + 0.15 / n
    return r


def bfs_ref(src, dst, n):
    import scipy.sparse as sps

    S = sps.csr_matrix((np.ones(len(src)), (dst, src)), shape=(n, n))
    lev = np.zeros(n, np.int64)
    front = np.zeros(n, bool)
    front[0] = True
    seen = front.copy()
    d = 0
    while front.any():
        d += 1
        lev[front] = d
        front = ((S @ front.astype(np.float64)) > 0) & ~seen
        seen |= front
    return lev, d


# ---------------------------------------------------------------------- #
def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps=20, warm=3):
    """Median device ms of fn over reps runs, each between two CUDA events.

    A spin kernel queued before the start event keeps the card busy while
    the host enqueues fn, so the events bracket device work and not the
    host's launch overhead."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def profile_breakdown(torch, fn, label, wall_unprofiled_ms):
    """Device time by kernel over one fn() run, from torch.profiler, and the
    card's idle share: 1 - device busy / wall_unprofiled_ms, the wall time
    of the same work measured without the profiler (which slows the host).
    The idle share over the profiled wall is kept beside it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) is None or \
                "CUDA" not in str(ev.device_type):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((ev.key, us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    idle = 1 - busy / wall_unprofiled_ms
    log(f"  profile {label}: device busy {busy:.4f} ms; wall unprofiled "
        f"{wall_unprofiled_ms:.4f} ms, idle share {idle:.4f}; wall profiled "
        f"{wall_ms:.4f} ms, idle share {1 - busy / wall_ms:.4f}")
    for key, ms, cnt in rows[:12]:
        log(f"    {ms:9.3f} ms  x{cnt:<5d} {key[:90]}")
    return {"wall_unprofiled_ms": wall_unprofiled_ms, "device_busy_ms": busy,
            "idle_share": idle, "wall_profiled_ms": wall_ms,
            "idle_share_profiled": 1 - busy / wall_ms,
            "kernels": [{"name": k, "ms": m, "count": c} for k, m, c in rows]}


def bound(nbytes, nops=0):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    32-bit operations over the FP32 rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def compare(name, got, want, rel=None):
    """Max abs error; bitwise equality (rel None) or rel tolerance."""
    import torch

    g = got.detach().reshape(-1)
    w = want.detach().reshape(-1)
    if g.shape != w.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if g.dtype.is_floating_point:
        err = float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
    else:
        err = float((g.long() - w.long()).abs().max()) if g.numel() else 0.0
    if rel is None:
        if g.element_size() == 4:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if not bool(torch.equal(g, w)):
            fail(f"{name}: kernel differs from its plain version "
                 f"(max abs err {err})")
    else:
        tol = rel * w.double().abs() + 1e-30
        bad = int(((g.double() - w.double()).abs() > tol).sum())
        if bad:
            fail(f"{name}: {bad} elements beyond rel {rel} (max abs err {err})")
    log(f"  {name}: ok, max_abs_err {err:.3g}")
    return err


def kernel_phase(gb, torch, dev, A, Ab, results):
    """Each kernel against its plain version at the main path's shapes."""
    from graphblas_tpu_torch.core.engine import lanepipe as lp
    from graphblas_tpu_torch.core.engine import permute as pm
    from graphblas_tpu_torch.core.dtypes import BOOL, FP32

    rng = np.random.default_rng(SEED)
    rows = {}

    def plan_of(M):
        t0 = time.perf_counter()
        e = lp.get_plan(M._sparse, False, device=dev)  # vxm: dest = column
        if e is None:
            fail("plan exceeds PACK_LIMIT")
        torch.cuda.synchronize()
        return e, time.perf_counter() - t0

    e, secs = plan_of(A)
    eb, secs_b = plan_of(Ab)
    log(f"plans: FP32 {secs:.2f} s, BOOL {secs_b:.2f} s; L={e['L']} "
        f"R_g={e['R_g']} nblocks_g={e['nblocks_g']} R_scan={e['R_scan']} "
        f"V={e['V']} two_level={e['two_level']} n_split={e.get('n_split')} "
        f"W2={e.get('W2')} T={e['permmeta']['routeP']['T']} "
        f"T_pad={e['permmeta']['routeP']['T_pad']}")

    def add(name, source, replaces, err, ms, plain_ms, nbytes, nops=0,
            library_ms=None):
        b_ms, b_by = bound(nbytes, nops)
        rows[name] = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": 0,
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": library_ms}
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB)"
            + ("" if library_ms is None else f", torch.take {library_ms:.4f} ms"))

    ring = gb.semiring.plus_times["FP32"]
    mono, mult = ring.monoid, ring.binaryop
    ringb = gb.semiring.lor_land["BOOL"]
    d, db = e["dev"], eb["dev"]
    routeP, extP = d["routeP"], d["extP"]
    n = e["n_in"]
    R_g, L, nblocks = e["R_g"], e["L"], e["nblocks_g"]

    # ---- K1 gather_mult, the PageRank variant (full_u, permA)
    u = torch.from_numpy(rng.random(n, dtype=np.float32)).to(dev)
    u2, u2ok = lp.pad_u(u, torch.ones(n, dtype=torch.bool, device=dev), FP32, n)
    plan_g = (d["meta"], d["idx1_g"], d["locidx_g"], d["okg"], d["avals_g"])
    kw = dict(kind="vxm", R_g=R_g, nblocks=nblocks, full_u=True,
              permA=routeP[0])
    k1 = lambda: lp.gather_mult(plan_g, u2, u2ok, mult, FP32, FP32, mono, **kw)[0]  # noqa: E731
    p1 = lambda: lp.gather_mult_plain(plan_g, u2, u2ok, mult, FP32, FP32, mono, **kw)[0]  # noqa: E731
    prods = k1()
    err = compare("K1 gather_mult FP32 full_u+permA", prods, p1())
    # the BFS variant: BOOL packed codes with a sparse u
    ub = torch.from_numpy(rng.random(n) < 0.3).to(dev)
    ub2, ub2ok = lp.pad_u(ub, ub, BOOL, n)
    plan_gb = (db["meta"], db["idx1_g"], db["locidx_g"], db["okg"], db["avals_g"])
    kwb = dict(kind="vxm", R_g=eb["R_g"], nblocks=eb["nblocks_g"], packed=True,
               permA=db["routeP"][0])
    codes = lp.gather_mult(plan_gb, ub2, ub2ok, ringb.binaryop, BOOL, BOOL,
                           ringb.monoid, **kwb)[0]
    compare("K1 gather_mult BOOL packed+permA", codes, lp.gather_mult_plain(
        plan_gb, ub2, ub2ok, ringb.binaryop, BOOL, BOOL, ringb.monoid, **kwb)[0])
    # the timed variant is full_u: u2ok is never read
    nbytes = 4 * (5 * R_g * 128 + nblocks * 128 * 128 + u2.numel()
                  + 3 * nblocks)
    add("gather_mult", "graphblas_tpu_torch/csrc/gather_mult.cu",
        "graphblas_tpu/core/engine/lanepipe.py:363", err,
        cuda_ms(torch, k1), cuda_ms(torch, p1), nbytes, nops=R_g * 128)

    # ---- K3 mid_perm: the route in full, the extract trimmed to TV
    mr, me = e["permmeta"]["routeP"], e["permmeta"]["extP"]
    pf = lp.pad_rows(prods, 0.0, L)
    x_mid = pm._exchange_in(pf, mr["T"])
    k3 = lambda: pm.mid_perm(routeP[1], [x_mid], mr["T128"], mr["T_pad"])[0]  # noqa: E731
    p3 = lambda: pm.mid_perm_plain(routeP[1], [x_mid], mr["T128"], mr["T_pad"])[0]  # noqa: E731
    err3 = compare("K3 mid_perm route", k3(), p3())
    lim1 = e["L2req"] if e["two_level"] else e["n_out"]
    TV = pm._trimmed_tiles(me, lim1)
    y_ext = pm._exchange_in(torch.from_numpy(
        rng.integers(-2**31, 2**31, (L // 128, 128), dtype=np.int64)
        .astype(np.int32)).to(dev), me["T"])
    compare(f"K3 mid_perm extract out_T={TV}",
            pm.mid_perm(extP[1], [y_ext], me["T128"], me["T_pad"], out_T=TV)[0],
            pm.mid_perm_plain(extP[1], [y_ext], me["T128"], me["T_pad"], out_T=TV)[0])
    src3 = pm.mid_perm_plain(routeP[1], [torch.arange(
        x_mid.numel(), dtype=torch.int32, device=dev).reshape(x_mid.shape)],
        mr["T128"], mr["T_pad"])[0].long()
    lib3 = cuda_ms(torch, lambda: torch.take(x_mid, src3))
    T, T_pad = mr["T"], mr["T_pad"]
    add("mid_perm", "graphblas_tpu_torch/csrc/mid_perm.cu",
        "graphblas_tpu/core/engine/permute.py:255", err3,
        cuda_ms(torch, k3), cuda_ms(torch, p3),
        4 * pm.N_TILE * (T_pad + 2 * T), library_ms=lib3)

    # ---- K4 fused route-C + scan + extract-A
    combine, combine_packed = lp.combines(mono)
    preC = pm.apply_perm_pre_c(mr, routeP, [pf], skip_a=True)[0]
    k4 = lambda: lp.fused_permC_scan_permA(routeP[2], d["barrier"], extP[0], preC, combine)  # noqa: E731
    p4 = lambda: lp.fused_permC_scan_permA_plain(routeP[2], d["barrier"], extP[0], preC, combine)  # noqa: E731
    yAe = k4()
    err4 = compare("K4 fused_scan FP32 plus", yAe, p4(), rel=1e-5)
    pcb = lp.pad_rows(codes, 0, eb["L"])
    preCb = pm.apply_perm_pre_c(eb["permmeta"]["routeP"], db["routeP"], [pcb],
                                skip_a=True)[0]
    compare("K4 fused_scan BOOL packed lor",
            lp.fused_permC_scan_permA(db["routeP"][2], db["barrier"],
                                      db["extP"][0], preCb, lp.combines(ringb.monoid)[1]),
            lp.fused_permC_scan_permA_plain(db["routeP"][2], db["barrier"],
                                            db["extP"][0], preCb, lp.combines(ringb.monoid)[1]))
    R_scan = e["R_scan"]
    add("fused_permC_scan_permA", "graphblas_tpu_torch/csrc/fused_scan.cu",
        "graphblas_tpu/core/engine/lanepipe.py:554", err4,
        cuda_ms(torch, k4), cuda_ms(torch, p4), 4 * 5 * R_scan * 128,
        nops=R_scan * 128)

    # ---- K2 tile_perm: the extract's stage C, trimmed to TV tiles, and
    # the whole extract (apply_perm_post_a) trimmed to TV and to TV=1
    fin = pm._exchange_out(pm.mid_perm(extP[1], [pm._exchange_in(yAe, me["T"])],
                                       me["T128"], me["T_pad"], out_T=TV)[0])
    pcv = extP[2][:TV * 128]
    k2 = lambda: pm.tile_perm(pcv, [fin])[0]  # noqa: E731
    p2 = lambda: pm.tile_perm_plain(pcv, [fin])[0]  # noqa: E731
    err2 = compare(f"K2 tile_perm extract stage C (TV={TV})", k2(), p2())
    xr = torch.from_numpy(rng.integers(-2**31, 2**31, (L // 128, 128),
                                       dtype=np.int64).astype(np.int32)).to(dev)
    compare("K2 tile_perm route stage A", pm.tile_perm(routeP[0], [xr])[0],
            pm.tile_perm_plain(routeP[0], [xr])[0])
    # the whole extract, untrimmed and trimmed, against its plain version:
    # the same composition through mid_perm_plain and tile_perm_plain
    ref = pm.tile_perm_plain(extP[2], [pm._exchange_out(pm.mid_perm_plain(
        extP[1], [pm._exchange_in(xr, me["T"])], me["T128"], me["T_pad"])[0])])[0]
    for lim in (None, lim1, 1):
        tv = pm._trimmed_tiles(me, lim)
        got = pm.apply_perm_post_a(me, extP, [xr], out_limit=lim)[0]
        compare(f"apply_perm_post_a TV={tv} vs plain", got, ref[:tv * 128])
    src2 = pm.tile_perm_plain(pcv, [torch.arange(fin.numel(), dtype=torch.int32,
                                                 device=dev).reshape(fin.shape)])[0].long()
    lib2 = cuda_ms(torch, lambda: torch.take(fin, src2))
    add("tile_perm", "graphblas_tpu_torch/csrc/tile_perm.cu",
        "graphblas_tpu/core/engine/permute.py:223", err2,
        cuda_ms(torch, k2), cuda_ms(torch, p2), 4 * 3 * fin.numel(),
        library_ms=lib2)
    results["kernels"] = rows
    results["plan"] = {"L": e["L"], "R_g": R_g, "nblocks_g": nblocks,
                       "R_scan": R_scan, "V": e["V"], "TV": TV,
                       "T": T, "T_pad": T_pad, "plan_s": secs,
                       "plan_bool_s": secs_b}


KERNELS = ("gather_mult", "mid_perm", "fused_permC_scan_permA", "tile_perm")


def check_launches(K, phase, totals):
    got = {k: K.launches[k] for k in KERNELS}
    log(f"  launches in {phase}: {got}")
    zero = [k for k, v in got.items() if v == 0]
    if zero:
        fail(f"{phase}: kernels never launched on the main path: {zero}")
    for k, v in got.items():
        totals[k] = totals.get(k, 0) + v


def pagerank_phase(gb, torch, K, src, dst, n, A, tag, iters, results, totals):
    nnz = len(src)
    outdeg = np.bincount(src, minlength=n).astype(np.float32)
    w = (1.0 / outdeg[src]).astype(np.float32)
    ring = gb.semiring.plus_times["FP32"]
    damp = np.float32(0.85)
    tele = np.float32(0.15 / n)
    damp_tele = gb.unary.register_anonymous(lambda x: x * damp + tele,
                                            name=f"damp_tele_{tag}")
    rank = gb.Vector.from_dense(np.full(n, 1.0 / n, np.float32))
    y = gb.Vector(gb.dtypes.FP32, n)

    def pr_body(s, i):
        s["y"] << s["rank"].vxm(A, ring)
        s["rank"] << s["y"].apply(damp_tele)

    t0 = time.perf_counter()
    pr_body({"rank": rank, "y": y}, None)  # builds the plan
    rank.wait(how="complete")
    first_s = time.perf_counter() - t0
    ref = pagerank_ref(src, dst, w, n, iters)
    lim = 1e-4 * np.abs(ref).max()
    runs = []
    for _ in range(RUNS):
        rank = gb.Vector.from_dense(np.full(n, 1.0 / n, np.float32))
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        it = gb.ss.iterate(pr_body, {"rank": rank, "y": y}, max_iter=iters)
        rank.wait(how="complete")
        runs.append((time.perf_counter() - t0) / it * 1e3)
        got = rank.to_dense().astype(np.float64)
        err = float(np.abs(got - ref).max())
        mass, mass_ref = float(got.sum()), float(ref.sum())
        if not np.isfinite(got).all():
            fail(f"pagerank {tag}: non-finite ranks")
        if it != iters:
            fail(f"pagerank {tag}: ran {it} iterations, expected {iters}")
        if err > lim:
            fail(f"pagerank {tag}: max|r - r_ref| {err} over 1e-4 max|r_ref|")
        if abs(mass - mass_ref) > 1e-3:
            fail(f"pagerank {tag}: total rank {mass} vs {mass_ref}")
    check_launches(K, f"pagerank {tag}", totals)
    ms_iter = float(np.median(runs))
    log(f"  pagerank {tag}: {it} iterations, ms/iter {runs} (median "
        f"{ms_iter:.4f}), {nnz / ms_iter / 1e6:.4f} GnnZ/s, max|r-ref| "
        f"{err:.3g} (limit {lim:.3g}), mass {mass:.6f} vs {mass_ref:.6f}, "
        f"first call {first_s:.2f} s")
    prof = profile_breakdown(
        torch, lambda: gb.ss.iterate(pr_body, {"rank": rank, "y": y},
                                     max_iter=5), f"pagerank {tag} x5",
        5 * ms_iter)
    results[f"pagerank_{tag}"] = {
        "n": n, "nnz": nnz, "iters": it, "ms_per_iter_runs": runs,
        "ms_per_iter": ms_iter, "gnnz_s": nnz / ms_iter / 1e6,
        "max_abs_err": err, "mass": mass, "mass_ref": mass_ref,
        "first_call_s": first_s, "profile_5_iters": prof}


def bfs_phase(gb, torch, K, src, dst, n, Ab, results, totals):
    lor_land = gb.semiring.lor_land["BOOL"]

    def bfs_body(s, i):
        s["v"](mask=s["q"].V)[:] = i
        s["q"](~s["v"].S, replace=True) << s["q"].vxm(Ab, lor_land)

    def bfs_cond(s, i):
        return s["q"].reduce(gb.monoid.lor, allow_empty=False).new()

    def run_bfs():
        q = gb.Vector.from_coo([0], [True], size=n)
        v = gb.Vector(gb.dtypes.INT32, n)
        it = gb.ss.iterate(bfs_body, {"q": q, "v": v}, cond=bfs_cond,
                           max_iter=64)
        v.wait(how="complete")
        return v, it

    run_bfs()  # warm-up
    lev, depth = bfs_ref(src, dst, n)
    ref_i = np.flatnonzero(lev)
    runs = []
    for _ in range(RUNS):
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, it = run_bfs()
        runs.append(time.perf_counter() - t0)
        vi, vv = v.to_coo()
        if not (np.array_equal(vi.astype(np.int64), ref_i)
                and np.array_equal(vv.astype(np.int64), lev[ref_i])):
            fail("bfs: levels differ from the numpy BFS")
        if it != depth:
            fail(f"bfs: depth {it} vs numpy {depth}")
    check_launches(K, "bfs", totals)
    secs = float(np.median(runs))
    traversed = int(np.bincount(src, minlength=n)[vi.astype(np.int64)].sum())
    log(f"  bfs: depth {it}, reached {len(vi)}, ms {[r * 1e3 for r in runs]} "
        f"(median {secs * 1e3:.3f}), {traversed / secs / 1e6:.2f} MTEPS "
        f"({traversed} edges traversed)")
    prof = profile_breakdown(torch, run_bfs, "bfs", secs * 1e3)
    results["bfs"] = {"n": n, "depth": it, "reached": int(len(vi)),
                      "ms_runs": [r * 1e3 for r in runs], "ms": secs * 1e3,
                      "edges_traversed": traversed,
                      "mteps": traversed / secs / 1e6, "profile": prof}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the full results and the "
                    "compiler's register report")
    args = ap.parse_args()
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import graphblas_tpu_torch as gb
        from graphblas_tpu_torch import native
        from graphblas_tpu_torch.core.engine import kernels as K
    except ImportError as exc:
        fail(f"graphblas_tpu_torch is not importable ({exc}): run this "
             f"script from the root of the repository")
    line = gpu_line()
    log(f"gpu: {line}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # ---- setup: native host libraries and the CUDA kernels
    t0 = time.perf_counter()
    if not native.permplan_loaded() or native.get_lib() is None:
        fail("native host libraries (permplan, builder) did not build")
    native_s = time.perf_counter() - t0
    cuda_s = K.build()
    log(f"build: native {native_s:.2f} s, CUDA kernels {cuda_s:.2f} s")
    for name in K.SOURCES:
        K.lib(name)
    results = {"gpu": line, "build_native_s": native_s, "build_cuda_s": cuda_s}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "ptxas.txt"), "w") as f:
            for name, out in K.build_log.items():
                f.write(f"==== {name}\n{out}\n")

    totals = {}
    with gb.config.set(device="cuda", auto_sparse_limit=0):
        n = 1 << 19
        src, dst = build_graph(n, 8)
        outdeg = np.bincount(src, minlength=n).astype(np.float32)
        w = (1.0 / outdeg[src]).astype(np.float32)
        t0 = time.perf_counter()
        A = gb.Matrix.from_coo(src, dst, w, dtype="FP32", nrows=n, ncols=n)
        Ab = gb.Matrix.from_coo(src, dst, np.ones(len(src), bool),
                                dtype="BOOL", nrows=n, ncols=n)
        log(f"graph zipf n={n} nnz={len(src)} built in "
            f"{time.perf_counter() - t0:.2f} s")
        log("phase: kernels")
        kernel_phase(gb, torch, torch.device("cuda"), A, Ab, results)
        log("phase: pagerank zipf")
        pagerank_phase(gb, torch, K, src, dst, n, A, "zipf", 20, results,
                       totals)
        log("phase: bfs zipf")
        bfs_phase(gb, torch, K, src, dst, n, Ab, results, totals)
        log("phase: pagerank rmat")
        rs, rd, rn = build_rmat(17)
        routdeg = np.bincount(rs, minlength=rn).astype(np.float32)
        rw = (1.0 / routdeg[rs]).astype(np.float32)
        R = gb.Matrix.from_coo(rs, rd, rw, dtype="FP32", nrows=rn, ncols=rn)
        pagerank_phase(gb, torch, K, rs, rd, rn, R, "rmat", 20, results,
                       totals)

    kernels = []
    for name, row in results["kernels"].items():
        row["launches"] = totals[name]
        kernels.append(row)
    results["wall_s"] = time.perf_counter() - t_start
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(results, f, indent=1)
    log(f"wall {results['wall_s']:.1f} s")
    log(f"gpu: {gpu_line()}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
