#!/usr/bin/env python3
"""Smoke run of graphblas_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--out DIR]

Run from the repository root.  It builds the host native libraries and
the seven CUDA kernels (six of the two SpMV engines, one of the dense
engine) from the sources, then:

1. kernel phase: on the plans of bench.py's zipf graph (n = 2**19, degree
   8, FP32 weights 1/outdeg, and its BOOL twin), runs each kernel and its
   plain PyTorch version on the card on the same inputs and compares them
   (bitwise for the permutations, integer paths, min/max and `first`, rel
   1e-5 for the FP32 plus scans), including the extract trimmed to TV=34
   and to TV=1, and times both with CUDA events; K2 and K3 at every shape
   the main paths launch them at (one and two channels, the route at
   T=264, the extract trimmed), beside torch.take of the composite index;
   K6 (one launch per group of channels) also where its look-back is most
   exposed (no barrier, barriers only at tile starts or tile ends, at
   every element, one tile, every channel tuple, an FP32 product carried
   across tiles), 200 launches of the main path's scan bitwise equal, and
   its achieved rate on the main path's two scans; K1 (one launch a call)
   at the PageRank, BFS and SSSP variants on the zipf and RMAT plans, each
   timed warm and after an L2 flush, 200 launches of each bitwise equal on
   the zipf plan, and with the logical multiplies on FP32 and INT32
   (plus_land, min_lor); K4 (one
   launch a call) also with FP32 min, on the RMAT plan, over every
   (monoid, 32-bit type, packed) triple, on a lane whose run crosses 128
   tiles, 200 launches bitwise equal, and timed after an L2 flush; K5
   (one launch a call) at the main path's FP32 min with validity, FP32
   and INT32 plus, with ok 0/1 and in [-1000, 1000], with and without a
   barrier in row 0, 200 launches of FP32 min and plus bitwise equal,
   timed warm and after an L2 flush with validity and values only;
2. PageRank (bench.py's pr_body, 20 iterations of ss.iterate) on the zipf
   graph, checked against a float64 scipy power iteration;
3. level BFS (bench.py's bfs_body with the lor-reduce cond) on the BOOL
   graph, checked level by level against a numpy frontier BFS;
4. PageRank on bench.py's RMAT graph (scale 17), checked the same way;
5. SSSP (algorithms.sssp, Bellman-Ford over min_plus) on the zipf graph,
   checked against scipy's Dijkstra in float64: its distance vector starts
   with one entry, so it runs the sparse-vector branch (lane_segscan);
6. row and column reduces of the zipf matrices through the sort pipeline
   (segscan), checked against numpy in float64;
7. vxm/mxv on a hypersparse random digraph (n = 2**22, 2**21 edges), which
   the lanepipe turns down, through the sort pipeline, checked against
   numpy in float64;
8. the dense engine.  Kernel phase `tropical`: tropical_matmul against its
   plain version (every element equal) for all 12 (reduce, combine) pairs
   in FP32 and two in FP64 at ragged and one-row/one-column shapes, the
   entry point with validity planes on finite operands and on stored
   inf/NaN, and FP32 min_plus at 2048^3 and 8192^3 in full, with times.
   Phase `apsp`: all-pairs shortest paths of an 8192-node weighted zipf
   graph by `A.power(n, min_plus)` (13 products) and by the
   `D(accum=min) << D.mxm(D, min_plus)` loop under ss.iterate, checked
   against scipy's Dijkstra in float64 (rel 1e-5); the lor_land closure;
   an FP32 plus_times mxm against the same call on the CPU;
9. the generic sparse engine (phase `sparse_algorithms`): triangle_count
   on bench.py's RMAT graph (scale 17) through the masked dot, its count
   exactly against scipy's L .* (L @ L), and pagerank (damping 0.85, tol
   1e-8, at most 100 iterations) on the zipf graph with FP32 values of 1,
   its FP64 ranks within 1e-9 of the largest against a float64 power
   iteration of the same formula and stopping rule, the iteration counts
   within one; each with its time (median of 3), the device's idle share
   and the peak memory;
10. extract, assign and delete by index lists (phase `index`):
   connected_components (FastSV) on bench.py's RMAT graph (scale 17) and
   on the zipf graph, its labels exactly against scipy's weakly connected
   components, with its FastSV iterations, time (median of 3), idle share
   and peak memory; on the zipf FP32 matrix A[rows, cols] (sorted halves
   of the nodes, the sparse route), A[hub, :] and A[:, hub],
   C(accum=plus)[rows, cols] << B, C(M.S, replace)[rows, cols] << B and
   del C[rows, cols], and on vectors of 2**19 f[parents] (repeated
   indices) and v[idx] = s (2**17 indices), each exactly against numpy,
   with its time (median of 5) and idle share.  None of the seven kernels
   may launch in it;
11. positional operators, aggregators, kronecker and reposition (phase
   `positional_agg`): bfs_parent on the zipf graph and on bench.py's RMAT
   graph (scale 17), exactly against numpy's BFS parents (the smallest
   in-neighbour on the level before); the triangle witness C(L.S) << L
   min_secondi L.T on RMAT 17 by the masked dot, its structure against
   plus_pair's and 10,000 values against numpy's intersections; a
   Gustavson min_firsti A @ A on the hypersparse graph; positional apply
   on the zipf matrix; eleven aggregators rowwise and columnwise and three
   reduce_scalar on a dense-backed 8192 x 8192 FP32 matrix against numpy
   in float64; kronecker to 8192 x 8192 against np.kron; reposition of
   that matrix and of a vector of 2**19 against numpy slicing.  Each call
   with its time (median of 3, of 5 under 10 ms), idle share and peak
   memory; none of the seven kernels may launch in it;
12. the operators slice (phase `operators`): on the zipf graph with values
   of each type, vxm and mxv through the lanepipe with each operand in its
   own type (BOOL x FP32 and BOOL x INT32 plus_times, INT32 x FP32
   min_plus), narrow types (INT8 plus_times and min_plus, UINT16
   max_minus), a comparison (lor_lt over FP32, a packed BOOL product) and
   the new monoids (lxor_land and eq_eq over BOOL, bxor_band over UINT16,
   also with a sparse u: K5 for bxor); row and column reduces through K6
   (lxor, bxor, max over INT8); from_coo with duplicates under lor, minus
   and bxor; and two products on the generic engine (UINT64 plus_times,
   INT16 plus_floordiv), where no kernel may launch.  Each exactly against
   numpy with typed wrapping arithmetic (FP32 sums to rel 1e-5), with its
   time (median of 3) and launches; two calls profiled.  The kernel phase
   adds K1 over every builtin multiply and type of at most 32 bits and 16
   mixed operand pairs on a small plan (bitwise against the plain
   version), K1 on the zipf plan at a mixed, a narrow and a comparison
   variant (timed warm and after an L2 flush), and K4 with lxor, K5 and
   K6 with bxor at the main path's shapes: bitwise, 200 launches equal,
   timed;
13. the expression surface and the constructors (phase `infix`): the zipf
   graph built by Matrix.from_csr from scipy's CSR (equal to from_coo),
   to_csr/to_csc bitwise against scipy, from_dcsr and to_dcsc, build with
   5% duplicate coordinates under plus and min against numpy, the edge
   list both ways, resize to 2**18 and back; PageRank, a level BFS from
   the hub and SSSP written in infix (`semiring.plus_times(r @ A)`,
   `lor_land(q @ Ab)` under `while q.reduce(lor)`, `d(binary.min) <<
   min_plus(d @ A)`), each bitwise equal to its method form with the
   same launches, both timed in turns (median of 5); `A + A.T`, `A *
   A.T`, `A - A.T`, `A == A.T`, `A > t`, `-A`, `abs(-A)`, the expression
   selects, vxm under `v.S & u.V` and `~v.S | u.S`, reduces under
   comparisons, Scalar conversions and Vector.outer (4,194,304 entries)
   against numpy; `D(binary.min) << min_plus(D @ D)` at 2048^2 (K7)
   against the method form bitwise.  Every one of K1-K7 launches in it;
14. the ss extensions and interchange (phase `ss_io`, on the zipf graph,
   before the graph is freed): `A.ss.export("csr")` and
   `Matrix.ss.import_csr`, then PageRank (20 iterations) and SSSP on the
   import bitwise equal to the original's with the same launches; the
   rowwise and columnwise `A.ss.scan("plus")` through K6 against a float64
   numpy cumsum per row (rel 1e-5 of the running sum) and against K6's
   plain version on the card's arrays (rel 1e-6), an INT32 copy's scans
   exactly; `sort`, `selectk("largest", 4)` and `compactify` exactly
   against numpy's lexsort, `selectk("random", 4)`'s counts; a 4 x 4
   `split` (sparse tiles) and `gb.ss.concat` back, its peak memory under
   three times `A.ss.nbytes`; `serialize`/`deserialize` and a pickle round
   trip of the BOOL graph, BFS on each exactly; the scipy round trip and
   `mmwrite`/`mmread` of an RMAT-12 graph; `repr` and `_repr_html_` under
   1 s and 1 MB; a Recorder around one BFS level; four dense 2048^2 tiles
   joined by `gb.ss.concat` into a 4096^2 `min_plus` product (K7) bitwise
   equal to the unsplit matrix's.  Every one of K1-K7 launches in it;
15. the complex types and user-defined types (phase `complex_udt`, on the
   zipf graph): FC32 and FC64 matrices exp(i theta) / outdeg through
   vxm/mxv plus_times, plus and times row reduces and reduce_scalar
   against scipy/numpy in complex128 (rel 1e-5 and 1e-12 of the
   magnitude), conj/creal/cimag/carg/abs, `cmplx` of two FP32 matrices,
   `A.T` and a cast, with no kernel launched; creal and cimag of W cmplx
   V bitwise W and V, and PageRank (20 iterations), SSSP (K5) and a row
   reduce (K6) on them bitwise equal to those on W and V with the same
   launches; a 4096^2 FC32 plus_times product against numpy and min_plus
   on creal of a 2048^2 FC32 matrix through K7 bitwise; point_t and a
   (3,)float32 vector through is_udt operators, a user monoid, extract,
   assign, delete and a structural mask against numpy; FC64 and point_t
   through serialize, pickle and the csr and bitmapr formats, and FC64
   through Matrix Market (hermitian, RMAT 12).  Every one of K1-K7
   launches in it.

Each main-path phase sets the kernels' launch counts to 0 just before it
runs and fails if a kernel of its path was not launched, or if an exchange
transpose ran (K3 reads and writes the tile layout itself).  The line
before the last is {"kernels": [...]}, the last {"ok": true, "device":
{...}}.  Any failure exits non-zero before the last line.  It uses no JAX.
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
# 67 TFLOP/s counts a fused multiply-add as two operations; a kernel whose
# pairs are two separate FP32 instructions (an add, then a min) is bounded
# by the instruction rate, half of it.  min/max run on the 64-lane ALU
# pipe (NVIDIA's arithmetic-throughput table for compute capability 9.0), for
# one min per pair the same bound: MNK / (132 SMs x 64 lanes x 1.98 GHz).
FP32_INSTR_PER_S = FP32_OPS_PER_S / 2
SEED = 0
SPIN_CYCLES = 20_000_000  # ~10 ms of spinning at the H100's clock
RUNS = 5  # timed runs of each loop; the median is reported
APSP_N = 8192  # the largest square matrix dense_limit = 2**26 densifies
APSP_MXM_N = 2048  # the plus_times and generic-product checks
CU_DENSE_N = 4096  # complex_udt: the FC32 plus_times product
CU_MINPLUS_N = 2048  # complex_udt: min_plus on creal; the bitmapr block


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


def triangles_ref(src, dst, n):
    """Triangles of the undirected graph: the sum of L .* (L @ L) for the
    strict lower triangle L after numbering the nodes by degree (float64
    free: int64 scipy products)."""
    import scipy.sparse as sps

    lin = np.unique(np.concatenate([src * n + dst, dst * n + src]))
    r, c = lin // n, lin % n
    keep = r != c
    r, c = r[keep], c[keep]
    rank = np.empty(n, np.int64)
    rank[np.argsort(np.bincount(r, minlength=n), kind="stable")] = \
        np.arange(n)
    r, c = rank[r], rank[c]
    low = r > c
    L = sps.csr_matrix((np.ones(int(low.sum()), np.int64),
                        (r[low], c[low])), shape=(n, n))
    return int(L.multiply(L @ L).sum())


def pagerank64_ref(src, dst, n, damping=0.85, tol=1e-8, max_iters=100):
    """algorithms.pagerank's formula and stopping rule in float64: ranks
    and the iteration count."""
    import scipy.sparse as sps

    outdeg = np.bincount(src, minlength=n).astype(np.float64)
    WT = sps.csr_matrix((1.0 / outdeg[src], (dst, src)), shape=(n, n))
    dangling = outdeg == 0
    r = np.full(n, 1.0 / n)
    it = 0
    for it in range(1, max_iters + 1):
        prev = r
        base = (1.0 - damping) / n + damping * r[dangling].sum() / n
        r = base + damping * (WT @ r)
        if np.abs(r - prev).sum() < tol:
            break
    return r, it


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


_flush = []


def cuda_ms(torch, fn, reps=20, warm=3, cold=False):
    """Median device ms of fn over reps runs, each between two CUDA events.

    A spin kernel queued before the start event keeps the card busy while
    the host enqueues fn, so the events bracket device work and not the
    host's launch overhead.  cold: before each run, 256 MB are written,
    which evicts fn's inputs from the 50 MB L2."""
    if cold and not _flush:
        _flush.append(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        if cold:
            _flush[0].zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def profile_breakdown(torch, fn, label, wall_unprofiled_ms, ranges=None):
    """Device time by kernel over one fn() run, from torch.profiler, and the
    card's idle share: 1 - device busy / wall_unprofiled_ms, the wall time
    of the same work measured without the profiler (which slows the host).
    The idle share over the profiled wall is kept beside it.  ``ranges``,
    where given, reads a record from a host range's name (None for others):
    the records of the run come back under "ranges"."""
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
        # a host range (record_function) shows on the device too: skip it
        if getattr(ev, "device_type", None) is None or \
                "CUDA" not in str(ev.device_type) or \
                getattr(ev, "is_user_annotation", False):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((ev.key, us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    recs = [] if ranges is None else [
        r for r in (ranges(ev.name) for ev in prof.events()
                    if "CPU" in str(ev.device_type)) if r is not None]
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
            "kernels": [{"name": k, "ms": m, "count": c} for k, m, c in rows],
            "ranges": recs}


def bound(nbytes, nops=0, rate=FP32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    32-bit operations over the FP32 rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def compare(name, got, want, rel=None, quiet=False):
    """Max abs error; bitwise equality (rel None) or rel tolerance."""
    import torch

    g = got.detach().reshape(-1)
    w = want.detach().reshape(-1)
    if g.shape != w.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if g.dtype.is_floating_point:
        # equal bits are no error (inf - inf and NaN - NaN are NaN)
        bits = {4: torch.int32, 8: torch.int64}.get(g.element_size())
        diff = (g.double() - w.double()).abs()
        if bits is not None:
            diff = torch.where(g.view(bits) == w.view(bits), 0.0, diff)
        err = float(diff.max()) if g.numel() else 0.0
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
    if not quiet:
        log(f"  {name}: ok, max_abs_err {err:.3g}")
    return err


def kernel_phase(gb, torch, dev, A, Ab, results):
    """Each kernel against its plain version at the main path's shapes."""
    from graphblas_tpu_torch.core.engine import lanepipe as lp
    from graphblas_tpu_torch.core.engine import permute as pm

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
        return rows[name]

    mono = gb.semiring.plus_times["FP32"].monoid
    ringb = gb.semiring.lor_land["BOOL"]
    d, db = e["dev"], eb["dev"]
    routeP, extP = d["routeP"], d["extP"]
    R_g, L, nblocks = e["R_g"], e["L"], e["nblocks_g"]

    # ---- K1 gather_mult at the main paths' variants, zipf and RMAT plans
    rs, rd, rn = build_rmat(17)
    R = gb.Matrix.from_coo(rs, rd, np.ones(len(rs), np.float32), dtype="FP32",
                           nrows=rn, ncols=rn)
    er = lp.get_plan(R._sparse, False, device=dev)
    if er is None:
        fail("RMAT plan exceeds PACK_LIMIT")
    del R
    variants = {}
    (err, k1_ms, k1_pms, k1_bytes), k1_out = k1_checks(
        gb, torch, {"zipf": (e, eb), "rmat": (er, None)}, rng, variants)
    prods, codes = k1_out["pagerank"], k1_out["bfs"]
    k1_new_variants(gb, torch, e, eb, rng, variants)
    k1_grid(gb, torch, dev, rng)
    add("gather_mult", "graphblas_tpu_torch/csrc/gather_mult.cu",
        "graphblas_tpu/core/engine/lanepipe.py:363", err, k1_ms, k1_pms,
        k1_bytes, nops=R_g * 128)

    # ---- K3 mid_perm_tiles: at the route with one and two channels and at
    # the extract trimmed to TV

    def ints(shape):
        return torch.from_numpy(rng.integers(-2**31, 2**31, shape,
                                             dtype=np.int64).astype(np.int32)).to(dev)

    def flat_source(fn, nrows):
        """The int64 flat index a permutation fn reads each output from."""
        return fn(torch.arange(nrows * 128, dtype=torch.int32,
                               device=dev).reshape(nrows, 128)).long().reshape(-1)

    def perm_variant(name, kfn, pfn, nbytes, x, src, chans=1):
        """Kernel and plain ms, the bound, and torch.take of the composite
        flat index over the channels stacked (one PyTorch call)."""
        xs = torch.stack([pm._as_i32(t) for t in x]).reshape(-1) if chans > 1 \
            else pm._as_i32(x).reshape(-1)
        idx = torch.cat([src + c * (xs.numel() // chans) for c in range(chans)])
        if not bool(torch.equal(torch.take(xs, idx).reshape(-1), torch.cat(
                [pm._as_i32(o).reshape(-1) for o in (kfn() if chans > 1 else [kfn()])]))):
            fail(f"{name}: torch.take of the composite index differs")
        ms, pms = cuda_ms(torch, kfn), cuda_ms(torch, pfn)
        lms = cuda_ms(torch, lambda: torch.take(xs, idx))
        b_ms, _ = bound(nbytes)
        variants[name] = {"ms": ms, "plain_ms": pms, "bound_ms": b_ms,
                          "bytes": nbytes, "take_ms": lms}
        log(f"  {name}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({nbytes / 1e6:.1f} MB), torch.take {lms:.4f} ms")
        return ms, pms, lms

    def k3_bytes(pb, m, TW, chans=1):
        """Bytes K3's function needs on this plan: the index words that its
        outputs' sources name, the input words they read (ports < T) and
        the outputs, each once."""
        pl = pb.long()
        j = torch.arange(TW, device=dev).expand(NT, TW)
        mm = (pl[:, :TW] >> 7) & 127
        i2 = (j & ~127) + mm
        s = (pl.gather(1, i2) >> 14) & 127
        i3 = s * 128 + mm
        col = s * 128 + (pl.gather(1, i3) & 127)
        idx = torch.zeros(pl.shape, dtype=torch.bool, device=dev)
        for i in (j, i2, i3):
            idx.scatter_(1, i, True)
        src = torch.zeros(pl.shape, dtype=torch.bool, device=dev)
        src.scatter_(1, col, True)
        return 4 * (int(idx.sum())
                    + chans * (int(src[:, :m["T"]].sum()) + NT * TW))

    mr, me = e["permmeta"]["routeP"], e["permmeta"]["extP"]
    T, T_pad = mr["T"], mr["T_pad"]
    NT = pm.N_TILE
    pf = lp.pad_rows(prods, 0.0, L)
    hr = ints((L // 128, 128))

    def k3(xs, out_T=None, plain=False, P=routeP, m=mr):
        f = pm.mid_perm_tiles_plain if plain else pm.mid_perm_tiles
        return f(P[1], xs, m["T"], m["T128"], m["T_pad"], out_T)

    err3 = compare("K3 mid_perm_tiles route", k3([pf])[0], k3([pf], plain=True)[0])
    for g, w_, nm in zip(k3([pf, hr]), k3([pf, hr], plain=True), ("values", "validity")):
        compare(f"K3 mid_perm_tiles route, two channels, {nm}", g, w_)
    lim1 = e["L2req"] if e["two_level"] else e["n_out"]
    TV = pm._trimmed_tiles(me, lim1)
    y_ext = ints((L // 128, 128))
    compare(f"K3 mid_perm_tiles extract out_T={TV}",
            k3([y_ext], TV, P=extP, m=me)[0],
            k3([y_ext], TV, plain=True, P=extP, m=me)[0])
    src3 = flat_source(lambda a: k3([a], plain=True)[0], L // 128)
    route_bytes = k3_bytes(routeP[1], mr, T)
    ms3, pms3, lib3 = perm_variant(
        "mid_perm_tiles route", lambda: k3([pf])[0],
        lambda: k3([pf], plain=True)[0], route_bytes, pf, src3)
    perm_variant("mid_perm_tiles route, two channels", lambda: k3([pf, hr]),
                 lambda: k3([pf, hr], plain=True),
                 k3_bytes(routeP[1], mr, T, chans=2), [pf, hr], src3, chans=2)
    perm_variant(f"mid_perm_tiles extract out_T={TV}",
                 lambda: k3([y_ext], TV, P=extP, m=me)[0],
                 lambda: k3([y_ext], TV, plain=True, P=extP, m=me)[0],
                 k3_bytes(extP[1], me, TV), y_ext,
                 flat_source(lambda a: k3([a], TV, plain=True, P=extP, m=me)[0],
                             L // 128))
    add("mid_perm", "graphblas_tpu_torch/csrc/mid_perm.cu",
        "graphblas_tpu/core/engine/permute.py:255", err3, ms3, pms3,
        route_bytes, library_ms=lib3)

    # ---- K4 fused route-C + scan + extract-A
    combine, combine_packed = lp.combines(mono)
    preC = pm.apply_perm_pre_c(mr, routeP, [pf], skip_a=True)[0]
    k4 = lambda: lp.fused_permC_scan_permA(routeP[2], d["barrier"], extP[0], preC, combine)  # noqa: E731
    p4 = lambda: lp.fused_permC_scan_permA_plain(routeP[2], d["barrier"], extP[0], preC, combine)  # noqa: E731
    yAe = k4()
    err4 = compare("K4 fused_scan FP32 plus", yAe, p4(), rel=1e-5)
    cmin = lp.combines(gb.monoid.min["FP32"])[0]
    compare("K4 fused_scan FP32 min",
            lp.fused_permC_scan_permA(routeP[2], d["barrier"], extP[0], preC, cmin),
            lp.fused_permC_scan_permA_plain(routeP[2], d["barrier"], extP[0], preC, cmin))
    pcb = lp.pad_rows(codes, 0, eb["L"])
    preCb = pm.apply_perm_pre_c(eb["permmeta"]["routeP"], db["routeP"], [pcb],
                                skip_a=True)[0]
    compare("K4 fused_scan BOOL packed lor",
            lp.fused_permC_scan_permA(db["routeP"][2], db["barrier"],
                                      db["extP"][0], preCb, lp.combines(ringb.monoid)[1]),
            lp.fused_permC_scan_permA_plain(db["routeP"][2], db["barrier"],
                                            db["extP"][0], preCb, lp.combines(ringb.monoid)[1]))
    k4_checks(gb, torch, dev, rng, k4, er)
    del er
    R_scan = e["R_scan"]
    k4_bytes = 4 * 5 * R_scan * 128
    add("fused_permC_scan_permA", "graphblas_tpu_torch/csrc/fused_scan.cu",
        "graphblas_tpu/core/engine/lanepipe.py:554", err4,
        cuda_ms(torch, k4), cuda_ms(torch, p4), k4_bytes, nops=R_scan * 128)
    ms4c = cuda_ms(torch, k4, cold=True)
    variants["fused_permC_scan_permA_cold"] = {
        "ms": ms4c, "bound_ms": bound(k4_bytes)[0], "bytes": k4_bytes}
    log(f"  fused_permC_scan_permA after an L2 flush: {ms4c:.4f} ms")

    # ---- K2 tile_perm: the extract's stage C trimmed to TV tiles (one
    # channel: the dense branch; two: the sparse-vector branch), the
    # route's stage C and the extract's stage A at all T tiles with two
    # channels (the sparse-vector branch), and the whole extract
    # (apply_perm_post_a) untrimmed, at TV and at TV=1
    fin = k3([yAe], TV, P=extP, m=me)[0]
    pcv = extP[2][:TV * 128]
    k2 = lambda: pm.tile_perm(pcv, [fin])[0]  # noqa: E731
    p2 = lambda: pm.tile_perm_plain(pcv, [fin])[0]  # noqa: E731
    err2 = compare(f"K2 tile_perm extract stage C (TV={TV})", k2(), p2())
    xr = ints((L // 128, 128))
    compare("K2 tile_perm route stage A", pm.tile_perm(routeP[0], [xr])[0],
            pm.tile_perm_plain(routeP[0], [xr])[0])
    hv = ints((TV * 128, 128))
    for g, w_, nm in zip(pm.tile_perm(pcv, [fin, hv]),
                         pm.tile_perm_plain(pcv, [fin, hv]), ("values", "validity")):
        compare(f"K2 tile_perm extract stage C (TV={TV}), two channels, {nm}", g, w_)
    mids = k3([pf, hr])
    sv, sh = ints((L // 128, 128)), ints((L // 128, 128))
    stage_cases = (("route stage C", routeP[2], mids), ("extract stage A", extP[0], [sv, sh]))
    for nm, idx, xs in stage_cases:
        for g, w_, ch in zip(pm.tile_perm(idx, xs), pm.tile_perm_plain(idx, xs),
                             ("values", "validity")):
            compare(f"K2 tile_perm {nm} (T={T}), two channels, {ch}", g, w_)
    ref = pm.tile_perm_plain(extP[2], [pm._exchange_out(pm.mid_perm_plain(
        extP[1], [pm._exchange_in(xr, me["T"])], me["T128"], me["T_pad"])[0])])[0]
    for lim in (None, lim1, 1):
        tv = pm._trimmed_tiles(me, lim)
        got = pm.apply_perm_post_a(me, extP, [xr], out_limit=lim)[0]
        compare(f"apply_perm_post_a TV={tv} vs plain", got, ref[:tv * 128])
    src2 = flat_source(lambda a: pm.tile_perm_plain(pcv, [a])[0], TV * 128)
    ms2, pms2, lib2 = perm_variant(f"tile_perm extract stage C (TV={TV})", k2, p2,
                                   4 * 3 * fin.numel(), fin, src2)
    perm_variant(f"tile_perm extract stage C (TV={TV}), two channels",
                 lambda: pm.tile_perm(pcv, [fin, hv]),
                 lambda: pm.tile_perm_plain(pcv, [fin, hv]),
                 4 * 5 * fin.numel(), [fin, hv], src2, chans=2)
    for nm, idx, xs in stage_cases:
        perm_variant(f"tile_perm {nm} (T={T}), two channels",
                     lambda: pm.tile_perm(idx, xs), lambda: pm.tile_perm_plain(idx, xs),
                     4 * 5 * L, xs, flat_source(
                         lambda a: pm.tile_perm_plain(idx, [a])[0], L // 128), chans=2)
    add("tile_perm", "graphblas_tpu_torch/csrc/tile_perm.cu",
        "graphblas_tpu/core/engine/permute.py:223", err2, ms2, pms2,
        4 * 3 * fin.numel(), library_ms=lib2)
    new_kernels_phase(gb, torch, dev, A, e, rng, add, variants)
    new_combine_checks(gb, torch, dev, rng, e, eb, variants)
    results["kernel_variants"] = variants
    results.setdefault("kernels", {}).update(rows)
    results["plan"] = {"L": e["L"], "R_g": R_g, "nblocks_g": nblocks,
                       "R_scan": R_scan, "V": e["V"], "TV": TV,
                       "T": T, "T_pad": T_pad, "plan_s": secs,
                       "plan_bool_s": secs_b}


def k1_checks(gb, torch, plans, rng, variants):
    """K1 at the main paths' three variants on each plan: PageRank (FP32
    times, a full u), BFS (BOOL land, packed codes, a u of 30% density)
    and SSSP (FP32 plus with the okp output, a u of 10% density), each
    through the route's stage A; bitwise against the plain version, one
    launch a call, timed warm and after an L2 flush; 200 launches of each
    zipf variant bitwise equal to the first; the logical multiplies in a
    type of their own.  plans: name -> (FP32 plan, BOOL twin's plan or
    None: the FP32 plan with avals != 0).  Returns the zipf PageRank
    variant's error, ms, plain ms and bytes for the kernels line, and the
    zipf variants' outputs by name."""
    from graphblas_tpu_torch.core.dtypes import BOOL, FP32, INT32
    from graphblas_tpu_torch.core.engine import kernels as K
    from graphblas_tpu_torch.core.engine import lanepipe as lp

    def words(v2, ok2):
        return torch.cat([v2.reshape(-1).view(torch.int32)]
                         + ([] if ok2 is None else [ok2.reshape(-1)]))

    row, outs = None, {}
    for pname, (e, eb) in plans.items():
        d = e["dev"]
        dev = d["meta"].device
        n, R_g, nb = e["n_in"], e["R_g"], e["nblocks_g"]
        plan_g = (d["meta"], d["idx1_g"], d["locidx_g"], d["okg"], d["avals_g"])
        plan_b = plan_g[:4] + ((d["avals_g"] != 0).to(torch.int32),) if eb is None \
            else tuple(eb["dev"][k] for k in ("meta", "idx1_g", "locidx_g", "okg",
                                              "avals_g"))
        u = torch.from_numpy(rng.random(n, dtype=np.float32)).to(dev)
        full = lp.pad_u(u, torch.ones(n, dtype=torch.bool, device=dev), FP32, n)
        ub = torch.from_numpy(rng.random(n) < 0.3).to(dev)
        sparse = lp.pad_u(u, torch.from_numpy(rng.random(n) < 0.1).to(dev), FP32, n)
        # bytes: locidx, okg, avals, permA and the output a slot (okp one
        # more), idx1, u (and its validity unless full), meta
        S, W, U = 4 * R_g * 128, 4 * nb * 128 * 128, 4 * full[0].numel()
        cases = (("pagerank", gb.semiring.plus_times["FP32"], plan_g, full, FP32,
                  dict(full_u=True), 5 * S + W + U + 12 * nb),
                 ("bfs", gb.semiring.lor_land["BOOL"], plan_b,
                  lp.pad_u(ub, ub, BOOL, n), BOOL, dict(packed=True),
                  5 * S + W + 2 * U + 12 * nb),
                 ("sssp", gb.semiring.min_plus["FP32"], plan_g, sparse, FP32, {},
                  6 * S + W + 2 * U + 12 * nb))
        for vname, ring, pg, (u2, u2ok), dt, extra, nbytes in cases:
            args = (pg, u2, u2ok, ring.binaryop, dt, dt, ring.monoid)
            kw = dict(kind="vxm", R_g=R_g, nblocks=nb, permA=d["routeP"][0], **extra)
            k1 = lambda: lp.gather_mult(*args, **kw)  # noqa: E731
            p1 = lambda: lp.gather_mult_plain(*args, **kw)  # noqa: E731
            tag = f"K1 gather_mult {pname} {vname}"
            before = K.launches["gather_mult"]
            got = k1()
            if K.launches["gather_mult"] - before != 1:
                fail(f"{tag}: not one launch a call")
            want = p1()
            err = compare(f"{tag}, values", got[0], want[0])
            if (got[1] is None) != (want[1] is None):
                fail(f"{tag}: the okp output came back from one side only")
            if want[1] is not None:
                compare(f"{tag}, okp", got[1], want[1])
            if pname == "zipf":
                first = words(*got)
                for r in range(200):
                    if not bool(torch.equal(words(*k1()), first)):
                        fail(f"{tag}: launch {r + 1} of 200 differs from the first")
            ms, cold, pms = (cuda_ms(torch, k1), cuda_ms(torch, k1, cold=True),
                             cuda_ms(torch, p1))
            b_ms, _ = bound(nbytes)
            variants[f"gather_mult {pname} {vname}"] = {
                "ms": ms, "cold_ms": cold, "plain_ms": pms, "bound_ms": b_ms,
                "bytes": nbytes}
            log(f"  gather_mult {pname} {vname}: kernel {ms:.4f} ms, after an L2 "
                f"flush {cold:.4f} ms, plain {pms:.4f} ms, bound {b_ms:.4f} ms "
                f"({nbytes / 1e6:.1f} MB)")
            if pname == "zipf":
                outs[vname] = got[0]
                if vname == "pagerank":
                    row = (err, ms, pms, nbytes)
        if pname != "zipf":
            continue
        log("  K1 zipf variants: one launch a call, 200 launches bitwise equal: ok")
        # the logical multiplies in a type of their own: the operands' truth
        # values as 1 or 0 (a NaN is true, -0.0 false), through the plan of
        # A with values of that type; plus_land with a full u, min_lor with
        # a sparse one
        zero = torch.from_numpy(rng.random((R_g, 128)) < 0.3).to(dev)
        af = torch.where(zero, 0.0, d["avals_g"])
        af[0, :4] = torch.tensor([float("nan"), -0.0, 2.0, 0.0])
        uf = torch.from_numpy(rng.choice(np.float32([0, -0.0, 1.5, np.nan]), n)).to(dev)
        ai = torch.from_numpy(rng.integers(-2, 3, (R_g, 128)).astype(np.int32)).to(dev)
        ui = torch.from_numpy(rng.integers(-2, 3, n).astype(np.int32)).to(dev)
        uiok = torch.from_numpy(rng.random(n) < 0.5).to(dev)
        for ring_l, a_l, u_l, u_ok, dt, full_u in (
                (gb.semiring.plus_land["FP32"], af, uf, None, FP32, True),
                (gb.semiring.min_lor["INT32"], ai, ui, uiok, INT32, False)):
            ul2, ul2ok = lp.pad_u(u_l, torch.ones(n, dtype=torch.bool, device=dev)
                                  if u_ok is None else u_ok, dt, n)
            kwl = dict(kind="vxm", R_g=R_g, nblocks=nb, full_u=full_u,
                       permA=d["routeP"][0])
            args = (plan_g[:4] + (a_l,), ul2, ul2ok, ring_l.binaryop, dt, dt,
                    ring_l.monoid)
            (gv, gh), (pv, ph) = lp.gather_mult(*args, **kwl), \
                lp.gather_mult_plain(*args, **kwl)
            compare(f"K1 gather_mult {ring_l.name}[{dt.name}], values", gv, pv)
            if not full_u:
                compare(f"K1 gather_mult {ring_l.name}[{dt.name}], okp", gh, ph)
            if not bool((pv != 0).any() & (pv == 0).any()):
                fail(f"K1 {ring_l.name}: the check saw one truth value only")
    return row, outs


def k4_checks(gb, torch, dev, rng, k4, er):
    """K4 against its plain version beyond the zipf plan: the RMAT plan
    (FP32 plus and min); every (monoid, 32-bit type, packed) triple the
    kernel takes, at 3 and 40 tiles, which runs the run-time combine; a
    lane whose only barrier is row 0 over 128 tiles; one launch a call;
    200 launches of the main path's scan bitwise equal.  FP32 plus to rel
    1e-5 (bitwise on exact values), the rest bitwise."""
    from graphblas_tpu_torch.core.dtypes import BOOL, FP32, INT32, UINT32
    from graphblas_tpu_torch.core.engine import kernels as K
    from graphblas_tpu_torch.core.engine import lanepipe as lp
    from graphblas_tpu_torch.core.engine import sortpipe as sp
    from graphblas_tpu_torch.core.operator.monoid import BUILTINS

    def check(tag, mono, packed, pc, bar, pa, vals, rel=None):
        cmb = lp.combines(mono)[1 if packed else 0]
        before = K.launches["fused_permC_scan_permA"]
        got = lp.fused_permC_scan_permA(pc, bar, pa, vals, cmb)
        if K.launches["fused_permC_scan_permA"] - before != 1:
            fail(f"K4 {tag}: not one launch a call")
        return compare(f"K4 {tag}", got,
                       lp.fused_permC_scan_permA_plain(pc, bar, pa, vals, cmb),
                       rel=rel, quiet=True)

    def ints(shape, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64)
                                .astype(np.int32)).to(dev)

    def values(shape, dt, packed):
        if packed:
            return ints(shape, 0, 3)
        if dt is FP32:
            return torch.from_numpy(rng.random(shape, dtype=np.float32)
                                    + np.float32(0.5)).to(dev)
        if dt is BOOL:
            return ints(shape, 0, 2)
        return ints(shape, -2**31, 2**31) if dt is UINT32 else ints(shape, -1000, 1000)

    # the RMAT plan's route, barrier and extract, random values
    rdv = er["dev"]
    shape = tuple(rdv["barrier"].shape)
    x = values(shape, FP32, False)
    for name, rel in (("plus", 1e-5), ("min", None)):
        check(f"RMAT plan FP32 {name} ({shape[0] // 128} tiles)",
              getattr(gb.monoid, name)["FP32"], False, rdv["routeP"][2],
              rdv["barrier"], rdv["extP"][0], x, rel)
    del rdv
    # every triple at small sizes
    monos = [m[dt] for m in BUILTINS.values() for dt in (BOOL, INT32, UINT32, FP32)
             if dt in m._domains and sp.eligible_reduce(m[dt], dt)
             and m.name in K.MONOID_OP]
    cases = 0
    for mono in monos:
        for packed in ((False, True) if mono.type is BOOL else (False,)):
            rel = 1e-5 if mono.type is FP32 and mono.parent.name in ("plus", "times") \
                else None
            for tiles in (3, 40):
                sh = (tiles * 128, 128)
                bar = (torch.from_numpy(rng.random(sh) < 1 / 40).to(dev)).to(torch.int32)
                bar[0] = 1
                check(f"sweep {mono.parent.name}[{mono.type}] packed={packed} "
                      f"{tiles} tiles", mono, packed, ints(sh, 0, 1 << 21), bar,
                      ints(sh, 0, 1 << 21), values(sh, mono.type, packed), rel)
                cases += 1
    # a lane whose only barrier is row 0 over 128 tiles; FP32 plus on
    # values 0, 1 and 2, whose sums are exact in any order
    sh = (128 * 128, 128)
    bar = (torch.from_numpy(rng.random(sh) < 1 / 300).to(dev)).to(torch.int32)
    bar[0] = 1
    bar[1:, 5] = 0
    pc, pa = ints(sh, 0, 1 << 21), ints(sh, 0, 1 << 21)
    exact = ints(sh, 0, 3).to(torch.float32)
    for tag, mono, vals in (("FP32 plus", gb.monoid.plus["FP32"], exact),
                            ("FP32 min", gb.monoid.min["FP32"], values(sh, FP32, False)),
                            ("INT32 plus", gb.monoid.plus["INT32"], ints(sh, -1000, 1000))):
        check(f"lane 5 one run over 128 tiles, {tag}", mono, False, pc, bar, pa, vals)
    # the race check on the main path's scan
    first = k4().view(torch.int32).clone()
    for r in range(200):
        if not bool(torch.equal(k4().view(torch.int32), first)):
            fail(f"K4 race check: launch {r + 1} of 200 differs from the first")
    log(f"  K4 checks: RMAT plan ({shape[0] // 128} tiles), {cases} sweep cases "
        f"over {len(monos)} monoids, one lane over 128 tiles, one launch a call, "
        f"200 launches bitwise equal: ok")


def new_kernels_phase(gb, torch, dev, A, e, rng, add, variants):
    """K5 and K6 against their plain versions."""
    from graphblas_tpu_torch.core.engine import kernels as K
    from graphblas_tpu_torch.core.engine import lanepipe as lp
    from graphblas_tpu_torch.core.engine import sortpipe as sp

    d = e["dev"]
    n, R_scan = e["n_in"], e["R_scan"]
    mono = gb.monoid.plus["FP32"]

    # ---- K5 lane_segscan on the S layout of the zipf plan: the main
    # path's combine (FP32 min with validity, SSSP's sparse-vector branch)
    # beside FP32 and INT32 plus; ok in [-1000, 1000] as well as the 0/1
    # the main path makes
    barrier, oks = d["barrier"], d["oks"]
    shape = (R_scan, 128)
    vf = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
    vi = torch.from_numpy(rng.integers(-1000, 1000, shape).astype(np.int32)).to(dev)
    hh = (torch.from_numpy(rng.random(shape) < 0.5).to(dev) & (oks != 0)).to(torch.int32)
    hw = torch.from_numpy(rng.integers(-1000, 1001, shape).astype(np.int32)).to(dev)
    bar0 = barrier.clone()
    bar0[0] = 0  # row 0 starts a run whether or not its barrier is set
    err5 = None
    per_call = set()
    for label, mono_k, vals, rel in (
            ("FP32 min", gb.monoid.min["FP32"], vf, None),
            ("FP32 plus", gb.monoid.plus["FP32"], vf, 1e-5),
            ("INT32 plus", gb.monoid.plus["INT32"], vi, None)):
        cmb = lp.combines(mono_k)[0]
        for bar, btag in ((barrier, ""), (bar0, ", no barrier in row 0")):
            for ok, otag in ((hh, " + validity"), (hw, " + ok in [-1000, 1000]"),
                             (None, "")):
                tag = f"K5 lane_segscan {label}{otag}{btag}"
                before = K.launches["lane_segscan"]
                gv, gh = lp.lane_segscan(bar, vals, ok, cmb)
                per_call.add(K.launches["lane_segscan"] - before)
                pv, ph = lp.lane_segscan_plain(bar, vals, ok, cmb)
                err = compare(tag, gv, pv, rel=rel)
                if ok is not None:
                    compare(tag + ", ok channel", gh, ph)
                elif gh is not None:
                    fail(f"{tag}: a validity channel came back")
                if err5 is None:
                    err5 = err
    if per_call != {1}:
        fail(f"K5: launches a call {sorted(per_call)}, not one")
    cmin = lp.combines(gb.monoid.min["FP32"])[0]
    cplus = lp.combines(mono)[0]
    # the race check on the main path's scan, and on FP32 plus, whose bits
    # depend on the fold order
    for label, cmb in (("FP32 min", cmin), ("FP32 plus", cplus)):
        fv, fh = lp.lane_segscan(barrier, vf, hh, cmb)
        fv = fv.view(torch.int32).clone()
        for r in range(200):
            gv, gh = lp.lane_segscan(barrier, vf, hh, cmb)
            if not (bool(torch.equal(gv.view(torch.int32), fv))
                    and bool(torch.equal(gh, fh))):
                fail(f"K5 race check {label}: launch {r + 1} of 200 differs "
                     f"from the first")
    log("  K5: one launch a call, 200 launches of FP32 min and plus with "
        "validity bitwise equal: ok")
    # timed warm and after an L2 flush; the kernels line's row is the main
    # path's variant, the first
    k5_bytes, k5v_bytes = 4 * 5 * R_scan * 128, 4 * 3 * R_scan * 128
    for i, (tag, cmb, ok, nbytes) in enumerate((
            ("FP32 min + validity", cmin, hh, k5_bytes),
            ("FP32 plus + validity", cplus, hh, k5_bytes),
            ("FP32 min values only", cmin, None, k5v_bytes),
            ("FP32 plus values only", cplus, None, k5v_bytes))):
        kfn = lambda: lp.lane_segscan(barrier, vf, ok, cmb)  # noqa: E731
        pfn = lambda: lp.lane_segscan_plain(barrier, vf, ok, cmb)  # noqa: E731
        ms, cold, pms = (cuda_ms(torch, kfn), cuda_ms(torch, kfn, cold=True),
                         cuda_ms(torch, pfn))
        b_ms, _ = bound(nbytes)
        variants[f"lane_segscan {tag}"] = {
            "ms": ms, "cold_ms": cold, "plain_ms": pms, "bound_ms": b_ms,
            "bytes": nbytes}
        log(f"  lane_segscan {tag}: kernel {ms:.4f} ms, after an L2 flush "
            f"{cold:.4f} ms, plain {pms:.4f} ms, bound {b_ms:.4f} ms "
            f"({nbytes / 1e6:.1f} MB)")
        if i == 0:
            row = add("lane_segscan", "graphblas_tpu_torch/csrc/lane_segscan.cu",
                      "graphblas_tpu/core/engine/lanepipe.py:476", err5, ms,
                      pms, nbytes, nops=2 * R_scan * 128)
            row["launches_per_call"] = per_call.pop()

    # ---- K6 segscan on the zipf matrix's sort-pipeline plan (vxm side)
    t0 = time.perf_counter()
    se = sp.get_plan(A._sparse, False, device=dev)
    torch.cuda.synchronize()
    L = se["L"]
    plan_bytes = sum(t.numel() * t.element_size() for t in sp.plan_dyn_tuple(se))
    log(f"sort-pipeline plan: {time.perf_counter() - t0:.2f} s, L={L}, "
        f"{plan_bytes / 1e6:.1f} MB on the card")
    variants["sortpipe_plan"] = {"L": L, "bytes": plan_bytes}
    src_m, barrier_m, src_back, barrier_i, _, vals_m, ok_m = sp.plan_dyn_tuple(se)
    u = torch.from_numpy(rng.random(n, dtype=np.float32)).to(dev)
    zpad = torch.zeros(L - n, dtype=torch.float32, device=dev)
    uok9 = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    m_v, m_h = sp.sort_apply(src_m, [torch.cat([u, zpad]),
                                     torch.cat([uok9.to(torch.int32),
                                                zpad.to(torch.int32)])])
    pair = [sp.FIRST, sp.FIRST]
    got = sp.segscan(barrier_m, [m_v, m_h], pair)
    want = sp.segscan_channels_plain(barrier_m, [m_v, m_h], pair)
    compare("K6 segscan fill (first, first), values", got[0], want[0])
    compare("K6 segscan fill (first, first), validity", got[1], want[1])
    okf = (got[1] != 0) & (ok_m != 0) & (barrier_m == 0)
    i_v, i_h = sp.sort_apply(src_back, [torch.where(okf, got[0] * vals_m, 0.0),
                                        okf.to(torch.int32)])
    err6 = None
    for label, mono_k, rel in (("plus", gb.monoid.plus["FP32"], 1e-5),
                               ("min", gb.monoid.min["FP32"], None)):
        pair = [sp.monoid_combine(mono_k), sp.COUNT]
        got = sp.segscan(barrier_i, [i_v, i_h], pair)
        want = sp.segscan_channels_plain(barrier_i, [i_v, i_h], pair)
        err = compare(f"K6 segscan reduce ({label}, plus), values", got[0],
                      want[0], rel=rel)
        compare(f"K6 segscan reduce ({label}, plus), count", got[1], want[1])
        if err6 is None:
            err6 = err
    b0 = barrier_i.clone()
    b0[0] = 0  # element 0 starts a segment whether or not its barrier is set
    pair = [sp.monoid_combine(gb.monoid.plus["INT32"]), sp.FIRST, sp.COUNT]
    chans = [i_h, torch.arange(L, dtype=torch.int32, device=dev), i_h]
    got = sp.segscan(b0, chans, pair)
    want = sp.segscan_channels_plain(b0, chans, pair)
    for g, w_, nm in zip(got, want, ("plus", "first", "count")):
        compare(f"K6 segscan three channels, no barrier at 0, {nm}", g, w_)
    pair = [sp.monoid_combine(mono), sp.COUNT]
    # how long the fold's segments run: what K6's look-back meets
    starts = torch.nonzero(barrier_i).reshape(-1)
    seg = torch.diff(torch.cat([starts, torch.tensor([L], device=dev)]))
    long_share = float(seg[seg > 64 * sp.SEG_BLOCK].sum()) / L
    bar_tiles = float((barrier_i.reshape(-1, sp.SEG_BLOCK) != 0).any(1)
                      .float().mean())
    log(f"  K6 fold: {long_share:.3f} of the elements in segments over 64 "
        f"tiles long, {bar_tiles:.3f} of the tiles hold a barrier")
    variants["segscan_fold_segments"] = {"over_64_tiles": long_share,
                                         "tiles_with_barrier": bar_tiles}
    k6_edge_cases(gb, torch, dev, rng, L)
    k6_race_check(torch, sp, barrier_i, [i_v, i_h], pair, 200)
    k6 = lambda: sp.segscan(barrier_i, [i_v, i_h], pair)  # noqa: E731
    p6 = lambda: sp.segscan_channels_plain(barrier_i, [i_v, i_h], pair)  # noqa: E731
    add("segscan", "graphblas_tpu_torch/csrc/segscan.cu",
        "graphblas_tpu/core/engine/sortpipe.py:168", err6, cuda_ms(torch, k6),
        cuda_ms(torch, p6), 4 * 5 * L, nops=2 * L)
    k6_rates(torch, sp, barrier_i, [i_v, i_h], pair, barrier_m, [m_v, m_h],
             variants)
    combine_sweep(gb, torch, dev, rng)


def k6_compare(name, got, want, combines):
    """K6 against its plain version: FP32 plus and times to rel 1e-5, the
    rest bitwise."""
    err = 0.0
    for i, (g, w, c) in enumerate(zip(got, want, combines)):
        fp_sum = c.dt is not None and c.dt.is_float and \
            c.monoid in ("plus", "times")
        err = max(err, compare(f"{name}, channel {i}", g, w,
                               rel=1e-5 if fp_sum else None, quiet=True))
    return err


def k6_edge_cases(gb, torch, dev, rng, L):
    """Where the look-back is most exposed, against the plain version: no
    barrier at all over L (one segment through every tile), barriers only
    at tile starts, only at the last element of each tile, at every
    element; one tile (L = 4096); every channel tuple with inline combines,
    the run-time path at one to four channels, and five channels (two
    launches), at L with random barriers and one long segment."""
    from graphblas_tpu_torch.core.engine import kernels as K
    from graphblas_tpu_torch.core.engine import sortpipe as sp

    T = sp.SEG_BLOCK

    def bars(kind, n):
        b = torch.zeros(n, dtype=torch.int32, device=dev)
        if kind == "tile starts":
            b[::T] = 1
        elif kind == "tile ends":
            b[T - 1::T] = 1
        elif kind == "every element":
            b[:] = 1
        elif kind == "random":
            b = torch.from_numpy((rng.random(n) < 1 / 500).astype(np.int32)).to(dev)
            b[n // 4:n // 2] = 0  # one segment over a quarter of the tiles
        return b

    def chan(c, n):
        if c.dt is not None and c.dt.is_float:
            return torch.from_numpy(rng.random(n, dtype=np.float32)
                                    + np.float32(0.5)).to(dev)
        small = c is sp.COUNT or (c.dt is not None and c.dt.is_bool)
        lo, hi = (0, 2) if small else (-1000, 1000)
        return torch.from_numpy(rng.integers(lo, hi, n).astype(np.int32)).to(dev)

    def run(tag, bar, combines):
        vals = [chan(c, bar.numel()) for c in combines]
        got = sp.segscan(bar, vals, combines)
        want = sp.segscan_channels_plain(bar, vals, combines)
        return k6_compare(f"K6 {tag}", got, want, combines)

    plus_count = [sp.monoid_combine(gb.monoid.plus["FP32"]), sp.COUNT]
    fill = [sp.FIRST, sp.FIRST]
    worst = 0.0
    for kind in ("none", "tile starts", "tile ends", "every element"):
        for n in (L, T):
            b = bars(kind, n)
            for tag, combines in (("plus", plus_count), ("fill", fill)):
                worst = max(worst, run(f"{kind}, L={n}, {tag}", b, combines))
    tuples = {
        "plus FP32, count": plus_count,
        "min FP32, count": [sp.monoid_combine(gb.monoid.min["FP32"]), sp.COUNT],
        "max FP32, count": [sp.monoid_combine(gb.monoid.max["FP32"]), sp.COUNT],
        "lor BOOL, count": [sp.monoid_combine(gb.monoid.lor["BOOL"]), sp.COUNT],
        "plus INT32, count": [sp.monoid_combine(gb.monoid.plus["INT32"]),
                              sp.COUNT],
        "first, first": fill,
        "run-time, 1 channel": [sp.monoid_combine(gb.monoid.times["FP32"])],
        "run-time, 2 channels": [sp.monoid_combine(gb.monoid.min["INT32"]),
                                 sp.FIRST],
        "run-time, 3 channels": [sp.monoid_combine(gb.monoid.max["UINT32"]),
                                 sp.FIRST, sp.COUNT],
        "run-time, 4 channels": [sp.monoid_combine(gb.monoid.band["UINT32"]),
                                 sp.FIRST, sp.COUNT,
                                 sp.monoid_combine(gb.monoid.land["BOOL"])],
        "5 channels, two launches": [
            sp.monoid_combine(gb.monoid.plus["FP32"]), sp.FIRST, sp.COUNT,
            sp.monoid_combine(gb.monoid.max["INT32"]),
            sp.monoid_combine(gb.monoid.min["FP32"])],
    }
    b = bars("random", L)
    for tag, combines in tuples.items():
        before = K.launches["segscan"]
        worst = max(worst, run(f"{tag}, L={L} random", b, combines))
        if K.launches["segscan"] - before != -(-len(combines) // K.MAXCH):
            fail(f"K6 {tag}: not one launch per group of four channels")
    # an FP32 product carried across tiles, in segments of about three: the
    # factors are 1/2, 1 and 2, so each product is exact in any fold order
    # and must agree in every bit, and a wrong carry shows
    times = [sp.monoid_combine(gb.monoid.times["FP32"])]
    bt = torch.zeros(L, dtype=torch.int32, device=dev)
    bt[1000::3 * T + 1234] = 1
    f = torch.from_numpy(rng.choice(np.float32([0.5, 1, 2]), L,
                                    p=[0.01, 0.98, 0.01])).to(dev)
    compare("K6 times FP32 across tiles, exact factors",
            sp.segscan(bt, [f], times)[0],
            sp.segscan_channels_plain(bt, [f], times)[0], quiet=True)
    log(f"  K6 look-back edge cases (4 barrier layouts at L={L} and {T}, "
        f"{len(tuples)} channel tuples, an FP32 product across tiles): ok, "
        f"largest FP32 abs err {worst:.3g}")


def k6_race_check(torch, sp, barrier, vals, combines, runs):
    """A look-back with a wrong fence fails now and then, not always: the
    main path's scan `runs` times, each output equal to the first in every
    bit (the fold order of FP32 sums is fixed: see csrc/segscan.cu)."""
    first = [t.view(torch.int32).clone() for t in sp.segscan(barrier, vals,
                                                             combines)]
    for r in range(runs):
        got = sp.segscan(barrier, vals, combines)
        for g, f in zip(got, first):
            if not bool(torch.equal(g.view(torch.int32), f)):
                fail(f"K6 race check: launch {r + 1} of {runs} differs from "
                     f"the first")
    log(f"  K6 race check: {runs} launches bitwise equal to the first")


def k6_rates(torch, sp, bar_i, fold, fold_c, bar_m, fill, variants):
    """K6 on the main path's two scans (the row fold and the fill): its
    time and achieved rate, the function's bytes (1 + 2 nv words an
    element) over the kernel's time, beside the bound."""
    fill_c = [sp.FIRST, sp.FIRST]
    for tag, bar, vals, combines in (("fold", bar_i, fold, fold_c),
                                     ("fill", bar_m, fill, fill_c)):
        nbytes = 4 * (1 + 2 * len(vals)) * bar.numel()
        ms = cuda_ms(torch, lambda: sp.segscan(bar, vals, combines))
        b_ms, _ = bound(nbytes)
        variants[f"segscan_{tag}"] = {"ms": ms, "bound_ms": b_ms,
                                      "bytes": nbytes,
                                      "gb_s": nbytes / ms / 1e6}
        log(f"  K6 {tag}: {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
            f"{b_ms / ms:.0%} of the bound); bound {b_ms:.4f} ms "
            f"({nbytes / 1e6:.1f} MB)")


def combine_sweep(gb, torch, dev, rng):
    """K5 and K6 at small sizes over every monoid and 32-bit type the
    engines take, against their plain versions: one and three tiles for
    K5; one tile and 16 tiles for K6 (three channels: the run-time
    combines), and 1030 tiles with one segment over some 340 of them and
    five channels, which takes two launches.  FP32 plus and times to rel
    1e-5, the rest bitwise."""
    from graphblas_tpu_torch.core.dtypes import BOOL, FP32, INT32, UINT32
    from graphblas_tpu_torch.core.engine import lanepipe as lp
    from graphblas_tpu_torch.core.engine import sortpipe as sp
    from graphblas_tpu_torch.core.operator.monoid import BUILTINS

    def values(shape, dt):
        if dt is FP32:
            return torch.from_numpy(
                rng.random(shape, dtype=np.float32) + np.float32(0.5)).to(dev)
        if dt is BOOL:
            return torch.from_numpy(
                (rng.random(shape) < 0.5).astype(np.int32)).to(dev)
        lo, hi = (-2**31, 2**31) if dt is UINT32 else (-1000, 1000)
        return torch.from_numpy(
            rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)).to(dev)

    def barriers(shape, p):
        b = (rng.random(shape) < p).astype(np.int32)
        b[0] = 1
        return torch.from_numpy(b).to(dev)

    # every monoid the scan engines take (`any` has no identity: the dense
    # engine alone has it)
    monos = [m[dt] for m in BUILTINS.values() for dt in (BOOL, INT32, UINT32, FP32)
             if dt in m._domains and sp.eligible_reduce(m[dt], dt)]
    worst = 0.0
    for mono in monos:
        rel = 1e-5 if mono.type is FP32 and mono.parent.name in ("plus", "times") \
            else None
        tag = f"{mono.parent.name}[{mono.type}]"
        cmb = lp.combines(mono)[0]
        for R in (128, 384):
            bar, v = barriers((R, 128), 1 / 40), values((R, 128), mono.type)
            h = values((R, 128), BOOL)
            for ok in (h, None):
                gv, gh = lp.lane_segscan(bar, v, ok, cmb)
                pv, ph = lp.lane_segscan_plain(bar, v, ok, cmb)
                worst = max(worst, compare(f"K5 sweep {tag} R={R}", gv, pv,
                                           rel=rel, quiet=True))
                if ok is not None:
                    compare(f"K5 sweep {tag} R={R} ok", gh, ph, quiet=True)
        for L in (4096, 1 << 16):
            bar = barriers(L, 1 / 100)
            chans = [values(L, mono.type), values(L, INT32), values(L, BOOL)]
            pair = [sp.monoid_combine(mono), sp.FIRST, sp.COUNT]
            got = sp.segscan(bar, chans, pair)
            want = sp.segscan_channels_plain(bar, chans, pair)
            worst = max(worst, compare(f"K6 sweep {tag} L={L}", got[0], want[0],
                                       rel=rel, quiet=True))
            compare(f"K6 sweep {tag} L={L} first", got[1], want[1], quiet=True)
            compare(f"K6 sweep {tag} L={L} count", got[2], want[2], quiet=True)
    L = 4096 * 1030
    bar = barriers(L, 1 / 5000)
    bar[L // 3:2 * L // 3] = 0  # one segment over some 340 blocks
    chans = [values(L, INT32), values(L, INT32), values(L, BOOL),
             values(L, INT32), values(L, FP32)]
    pair = [sp.monoid_combine(gb.monoid.plus["INT32"]), sp.FIRST, sp.COUNT,
            sp.monoid_combine(gb.monoid.max["INT32"]),
            sp.monoid_combine(gb.monoid.min["FP32"])]
    got = sp.segscan(bar, chans, pair)
    want = sp.segscan_channels_plain(bar, chans, pair)
    for i, (g, w_) in enumerate(zip(got, want)):
        compare(f"K6 sweep five channels, 1030 blocks, channel {i}", g, w_,
                quiet=True)
    log(f"  K5 and K6 sweep over {len(monos)} monoids: ok, largest FP32 abs "
        f"err {worst:.3g}")


def k7_compare(name, got, want, quiet=True):
    """K7 against its plain version: every element equal, NaN matching NaN
    (== also takes -0.0 for +0.0, the one freedom a min of zeros has)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(want.shape)} {want.dtype}")
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    if not bool(same.all()):
        fail(f"{name}: kernel differs from its plain version in "
             f"{int((~same).sum())} of {same.numel()} elements")
    if not quiet:
        log(f"  {name}: ok, equal in all {same.numel()} elements")
    return 0.0


def tropical_phase(gb, torch, dev, results):
    """K7 against its plain version: all 12 (red, comb) pairs in FP32 and
    two in FP64 at ragged and degenerate shapes, the entry point with
    validity planes on finite operands and on stored inf/NaN, then the
    main path's shape (8192^3, validity planes, FP32 min_plus) in full,
    and the times at 8192^3 and 2048^3."""
    from graphblas_tpu_torch.core.engine import tropical as tr

    rng = np.random.default_rng(SEED + 3)
    shapes = ((300, 260, 200), (1, 260, 200), (300, 260, 1), (1, 70, 1),
              (129, 17, 65))

    def operand(shape, dtype, ident, p_missing=0.2, special=False):
        v = (rng.standard_normal(shape) * 10).astype(dtype)
        ok = rng.random(shape) >= p_missing
        if special:
            pick = rng.random(shape)
            v[pick < 0.02] = np.inf
            v[(pick >= 0.02) & (pick < 0.04)] = -np.inf
            v[(pick >= 0.04) & (pick < 0.05)] = np.nan
        enc = np.where(ok, v, dtype(ident))
        return (torch.from_numpy(v).to(dev), torch.from_numpy(ok).to(dev),
                torch.from_numpy(enc).to(dev))

    cases = 0
    for dtype, pairs in ((np.float32, [(r, c) for r in tr.RED_CODE
                                       for c in ("plus", "min", "max", "times",
                                                 "first", "second")]),
                         (np.float64, [("min", "plus"), ("max", "min")])):
        for red, comb in pairs:
            ident = np.inf if red == "min" else -np.inf
            for m, k, n in shapes:
                _, _, a = operand((m, k), dtype, ident)
                _, _, b = operand((k, n), dtype, ident)
                k7_compare(f"K7 {red}_{comb} {dtype.__name__} {m}x{k}x{n}",
                           tr.tropical_matmul(a, b, red, comb),
                           tr.tropical_matmul_plain(a, b, red, comb))
                cases += 1
    for dtype in (np.float32, np.float64):
        for red, comb in tr.MASKED_PAIRS:
            ident = np.inf if red == "min" else -np.inf
            for special in (False, True):
                for m, k, n in shapes:
                    a, aok, _ = operand((m, k), dtype, ident, 0.4, special)
                    b, bok, _ = operand((k, n), dtype, ident, 0.4, special)
                    k7_compare(
                        f"K7 validity planes {red}_{comb} {dtype.__name__} "
                        f"{m}x{k}x{n} special={special}",
                        tr.tropical_matmul(a, b, red, comb, aok, bok),
                        tr.tropical_matmul_plain(a, b, red, comb, aok, bok))
                    cases += 1
    log(f"  K7 against its plain version at small shapes: {cases} cases ok")

    out = {}
    row = None
    for size in (2048, 8192):
        a = torch.from_numpy(rng.random((size, size), dtype=np.float32)).to(dev)
        b = torch.from_numpy(rng.random((size, size), dtype=np.float32)).to(dev)
        aok = torch.from_numpy(rng.random((size, size)) < 0.5).to(dev)
        bok = torch.from_numpy(rng.random((size, size)) < 0.5).to(dev)
        inf = torch.tensor(np.inf, dtype=torch.float32, device=dev)
        ae, be = torch.where(aok, a, inf), torch.where(bok, b, inf)
        kfn = lambda: tr.tropical_matmul(a, b, "min", "plus", aok, bok)  # noqa: E731
        efn = lambda: tr.tropical_matmul(ae, be, "min", "plus")  # noqa: E731
        got = kfn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = tr.tropical_matmul_plain(a, b, "min", "plus", aok, bok)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = k7_compare(f"K7 min_plus FP32 {size}^3, validity planes", got,
                         want, quiet=False)
        k7_compare(f"K7 min_plus FP32 {size}^3, encoded", efn(), want,
                   quiet=False)
        del want, got
        ms, enc_ms = cuda_ms(torch, kfn), cuda_ms(torch, efn)
        nbytes = 4 * 3 * size * size + 2 * size * size
        b_ms, b_by = bound(nbytes, 2 * size ** 3, FP32_INSTR_PER_S)
        e_ms, _ = bound(4 * 3 * size * size, 2 * size ** 3, FP32_INSTR_PER_S)
        log(f"  tropical_matmul {size}^3 FP32 min_plus: validity planes "
            f"{ms:.4f} ms, encoded {enc_ms:.4f} ms, plain (one run) "
            f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}; bytes alone "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms), "
            f"{2 * size ** 3 / ms / 1e9:.3f} T instructions/s")
        out[f"{size}^3"] = {"ms": ms, "encoded_ms": enc_ms,
                            "plain_ms": plain_ms, "bound_ms": b_ms,
                            "encoded_bound_ms": e_ms, "bytes": nbytes}
        row = {"name": "tropical_matmul", "route": "cuda",
               "source": "graphblas_tpu_torch/csrc/tropical.cu",
               "replaces": "graphblas_tpu/core/engine/kernels/tropical.py:61",
               "launches": 0, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None}
        del a, b, aok, bok, ae, be
        torch.cuda.empty_cache()
    results.setdefault("kernels", {})["tropical_matmul"] = row
    results["tropical"] = out


KERNELS = ("gather_mult", "mid_perm", "fused_permC_scan_permA", "tile_perm",
           "lane_segscan", "segscan", "tropical_matmul")
LANEPIPE_FAST = KERNELS[:4]


def reset_counts(K):
    """Set the kernels' launch counts and the exchange count to 0."""
    from graphblas_tpu_torch.core.engine import permute as pm

    K.reset_launches()
    pm.exchanges = 0


def check_launches(K, phase, totals, need=LANEPIPE_FAST):
    """Log the phase's launch counts, fail if a kernel in `need` was never
    launched in it or if an exchange transpose ran (K3 folds them), and add
    all counts to totals."""
    from graphblas_tpu_torch.core.engine import permute as pm

    got = {k: K.launches[k] for k in KERNELS}
    log(f"  launches in {phase}: {got}; exchanges {pm.exchanges}")
    zero = [k for k in need if got[k] == 0]
    if zero:
        fail(f"{phase}: kernels never launched on the main path: {zero}")
    if pm.exchanges:
        fail(f"{phase}: {pm.exchanges} exchange transposes ran on the main path")
    for k, v in got.items():
        totals[k] = totals.get(k, 0) + v
    return got


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
        reset_counts(K)
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
        reset_counts(K)
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


def check_vector(name, vec, ref_idx, ref_vals, rel=None):
    """A result Vector against a numpy reference: structure exactly, values
    exactly (rel None) or within rel.  Returns the max abs error."""
    gi, gv = vec.to_coo()
    if not np.array_equal(gi.astype(np.int64), ref_idx):
        fail(f"{name}: structure differs from the reference ({len(gi)} vs "
             f"{len(ref_idx)} entries)")
    if not np.isfinite(gv.astype(np.float64)).all():
        fail(f"{name}: non-finite values")
    g64, r64 = gv.astype(np.float64), ref_vals.astype(np.float64)
    err = float(np.abs(g64 - r64).max()) if len(gi) else 0.0
    if rel is None:
        if not np.array_equal(gv, ref_vals.astype(gv.dtype)):
            fail(f"{name}: values differ from the reference")
    elif (np.abs(g64 - r64) > rel * np.abs(r64)).any():
        fail(f"{name}: values beyond rel {rel} of the reference (max abs "
             f"err {err})")
    return err


def timed_calls(torch, fn, reps=RUNS):
    """Median host ms of reps calls of fn, each ending in a device sync
    (after one warm-up call, which builds any plan)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(runs)), runs, first_s


def sssp_phase(gb, torch, K, src, dst, w, n, A, results, totals):
    import scipy.sparse as sps
    from scipy.sparse.csgraph import dijkstra

    t0 = time.perf_counter()
    ref = dijkstra(sps.csr_matrix((w.astype(np.float64), (src, dst)),
                                  shape=(n, n)), indices=0)
    ref_s = time.perf_counter() - t0
    reach = np.flatnonzero(np.isfinite(ref))
    gb.algorithms.sssp(A, 0)  # warm-up
    runs = []
    for _ in range(RUNS):
        reset_counts(K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = gb.algorithms.sssp(A, 0)
        d.wait(how="complete")
        runs.append(time.perf_counter() - t0)
        err = check_vector("sssp", d, reach, ref[reach], rel=1e-5)
    got = check_launches(K, "sssp", totals,
                         need=("gather_mult", "mid_perm", "tile_perm",
                               "lane_segscan"))
    slow = got["lane_segscan"]  # one launch a call
    fast = got["fused_permC_scan_permA"]  # one launch a call
    iters = slow + fast
    secs = float(np.median(runs))
    log(f"  sssp: {iters} iterations ({slow} on the sparse-vector branch, "
        f"{fast} on the dense one), ms {[r * 1e3 for r in runs]} (median "
        f"{secs * 1e3:.3f}), {secs * 1e3 / iters:.4f} ms/iteration, reached "
        f"{len(reach)}, max abs err {err:.3g} (scipy dijkstra {ref_s:.2f} s)")
    prof = profile_breakdown(torch, lambda: gb.algorithms.sssp(A, 0), "sssp",
                             secs * 1e3)
    results["sssp"] = {"n": n, "iterations": iters, "slow_iterations": slow,
                       "fast_iterations": fast,
                       "ms_runs": [r * 1e3 for r in runs], "ms": secs * 1e3,
                       "ms_per_iteration": secs * 1e3 / iters,
                       "reached": int(len(reach)), "max_abs_err": err,
                       "profile": prof}


def reduce_phase(gb, torch, K, src, dst, w, n, A, Ab, results, totals):
    w64 = w.astype(np.float64)
    colmax = np.full(n, -np.inf)
    np.maximum.at(colmax, dst, w64)
    rows_i = np.flatnonzero(np.bincount(src, minlength=n))
    cols_i = np.flatnonzero(np.bincount(dst, minlength=n))
    cases = [
        ("A.reduce_rowwise(plus)", lambda: A.reduce_rowwise("plus").new(),
         rows_i, np.bincount(src, weights=w64, minlength=n)[rows_i], 1e-5),
        ("A.reduce_columnwise(plus)", lambda: A.reduce_columnwise("plus").new(),
         cols_i, np.bincount(dst, weights=w64, minlength=n)[cols_i], 1e-5),
        ("A.T.reduce_rowwise(max)", lambda: A.T.reduce_rowwise("max").new(),
         cols_i, colmax[cols_i], 1e-5),
        ("Ab.reduce_columnwise(lor)", lambda: Ab.reduce_columnwise("lor").new(),
         cols_i, np.ones(len(cols_i), bool), None),
    ]
    reset_counts(K)
    out = {}
    for name, fn, ref_i, ref_v, rel in cases:
        vec, ms, runs, first_s = timed_calls(torch, fn)
        err = check_vector(name, vec, ref_i, ref_v, rel=rel)
        log(f"  {name}: ms {runs} (median {ms:.4f}), "
            f"{len(src) / ms / 1e6:.4f} GnnZ/s, first call {first_s:.2f} s, "
            f"{len(ref_i)} entries, max abs err {err:.3g}")
        out[name] = {"ms": ms, "ms_runs": runs, "first_call_s": first_s,
                     "gnnz_s": len(src) / ms / 1e6, "max_abs_err": err}
    check_launches(K, "reduce", totals, need=("segscan",))
    fn = cases[0][1]
    out["profile"] = profile_breakdown(torch, fn, cases[0][0],
                                       out[cases[0][0]]["ms"])
    results["reduce"] = out


def hypersparse_phase(gb, torch, K, dev, results, totals):
    """vxm/mxv on a uniformly random digraph with far fewer edges than
    rows: every 16384-wide window costs the lanepipe a whole gather block,
    so its plan is over PACK_LIMIT and the sort pipeline runs."""
    from graphblas_tpu_torch.core.engine import lanepipe as lp

    n, m = 1 << 22, 1 << 21
    rng = np.random.default_rng(SEED + 2)
    lin = np.unique(rng.integers(0, n * n, int(m * 1.01)))
    lin = np.sort(rng.choice(lin, m, replace=False))
    r, c = lin // n, lin % n
    w = (rng.random(m, dtype=np.float32) + np.float32(0.5))
    t0 = time.perf_counter()
    H = gb.Matrix.from_coo(r, c, w, dtype="FP32", nrows=n, ncols=n)
    Hb = gb.Matrix.from_coo(r, c, np.ones(m, bool), dtype="BOOL", nrows=n,
                            ncols=n)
    for M, dest_is_row, tag in ((H, False, "FP32 vxm"), (H, True, "FP32 mxv"),
                                (Hb, False, "BOOL vxm")):
        if lp.get_plan(M._sparse, dest_is_row, device=dev) is not None:
            fail(f"hypersparse {tag}: the lanepipe took the matrix, so the "
                 f"sort pipeline would not run")
    log(f"  hypersparse n={n} nnz={m}: matrices and the lanepipe's refusals "
        f"in {time.perf_counter() - t0:.2f} s")
    w64 = w.astype(np.float64)

    # vxm plus_times with a dense u
    uv = rng.random(n, dtype=np.float32)
    u = gb.Vector.from_dense(uv)
    ref1 = np.bincount(c, weights=uv.astype(np.float64)[r] * w64, minlength=n)
    idx1 = np.flatnonzero(np.bincount(c, minlength=n))
    # mxv min_plus with a 1% sparse u
    si = np.sort(rng.choice(n, n // 100, replace=False))
    sv = rng.random(len(si), dtype=np.float32)
    us = gb.Vector.from_coo(si, sv, dtype="FP32", size=n)
    uok = np.zeros(n, bool)
    uok[si] = True
    ud = np.zeros(n, np.float32)
    ud[si] = sv
    e2 = uok[c]
    # the port adds in float32; the reference adds the same two float32
    # numbers in float64, so rel 1e-5 covers the one rounding
    ref2 = np.full(n, np.inf)
    np.minimum.at(ref2, r[e2], w64[e2] + ud[c[e2]].astype(np.float64))
    idx2 = np.flatnonzero(np.bincount(r[e2], minlength=n))
    # BOOL lor_land vxm with a 30% sparse u of random truth values
    bok = rng.random(n) < 0.3
    bi = np.flatnonzero(bok)
    bv = rng.random(len(bi)) < 0.5
    ub = gb.Vector.from_coo(bi, bv, dtype="BOOL", size=n)
    uf = gb.Vector.from_coo(bi, np.where(bv, np.float32(2.5), np.float32(0)),
                            dtype="FP32", size=n)
    bd = np.zeros(n, bool)
    bd[bi] = bv
    e3 = bok[r]
    idx3 = np.flatnonzero(np.bincount(c[e3], minlength=n))
    ref3 = np.bincount(c[e3], weights=bd[r[e3]].astype(np.float64),
                       minlength=n)[idx3] > 0
    cases = [
        ("vxm plus_times[FP32], dense u",
         lambda: u.vxm(H, gb.semiring.plus_times["FP32"]).new(),
         idx1, ref1[idx1], 1e-5),
        ("mxv min_plus[FP32], 1% sparse u",
         lambda: H.mxv(us, gb.semiring.min_plus["FP32"]).new(),
         idx2, ref2[idx2], 1e-5),
        ("vxm lor_land[BOOL], 30% sparse u",
         lambda: ub.vxm(Hb, gb.semiring.lor_land["BOOL"]).new(),
         idx3, ref3, None),
        # the same truth values as FP32: the BOOL ring over the truth of
        # H's values, on the plan of the plus_times vxm above
        ("vxm lor_land[FP32], 30% sparse u",
         lambda: uf.vxm(H, gb.semiring.lor_land["FP32"]).new(),
         idx3, ref3, None),
    ]
    reset_counts(K)
    out = {"n": n, "nnz": m}
    for name, fn, ref_i, ref_v, rel in cases:
        vec, ms, runs, first_s = timed_calls(torch, fn)
        err = check_vector(f"hypersparse {name}", vec, ref_i, ref_v, rel=rel)
        log(f"  {name}: ms {runs} (median {ms:.4f}), {m / ms / 1e6:.4f} "
            f"GnnZ/s, first call {first_s:.2f} s, {len(ref_i)} entries, max "
            f"abs err {err:.3g}")
        out[name] = {"ms": ms, "ms_runs": runs, "first_call_s": first_s,
                     "gnnz_s": m / ms / 1e6, "entries": int(len(ref_i)),
                     "max_abs_err": err}
    nplans = len(H._sparse._sortpipe_plans)
    if nplans != 2 or H._sparse._bool_twins:
        fail(f"hypersparse: H holds {nplans} sort-pipeline plans and "
             f"{len(H._sparse._bool_twins)} BOOL twins; lor_land[FP32] "
             f"should share the plus_times vxm's plan")
    got = check_launches(K, "hypersparse", totals, need=("segscan",))
    if any(got[k] for k in KERNELS if k != "segscan"):
        fail("hypersparse: a lanepipe kernel launched; the path was not the "
             "sort pipeline")
    fn = cases[0][1]
    out["profile"] = profile_breakdown(torch, fn, cases[0][0],
                                       out[cases[0][0]]["ms"])
    # what the FP32 ring costs beyond the BOOL one on the same structure
    for name, fn, *_ in cases[2:]:
        out[f"profile {name}"] = profile_breakdown(torch, fn, name,
                                                   out[name]["ms"])
    results["hypersparse"] = out


def apsp_phase(gb, torch, K, results, totals):
    """All-pairs shortest paths at the full default width of the dense
    engine: n = 8192, the largest square matrix dense_limit = 2**26 lets
    the library densify.  `A.power(n, min_plus)` (13 squarings) and the
    `D(accum=min) << D.mxm(D, min_plus)` loop against scipy's Dijkstra in
    float64; the lor_land closure; an FP32 plus_times mxm against the same
    call on the CPU; the generic blocked product timed once."""
    import scipy.sparse as sps
    from scipy.sparse.csgraph import connected_components, shortest_path
    from graphblas_tpu_torch.core.engine import tropical as tr

    if torch.backends.cuda.matmul.allow_tf32:
        fail("apsp: TF32 matmul is on; plus_times and the structure product "
             "need full float32")
    n = APSP_N
    # repeated squaring: 13 squarings and no multiply for n = 8192
    products = n.bit_length() - 1 + bin(n).count("1") - 1
    rng = np.random.default_rng(SEED + 4)
    src, dst = build_graph(n, 8)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = (rng.random(len(src), dtype=np.float32) + np.float32(0.05))
    diag = np.arange(n, dtype=np.int64)
    src_d = np.concatenate([src, diag])
    dst_d = np.concatenate([dst, diag])
    w_d = np.concatenate([w, np.zeros(n, np.float32)])
    t0 = time.perf_counter()
    G = sps.csr_matrix((w.astype(np.float64), (src, dst)), shape=(n, n))
    ref = shortest_path(G, method="D")
    ncomp, _ = connected_components(G, connection="strong")
    ref_s = time.perf_counter() - t0
    if ncomp != 1 or not np.isfinite(ref).all():
        fail("apsp: the reference graph is not strongly connected")
    log(f"  apsp n={n} nnz={len(src)}: scipy Dijkstra from every source "
        f"{ref_s:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    A = gb.Matrix.from_coo(src_d, dst_d, w_d, dtype="FP32", nrows=n, ncols=n)
    if A._sparse is None:
        fail(f"apsp: from_coo at n={n} should be sparse-backed")
    ring = gb.semiring.min_plus["FP32"]
    plain0 = tr.plain_calls

    def run_power():
        return A.power(n, ring).new()

    reset_counts(K)
    D = run_power()          # densifies A under dense_limit; warm-up
    torch.cuda.synchronize()
    if K.launches["tropical_matmul"] != products:
        fail(f"apsp: power({n}) launched K7 "
             f"{K.launches['tropical_matmul']} times, expected {products}")
    if A._sparse is not None:
        fail("apsp: power did not densify its operand")
    got = D.to_dense(fill_value=np.inf).astype(np.float64)
    if D.nvals != n * n:
        fail(f"apsp: power reached {D.nvals} pairs, scipy {n * n}")
    err = np.abs(got - ref)
    if (err > 1e-5 * np.abs(ref)).any():
        fail(f"apsp: distances beyond rel 1e-5 of scipy (max abs err "
             f"{err.max()})")
    max_err = float(err.max())
    runs = []
    for _ in range(RUNS):
        del D
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        D = run_power()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    power_ms = float(np.median(runs))
    log(f"  A.power({n}, min_plus): ms {runs} (median {power_ms:.2f}), "
        f"{power_ms / products:.4f} ms per product, "
        f"{products} K7 launches, max abs err {max_err:.3g} against scipy")

    # the explicit loop, with the Matrix as ss.iterate's state
    L = A.dup()
    seen = {}

    def body(s, i):
        seen["prev"] = s["D"].dup()
        s["D"](accum=gb.binary.min) << s["D"].mxm(s["D"], ring)

    def changed(s, i):
        return gb.Scalar.from_value(not s["D"].isequal(seen["prev"]))

    LOOP_MAX = 48
    before = K.launches["tropical_matmul"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    it = gb.ss.iterate(body, {"D": L}, cond=changed, max_iter=LOOP_MAX)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3
    if K.launches["tropical_matmul"] - before != it:
        fail(f"apsp: the mxm loop ran {it} products but launched K7 "
             f"{K.launches['tropical_matmul'] - before} times")
    if it >= LOOP_MAX:
        fail(f"apsp: the mxm loop did not converge in {LOOP_MAX} products")
    got_loop = L.to_dense(fill_value=np.inf).astype(np.float64)
    err_loop = np.abs(got_loop - ref)
    if L.nvals != n * n or (err_loop > 1e-5 * np.abs(ref)).any():
        fail(f"apsp: the mxm loop's distances beyond rel 1e-5 of scipy (max "
             f"abs err {err_loop.max()})")
    # both are repeated squarings, but the loop squares until nothing
    # changes and power a fixed 13 times: in float32 a squaring past
    # convergence in exact arithmetic can still lower a last bit
    differ = int((got_loop != got).sum())
    if (np.abs(got_loop - got) > 1e-6 * np.abs(got)).any():
        fail(f"apsp: the mxm loop ({it} products) and power disagree "
             f"beyond rel 1e-6 in {differ} distances")
    log(f"  mxm loop: {it} products in {loop_ms:.2f} ms "
        f"({loop_ms / it:.4f} ms per iteration), max abs err "
        f"{err_loop.max():.3g} against scipy; {differ} of {n * n} distances "
        f"differ from power's in the last bits")
    del L, seen

    if tr.plain_calls != plain0:
        fail("apsp: the plain version of K7 ran on the main path")
    got_l = check_launches(K, "apsp", totals, need=("tropical_matmul",))
    prof = profile_breakdown(torch, run_power, f"A.power({n}, min_plus)",
                             power_ms)
    del D

    # transitive closure over lor_land: library products only
    Ab = gb.Matrix.from_coo(src_d, dst_d, np.ones(len(src_d), bool),
                            dtype="BOOL", nrows=n, ncols=n)
    ringb = gb.semiring.lor_land["BOOL"]
    R, closure_ms, closure_runs, _ = timed_calls(
        torch, lambda: Ab.power(n, ringb).new())
    ok = bool((R._valid & R._vals).all())
    if not ok or R.nvals != n * n:
        fail("apsp: the lor_land closure of a strongly connected graph is "
             "not full")
    log(f"  Ab.power({n}, lor_land): ms {closure_runs} (median "
        f"{closure_ms:.2f}), {closure_ms / products:.4f} ms per product, "
        f"closure full as scipy's one strong component says")
    del R, Ab

    # plus_times FP32 against the same call on the CPU (full float32)
    m = APSP_MXM_N
    av = rng.random((m, m), dtype=np.float32) * (rng.random((m, m)) < 0.5)
    bv = rng.random((m, m), dtype=np.float32) * (rng.random((m, m)) < 0.5)

    def product(ring_name):
        P = gb.Matrix.from_dense(av, missing_value=0)
        Q = gb.Matrix.from_dense(bv, missing_value=0)
        return P.mxm(Q, getattr(gb.semiring, ring_name)["FP32"]).new()

    C, pt_ms, _, _ = timed_calls(torch, lambda: product("plus_times"))
    with gb.config.set(device="cpu"):
        C_cpu = product("plus_times")
    gv, gok = C._host_arrays()
    cv, cok = C_cpu._host_arrays()
    if not np.array_equal(gok, cok):
        fail("apsp: plus_times structure differs between the card and the CPU")
    pt_err = float(np.abs(gv - cv)[cok].max())
    if (np.abs(gv - cv)[cok] > 1e-5 * np.abs(cv[cok])).any():
        fail(f"apsp: plus_times beyond rel 1e-5 of the CPU (max abs err "
             f"{pt_err})")
    # the generic blocked product, once: at 2048^3 a step is one k
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Gm = product("min_times")
    torch.cuda.synchronize()
    generic_ms = (time.perf_counter() - t0) * 1e3
    T = product("min_plus")
    if Gm.nvals != T.nvals:
        fail("apsp: the generic product and K7 disagree on structure")
    peak = torch.cuda.max_memory_allocated()
    log(f"  mxm {m}^3 FP32, each with its two from_dense uploads: "
        f"plus_times {pt_ms:.3f} ms, max abs err {pt_err:.3g} against the "
        f"CPU; generic blocked product (min_times) {generic_ms:.1f} ms, one "
        f"run; peak memory of the phase {peak / 1e9:.3f} GB")
    results["apsp"] = {
        "n": n, "nnz": int(len(src)), "products": products,
        "power_ms_runs": runs, "power_ms": power_ms,
        "ms_per_product": power_ms / products, "max_abs_err": max_err,
        "loop_products": int(it), "loop_ms": loop_ms,
        "closure_ms": closure_ms, "closure_ms_runs": closure_runs,
        "plus_times_2048_ms": pt_ms, "plus_times_max_abs_err": pt_err,
        "generic_min_times_2048_ms": generic_ms, "scipy_s": ref_s,
        "peak_memory_bytes": int(peak), "launches": got_l, "profile": prof}


def sparse_algorithms_phase(gb, torch, K, src, dst, n, results, totals):
    """The generic sparse engine at full size: triangle_count on bench.py's
    RMAT graph (scale 17), exact against scipy, and pagerank (its defaults)
    on the zipf graph with FP32 values of 1 against a float64 power
    iteration.  Kernels: the FP32 outdegree reduce runs K6; the rest is
    torch ops (the masked dot, the FP64 SpMV, merges)."""
    from graphblas_tpu_torch.core import execute as ex

    out = {}
    rs, rd, rn = build_rmat(17)
    t0 = time.perf_counter()
    ref = triangles_ref(rs, rd, rn)
    ref_s = time.perf_counter() - t0
    G = gb.Matrix.from_coo(rs, rd, np.ones(len(rs), bool), dtype="BOOL",
                           nrows=rn, ncols=rn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts(K)
    count, ms, runs, first_s = timed_calls(
        torch, lambda: gb.algorithms.triangle_count(G), reps=3)
    peak = torch.cuda.max_memory_allocated() - before
    check_launches(K, "triangle_count", totals, need=())
    if count != ref:
        fail(f"triangle_count: {count} triangles, scipy {ref}")
    log(f"  triangle_count rmat17: {count} triangles (scipy {ref}, "
        f"{ref_s:.2f} s); ms {runs} (median {ms:.4f}), first call "
        f"{first_s:.2f} s; peak memory over the graph {peak / 1e9:.3f} GB")
    prof = profile_breakdown(torch, lambda: gb.algorithms.triangle_count(G),
                             "triangle_count", ms, ranges=ex.spgemm_record)
    if len(prof["ranges"]) != 1:
        fail(f"triangle_count: {len(prof['ranges'])} SpGEMM ranges, not 1")
    rec = prof["ranges"][0]
    log(f"  triangle_count's mxm: {rec['formulation']} with {rec['terms']} "
        f"terms (Gustavson {rec['gustavson_terms']}, dot {rec['dot_terms']})")
    out["triangle_count"] = {
        "n": rn, "nnz": int(len(rs)), "triangles": count, "scipy_s": ref_s,
        "spgemm": rec, "ms": ms, "ms_runs": runs, "first_call_s": first_s,
        "peak_memory_bytes": int(peak), "profile": prof}
    del G

    P = gb.Matrix.from_coo(src, dst, np.ones(len(src), np.float32),
                           dtype="FP32", nrows=n, ncols=n)
    ref_r, ref_it = pagerank64_ref(src, dst, n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gb.algorithms.pagerank(P)  # builds the reduce's plan
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    reset_counts(K)
    (rank, it), ms, runs, _ = timed_calls(
        torch, lambda: gb.algorithms.pagerank(P), reps=3)
    peak = torch.cuda.max_memory_allocated() - before
    got_l = check_launches(K, "pagerank fp64", totals, need=("segscan",))
    got = rank.to_dense(fill_value=np.nan)
    if not np.isfinite(got).all():
        fail("pagerank fp64: a rank is missing or not finite")
    err = float(np.abs(got - ref_r).max())
    lim = 1e-9 * float(np.abs(ref_r).max())
    if err > lim:
        fail(f"pagerank fp64: max|r - r_ref| {err} over 1e-9 max|r_ref|")
    if abs(it - ref_it) > 1:
        fail(f"pagerank fp64: {it} iterations, the float64 reference "
             f"{ref_it}")
    log(f"  pagerank fp64 zipf: {it} iterations (reference {ref_it}), ms "
        f"{runs} (median {ms:.4f}), {ms / it:.4f} ms/iteration, max|r-ref| "
        f"{err:.3g} (limit {lim:.3g}), first call {first_s:.2f} s, K6 "
        f"launches {got_l['segscan']}; peak memory {peak / 1e9:.3f} GB")
    prof = profile_breakdown(torch, lambda: gb.algorithms.pagerank(P),
                             "pagerank fp64", ms)
    out["pagerank_fp64"] = {
        "n": n, "nnz": int(len(src)), "iterations": it,
        "reference_iterations": ref_it, "ms": ms, "ms_runs": runs,
        "ms_per_iteration": ms / it, "max_abs_err": err,
        "first_call_s": first_s, "launches": got_l,
        "peak_memory_bytes": int(peak), "profile": prof}
    results["sparse_algorithms"] = out


def components_ref(src, dst, n):
    """scipy's weakly connected components, each labelled by its smallest
    vertex id (connected_components' labels)."""
    import scipy.sparse as sps
    from scipy.sparse.csgraph import connected_components

    G = sps.csr_matrix((np.ones(len(src), np.int8), (src, dst)),
                       shape=(n, n))
    count, lab = connected_components(G, directed=True, connection="weak")
    smallest = np.full(count, n, np.int64)
    np.minimum.at(smallest, lab, np.arange(n, dtype=np.int64))
    return smallest[lab], count


def index_phase(gb, torch, K, src, dst, w, n, results, totals):
    """connected_components (FastSV) on bench.py's RMAT graph (scale 17)
    and on the zipf graph, its labels exactly against scipy; extract,
    assign and delete by index lists on the zipf FP32 matrix and extract
    with repeated indices from an INT64 vector of 2**19, each exactly
    against numpy.  All of it is torch ops on the generic sparse engine and
    the dense one: it fails if any of the seven kernels launches."""
    out = {}

    def no_kernels(what):
        got = check_launches(K, what, totals, need=())
        if any(got.values()):
            fail(f"{what}: a kernel launched where none should: {got}")

    from graphblas_tpu_torch.core.vector import Vector

    for tag, (gs, gd, gn) in (("rmat17", build_rmat(17)),
                              ("zipf", (src, dst, n))):
        t0 = time.perf_counter()
        ref, count = components_ref(gs, gd, gn)
        ref_s = time.perf_counter() - t0
        G = gb.Matrix.from_coo(gs, gd, np.ones(len(gs), bool), dtype="BOOL",
                               nrows=gn, ncols=gn)
        # FastSV's loop ends with one isequal an iteration: count them
        calls = []
        isequal = Vector.isequal

        def counted(self, other, **kw):
            calls.append(1)
            return isequal(self, other, **kw)

        Vector.isequal = counted
        try:
            gb.algorithms.connected_components(G)
        finally:
            Vector.isequal = isequal
        iters = len(calls)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_counts(K)
        f, ms, runs, first_s = timed_calls(
            torch, lambda: gb.algorithms.connected_components(G), reps=3)
        peak = torch.cuda.max_memory_allocated() - before
        no_kernels(f"connected_components {tag}")
        idx, lab = f.to_coo()
        if not (np.array_equal(idx.astype(np.int64), np.arange(gn))
                and np.array_equal(lab, ref)):
            fail(f"connected_components {tag}: labels differ from scipy's "
                 f"({int((lab != ref).sum()) if len(lab) == gn else 'size'}"
                 f" differ)")
        got_count = len(np.unique(lab))
        log(f"  connected_components {tag} (n={gn}, nnz={len(gs)}): "
            f"{got_count} components (scipy {count}, {ref_s:.2f} s), "
            f"{iters} FastSV iterations, ms {runs} (median {ms:.4f}), "
            f"first call {first_s:.2f} s; peak memory {peak / 1e9:.3f} GB")
        prof = profile_breakdown(
            torch, lambda: gb.algorithms.connected_components(G),
            f"connected_components {tag}", ms)
        out[f"connected_components_{tag}"] = {
            "n": gn, "nnz": int(len(gs)), "components": got_count,
            "iterations": iters, "ms": ms, "ms_runs": runs,
            "first_call_s": first_s, "peak_memory_bytes": int(peak),
            "scipy_s": ref_s, "profile": prof}
        del G, f

    # extract and assign on the zipf FP32 matrix
    rng = np.random.default_rng(SEED + 11)
    A = gb.Matrix.from_coo(src, dst, w, dtype="FP32", nrows=n, ncols=n)
    rows = np.sort(rng.choice(n, n // 2, replace=False))
    cols = np.sort(rng.choice(n, n // 2, replace=False))
    hub = int(np.bincount(dst, minlength=n).argmax())
    in_r = np.zeros(n, bool)
    in_r[rows] = True
    in_c = np.zeros(n, bool)
    in_c[cols] = True
    region = in_r[src] & in_c[dst]
    pos_r = np.full(n, -1, np.int64)
    pos_r[rows] = np.arange(len(rows))
    pos_c = np.full(n, -1, np.int64)
    pos_c[cols] = np.arange(len(cols))
    two = gb.binary.times["FP32"]
    B = A[rows, cols].new().apply(two, right=2.0).new()
    M = A.select("tril").new()
    f_np = rng.integers(0, n, n)
    fv = gb.Vector.from_dense(f_np)
    parents = rng.integers(0, n, n)
    v_idx = rng.choice(n, n // 4, replace=False)  # 2**17 at n = 2**19
    v_np = rng.integers(-9, 9, n)
    v_ok = rng.random(n) < 0.5
    v0 = gb.Vector.from_coo(np.flatnonzero(v_ok), v_np[v_ok], dtype="INT64",
                            size=n)

    def assign_accum():
        C = A.dup()
        C(accum=gb.binary.plus)[rows, cols] << B
        return C

    def assign_masked():
        C = A.dup()
        C(M.S, replace=True)[rows, cols] << B
        return C

    def delete():
        C = A.dup()
        del C[rows, cols]
        return C

    def assign_vector():
        v = v0.dup()
        v[v_idx] = 5
        return v

    w2 = (w * np.float32(2)).astype(np.float32)
    tril = src >= dst
    v_ref = v_np.copy()
    v_ref[v_idx] = 5
    v_ref_ok = v_ok.copy()
    v_ref_ok[v_idx] = True
    cases = (
        ("extract A[rows, cols]", lambda: A[rows, cols].new(),
         (pos_r[src[region]], pos_c[dst[region]], w[region])),
        ("extract A[hub, :]", lambda: A[hub, :].new(),
         (dst[src == hub], w[src == hub])),
        ("extract A[:, hub]", lambda: A[:, hub].new(),
         (src[dst == hub], w[dst == hub])),
        ("extract f[parents]", lambda: fv[parents].new(),
         (np.arange(n), f_np[parents])),
        ("assign C(accum=plus)[rows, cols] << B", assign_accum,
         (src, dst, np.where(region, w + w2, w))),
        ("assign C(M.S, replace)[rows, cols] << B", assign_masked,
         (src[tril], dst[tril], np.where(region, w2, w)[tril])),
        ("delete del C[rows, cols]", delete,
         (src[~region], dst[~region], w[~region])),
        ("assign v[idx] = s", assign_vector,
         (np.flatnonzero(v_ref_ok), v_ref[v_ref_ok])),
    )
    for name, fn, want in cases:
        reset_counts(K)
        got, ms, runs, first_s = timed_calls(torch, fn)
        no_kernels(name)
        coo = got.to_coo()
        for k, (g, r) in enumerate(zip(coo, want)):
            if not np.array_equal(g.astype(r.dtype), r):
                fail(f"{name}: part {k} of to_coo differs from numpy's "
                     f"({len(g)} vs {len(r)} entries)")
        if got.ndim == 2 and got._sparse is None:
            fail(f"{name}: the result is not sparse-backed")
        log(f"  {name}: {got.nvals} entries, exact; ms {runs} (median "
            f"{ms:.4f}), first call {first_s:.2f} s")
        prof = profile_breakdown(torch, fn, name, ms)
        out[name] = {"nvals": int(got.nvals), "ms": ms, "ms_runs": runs,
                     "first_call_s": first_s, "profile": prof}
    out["shapes"] = {"n": n, "nnz": int(len(src)), "rows": len(rows),
                     "cols": len(cols), "region_nnz": int(region.sum()),
                     "hub": hub, "hub_in_degree": int((dst == hub).sum()),
                     "vector_assign_indices": int(len(v_idx))}
    results["index"] = out


def bfs_parent_ref(src, dst, n):
    """BFS parents from node 0: each reached node's smallest in-neighbour
    on the level before it (bfs_ref's levels); node 0 is its own."""
    lev, depth = bfs_ref(src, dst, n)
    e = (lev[src] > 0) & (lev[dst] == lev[src] + 1)
    parent = np.full(n, n, np.int64)
    np.minimum.at(parent, dst[e], src[e])
    parent[0] = 0
    reached = np.flatnonzero(lev > 0)
    return reached, parent[reached], depth


def hypersparse_graph():
    """hypersparse_phase's digraph: n = 2**22, 2**21 uniform edges."""
    n, m = 1 << 22, 1 << 21
    rng = np.random.default_rng(SEED + 2)
    lin = np.unique(rng.integers(0, n, int(m * 1.01)) * n
                    + rng.integers(0, n, int(m * 1.01)))
    lin = np.sort(rng.choice(lin, m, replace=False))
    return lin // n, lin % n, n


def two_hop_ref(r, c, n):
    """(rows, cols) of A @ A's structure, sorted, by a numpy expansion."""
    indptr = np.searchsorted(r, np.arange(n + 1))
    deg = np.diff(indptr)
    cnt = deg[c]
    e = np.repeat(np.arange(len(r)), cnt)
    t = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    j = c[indptr[c[e]] + t]
    lin = np.unique(r[e] * n + j)
    return lin // n, lin % n


def shifted(a, ro, co):
    """a moved by ro rows and co columns, what falls outside dropped."""
    out = np.zeros_like(a)
    (h, w) = a.shape
    rows = (max(ro, 0), min(h, h + ro))
    cols = (max(co, 0), min(w, w + co))
    if rows[1] > rows[0] and cols[1] > cols[0]:
        out[rows[0]:rows[1], cols[0]:cols[1]] = \
            a[rows[0] - ro:rows[1] - ro, cols[0] - co:cols[1] - co]
    return out


def positional_agg_phase(gb, torch, K, src, dst, n, results, totals):
    """Positional operators, aggregators, kronecker and reposition at full
    size: bfs_parent on the zipf graph and on bench.py's RMAT graph (scale
    17), exact against numpy's BFS parents; the triangle witness
    C(L.S) << L min_secondi L.T by the masked dot, its structure against
    plus_pair's and 10,000 values against numpy's intersections; a
    Gustavson min_firsti A @ A on the hypersparse graph against a numpy
    expansion; positional apply on the zipf matrix; eleven aggregators
    rowwise and columnwise and three reduce_scalar on a dense-backed
    8192 x 8192 FP32 matrix against numpy in float64 (counts and indices
    exactly, the rest within rel 1e-5); kronecker to 8192 x 8192 against
    np.kron; reposition of a matrix and a vector against numpy slicing.
    All of it is torch ops: it fails if any of the seven kernels launches.
    Each call's time is the median of 3 runs (5 under 10 ms), with its
    device idle share and its peak memory."""
    from graphblas_tpu_torch.core import execute as ex

    out = {}

    def run(name, fn, check, ranges=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_counts(K)
        got, ms, runs, first_s = timed_calls(torch, fn, reps=3)
        if ms < 10:
            runs += timed_calls(torch, fn, reps=2)[2]
            ms = float(np.median(runs))
        peak = torch.cuda.max_memory_allocated() - before
        launched = check_launches(K, name, totals, need=())
        if any(launched.values()):
            fail(f"{name}: a kernel launched where none should: {launched}")
        info = check(got) or {}
        prof = profile_breakdown(torch, fn, name, ms, ranges=ranges)
        if prof["device_busy_ms"] == 0:  # a profile that saw no device
            log(f"  {name}: the profile saw no device time; once more")
            prof = profile_breakdown(torch, fn, name, ms, ranges=ranges)
        log(f"  {name}: ms {runs} (median {ms:.4f}), first call "
            f"{first_s:.2f} s, peak memory {peak / 1e9:.3f} GB {info}")
        out[name] = {"ms": ms, "ms_runs": runs, "first_call_s": first_s,
                     "peak_memory_bytes": int(peak), "profile": prof, **info}
        return got, prof

    def check_coo(name, got, want):
        for k, (g, w) in enumerate(zip(got.to_coo(), want)):
            if not np.array_equal(g.astype(np.asarray(w).dtype), w):
                fail(f"{name}: part {k} of to_coo differs from numpy's "
                     f"({len(g)} vs {len(w)} entries)")

    # 1. bfs_parent
    rs, rd, rn = build_rmat(17)
    for tag, (gs, gd, gn) in (("zipf", (src, dst, n)), ("rmat17",
                                                       (rs, rd, rn))):
        reached, par, depth = bfs_parent_ref(gs, gd, gn)
        G = gb.Matrix.from_coo(gs, gd, np.ones(len(gs), np.float32),
                               dtype="FP32", nrows=gn, ncols=gn)

        def check_parent(p, reached=reached, par=par, depth=depth, tag=tag):
            check_coo(f"bfs_parent {tag}", p, (reached, par))
            return {"levels": int(depth), "reached": int(len(reached)),
                    "nnz": int(len(gs))}

        run(f"bfs_parent {tag}", lambda G=G: gb.algorithms.bfs_parent(G, 0),
            check_parent)
        del G

    # 2. the triangle witness on RMAT 17
    G = gb.Matrix.from_coo(rs, rd, np.ones(len(rs), bool), dtype="BOOL",
                           nrows=rn, ncols=rn)
    S = G.apply(gb.unary.one).new(dtype="INT64")
    S(accum=gb.binary.max) << G.T.new(dtype="INT64").apply(gb.unary.one)
    L = S.select(gb.select.tril, -1).new(name="L")
    del G, S
    lin = np.unique(np.concatenate([rs * rn + rd, rd * rn + rs]))
    lr, lc = lin // rn, lin % rn
    low = lr > lc
    lr, lc = lr[low], lc[low]
    l_ptr = np.searchsorted(lr, np.arange(rn + 1))

    def witness():
        C = gb.Matrix("INT64", rn, rn)
        C(L.S) << L.mxm(L.T, gb.semiring.ss.min_secondi)
        return C

    P = gb.Matrix("INT64", rn, rn)
    P(L.S) << L.mxm(L.T, gb.semiring.plus_pair)
    pr_, pc_, _ = P.to_coo()
    del P

    def check_witness(C):
        cr, cc, cv = C.to_coo()
        if not (np.array_equal(cr, pr_) and np.array_equal(cc, pc_)):
            fail(f"triangle witness: structure differs from plus_pair's "
                 f"({len(cr)} vs {len(pr_)} entries)")
        pick = np.random.default_rng(12).choice(len(cr), min(10000, len(cr)),
                                                replace=False)
        for p in pick:
            i, j = int(cr[p]), int(cc[p])
            common = np.intersect1d(lc[l_ptr[i]:l_ptr[i + 1]],
                                    lc[l_ptr[j]:l_ptr[j + 1]],
                                    assume_unique=True)
            if not len(common) or int(cv[p]) != int(common[0]):
                fail(f"triangle witness: C[{i}, {j}] = {cv[p]}, numpy "
                     f"{common[:1]}")
        return {"entries": int(len(cr)), "checked": int(len(pick))}

    _, prof = run("triangle witness min_secondi", witness, check_witness,
                  ranges=ex.spgemm_record)
    if len(prof["ranges"]) != 1:
        fail(f"triangle witness: {len(prof['ranges'])} SpGEMM ranges, not 1")
    rec = prof["ranges"][0]
    log(f"  triangle witness's mxm: {rec['formulation']} with "
        f"{rec['terms']} terms (Gustavson {rec['gustavson_terms']}, dot "
        f"{rec['dot_terms']})")
    out["triangle witness min_secondi"]["spgemm"] = rec
    del L

    # 3. Gustavson SpGEMM with a positional multiply
    hr, hc, hn = hypersparse_graph()
    H = gb.Matrix.from_coo(hr, hc, np.ones(len(hr), np.float32),
                           dtype="FP32", nrows=hn, ncols=hn)
    tr, tc = two_hop_ref(hr, hc, hn)
    run("hypersparse A @ A min_firsti",
        lambda: H.mxm(H, gb.semiring.ss.min_firsti).new(),
        lambda C: check_coo("hypersparse min_firsti", C, (tr, tc, tr))
        or {"entries": int(len(tr))}, ranges=ex.spgemm_record)
    del H

    # 4. positional apply on the zipf matrix
    Z = gb.Matrix.from_coo(src, dst, np.ones(len(src), np.float32),
                           dtype="FP32", nrows=n, ncols=n)
    run("apply binary.ss.firstj, right=0",
        lambda: Z.apply(gb.binary.ss.firstj, right=0).new(),
        lambda C: check_coo("apply firstj", C, (src, dst, dst)))
    run("apply unary.ss.positioni",
        lambda: Z.apply(gb.unary.ss.positioni).new(),
        lambda C: check_coo("apply positioni", C, (src, dst, src)))
    del Z

    # 5. aggregators on a dense-backed 8192 x 8192 FP32 matrix
    rng = np.random.default_rng(12)
    d = (rng.random((APSP_N, APSP_N), dtype=np.float32)
         + np.float32(0.05))
    keep = d.astype(np.float64) > 0.55  # the thunk's FP64 compares
    D = gb.Matrix.from_dense(d).select("valuegt", 0.55).new()
    if D._sparse is not None:
        fail("aggregators: the matrix is not dense-backed")
    d64 = np.where(keep, d.astype(np.float64), np.nan)
    cnt = keep.sum(axis=None)

    def stats(axis):
        c = keep.sum(axis=axis)
        s = np.nansum(d64, axis=axis)
        mean = s / c
        var = np.nanvar(d64, axis=axis)
        big = np.where(keep, d, np.inf)
        small = np.where(keep, d, -np.inf)
        idx = np.arange(APSP_N)
        first = np.argmax(keep, axis=axis)
        last = APSP_N - 1 - np.argmax(np.flip(keep, axis=axis), axis=axis)
        take = (lambda k: d[idx, k]) if axis == 1 else (lambda k: d[k, idx])
        return {
            "count": (c, None), "sum": (s, 1e-5), "mean": (mean, 1e-5),
            "varp": (var, 1e-5),
            "stds": (np.sqrt(var * c / np.maximum(c - 1, 1)), 1e-5),
            "L2norm": (np.sqrt(np.nansum(d64 * d64, axis=axis)), 1e-5),
            "peak_to_peak": (np.nanmax(d64, axis=axis)
                             - np.nanmin(d64, axis=axis), 1e-5),
            "argmin": (np.argmin(big, axis=axis), None),
            "argmax": (np.argmax(small, axis=axis), None),
            "first": (take(first), None), "last": (take(last), None)}

    def check_values(name, got, want, rel):
        got = np.asarray(got)
        if rel is None:
            if not np.array_equal(got.astype(np.asarray(want).dtype), want):
                fail(f"{name}: differs from numpy")
            return 0.0
        err = np.abs(got.astype(np.float64) - want)
        if not (err <= rel * np.abs(want)).all():
            fail(f"{name}: beyond rel {rel} of numpy (max abs err "
                 f"{float(err.max())})")
        return float(err.max())

    for axis, method in ((1, "reduce_rowwise"), (0, "reduce_columnwise")):
        ref = stats(axis)
        for name, (want, rel) in ref.items():
            agg = getattr(gb.agg.ss if name in ("argmin", "argmax", "first",
                                                "last") else gb.agg, name)

            def check_agg(v, want=want, rel=rel, name=name, method=method):
                idx, vals = v.to_coo()
                if len(idx) != APSP_N:
                    fail(f"{method} {name}: {len(idx)} entries")
                return {"max_abs_err": check_values(f"{method} {name}",
                                                    vals, want, rel)}

            run(f"{method} agg.{name}",
                lambda agg=agg, method=method: getattr(D, method)(agg).new(),
                check_agg)
    var_all = np.nanvar(d64)
    for name, want, rel in (("count", cnt, None),
                            ("mean", np.nansum(d64) / cnt, 1e-5),
                            ("stdp", np.sqrt(var_all), 1e-5)):
        run(f"reduce_scalar agg.{name}",
            lambda name=name: D.reduce_scalar(getattr(gb.agg, name)).new(),
            lambda s, name=name, want=want, rel=rel: {
                "max_abs_err": check_values(f"reduce_scalar {name}",
                                            s.value, want, rel)})

    # 6. kronecker to 8192 x 8192
    ka = rng.random((64, 128), dtype=np.float32)
    kb = rng.random((128, 64), dtype=np.float32)
    ka_ok = rng.random(ka.shape) < 0.5
    kb_ok = rng.random(kb.shape) < 0.5
    KA = gb.Matrix.from_coo(*np.nonzero(ka_ok), ka[ka_ok], dtype="FP32",
                            nrows=64, ncols=128)
    KB = gb.Matrix.from_coo(*np.nonzero(kb_ok), kb[kb_ok], dtype="FP32",
                            nrows=128, ncols=64)
    k_ok = np.kron(ka_ok.astype(np.int8), kb_ok.astype(np.int8)) > 0
    k_vals = np.kron(ka, kb)
    kr, kc = np.nonzero(k_ok)
    run("kronecker 64x128 (x) 128x64 times",
        lambda: KA.kronecker(KB, gb.binary.times).new(),
        lambda C: check_coo("kronecker", C, (kr, kc, k_vals[kr, kc]))
        or {"entries": int(len(kr))})
    del k_ok, k_vals, kr, kc

    # 7. reposition
    sh, sv = shifted(keep, 1000, -3000), shifted(d, 1000, -3000)
    rr, rc = np.nonzero(sh)
    run("reposition matrix (+1000, -3000)",
        lambda: D.reposition(1000, -3000).new(),
        lambda C: check_coo("reposition matrix", C, (rr, rc, sv[rr, rc]))
        or {"entries": int(len(rr))})
    nv = 1 << 19
    vi = np.flatnonzero(rng.random(nv) < 0.5)
    vv = rng.integers(-99, 99, len(vi))
    V = gb.Vector.from_coo(vi, vv, dtype="INT64", size=nv)
    keep_v = vi >= 7
    run("reposition vector -7", lambda: V.reposition(-7).new(),
        lambda v: check_coo("reposition vector", v,
                            (vi[keep_v] - 7, vv[keep_v])))
    out["shapes"] = {"aggregate_matrix": [APSP_N, APSP_N],
                     "aggregate_nvals": int(cnt), "vector_size": nv}
    results["positional_agg"] = out


# --------------------------------------------------------------------- #
# the operators slice: every builtin multiply in K1, the new combines in
# K4-K6, and the new types end to end
K1_TNAMES = ("FP32", "INT32", "UINT32", "BOOL", "INT8", "INT16", "UINT8",
             "UINT16")
# (op, matrix type, vector type, op's lookup type, monoid or None): each
# operand in its own type; the last casts FP32 products to BOOL for lor
K1_MIXED = (("times", "BOOL", "FP32", "FP32", None),
            ("times", "BOOL", "INT32", "INT32", None),
            ("plus", "FP32", "INT32", "FP32", None),
            ("lt", "INT8", "FP32", "FP32", None),
            ("times", "UINT16", "INT32", "INT32", None),
            ("plus", "FP32", "INT8", "INT8", None),
            ("bxor", "INT32", "UINT8", "UINT8", None),
            ("pow", "UINT8", "INT16", "INT16", None),
            ("land", "FP32", "BOOL", "BOOL", None),
            ("eq", "UINT32", "INT32", "INT32", None),
            ("minus", "INT16", "UINT16", "UINT16", None),
            ("max", "UINT32", "FP32", "FP32", None),
            ("bshift", "INT8", "INT32", "INT8", None),
            ("cdiv", "FP32", "UINT8", "UINT8", None),
            ("rminus", "BOOL", "INT16", "INT16", None),
            ("plus", "FP32", "FP32", "FP32", "lor"))


def typed_words(torch, rng, shape, tname, dev):
    """Carrier words of a type with the values that tell multiplies apart:
    FP32 zeros of both signs, NaN, infinities, a subnormal, values past
    the integer types' ranges; integers over the type's full range (so
    products and sums wrap) and small ones (so divisions and shifts
    matter)."""
    if tname == "FP32":
        pool = np.float32([0, -0.0, 1.5, -2, np.nan, np.inf, -np.inf, 3e-39,
                           1e30, 7, 300.7, -40000.5, 3e9])
        x = np.where(rng.random(shape) < 0.5, rng.choice(pool, shape),
                     (4 * rng.standard_normal(shape)).astype(np.float32))
        return torch.from_numpy(x.astype(np.float32)).to(dev)
    if tname == "BOOL":
        return torch.from_numpy(rng.integers(0, 2, shape, dtype=np.int32)).to(dev)
    info = np.iinfo(np.dtype(tname.lower()))
    x = rng.integers(int(info.min), int(info.max) + 1, shape, dtype=np.int64)
    small = rng.random(shape) < 0.4
    x[small] = rng.integers(-3 if info.min < 0 else 0, 9, int(small.sum()))
    return torch.from_numpy(x.astype(np.dtype(tname.lower())).astype(np.int64)
                            .astype(np.int32)).to(dev)


def k1_grid(gb, torch, dev, rng):
    """K1 over every builtin multiply and every type of at most 32 bits it
    takes, and over the mixed operand pairs of K1_MIXED, at a small plan
    (three windows, the last ending at the end of u): vxm and mxv, a
    sparse u (the okp output) through the route's stage A, the BOOL
    monoids packed and not; every output bitwise against
    gather_mult_plain, one launch a call.  Returns the number of cases."""
    from graphblas_tpu_torch.core import dtypes as dts
    from graphblas_tpu_torch.core.engine import kernels as K
    from graphblas_tpu_torch.core.engine import lanepipe as lp

    nk = 3 * lp.WINDOW_K
    lin = np.unique(rng.integers(0, nk * nk, 2 * nk))
    M = gb.Matrix.from_coo(lin // nk, lin % nk, np.ones(len(lin), np.float32),
                           dtype="FP32", nrows=nk, ncols=nk)
    plans = {kind: lp.get_plan(M._sparse, kind == "mxv", device=dev)
             for kind in ("vxm", "mxv")}
    if None in plans.values():
        fail("K1 grid: the small plan exceeds PACK_LIMIT")

    def case(tag, mult, a_t, u_t, mono):
        a_dt, u_dt = (dts.lookup_dtype(t) for t in (a_t, u_t))
        for kind, e in plans.items():
            x_dt, y_dt = (a_dt, u_dt) if kind == "mxv" else (u_dt, a_dt)
            if K.k1_code(mult, x_dt, y_dt, mono.type) is None:
                fail(f"K1 grid {tag}: the kernel does not take it")
            d = e["dev"]
            R_g, nb = e["R_g"], e["nblocks_g"]
            plan_g = (d["meta"], d["idx1_g"], d["locidx_g"], d["okg"],
                      typed_words(torch, rng, (R_g, 128), a_t, dev))
            u2 = typed_words(torch, rng, (nk // 128, 128), u_t, dev)
            u2ok = torch.from_numpy(rng.integers(0, 2, u2.shape, dtype=np.int32)).to(dev)
            for packed in ((False, True) if mono.type is dts.BOOL else (False,)):
                kw = dict(kind=kind, R_g=R_g, nblocks=nb, packed=packed,
                          permA=d["routeP"][0])
                args = (plan_g, u2, u2ok, mult, a_dt, u_dt, mono)
                before = K.launches["gather_mult"]
                got = lp.gather_mult(*args, **kw)
                if K.launches["gather_mult"] - before != 1:
                    fail(f"K1 grid {tag}: not one launch a call")
                want = lp.gather_mult_plain(*args, **kw)
                compare(f"K1 grid {tag} {kind} packed={packed}", got[0],
                        want[0], quiet=True)
                if want[1] is not None:
                    compare(f"K1 grid {tag} {kind} okp", got[1], want[1],
                            quiet=True)

    def monoid_for(ret, name=None):
        if name is not None:
            return getattr(gb.monoid, name)[ret]
        return (gb.monoid.lor if ret is dts.BOOL else gb.monoid.min)[ret]

    cases = skipped = 0
    for op in K.K1_OP:
        for t in K1_TNAMES:
            try:
                mult = getattr(gb.binary, op)[t]
            except KeyError:
                continue
            mono = monoid_for(mult.return_type)
            if K.k1_code(mult, mult.type, mult.type, mono.type) is None:
                skipped += 1  # a return type of 64 bits (truediv on INT8)
                continue
            case(f"{op}[{t}]", mult, t, t, mono)
            cases += 1
    for op, a_t, u_t, t, mname in K1_MIXED:
        mult = getattr(gb.binary, op)[t]
        case(f"{op}[{t}] over {a_t} x {u_t}", mult, a_t, u_t,
             monoid_for(mult.return_type, mname))
        cases += 1
    log(f"  K1 grid: {cases} (op, type) and mixed cases bitwise equal to the "
        f"plain version, vxm and mxv, one launch a call ({skipped} pairs with "
        f"a 64-bit product left to the generic engine)")
    return cases


def k1_new_variants(gb, torch, e, eb, rng, variants):
    """K1 on the zipf plan at the slice's variants, beside PageRank's:
    BOOL x FP32 plus_times (PageRank over a BOOL adjacency), min_plus on
    INT8 (products wrapped before the min) and lor_lt on FP32 (a BOOL
    product, packed); each with a full u through the route's stage A,
    bitwise against the plain version, timed warm and after an L2 flush."""
    from graphblas_tpu_torch.core import dtypes as dts
    from graphblas_tpu_torch.core.engine import lanepipe as lp

    d, db = e["dev"], eb["dev"]
    dev = d["meta"].device
    n, R_g, nb = e["n_in"], e["R_g"], e["nblocks_g"]
    plan_g = (d["meta"], d["idx1_g"], d["locidx_g"], d["okg"])
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    uf = torch.from_numpy(rng.random(n, dtype=np.float32)).to(dev)
    ui8 = torch.from_numpy(rng.integers(-128, 128, n).astype(np.int8)).to(dev)
    ai8 = torch.from_numpy(rng.integers(-128, 128, (R_g, 128)).astype(np.int32)).to(dev)
    S, W = 4 * R_g * 128, 4 * nb * 128 * 128
    U = 4 * lp.pad_u(uf, ones, dts.FP32, n)[0].numel()
    nbytes = 5 * S + W + U + 12 * nb
    cases = (("mixed BOOL x FP32 plus_times", gb.semiring.plus_times["FP32"],
              db["avals_g"], dts.BOOL, uf, dts.FP32, False),
             ("narrow min_plus[INT8]", gb.semiring.min_plus["INT8"], ai8,
              dts.INT8, ui8, dts.INT8, False),
             ("comparison lor_lt[FP32]", gb.semiring.lor_lt["FP32"],
              d["avals_g"], dts.FP32, uf, dts.FP32, True))
    for vname, ring, avals, a_dt, u, u_dt, packed in cases:
        u2, u2ok = lp.pad_u(u, ones, u_dt, n)
        args = (plan_g + (avals,), u2, u2ok, ring.binaryop, a_dt, u_dt,
                ring.monoid)
        kw = dict(kind="vxm", R_g=R_g, nblocks=nb, packed=packed, full_u=True,
                  permA=d["routeP"][0])
        k1 = lambda: lp.gather_mult(*args, **kw)  # noqa: E731
        p1 = lambda: lp.gather_mult_plain(*args, **kw)  # noqa: E731
        compare(f"K1 gather_mult zipf {vname}", k1()[0], p1()[0])
        ms, cold, pms = (cuda_ms(torch, k1), cuda_ms(torch, k1, cold=True),
                         cuda_ms(torch, p1))
        b_ms, _ = bound(nbytes)
        variants[f"gather_mult zipf {vname}"] = {
            "ms": ms, "cold_ms": cold, "plain_ms": pms, "bound_ms": b_ms,
            "bytes": nbytes}
        log(f"  gather_mult zipf {vname}: kernel {ms:.4f} ms, after an L2 "
            f"flush {cold:.4f} ms, plain {pms:.4f} ms, bound {b_ms:.4f} ms "
            f"({nbytes / 1e6:.1f} MB)")


def new_combine_checks(gb, torch, dev, rng, e, eb, variants):
    """Each kernel with a combine of this slice at the main path's shapes:
    K4 with packed BOOL lxor on the BOOL plan, K5 with UINT32 bxor and
    validity on the zipf plan's S layout, K6 with UINT32 bxor and a count
    on a flat array of the zipf plan's length; bitwise against the plain
    version, 200 launches each equal to the first, timed beside the plain
    version."""
    from graphblas_tpu_torch.core import dtypes as dts
    from graphblas_tpu_torch.core.engine import lanepipe as lp
    from graphblas_tpu_torch.core.engine import sortpipe as sp

    def check(tag, kfn, pfn, nbytes):
        for g, w_ in zip(kfn(), pfn()):
            compare(tag, g, w_)
        first = [t.view(torch.int32).clone() for t in kfn()]
        for r in range(200):
            if not all(bool(torch.equal(g.view(torch.int32), f))
                       for g, f in zip(kfn(), first)):
                fail(f"{tag} race check: launch {r + 1} of 200 differs from "
                     f"the first")
        ms, pms = cuda_ms(torch, kfn), cuda_ms(torch, pfn)
        b_ms, _ = bound(nbytes)
        variants[tag] = {"ms": ms, "plain_ms": pms, "bound_ms": b_ms,
                         "bytes": nbytes}
        log(f"  {tag}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({nbytes / 1e6:.1f} MB); 200 launches bitwise "
            f"equal")

    db = eb["dev"]
    shb = tuple(db["barrier"].shape)
    codes = torch.from_numpy(rng.integers(0, 3, shb).astype(np.int32)).to(dev)
    lx = lp.combines(gb.monoid.lxor["BOOL"])[1]
    k4 = (db["routeP"][2], db["barrier"], db["extP"][0], codes, lx)
    check("fused_permC_scan_permA BOOL packed lxor",
          lambda: [lp.fused_permC_scan_permA(*k4)],
          lambda: [lp.fused_permC_scan_permA_plain(*k4)], 4 * 5 * codes.numel())
    d = e["dev"]
    shape = tuple(d["barrier"].shape)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                             .astype(np.int32)).to(dev)
    ok = torch.from_numpy(rng.random(shape) < 0.5).to(dev).to(torch.int32)
    bx = lp.combines(gb.monoid.bxor[dts.UINT32])[0]
    check("lane_segscan UINT32 bxor + validity",
          lambda: lp.lane_segscan(d["barrier"], words, ok, bx),
          lambda: lp.lane_segscan_plain(d["barrier"], words, ok, bx),
          4 * 5 * words.numel())
    L = e["L"] // sp.SEG_BLOCK * sp.SEG_BLOCK
    bar = torch.from_numpy((rng.random(L) < 1 / 50).astype(np.int32)).to(dev)
    chans = [torch.from_numpy(rng.integers(-2**31, 2**31, L, dtype=np.int64)
                              .astype(np.int32)).to(dev),
             torch.from_numpy(rng.integers(0, 2, L).astype(np.int32)).to(dev)]
    pair = [sp.monoid_combine(gb.monoid.bxor[dts.UINT32]), sp.COUNT]
    check("segscan UINT32 bxor, count", lambda: sp.segscan(bar, chans, pair),
          lambda: sp.segscan_channels_plain(bar, chans, pair), 4 * 5 * L)


def _ref_spmv(order, k, d, u_vals, u_valid, a_vals, mult, fold):
    """numpy vxm/mxv over the edges (k contracts, d receives), edges
    pre-sorted by d (order): (indices, values) of the result."""
    ok = u_valid[k[order]]
    kk, dd = k[order][ok], d[order][ok]
    p = mult(u_vals[kk], a_vals[order][ok])
    if len(dd) == 0:
        return dd, p
    starts = np.flatnonzero(np.r_[True, dd[1:] != dd[:-1]])
    return dd[starts].astype(np.int64), fold(p, starts)


def _xnor_fold(p, starts):
    """The eq (lxnor) monoid over runs of BOOL: the xor of each run, with
    one flip for every pair in it."""
    cnt = np.diff(np.r_[starts, len(p)])
    return np.logical_xor.reduceat(p, starts) ^ ((cnt - 1) % 2 == 1)


def operators_phase(gb, torch, K, src, dst, n, results, totals):
    """The operators slice at full width, on bench.py's zipf graph (n =
    2**19, 3,750,401 entries) with values of each type: vxm and mxv
    through the lanepipe with mixed operand types (BOOL x FP32 and BOOL x
    INT32 plus_times, INT32 x FP32 min_plus), narrow types (INT8
    plus_times and min_plus, UINT16 max_minus), a comparison (lor_lt over
    FP32) and the new monoids (lxor_land and eq_eq over BOOL, bxor_band
    over UINT16), each with a full u, and with a sparse u for the new
    monoids (K5 for bxor; the BOOL monoids take the packed route); row
    and column reduces through K6 (lxor over BOOL, bxor over UINT16, max
    over INT8); from_coo with duplicates under lor, minus and bxor; and
    two generic-engine products (UINT64 plus_times, INT16 plus_floordiv),
    where no kernel may launch.  Every result exactly against numpy with
    typed wrapping arithmetic (FP32 sums within rel 1e-5)."""
    rng = np.random.default_rng(SEED + 13)
    nnz = len(src)
    out = {}
    by_dst = np.argsort(dst, kind="stable")
    by_src = np.argsort(src, kind="stable")
    ev = {"BOOL": rng.random(nnz) < 0.6,
          "FP32": rng.choice(np.float32([0, 0.25, 0.5, 1, 2, 3, -1.5]), nnz),
          "INT32": rng.integers(-1000, 1000, nnz).astype(np.int32),
          "INT8": rng.integers(-128, 128, nnz).astype(np.int8),
          "UINT16": rng.integers(0, 1 << 16, nnz).astype(np.uint16)}
    uv = {"BOOL": rng.random(n) < 0.5,
          "FP32": rng.choice(np.float32([0, 0.5, 1, 2, -3, 7.5]), n),
          "INT32": rng.integers(-1000, 1000, n).astype(np.int32),
          "INT8": rng.integers(-128, 128, n).astype(np.int8),
          "UINT16": rng.integers(0, 1 << 16, n).astype(np.uint16)}
    full = np.ones(n, bool)
    sparse = rng.random(n) < 0.1
    mats, vecs = {}, {}
    for t, v in ev.items():
        mats[t] = gb.Matrix.from_coo(src, dst, v, dtype=t, nrows=n, ncols=n)
    for t, v in uv.items():
        vecs[t, True] = gb.Vector.from_coo(np.arange(n), v, dtype=t, size=n)
        idx = np.flatnonzero(sparse)
        vecs[t, False] = gb.Vector.from_coo(idx, v[idx], dtype=t, size=n)

    def run(tag, fn, check, need, profile=False):
        reset_counts(K)
        res, ms, runs, first_s = timed_calls(torch, fn, reps=3)
        torch.cuda.synchronize()
        got = check_launches(K, tag, totals, need=need)
        if not need and any(got.values()):
            fail(f"{tag}: a kernel launched on the generic engine's route")
        err = check(res)
        out[tag] = {"ms": ms, "runs_ms": runs, "first_s": first_s,
                    "launches": got, "max_abs_err": err}
        if profile:
            out[tag]["profile"] = profile_breakdown(torch, fn, tag, ms)
        log(f"  {tag}: {ms:.4f} ms (median of 3), first call {first_s:.2f} s, "
            f"max abs err {err:.3g}")

    with np.errstate(over="ignore"):
        f32 = np.float32
        spmv_cases = (
            ("plus_times BOOL x FP32", "BOOL", "FP32", "plus_times", "FP32",
             lambda x, a: x * a.astype(f32), np.add.reduceat, 1e-5),
            ("plus_times BOOL x INT32", "BOOL", "INT32", "plus_times", "INT32",
             lambda x, a: x * a.astype(np.int32),
             lambda p, s: np.add.reduceat(p.astype(np.int64), s).astype(np.int32),
             None),
            ("min_plus[FP32] FP32 x INT32", "FP32", "INT32", "min_plus", "FP32",
             lambda x, a: x.astype(f32) + a, np.minimum.reduceat, None),
            ("plus_times[INT8]", "INT8", "INT8", "plus_times", "INT8",
             lambda x, a: x * a,
             lambda p, s: np.add.reduceat(p.astype(np.int64), s).astype(np.int8),
             None),
            ("min_plus[INT8]", "INT8", "INT8", "min_plus", "INT8",
             lambda x, a: x + a, np.minimum.reduceat, None),
            ("max_minus[UINT16]", "UINT16", "UINT16", "max_minus", "UINT16",
             lambda x, a: x - a, np.maximum.reduceat, None),
            ("lor_lt[FP32]", "FP32", "FP32", "lor_lt", "FP32",
             lambda x, a: x < a, np.logical_or.reduceat, None),
            ("lxor_land[BOOL]", "BOOL", "BOOL", "lxor_land", "BOOL",
             lambda x, a: x & a, np.logical_xor.reduceat, None),
            ("bxor_band[UINT16]", "UINT16", "UINT16", "bxor_band", "UINT16",
             lambda x, a: x & a, np.bitwise_xor.reduceat, None),
            ("eq_eq[BOOL]", "BOOL", "BOOL", "eq_eq", "BOOL",
             lambda x, a: x == a, _xnor_fold, None))
        for tag, at, ut, rname, rt, mult, fold, rel in spmv_cases:
            ring = getattr(gb.semiring, rname)[rt]
            A = mats[at]
            for kind in ("vxm", "mxv"):
                k, d, order = (src, dst, by_dst) if kind == "vxm" else \
                    (dst, src, by_src)
                fulls = (True, False) if rname in ("lxor_land", "bxor_band",
                                                   "eq_eq") else (True,)
                for is_full in fulls:
                    u = vecs[ut, is_full]
                    if kind == "vxm":  # mult(u(i), A(i, j))
                        mul = mult
                        fn = lambda u=u, A=A, ring=ring: u.vxm(A, ring).new()  # noqa: E731
                    else:  # mult(A(i, j), u(j)): the two that do not commute
                        mul = {"max_minus": lambda x, a: a - x,
                               "lor_lt": lambda x, a: a < x}.get(rname, mult)
                        fn = lambda u=u, A=A, ring=ring: A.mxv(u, ring).new()  # noqa: E731
                    want = _ref_spmv(order, k, d, uv[ut],
                                     full if is_full else sparse, ev[at], mul,
                                     fold)
                    need = ["gather_mult"] + (
                        ["fused_permC_scan_permA"] if is_full
                        or ring.monoid.type.is_bool else ["lane_segscan"])
                    label = f"{kind} {tag}" + ("" if is_full else " sparse u")
                    run(label, fn, lambda v, label=label, want=want, rel=rel:
                        check_vector(label, v, *want, rel=rel), need,
                        profile=label == "vxm plus_times BOOL x FP32")

        # row and column reduces through K6
        for tag, t, mname, fold in (("lxor", "BOOL", "lxor",
                                     np.logical_xor.reduceat),
                                    ("bxor", "UINT16", "bxor",
                                     np.bitwise_xor.reduceat),
                                    ("max", "INT8", "max", np.maximum.reduceat)):
            A, mono = mats[t], getattr(gb.monoid, mname)[t]
            for axis, d, order in (("rowwise", src, by_src),
                                   ("columnwise", dst, by_dst)):
                dd = d[order]
                starts = np.flatnonzero(np.r_[True, dd[1:] != dd[:-1]])
                want = (dd[starts].astype(np.int64), fold(ev[t][order], starts))
                label = f"reduce_{axis} {tag}[{t}]"
                run(label, lambda A=A, axis=axis, mono=mono:
                    getattr(A, f"reduce_{axis}")(mono).new(),
                    lambda v, label=label, want=want: check_vector(label, v, *want),
                    ["segscan"])

        # from_coo with duplicates: a tenth of the entries twice more
        dup = rng.choice(nnz, nnz // 10, replace=False)
        rr = np.r_[src, src[dup], src[dup]]
        cc = np.r_[dst, dst[dup], dst[dup]]
        for tag, t, op, vals, fold in (
                ("lor", "BOOL", gb.binary.lor, rng.random(len(rr)) < 0.3,
                 np.logical_or.reduceat),
                ("minus", "INT32", gb.binary.minus,
                 rng.integers(-2**31, 2**31, len(rr)).astype(np.int32),
                 lambda v, s: (v[s].astype(np.int64) - np.add.reduceat(
                     v.astype(np.int64), s) + v[s]).astype(np.int32)),
                ("bxor", "UINT16", gb.binary.bxor,
                 rng.integers(0, 1 << 16, len(rr)).astype(np.uint16),
                 np.bitwise_xor.reduceat)):
            lin = rr * n + cc
            order = np.argsort(lin, kind="stable")
            ls = lin[order]
            starts = np.flatnonzero(np.r_[True, ls[1:] != ls[:-1]])
            want_v = fold(vals[order], starts)
            want_r, want_c = rr[order][starts], cc[order][starts]

            def check_dup(M, tag=tag, want=(want_r, want_c, want_v)):
                r, c, v = M.to_coo()
                if not (np.array_equal(r, want[0]) and np.array_equal(c, want[1])
                        and np.array_equal(v, want[2])):
                    fail(f"from_coo dup_op={tag}: differs from numpy")
                return 0.0

            run(f"from_coo dup_op={tag}[{t}]",
                lambda t=t, op=op, vals=vals: gb.Matrix.from_coo(
                    rr, cc, vals, dtype=t, nrows=n, ncols=n, dup_op=op),
                check_dup, [])

        # the generic sparse engine: a 64-bit type (values of 2**63 and
        # above), and a multiply K1 does not compute (the JAX package's
        # Python binary floordiv)
        v64 = rng.integers(0, 2**64, nnz, dtype=np.uint64)
        u64 = rng.integers(0, 2**64, n, dtype=np.uint64)
        A64 = gb.Matrix.from_coo(src, dst, v64, dtype="UINT64", nrows=n, ncols=n)
        x64 = gb.Vector.from_coo(np.arange(n), u64, dtype="UINT64", size=n)
        want = _ref_spmv(by_src, dst, src, u64, full, v64, lambda x, a: a * x,
                         np.add.reduceat)
        run("mxv plus_times[UINT64] (generic)",
            lambda: A64.mxv(x64, gb.semiring.plus_times["UINT64"]).new(),
            lambda v: check_vector("mxv plus_times[UINT64]", v, *want), [],
            profile=True)
        a16 = rng.integers(-30000, 30000, nnz).astype(np.int16)
        u16 = rng.integers(1, 300, n).astype(np.int16)
        A16 = gb.Matrix.from_coo(src, dst, a16, dtype="INT16", nrows=n, ncols=n)
        x16 = gb.Vector.from_coo(np.arange(n), u16, dtype="INT16", size=n)
        want = _ref_spmv(by_src, dst, src, u16, full, a16, lambda x, a: a // x,
                         lambda p, s: np.add.reduceat(p.astype(np.int64), s)
                         .astype(np.int16))
        run("mxv plus_floordiv[INT16] (generic)",
            lambda: A16.mxv(x16, gb.semiring.plus_floordiv["INT16"]).new(),
            lambda v: check_vector("mxv plus_floordiv[INT16]", v, *want), [])
    results["operators"] = out


def _merge_ref(ka, va, kb, vb, how):
    """Keys and values of an element-wise add, mult, minus (union with 0
    defaults) or eq of two sorted key arrays, in numpy."""
    both = np.intersect1d(ka, kb)
    pa, pb = np.searchsorted(ka, both), np.searchsorted(kb, both)
    if how == "mult":
        return both, va[pa] * vb[pb]
    if how == "eq":
        return both, va[pa] == vb[pb]
    keys = np.union1d(ka, kb)
    ia, ib = np.searchsorted(ka, keys), np.searchsorted(kb, keys)
    in_a = (ia < len(ka)) & (ka[np.minimum(ia, len(ka) - 1)] == keys)
    in_b = (ib < len(kb)) & (kb[np.minimum(ib, len(kb) - 1)] == keys)
    a = np.where(in_a, va[np.minimum(ia, len(ka) - 1)], va.dtype.type(0))
    b = np.where(in_b, vb[np.minimum(ib, len(kb) - 1)], vb.dtype.type(0))
    if how == "add":
        return keys, np.where(in_a & in_b, a + b, np.where(in_a, a, b))
    return keys, a - b  # minus: a - 0 and 0 - b where one side is missing


def _check_coo(name, M, n, keys, vals, rel=None):
    """A result Matrix against (row * n + col) keys and values."""
    r, c, v = M.to_coo()
    got = r.astype(np.int64) * n + c.astype(np.int64)
    if not np.array_equal(got, keys):
        fail(f"infix {name}: structure differs ({len(got)} vs {len(keys)} "
             f"entries)")
    if rel is None:
        if not np.array_equal(v, vals.astype(v.dtype)):
            fail(f"infix {name}: values differ from numpy")
    else:
        g, w = v.astype(np.float64), vals.astype(np.float64)
        if (np.abs(g - w) > rel * np.abs(w)).any():
            fail(f"infix {name}: values beyond rel {rel} of numpy")


def _same_vector(name, a, b):
    ai, av = a.to_coo()
    bi, bv = b.to_coo()
    if not (np.array_equal(ai, bi) and np.array_equal(av.view(np.uint8),
                                                      bv.view(np.uint8))):
        fail(f"infix {name}: the infix form differs from the method form")


def infix_phase(gb, torch, K, src, dst, w, n, results, totals):
    """The expression surface and the constructors at full width, on
    bench.py's zipf graph (n = 2**19, 3,750,401 entries) built by
    Matrix.from_csr from scipy's CSR: the constructors and exports round
    trip against scipy and numpy; PageRank (20 iterations), a level BFS
    from the hub and SSSP written in infix (``semiring.plus_times(r @
    A)``, ``q(~v.S, replace=True) << lor_land(q @ Ab)`` under ``while
    q.reduce(lor)``, ``d(binary.min) << min_plus(d @ A)``) equal their
    method forms bitwise with the same launch counts, each timed (host
    clock, median of 5); the arithmetic and comparison operators, the
    expression selects, two combined masks, Scalar comparisons and
    conversions and Vector.outer against numpy; and K7 through
    ``D(binary.min) << min_plus(D @ D)`` at 2048 x 2048.  Each of K1-K7
    must launch in the phase."""
    import scipy.sparse as sps

    rng = np.random.default_rng(SEED + 14)
    nnz = len(src)
    out = {}
    phase = {k: 0 for k in KERNELS}

    def launches(tag, need=()):
        got = check_launches(K, tag, totals, need=need)
        for k, v in got.items():
            phase[k] += v
        return got

    def timed_expr(tag, fn):
        """Median host ms of 3 calls after a first one (plans)."""
        res, ms, runs, first_s = timed_calls(torch, fn, reps=3)
        out[tag] = {"ms": ms, "ms_runs": runs, "first_call_s": first_s}
        log(f"  {tag}: ms {runs} (median {ms:.4f}), first call "
            f"{first_s * 1e3:.2f} ms")
        return res

    def timed(tag, fn):
        """Host ms of one call (a construction: it is not repeated)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out[tag] = {"ms": ms}
        log(f"  {tag}: {ms:.2f} ms")
        return res

    # ---- construction and export against scipy
    reset_counts(K)
    S = sps.csr_matrix((w, (src, dst)), shape=(n, n))
    S.sum_duplicates()
    S.sort_indices()
    A = timed("from_csr", lambda: gb.Matrix.from_csr(
        S.indptr, S.indices, S.data, dtype="FP32", nrows=n, ncols=n))
    if A._sparse is None:
        fail("infix: from_csr densified the zipf graph")
    A0 = gb.Matrix.from_coo(src, dst, w, dtype="FP32", nrows=n, ncols=n)
    if not A.isequal(A0, check_dtype=True):
        fail("infix: from_csr differs from from_coo")
    del A0
    indptr, ind, data = timed("to_csr", A.to_csr)
    if not (np.array_equal(indptr.astype(np.int64), S.indptr)
            and np.array_equal(ind.astype(np.int64), S.indices)
            and np.array_equal(data.view(np.uint32), S.data.view(np.uint32))):
        fail("infix: to_csr differs from scipy's CSR")
    Sc = S.tocsc()
    Sc.sort_indices()
    indptr, ind, data = timed("to_csc", A.to_csc)
    if not (np.array_equal(indptr.astype(np.int64), Sc.indptr)
            and np.array_equal(ind.astype(np.int64), Sc.indices)
            and np.array_equal(data.view(np.uint32),
                               Sc.data.view(np.uint32))):
        fail("infix: to_csc differs from scipy's CSC")
    counts = np.diff(S.indptr)
    crows = np.flatnonzero(counts)
    B = timed("from_dcsr", lambda: gb.Matrix.from_dcsr(
        crows, np.r_[0, np.cumsum(counts[crows])], S.indices, S.data,
        dtype="FP32", nrows=n, ncols=n))
    if not B.isequal(A, check_dtype=True):
        fail("infix: from_dcsr differs from the matrix")
    ccols, cptr, rows_c, vals_c = timed("to_dcsc", A.to_dcsc)
    ccounts = np.diff(Sc.indptr)
    if not (np.array_equal(ccols.astype(np.int64), np.flatnonzero(ccounts))
            and np.array_equal(cptr.astype(np.int64),
                               np.r_[0, np.cumsum(ccounts[ccounts > 0])])
            and np.array_equal(rows_c.astype(np.int64), Sc.indices)
            and np.array_equal(vals_c.view(np.uint32),
                               Sc.data.view(np.uint32))):
        fail("infix: to_dcsc differs from scipy's CSC")
    # build with 5% duplicate coordinates
    dup = rng.choice(nnz, nnz // 20, replace=False)
    rows2 = np.concatenate([src, src[dup]])
    cols2 = np.concatenate([dst, dst[dup]])
    vals2 = np.concatenate([w, rng.random(len(dup), dtype=np.float32)])
    keys2 = rows2 * n + cols2
    order = np.argsort(keys2, kind="stable")
    starts = np.flatnonzero(np.r_[True, np.diff(keys2[order]) != 0])
    for name, op, fold in (("plus", gb.binary.plus, np.add),
                           ("min", gb.binary.min, np.minimum)):
        Bd = gb.Matrix(gb.dtypes.FP32, n, n)
        timed(f"build dup_op={name}", lambda Bd=Bd, op=op: Bd.build(
            rows2, cols2, vals2, dup_op=op))
        _check_coo(f"build dup_op={name}", Bd, n, keys2[order][starts],
                   fold.reduceat(vals2[order], starts))
    E, V = timed("to_edgelist", A.to_edgelist)
    if not (np.array_equal(E[:, 0].astype(np.int64), src)
            and np.array_equal(E[:, 1].astype(np.int64), dst)):
        fail("infix: to_edgelist differs from the COO")
    B = timed("from_edgelist", lambda: gb.Matrix.from_edgelist(
        E, V, dtype="FP32", nrows=n, ncols=n))
    if not B.isequal(A, check_dtype=True):
        fail("infix: from_edgelist differs from the matrix")
    B = A.dup()
    half = n // 2
    crop = (src < half) & (dst < half)
    timed("resize to 2**18", lambda: B.resize(half, half))
    if B._sparse is None or B.shape != (half, half):
        fail("infix: resize densified or kept its shape")
    _check_coo("resize down", B, half, src[crop] * half + dst[crop], w[crop])
    timed("resize back", lambda: B.resize(n, n))
    _check_coo("resize back", B, n, src[crop] * n + dst[crop], w[crop])
    del B, E, V, Sc
    launches("construction")

    # ---- the main paths, infix against the method form
    Ab = gb.Matrix.from_coo(src, dst, np.ones(nnz, bool), dtype="BOOL",
                            nrows=n, ncols=n)
    pt = gb.semiring.plus_times["FP32"]
    damp, tele = np.float32(0.85), np.float32(0.15 / n)
    damp_tele = gb.unary.register_anonymous(lambda x: x * damp + tele,
                                            name="damp_tele_infix")
    lor_land = gb.semiring.lor_land["BOOL"]
    min_plus = gb.semiring.min_plus["FP32"]
    hub = int(np.argmax(np.bincount(dst, minlength=n)))

    def pagerank(infix):
        rank = gb.Vector.from_dense(np.full(n, 1.0 / n, np.float32))
        y = gb.Vector(gb.dtypes.FP32, n)
        for _ in range(20):
            if infix:
                y << pt(rank @ A)
                rank << damp_tele(y)
            else:
                y << rank.vxm(A, pt)
                rank << y.apply(damp_tele)
        return rank

    def bfs(infix):
        q = gb.Vector.from_coo([hub], [True], size=n)
        v = gb.Vector(gb.dtypes.INT32, n)
        i = 0
        while True:
            i += 1
            v(mask=q.V)[:] = i
            if infix:
                q(~v.S, replace=True) << lor_land(q @ Ab)
                if not q.reduce(gb.monoid.lor):
                    break
            else:
                q(~v.S, replace=True) << q.vxm(Ab, lor_land)
                if not q.reduce(gb.monoid.lor, allow_empty=False).new().value:
                    break
        return v

    def sssp(infix):
        if not infix:
            return gb.algorithms.sssp(A, 0)
        d = gb.Vector(gb.dtypes.FP32, n)
        d[0] = 0
        while True:
            prev = d.dup()
            d(gb.binary.min) << min_plus(d @ A)
            if d.isequal(prev):
                return d

    need = {"pagerank": LANEPIPE_FAST, "bfs": LANEPIPE_FAST,
            "sssp": ("gather_mult", "mid_perm", "tile_perm",
                     "lane_segscan")}
    for tag, fn in (("pagerank", pagerank), ("bfs", bfs), ("sssp", sssp)):
        fn(False)  # warm-up: plans
        forms = {}
        for infix in (False, True):
            form = "infix" if infix else "method"
            reset_counts(K)
            res = fn(infix)
            torch.cuda.synchronize()
            forms[form] = (res, launches(f"{tag} ({form})", need[tag]), [])
        # timed in turns (method, infix, infix, method, ...)
        for r in range(2 * RUNS):
            infix = r % 4 in (1, 2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(infix)
            torch.cuda.synchronize()
            forms["infix" if infix else "method"][2].append(
                (time.perf_counter() - t0) * 1e3)
        (rm, gm, tm), (ri, gi, ti) = forms["method"], forms["infix"]
        _same_vector(tag, ri, rm)
        if {k: gm[k] for k in KERNELS[:6]} != {k: gi[k] for k in KERNELS[:6]}:
            fail(f"infix {tag}: launches {gi} differ from the method form's "
                 f"{gm}")
        med_m, med_i = float(np.median(tm)), float(np.median(ti))
        spread = max(max(tm) - min(tm), max(ti) - min(ti))
        log(f"  {tag}: method ms {tm} (median {med_m:.3f}), infix ms {ti} "
            f"(median {med_i:.3f}), gap {med_i - med_m:+.3f} ms, spread "
            f"{spread:.3f} ms, launches {gi}, {ri.nvals} entries")
        out[tag] = {"method_ms_runs": tm, "infix_ms_runs": ti,
                    "method_ms": med_m, "infix_ms": med_i,
                    "gap_ms": med_i - med_m, "spread_ms": spread,
                    "launches": {k: gi[k] for k in KERNELS},
                    "nvals": ri.nvals}

    # ---- expressions against numpy
    reset_counts(K)
    ka = src * n + dst
    kt_order = np.argsort(dst * n + src)
    kt, vt = (dst * n + src)[kt_order], w[kt_order]
    t = np.float32(np.median(w))
    k = n // 2
    cases = (
        ("A + A.T", lambda: (A + A.T).new(), _merge_ref(ka, w, kt, vt, "add")),
        ("A * A.T", lambda: (A * A.T).new(), _merge_ref(ka, w, kt, vt, "mult")),
        ("A - A.T", lambda: (A - A.T).new(),
         _merge_ref(ka, w, kt, vt, "minus")),
        ("A == A.T", lambda: (A == A.T).new(), _merge_ref(ka, w, kt, vt, "eq")),
        ("A > t", lambda: (A > t).new(), (ka, w > t)),
        ("-A", lambda: (-A).new(), (ka, -w)),
        ("abs(-A)", lambda: abs(-A).new(), (ka, w)),
        ("select.value(A > t)", lambda: gb.select.value(A > t).new(),
         (ka[w > t], w[w > t])),
        ("select.row(A < k)", lambda: gb.select.row(A < k).new(),
         (ka[src < k], w[src < k])),
        ("select.column(A >= k)", lambda: gb.select.column(A >= k).new(),
         (ka[dst >= k], w[dst >= k])),
    )
    for name, fn, (keys, vals) in cases:
        res = timed_expr(name, fn)
        _check_coo(name, res, n, keys, vals)
    if not gb.select.value(A > t).new().isequal(
            A.select("valuegt", t).new(), check_dtype=True):
        fail("infix: select.value(A > t) differs from A.select('valuegt', t)")
    # masked vxm under combined masks
    x = gb.Vector.from_dense(rng.random(n, dtype=np.float32))
    v_in = rng.random(n) < 0.3
    u_in = rng.random(n) < 0.5
    u_val = rng.random(n) < 0.5
    vv = gb.Vector.from_coo(np.flatnonzero(v_in), 1.0, dtype="FP32", size=n)
    uu = gb.Vector.from_coo(np.flatnonzero(u_in), u_val[u_in], dtype="BOOL",
                            size=n)
    xs = x.to_dense().astype(np.float64)
    yref = np.bincount(dst, weights=xs[src] * w.astype(np.float64),
                       minlength=n)
    ystruct = np.bincount(dst, minlength=n) > 0
    for name, mask, want in (
            ("vxm under v.S & u.V", lambda: vv.S & uu.V, v_in & u_in & u_val),
            ("vxm under ~v.S | u.S", lambda: ~vv.S | uu.S, ~v_in | u_in)):
        res = gb.Vector(gb.dtypes.FP32, n)

        def run(res=res, mask=mask):
            res(mask()) << pt(x @ A)
            return res

        timed_expr(name, run)
        idx = np.flatnonzero(want & ystruct)
        check_vector(f"infix {name}", res, idx, yref[idx], rel=1e-5)
    total = A.reduce_scalar().new().value
    if not (bool(A.reduce_scalar() == total)
            and not bool(A.reduce_scalar() == total + 1)):
        fail("infix: bool(A.reduce_scalar() == x) is wrong")
    rows_ok = timed_expr("A.reduce_rowwise() > 0",
                    lambda: (A.reduce_rowwise() > 0).new())
    rows_i = np.flatnonzero(np.bincount(src, minlength=n))
    check_vector("infix A.reduce_rowwise() > 0", rows_ok, rows_i,
                 np.ones(len(rows_i), bool))
    s = A.apply(gb.unary.one["INT64"]).reduce_scalar().new()
    if int(s) != nnz or float(s) != float(nnz) or not isinstance(int(s), int):
        fail(f"infix: int(s), float(s) give {int(s)}, {float(s)}, not {nnz}")
    ia = np.sort(rng.choice(n, 2048, replace=False))
    ib = np.sort(rng.choice(n, 2048, replace=False))
    va = rng.random(2048, dtype=np.float32)
    vb = rng.random(2048, dtype=np.float32)
    a = gb.Vector.from_coo(ia, va, dtype="FP32", size=n)
    b = gb.Vector.from_coo(ib, vb, dtype="FP32", size=n)
    M = timed_expr("Vector.outer", lambda: a.outer(b).new())
    if M._sparse is None or M.nvals != 2048 * 2048:
        fail(f"infix: outer gave {M.nvals} entries (sparse: "
             f"{M._sparse is not None})")
    _check_coo("Vector.outer", M, n,
               (ia[:, None] * n + ib[None, :]).ravel(),
               np.outer(va, vb).ravel())
    del M
    launches("expressions", need=("segscan",) + LANEPIPE_FAST)

    # ---- K7 through infix: min_plus(D @ D) on a dense-backed matrix
    dn = APSP_MXM_N
    vals = rng.random((dn, dn), dtype=np.float32) + np.float32(0.05)
    vals[rng.random((dn, dn)) < 0.9] = np.inf
    np.fill_diagonal(vals, 0)
    with gb.config.set(auto_sparse_limit=1 << 22):
        D1 = gb.Matrix.from_dense(vals, missing_value=np.inf)
        D2 = gb.Matrix.from_dense(vals, missing_value=np.inf)
        res = {}
        for form, D in (("method", D1), ("infix", D2)):
            reset_counts(K)

            def step(D=D, form=form):
                if form == "infix":
                    D(gb.binary.min) << min_plus(D @ D)
                else:
                    D(accum=gb.binary.min) << D.mxm(D, min_plus)
                return D

            timed_expr(f"D(min) << min_plus(D @ D) ({form})", step)
            res[form] = launches(f"min_plus(D @ D) ({form})",
                                 need=("tropical_matmul",))
        if D1._sparse is not None or D2._sparse is not None:
            fail("infix: the dense product left the dense engine")
        if res["method"] != res["infix"] or not np.array_equal(
                D1.to_dense(fill_value=np.inf).view(np.uint32),
                D2.to_dense(fill_value=np.inf).view(np.uint32)):
            fail("infix: min_plus(D @ D) differs from the method form")
    never = [k for k in KERNELS if phase[k] == 0]
    if never:
        fail(f"infix: kernels never launched in the phase: {never}")
    log(f"  launches in the phase: {phase}")
    out["launches"] = phase
    results["infix"] = out


def _pagerank_run(gb, torch, K, A, n, iters):
    """bench.py's PageRank (pr_body under ss.iterate) on A: the ranks and
    the launches of the run."""
    ring = gb.semiring.plus_times["FP32"]
    damp, tele = np.float32(0.85), np.float32(0.15 / n)
    damp_tele = gb.unary.register_anonymous(lambda x: x * damp + tele,
                                            name="damp_tele_ss_io")

    def pr_body(s, i):
        s["y"] << s["rank"].vxm(A, ring)
        s["rank"] << s["y"].apply(damp_tele)

    y = gb.Vector(gb.dtypes.FP32, n)
    pr_body({"rank": gb.Vector.from_dense(np.full(n, 1.0 / n, np.float32)),
             "y": y}, None)  # plans
    rank = gb.Vector.from_dense(np.full(n, 1.0 / n, np.float32))
    torch.cuda.synchronize()
    before = dict(K.launches)
    gb.ss.iterate(pr_body, {"rank": rank, "y": y}, max_iter=iters)
    torch.cuda.synchronize()
    return rank.to_dense(), {k: K.launches[k] - before.get(k, 0)
                            for k in KERNELS}


def _bfs_levels(gb, Ab, n):
    """bench.py's level BFS from node 0 on Ab: (levels Vector, depth)."""
    lor_land = gb.semiring.lor_land["BOOL"]

    def body(s, i):
        s["v"](mask=s["q"].V)[:] = i
        s["q"](~s["v"].S, replace=True) << s["q"].vxm(Ab, lor_land)

    def cond(s, i):
        return s["q"].reduce(gb.monoid.lor, allow_empty=False).new()

    q = gb.Vector.from_coo([0], [True], size=n)
    v = gb.Vector(gb.dtypes.INT32, n)
    it = gb.ss.iterate(body, {"q": q, "v": v}, cond=cond, max_iter=64)
    return v, it


def _row_ranks(keys_sorted):
    """Rank of each entry within its run of equal keys (keys sorted)."""
    idx = np.arange(len(keys_sorted))
    starts = np.searchsorted(keys_sorted, keys_sorted, side="left")
    return idx - starts


def _segment_cumsum(group, x):
    """Inclusive cumsum of x (sorted by group) restarting at each group,
    in float64 (or int64 for integers)."""
    cs = np.cumsum(x)
    first = np.searchsorted(group, group, side="left")
    before = np.where(first > 0, cs[np.maximum(first - 1, 0)], 0)
    return cs - before


def ss_io_phase(gb, torch, K, src, dst, w, n, A, Ab, results, totals):
    """The ss extensions and interchange at full width, on bench.py's zipf
    graph (n = 2**19): export as CSR and import_csr (PageRank bitwise with
    the same K1-K4 launches, SSSP through K5 bitwise); the rowwise and
    columnwise scans through K6 against numpy in float64 (rel 1e-5 of each
    row's running sum) and against K6's plain version on the card's arrays,
    an INT32 scan exactly; sort, selectk and compactify exactly against
    numpy's lexsort; a 4 x 4 split and concat (sparse tiles, peak memory
    under three times the matrix's bytes); serialize and pickle of the BOOL
    graph (BFS levels exactly); scipy and Matrix Market round trips; repr
    (under 1 s and 1 MB); a Recorder around one BFS level; and four dense
    2048 x 2048 tiles joined by concat into a min_plus product (K7)
    bitwise equal to the unsplit matrix's.  Every one of K1-K7 launches in
    it."""
    import pickle
    import tempfile

    from graphblas_tpu_torch.core.engine import sortpipe as spipe
    from graphblas_tpu_torch.core.engine import sparse as spx

    out = {}
    nnz = len(src)
    r_h, c_h, v_h = (x.copy() for x in A._sparse.host_coo())

    def timed(tag, fn, peak=False, reps=0):
        """Host ms of one call; with peak, the device memory it raised
        the peak by; with reps, the median of reps calls after a first
        one (which may build plans and grow the allocator's pool)."""
        if reps:
            res, ms, runs, first_s = timed_calls(torch, fn, reps=reps)
            out[tag] = {"ms": ms, "ms_runs": runs, "first_call_s": first_s}
            log(f"  {tag}: ms {[round(r, 4) for r in runs]} (median "
                f"{ms:.4f}), first call {first_s * 1e3:.2f} ms")
            return res
        torch.cuda.synchronize()
        if peak:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out[tag] = {"ms": ms}
        extra = ""
        if peak:
            mb = (torch.cuda.max_memory_allocated() - base) / 2**20
            out[tag]["peak_mb"] = mb
            extra = f", peak +{mb:.3f} MB"
        log(f"  {tag}: {ms:.2f} ms{extra}")
        return res

    reset_counts(K)
    # ---- 1. CSR export and import; PageRank and SSSP on the import
    d = timed("export csr", lambda: A.ss.export("csr"))
    B = timed("import_csr", lambda: gb.Matrix.ss.import_csr(**d))
    del d
    if B._sparse is None or not B.isequal(A, check_dtype=True):
        fail("ss_io: import_csr of the export differs from the matrix")
    ranks, counts = [], []
    for M in (A, B):
        rk, cnt = _pagerank_run(gb, torch, K, M, n, 20)
        ranks.append(rk)
        counts.append(cnt)
    if not np.array_equal(ranks[0].view(np.uint32), ranks[1].view(np.uint32)):
        fail("ss_io: PageRank on the imported matrix is not bitwise equal")
    if counts[0] != counts[1] or not all(counts[1][k] for k in LANEPIPE_FAST):
        fail(f"ss_io: PageRank launches differ: {counts}")
    log(f"  pagerank x20 on import_csr: bitwise equal, launches {counts[1]}")
    d_a = gb.algorithms.sssp(A, 0)
    k5 = K.launches["lane_segscan"]
    d_b = timed("sssp on import_csr", lambda: gb.algorithms.sssp(B, 0))
    if K.launches["lane_segscan"] == k5:
        fail("ss_io: SSSP on the imported matrix did not launch K5")
    if not all(np.array_equal(x, y) for x, y in zip(d_a.to_coo(),
                                                      d_b.to_coo())):
        fail("ss_io: SSSP on the imported matrix differs")
    del B, d_a, d_b

    # ---- 2. scans through K6
    group_c = np.lexsort((r_h, c_h))  # (col, row) order

    def check_scan(tag, S, group, vals, order, rel):
        sr, sc, sv = S.to_coo()
        if not (np.array_equal(sr, r_h) and np.array_equal(sc, c_h)):
            fail(f"ss_io: {tag} changed the structure")
        g, x = group[order], vals[order]
        ref = np.empty(nnz, np.float64 if rel else np.int64)
        ref[order] = _segment_cumsum(g, x.astype(ref.dtype))
        if rel is None:
            if not np.array_equal(sv.astype(np.int64), ref):
                fail(f"ss_io: {tag} differs from numpy")
            return 0.0
        mag = np.empty(nnz)
        mag[order] = _segment_cumsum(g, np.abs(x.astype(np.float64)))
        err = np.abs(sv.astype(np.float64) - ref)
        if (err > rel * mag).any():
            fail(f"ss_io: {tag} beyond rel {rel} of the running sum")
        return float(err.max())

    def check_plain(tag, M, S, rowwise, rel):
        """S's values against K6's plain version on the card's arrays."""
        sp_ = M._sparse
        if rowwise:
            group, x, perm = sp_.rows, sp_.vals, None
        else:
            perm = sp_.csc_perm()
            group, x = sp_.cols[perm], sp_.vals[perm]
        mono = gb.binary.plus[M.dtype].monoid
        plain = spipe.from_carrier(spipe.segscan_channels_plain(
            spx.group_barrier(group), [spipe.to_carrier(x, M.dtype)],
            [spipe.monoid_combine(mono)])[0], M.dtype)
        got = S._sparse.vals if perm is None else S._sparse.vals[perm]
        if rel is None:
            ok = bool(torch.equal(got, plain))
        else:
            ok = bool((torch.abs(got - plain) <= rel * torch.abs(plain)).all())
        if not ok:
            fail(f"ss_io: {tag} differs from K6's plain version")

    for tag, rowwise in (("scan plus rowwise", True),
                         ("scan plus columnwise", False)):
        k6 = K.launches["segscan"]
        S = timed(tag, lambda rowwise=rowwise: A.ss.scan(
            "plus", order="rowwise" if rowwise else "columnwise"), reps=3)
        if K.launches["segscan"] == k6:
            fail(f"ss_io: {tag} did not launch K6")
        order = np.arange(nnz) if rowwise else group_c
        group = r_h if rowwise else c_h
        err = check_scan(tag, S, group, v_h, order, 1e-5)
        check_plain(tag, A, S, rowwise, 1e-6)
        out[tag]["max_abs_err"] = err
        del S
    wi = ((src + dst) % 7 + 1).astype(np.float32)
    Ai = gb.Matrix.from_coo(src, dst, wi, dtype="FP32", nrows=n,
                            ncols=n).apply("identity[INT32]").new()
    if Ai.dtype.name != "INT32" or Ai._sparse is None:
        fail("ss_io: the INT32 copy is not a sparse INT32 matrix")
    for tag, rowwise in (("scan plus INT32 rowwise", True),
                         ("scan plus INT32 columnwise", False)):
        S = timed(tag, lambda rowwise=rowwise: Ai.ss.scan(
            "plus", order="rowwise" if rowwise else "columnwise"), reps=3)
        check_scan(tag, S, r_h if rowwise else c_h, wi.astype(np.int64),
                   np.arange(nnz) if rowwise else group_c, None)
        check_plain(tag, Ai, S, rowwise, None)
        del S
    del Ai

    # ---- 3. sort, selectk and compactify against numpy's lexsort
    C, P = timed("sort", lambda: A.ss.sort(), reps=3)
    o = np.lexsort((c_h, v_h, r_h))
    rank = _row_ranks(r_h[o])
    cr, cc, cv = C.to_coo()
    pr, pc, pv = P.to_coo()
    if not (np.array_equal(cr, r_h[o]) and np.array_equal(cc, rank)
            and np.array_equal(cv, v_h[o]) and np.array_equal(pv, c_h[o])
            and np.array_equal(pr, cr) and np.array_equal(pc, cc)):
        fail("ss_io: sort differs from numpy's lexsort")
    del C, P
    L = timed("selectk largest 4", lambda: A.ss.selectk("largest", 4),
              reps=3)
    o = np.lexsort((c_h, -v_h.astype(np.float64), r_h))
    keep = np.sort(o[_row_ranks(r_h[o]) < 4])
    if not all(np.array_equal(x, y[keep]) for x, y in
               zip(L.to_coo(), (r_h, c_h, v_h))):
        fail("ss_io: selectk largest differs from numpy")
    del L
    Cf = timed("compactify first", lambda: A.ss.compactify("first"),
               reps=3)
    deg = np.bincount(r_h, minlength=n)
    cr, cc, cv = Cf.to_coo()
    if Cf.shape != (n, int(deg.max())) or not (
            np.array_equal(cr, r_h) and np.array_equal(cc, _row_ranks(r_h))
            and np.array_equal(cv, v_h)):
        fail("ss_io: compactify differs from numpy")
    del Cf
    R4 = timed("selectk random 4", lambda: A.ss.selectk("random", 4),
               reps=3)
    if not np.array_equal(np.bincount(R4.to_coo()[0].astype(np.int64),
                                      minlength=n), np.minimum(deg, 4)):
        fail("ss_io: selectk random does not keep min(4, count) a row")
    del R4

    # ---- 4. split into a 4 x 4 grid and concat back
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tiles = timed("split 4x4", lambda: A.ss.split(n // 4))
    if len(tiles) != 4 or any(len(row) != 4 or any(t._sparse is None
                                                    for t in row)
                              for row in tiles):
        fail("ss_io: split did not give a 4 x 4 grid of sparse tiles")
    D = timed("concat 4x4", lambda: gb.ss.concat(tiles))
    peak = torch.cuda.max_memory_allocated() - base
    if D._sparse is None or not D.isequal(A, check_dtype=True):
        fail("ss_io: concat of the split differs from the matrix")
    if peak > 3 * A.ss.nbytes:
        fail(f"ss_io: split and concat peak {peak} bytes over three times "
             f"the matrix's {A.ss.nbytes}")
    out["split_concat_peak_mb"] = peak / 2**20
    log(f"  split + concat peak +{peak / 2**20:.1f} MB (matrix "
        f"{A.ss.nbytes / 2**20:.1f} MB)")
    del tiles, D

    # ---- 5. serialize and pickle of the BOOL graph; BFS on each
    lev, depth = bfs_ref(src, dst, n)
    ref_i = np.flatnonzero(lev)
    blob = timed("serialize", lambda: Ab.ss.serialize())
    Bs = timed("deserialize", lambda: gb.Matrix.ss.deserialize(blob))
    out["serialize"]["bytes"] = int(blob.nbytes)
    data = timed("pickle dumps", lambda: pickle.dumps(Ab))
    Bp = timed("pickle loads", lambda: pickle.loads(data))
    del blob, data
    for tag, M in (("deserialize", Bs), ("pickle", Bp)):
        if M._sparse is None or not M.isequal(Ab, check_dtype=True):
            fail(f"ss_io: {tag} round trip differs")
        v, it = _bfs_levels(gb, M, n)
        vi, vv = v.to_coo()
        if it != depth or not (np.array_equal(vi.astype(np.int64), ref_i)
                               and np.array_equal(vv.astype(np.int64),
                                                  lev[ref_i])):
            fail(f"ss_io: BFS on the {tag} graph differs from numpy's")
    log(f"  bfs on deserialized and unpickled graphs: depth {depth}, exact")
    del Bs, Bp

    # ---- 6. scipy and Matrix Market round trips
    Ssp = timed("to_scipy_sparse", lambda: gb.io.to_scipy_sparse(A))
    Bsp = timed("from_scipy_sparse", lambda: gb.io.from_scipy_sparse(Ssp))
    if not Bsp.isequal(A, check_dtype=True):
        fail("ss_io: the scipy round trip differs")
    del Ssp, Bsp
    rs, rd, rn = build_rmat(12)
    rv = np.random.default_rng(SEED + 15).random(len(rs))
    R = gb.Matrix.from_coo(rs, rd, rv, dtype="FP64", nrows=rn, ncols=rn)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rmat12.mtx")
        timed("mmwrite rmat12", lambda: gb.io.mmwrite(path, R))
        R2 = timed("mmread rmat12", lambda: gb.io.mmread(path))
    if not R2.isequal(R, check_dtype=True):
        fail("ss_io: the Matrix Market round trip differs")

    # ---- 7. repr without a plane
    for tag, fn in (("repr", lambda: repr(A)),
                    ("repr_html", lambda: A._repr_html_())):
        text = timed(tag, fn, peak=True)
        if out[tag]["ms"] > 1000 or out[tag]["peak_mb"] > 1.0:
            fail(f"ss_io: {tag} took {out[tag]}")
        if "(0, " not in text:
            fail(f"ss_io: {tag} shows no entries")
    log("  repr: " + repr(A).replace("\n", " | ")[:200])

    # ---- 8. a Recorder around one BFS level
    q = gb.Vector.from_coo([0], [True], size=n)
    v = gb.Vector(gb.dtypes.INT32, n, name="v")
    q.name = "q"
    with gb.Recorder() as rec:
        v(mask=q.V)[:] = 1
        q(~v.S, replace=True) << q.vxm(Ab, gb.semiring.lor_land["BOOL"])
    if len(rec) < 1:
        fail("ss_io: the Recorder recorded nothing")
    log(f"  recorder: {len(rec)} lines; first: {rec.data[:3]}")
    out["recorder_lines"] = rec.data[:3]

    # ---- 9. dense tiles joined by concat, then min_plus (K7)
    rng = np.random.default_rng(SEED + 16)
    full = rng.random((4096, 4096), dtype=np.float32)
    full[rng.random(full.shape) < 0.5] = np.inf
    with gb.config.set(auto_sparse_limit=1 << 25):  # products stay dense
        tiles = [[gb.Matrix.from_dense(full[i:i + 2048, j:j + 2048],
                                       missing_value=np.inf)
                  for j in (0, 2048)] for i in (0, 2048)]
        Dd = timed("concat dense 2x2", lambda: gb.ss.concat(tiles))
        E = gb.Matrix.from_dense(full, missing_value=np.inf)
        if Dd._sparse is not None or not Dd.isequal(E, check_dtype=True):
            fail("ss_io: the dense concat differs from the unsplit matrix")
        k7 = K.launches["tropical_matmul"]
        got = timed("min_plus on the concat", lambda: Dd.mxm(
            Dd, gb.semiring.min_plus).new(), reps=3)
        if K.launches["tropical_matmul"] == k7 or got._sparse is not None:
            fail("ss_io: min_plus on the concat did not run K7")
        want = E.mxm(E, gb.semiring.min_plus).new()
        if not got.isequal(want, check_dtype=True):
            fail("ss_io: min_plus on the concat is not bitwise equal")
    del tiles, Dd, E, got, want
    out["launches"] = check_launches(K, "ss_io", totals, need=KERNELS)
    results["ss_io"] = out


# ---------------------------------------------------------------------- #
# the complex types and user-defined types (phase `complex_udt`)
def _cclose(name, got, want, rel):
    """Complex (or real) values against a complex128 reference within rel
    of the magnitude: |got - want| <= rel * max(|want|, max |want|).
    Returns the max abs error."""
    g = np.asarray(got).astype(np.complex128)
    w = np.asarray(want).astype(np.complex128)
    if g.shape != w.shape:
        fail(f"{name}: shape {g.shape} != {w.shape}")
    if not np.isfinite(g).all():
        fail(f"{name}: non-finite values")
    if not len(w):
        return 0.0
    err = np.abs(g - w)
    bad = int((err > rel * np.maximum(np.abs(w), np.abs(w).max())).sum())
    if bad:
        fail(f"{name}: {bad} values beyond rel {rel} of the magnitude (max "
             f"abs err {err.max():.3g})")
    return float(err.max())


def _same_bits(name, a, b):
    """Two float arrays equal bit for bit."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    if a.dtype != b.dtype or a.shape != b.shape or \
            not np.array_equal(a.view(np.uint8), b.view(np.uint8)):
        fail(f"{name}: not bitwise equal")


def _keys(M, n):
    r, c, v = M.to_coo()
    return r.astype(np.int64) * n + c.astype(np.int64), v


def _no_launch(K, before, what):
    """Fail if a kernel launched since `before` (no complex or user-defined
    value may enter K1-K7)."""
    moved = {k: K.launches[k] - before.get(k, 0) for k in KERNELS
             if K.launches[k] != before.get(k, 0)}
    if moved:
        fail(f"complex_udt: {what} launched kernels {moved}")


def _record(gb, torch, out, tag, fn, profile=False):
    """Host ms (warm median of 3), the peak memory one call raises, and,
    with profile, the device busy and idle share."""
    res, ms, runs, first_s = timed_calls(torch, fn, reps=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    rec = {"ms": ms, "ms_runs": runs, "first_call_s": first_s,
           "peak_mb": peak}
    log(f"  {tag}: ms {[round(r, 4) for r in runs]} (median {ms:.4f}), "
        f"first call {first_s * 1e3:.2f} ms, peak +{peak:.1f} MB")
    if profile:
        rec["profile"] = profile_breakdown(torch, fn, tag, ms)
    out[tag] = rec
    return res


def complex_udt_phase(gb, torch, K, src, dst, w, n, A, results, totals):
    """The complex types and user-defined types at full width, on bench.py's
    zipf graph (n = 2**19): FC32 and FC64 magnetic adjacencies exp(i theta)
    / outdeg (theta from seed 17) through vxm/mxv plus_times, plus and
    times reduces and reduce_scalar against scipy/numpy in complex128 (rel
    1e-5 and 1e-12 of the magnitude), conj/creal/cimag/carg/abs, cmplx of
    two FP32 matrices, A.T and a cast, with no kernel launched; Z = W cmplx
    V with creal(Z) and cimag(Z) bitwise W and V, and PageRank, SSSP (K5)
    and a row reduce (K6) on them bitwise equal to those on W and V with
    the same launches; a 4096^2 FC32 plus_times product against numpy and
    min_plus on creal of a 2048^2 FC32 matrix through K7 bitwise; point_t
    (two float64 fields) on the zipf graph and a (3,)float32 subarray
    vector of 2**19 through is_udt ewise_add/ewise_mult/apply, a user
    monoid's row reduce, extract/assign/delete by index lists and a
    structural-mask write, exactly against numpy; FC64 and point_t through
    serialize, pickle, CSR and bitmapr export/import and FC64 through
    Matrix Market (hermitian, RMAT 12).  Host ms, peak memory, device busy
    and idle share of the complex vxm, the complex reduce and the UDT
    ewise_add.  Every one of K1-K7 launches in it."""
    import pickle
    import tempfile

    import scipy.sparse as sps

    out = {}
    nnz = len(src)
    rng = np.random.default_rng(SEED + 17)
    theta = rng.uniform(0, 2 * np.pi, nnz)
    outdeg = np.bincount(src, minlength=n).astype(np.float64)
    mag = np.exp(1j * theta) / outdeg[src]
    x = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
    keys = src * n + dst  # sorted: build_graph's COO is (row, col) order
    reset_counts(K)

    # ---- 1. complex SpMV and reduces, FC32 and FC64: no kernel
    before = dict(K.launches)
    Z64 = None
    for dt, rel in (("FC32", 1e-5), ("FC64", 1e-12)):
        np_t = np.complex64 if dt == "FC32" else np.complex128
        vals = mag.astype(np_t)
        M = sps.csr_matrix((vals.astype(np.complex128), (src, dst)),
                           shape=(n, n))
        xs = x.astype(np_t)
        Z = gb.Matrix.from_coo(src, dst, vals, dtype=dt, nrows=n, ncols=n)
        u = gb.Vector.from_dense(xs, dtype=dt)
        ring = gb.semiring.plus_times[dt]
        tag = dt.lower()
        vxm = _record(gb, torch, out, f"vxm plus_times {tag}",
                      lambda: u.vxm(Z, ring).new(), profile=dt == "FC32")
        mxv = _record(gb, torch, out, f"mxv plus_times {tag}",
                      lambda: Z.mxv(u, ring).new())
        rows = _record(gb, torch, out, f"reduce_rowwise plus {tag}",
                       lambda: Z.reduce_rowwise(gb.monoid.plus[dt]).new(),
                       profile=dt == "FC32")
        prod = Z.reduce_rowwise(gb.monoid.times[dt]).new()
        total = Z.reduce_scalar(gb.monoid.plus[dt]).new().value
        x128 = xs.astype(np.complex128)
        errs = []
        for name, vec, ref in (("vxm", vxm, M.T @ x128), ("mxv", mxv, M @ x128),
                               ("rows plus", rows,
                                np.asarray(M.sum(axis=1)).ravel())):
            idx, got = vec.to_coo()
            if vec.dtype.name != dt or len(idx) != n:
                fail(f"complex_udt: {name} {dt}: {vec.dtype} with "
                     f"{len(idx)} entries")
            errs.append(_cclose(f"{name} {dt}", got, ref[idx.astype(
                np.int64)], rel))
        starts = np.searchsorted(src, np.arange(n))
        nonempty = np.flatnonzero(np.bincount(src, minlength=n))
        pref = np.multiply.reduceat(vals.astype(np.complex128),
                                    starts[nonempty])
        idx, got = prod.to_coo()
        if not np.array_equal(idx.astype(np.int64), nonempty):
            fail(f"complex_udt: times reduce {dt}: structure differs")
        errs.append(_cclose(f"rows times {dt}", got, pref, rel))
        errs.append(_cclose(f"reduce_scalar {dt}", [total], [M.sum()], rel))
        log(f"  {dt}: vxm, mxv, plus and times row reduces, reduce_scalar "
            f"within rel {rel} (max abs err {max(errs):.3g})")
        out[f"max_abs_err_{tag}"] = max(errs)
        if dt == "FC64":
            Z64, vals64, M64 = Z, vals, M
        del M, Z, u, vxm, mxv, rows, prod
    # the complex unaries, cmplx, transpose and a cast, against numpy
    for opname, fn, rtype in (("conj", np.conj, "FC64"),
                              ("creal", np.real, "FP64"),
                              ("cimag", np.imag, "FP64"),
                              ("carg", np.angle, "FP64"),
                              ("abs", np.abs, "FP64")):
        Y = Z64.apply(getattr(gb.unary, opname)).new()
        k, v = _keys(Y, n)
        if Y.dtype.name != rtype or not np.array_equal(k, keys):
            fail(f"complex_udt: {opname}: {Y.dtype} or structure differs")
        if opname in ("conj", "creal", "cimag"):
            _same_bits(opname, v, fn(vals64))
        else:
            _cclose(opname, v, fn(vals64), 1e-15)
    wv = w  # FP32 1/outdeg
    vv = (np.sin(theta) / outdeg[src]).astype(np.float32)
    V = gb.Matrix.from_coo(src, dst, vv, dtype="FP32", nrows=n, ncols=n)
    Zc = A.ewise_mult(V, gb.binary.cmplx).new()
    zc = np.empty(nnz, np.complex64)
    zc.real, zc.imag = wv, vv
    k, v = _keys(Zc, n)
    if Zc.dtype.name != "FC32" or not np.array_equal(k, keys):
        fail("complex_udt: cmplx: type or structure differs")
    _same_bits("cmplx", v, zc)
    T = Z64.T.new()
    tr, tc, tv = T.to_coo()
    order = np.lexsort((src, dst))
    if not (np.array_equal(tr.astype(np.int64), dst[order])
            and np.array_equal(tc.astype(np.int64), src[order])):
        fail("complex_udt: A.T structure differs")
    _same_bits("A.T", tv, vals64[order])
    C32 = Z64.dup("FP32")
    _same_bits("cast FC64 to FP32", C32.to_coo()[2],
               vals64.real.astype(np.float32))
    _no_launch(K, before, "the complex SpMV, reduces and unaries")
    log("  conj, creal, cimag bitwise; carg, abs within 1e-15; cmplx, A.T, "
        "the cast bitwise; no kernel launched")

    # ---- 2. into the kernels: creal and cimag of W cmplx V
    Re = Zc.apply(gb.unary.creal).new()
    Im = Zc.apply(gb.unary.cimag).new()
    for tag, got, want in (("creal(Z)", Re, A), ("cimag(Z)", Im, V)):
        if got.dtype.name != "FP32" or got._sparse is None or \
                not got._sparse.vals.is_contiguous():
            fail(f"complex_udt: {tag} is not a contiguous FP32 store")
        if not torch.equal(got._sparse.rows, want._sparse.rows) or \
                not torch.equal(got._sparse.cols, want._sparse.cols) or \
                not torch.equal(got._sparse.vals.view(torch.int32),
                                want._sparse.vals.view(torch.int32)):
            fail(f"complex_udt: {tag} is not bitwise equal to its part")
    runs = {}
    for tag, M in (("W", A), ("creal(Z)", Re)):
        runs[tag] = _pagerank_run(gb, torch, K, M, n, 20)
    (rw, cw), (rr, cr) = runs["W"], runs["creal(Z)"]
    _same_bits("pagerank on creal(Z)", rr, rw)
    if cw != cr or any(cr[k] == 0 for k in LANEPIPE_FAST):
        fail(f"complex_udt: PageRank launches differ: W {cw}, creal(Z) {cr}")
    log(f"  pagerank (20 iterations) on creal(Z) bitwise equal to W's, "
        f"launches {cr}")
    k5 = K.launches["lane_segscan"]
    dw = gb.algorithms.sssp(A, 0)
    k5w = K.launches["lane_segscan"] - k5
    dr = gb.algorithms.sssp(Re, 0)
    k5r = K.launches["lane_segscan"] - k5 - k5w
    iw, vw_ = dw.to_coo()
    ir, vr = dr.to_coo()
    if not np.array_equal(iw, ir) or k5r == 0 or k5r != k5w:
        fail(f"complex_udt: SSSP on creal(Z): structure or K5 launches "
             f"({k5r} vs {k5w}) differ")
    _same_bits("sssp on creal(Z)", vr, vw_)
    k6 = K.launches["segscan"]
    ri = Im.reduce_rowwise().new()
    if K.launches["segscan"] == k6:
        fail("complex_udt: cimag(Z).reduce_rowwise() did not run K6")
    rv_ = V.reduce_rowwise().new()
    if not np.array_equal(ri.to_coo()[0], rv_.to_coo()[0]):
        fail("complex_udt: the row reduce of cimag(Z): structure differs")
    _same_bits("cimag(Z).reduce_rowwise()", ri.to_coo()[1], rv_.to_coo()[1])
    ab = Zc.apply(gb.unary.abs).new()
    _cclose("abs(Z)", ab.to_coo()[2], np.abs(zc), 1e-6)
    log(f"  sssp on creal(Z) bitwise ({k5r} K5 launches), cimag(Z) row "
        f"reduce through K6 bitwise, abs(Z) within rel 1e-6")
    del Re, Im, Zc, V, ri, rv_, ab, dw, dr, C32, T

    # ---- 3. dense: a 4096^2 FC32 product, min_plus on creal through K7
    drng = np.random.default_rng(SEED + 18)
    with gb.config.set(auto_sparse_limit=1 << 25):  # products stay dense
        X = (drng.uniform(-1, 1, (CU_DENSE_N, CU_DENSE_N))
             + 1j * drng.uniform(-1, 1, (CU_DENSE_N, CU_DENSE_N))).astype(
                 np.complex64)
        D = gb.Matrix.from_dense(X)
        before = dict(K.launches)
        P = _record(gb, torch, out, f"mxm plus_times fc32 {CU_DENSE_N}",
                    lambda: D.mxm(D, gb.semiring.plus_times["FC32"]).new())
        _no_launch(K, before, "the FC32 product")
        t0 = time.perf_counter()
        ref = X @ X
        ref_s = time.perf_counter() - t0
        err = _cclose("mxm plus_times fc32", P.to_dense(), ref, 1e-5)
        log(f"  {CU_DENSE_N}^2 FC32 plus_times within rel 1e-5 of numpy (max "
            f"abs err {err:.3g}; numpy {ref_s:.2f} s)")
        del D, P, X, ref
        m = CU_MINPLUS_N
        stored = drng.random((m, m)) < 0.1
        r2, c2 = np.nonzero(stored)
        cz = (drng.uniform(0.05, 1.05, len(r2))
              + 1j * drng.uniform(-1, 1, len(r2))).astype(np.complex64)
        Dz = gb.Matrix.from_coo(r2, c2, cz, dtype="FC32", nrows=m, ncols=m)
        Dre = Dz.apply(gb.unary.creal).new()
        Dr = gb.Matrix.from_coo(r2, c2, cz.real.copy(), dtype="FP32",
                                nrows=m, ncols=m)
        if Dz._sparse is not None or Dre._sparse is not None:
            fail("complex_udt: the 2048^2 matrices are not dense-backed")
        k7 = K.launches["tropical_matmul"]
        got = Dre.mxm(Dre, gb.semiring.min_plus).new()
        if K.launches["tropical_matmul"] == k7:
            fail("complex_udt: min_plus on creal did not run K7")
        want = Dr.mxm(Dr, gb.semiring.min_plus).new()
        if not got.isequal(want, check_dtype=True):
            fail("complex_udt: min_plus on creal is not bitwise equal")
        log(f"  min_plus on creal of a {m}^2 FC32 matrix (10% stored) "
            f"through K7, bitwise equal to the FP32 matrix's")
        del Dz, Dre, Dr, got, want

    # ---- 4. user-defined types: point_t on the zipf graph, a subarray
    before = dict(K.launches)
    pt = gb.dtypes.register_anonymous(
        np.dtype([("x", np.float64), ("y", np.float64)]), "point_t")
    urng = np.random.default_rng(SEED + 19)
    pv = np.empty(nnz, pt.np_type)
    pv["x"], pv["y"] = urng.integers(-50, 50, nnz), urng.integers(-50, 50, nnz)
    P = gb.Matrix.from_coo(src, dst, pv, dtype=pt, nrows=n, ncols=n)
    qkeys = np.unique(dst * n + src)  # the transposed structure
    qv = np.empty(len(qkeys), pt.np_type)
    qv["x"], qv["y"] = (urng.integers(-50, 50, len(qkeys)),
                        urng.integers(-50, 50, len(qkeys)))
    Q = gb.Matrix.from_coo(qkeys // n, qkeys % n, qv, dtype=pt, nrows=n,
                           ncols=n)
    add = gb.binary.register_anonymous(
        lambda a, b: {"x": a["x"] + b["x"], "y": a["y"] * b["y"]},
        name="point_add", is_udt=True)
    flip = gb.unary.register_anonymous(
        lambda a: {"x": -a["y"], "y": a["x"] * 2}, name="point_flip",
        is_udt=True)
    psum = gb.monoid.register_anonymous(gb.binary.register_anonymous(
        lambda a, b: {"x": a["x"] + b["x"], "y": a["y"] + b["y"]},
        name="point_sum", is_udt=True), 0.0)
    E = _record(gb, torch, out, "udt ewise_add", lambda: P.ewise_add(
        Q, add).new(), profile=True)
    both = np.intersect1d(keys, qkeys)
    ia = np.searchsorted(keys, both)
    ib = np.searchsorted(qkeys, both)
    union = np.union1d(keys, qkeys)
    ex = np.empty(len(union), pt.np_type)
    in_p, in_q = np.isin(union, keys), np.isin(union, qkeys)
    ex[in_p] = pv[np.searchsorted(keys, union[in_p])]
    ex[in_q & ~in_p] = qv[np.searchsorted(qkeys, union[in_q & ~in_p])]
    hit = np.searchsorted(union, both)
    ex["x"][hit] = pv["x"][ia] + qv["x"][ib]
    ex["y"][hit] = pv["y"][ia] * qv["y"][ib]
    k, v = _keys(E, n)
    if E.dtype is not pt or not np.array_equal(k, union) or \
            not np.array_equal(v, ex):
        fail("complex_udt: UDT ewise_add differs from numpy")
    Mu = P.ewise_mult(Q, add).new()
    k, v = _keys(Mu, n)
    if not np.array_equal(k, both) or not np.array_equal(v, ex[hit]):
        fail("complex_udt: UDT ewise_mult differs from numpy")
    F = P.apply(flip).new()
    fx = np.empty(nnz, pt.np_type)
    fx["x"], fx["y"] = -pv["y"], pv["x"] * 2
    if not np.array_equal(_keys(F, n)[1], fx):
        fail("complex_udt: UDT apply differs from numpy")
    S = P.reduce_rowwise(psum).new()
    nonempty = np.flatnonzero(np.bincount(src, minlength=n))
    st_ = np.searchsorted(src, nonempty)
    si, sv = S.to_coo()
    if not (np.array_equal(si.astype(np.int64), nonempty)
            and np.array_equal(sv["x"], np.add.reduceat(pv["x"], st_))
            and np.array_equal(sv["y"], np.add.reduceat(pv["y"], st_))):
        fail("complex_udt: the UDT monoid's row reduce differs from numpy")
    rows = np.sort(urng.choice(n, n // 2, replace=False))
    cols = np.sort(urng.choice(n, n // 2, replace=False))
    X_ = P[rows, cols].new()
    inv_r = np.full(n, -1)
    inv_r[rows] = np.arange(len(rows))
    inv_c = np.full(n, -1)
    inv_c[cols] = np.arange(len(cols))
    keep = (inv_r[src] >= 0) & (inv_c[dst] >= 0)
    xk = inv_r[src[keep]] * len(cols) + inv_c[dst[keep]]
    xr, xc, xv = X_.to_coo()
    if not (np.array_equal(xr.astype(np.int64) * len(cols)
                           + xc.astype(np.int64), xk)
            and np.array_equal(xv, pv[keep])):
        fail("complex_udt: UDT extract by index lists differs from numpy")
    C = P.dup()
    sub = Q[rows, cols].new()
    C[rows, cols] = sub
    region = np.isin(src, rows) & np.isin(dst, cols)
    qs, qd = qkeys // n, qkeys % n
    qin = np.isin(qs, rows) & np.isin(qd, cols)
    ck = np.concatenate([keys[~region], qkeys[qin]])
    cv = np.concatenate([pv[~region], qv[qin]])
    o = np.argsort(ck)
    k, v = _keys(C, n)
    if not (np.array_equal(k, ck[o]) and np.array_equal(v, cv[o])):
        fail("complex_udt: UDT assign by index lists differs from numpy")
    del C[rows, cols]
    k, v = _keys(C, n)
    if not (np.array_equal(k, keys[~region])
            and np.array_equal(v, pv[~region])):
        fail("complex_udt: UDT delete differs from numpy")
    G = P.dup()
    G.clear()
    G(Q.S) << P
    k, v = _keys(G, n)
    if not (np.array_equal(k, both) and np.array_equal(v, pv[ia])):
        fail("complex_udt: UDT structural-mask write differs from numpy")
    r_, c_, v_ = P.to_coo()
    P2 = gb.Matrix.from_coo(r_, c_, v_, dtype=pt, nrows=n, ncols=n)
    if not P2.isequal(P, check_dtype=True) or v_.dtype != pt.np_type:
        fail("complex_udt: UDT to_coo round trip differs")
    v3 = gb.dtypes.register_anonymous(np.dtype("(3,)float32"), "vec3_t")
    a3 = urng.integers(-9, 9, (n, 3)).astype(np.float32)
    b_idx = np.sort(urng.choice(n, n // 2, replace=False))
    b3 = urng.integers(-9, 9, (len(b_idx), 3)).astype(np.float32)
    wa = gb.Vector.from_coo(np.arange(n), a3, dtype=v3, size=n)
    wb = gb.Vector.from_coo(b_idx, b3, dtype=v3, size=n)
    vadd = gb.binary.register_anonymous(lambda a, b: a + 2 * b,
                                        name="vec3_add", is_udt=True)
    ws = wa.ewise_add(wb, vadd).new()
    e3 = a3.copy()
    e3[b_idx] = a3[b_idx] + 2 * b3
    si, sv = ws.to_coo()
    if not (np.array_equal(si.astype(np.int64), np.arange(n))
            and sv.shape == (n, 3) and np.array_equal(sv, e3)):
        fail("complex_udt: the (3,)float32 vector's ewise_add differs")
    _no_launch(K, before, "the user-defined types")
    log("  point_t ewise_add/ewise_mult/apply, the monoid's row reduce, "
        "extract, assign, delete, the structural mask, to_coo and the "
        "(3,)float32 vector: exact, no kernel launched")
    del E, Mu, F, S, X_, C, sub, G, P2, wa, wb, ws

    # ---- 5. interchange of FC64 and point_t
    before = dict(K.launches)
    blk = np.arange(min(CU_MINPLUS_N, n))
    for tag, M, dt in (("fc64", Z64, None), ("point_t", P, pt)):
        kw = {} if dt is None else {"dtype": dt}
        blob = M.ss.serialize()
        back = gb.Matrix.ss.deserialize(blob, **kw)
        pk = pickle.loads(pickle.dumps(M))
        csr = gb.Matrix.ss.import_csr(**M.ss.export("csr"), **kw)
        Mb = M[blk, blk].new()
        bm = gb.Matrix.ss.import_bitmapr(**Mb.ss.export("bitmapr"), **kw)
        for what, got, want in (("serialize", back, M), ("pickle", pk, M),
                                ("csr", csr, M), ("bitmapr", bm, Mb)):
            if not got.isequal(want, check_dtype=True):
                fail(f"complex_udt: {tag} {what} round trip differs")
        log(f"  {tag}: serialize ({blob.nbytes} bytes), pickle, csr and "
            f"bitmapr round trips equal")
        del blob, back, pk, csr, Mb, bm
    rs, rd, rn = build_rmat(12)
    low = rs > rd
    lk = np.unique(rs[low] * rn + rd[low])
    lr, lc = lk // rn, lk % rn
    hrng = np.random.default_rng(SEED + 20)
    lv = hrng.uniform(-1, 1, len(lk)) + 1j * hrng.uniform(-1, 1, len(lk))
    dv = hrng.uniform(-1, 1, rn)
    lines = ["%%MatrixMarket matrix coordinate complex hermitian",
             f"{rn} {rn} {len(lk) + rn}"]
    lines += [f"{i + 1} {i + 1} {float(dv[i])!r} 0" for i in range(rn)]
    lines += [f"{a + 1} {b + 1} {float(z.real)!r} {float(z.imag)!r}"
              for a, b, z in zip(lr, lc, lv)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hermitian.mtx")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        H = timed_calls(torch, lambda: gb.io.mmread(path), reps=1)[0]
        path2 = os.path.join(tmp, "fc64.mtx")
        gb.io.mmwrite(path2, H)
        H2 = gb.io.mmread(path2)
    hk = np.concatenate([np.arange(rn) * (rn + 1), lk, lc * rn + lr])
    hv = np.concatenate([dv.astype(np.complex128), lv, np.conj(lv)])
    o = np.argsort(hk)
    k, v = _keys(H, rn)
    if H.dtype.name != "FC64" or not np.array_equal(k, hk[o]) or \
            not np.array_equal(v, hv[o]):
        fail("complex_udt: the hermitian Matrix Market file reads wrong")
    if not H2.isequal(H, check_dtype=True):
        fail("complex_udt: the FC64 Matrix Market round trip differs")
    _no_launch(K, before, "the interchange")
    log(f"  Matrix Market: hermitian RMAT 12 ({len(k)} entries) exact, "
        f"FC64 round trip equal")
    out["launches"] = check_launches(K, "complex_udt", totals, need=KERNELS)
    results["complex_udt"] = out


PHASES = ("kernels", "tropical", "pagerank_zipf", "bfs", "pagerank_rmat",
          "sssp", "reduce", "hypersparse", "sparse_algorithms", "apsp",
          "index", "positional_agg", "operators", "infix", "ss_io",
          "complex_udt")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the full results and the "
                    "compiler's register report")
    ap.add_argument("--phases", default="all", help="comma-separated subset "
                    f"of {','.join(PHASES)}; a partial run checks what it "
                    "runs and prints no ok line")
    args = ap.parse_args()
    phases = PHASES if args.phases == "all" else tuple(args.phases.split(","))
    if set(phases) - set(PHASES):
        ap.error(f"unknown phase in {args.phases!r}")
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
    log(f"build: native {native_s:.2f} s, CUDA kernels {cuda_s:.2f} s "
        f"{ {k: round(v, 1) for k, v in K.build_secs.items()} }")
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
        if "kernels" in phases:
            log("phase: kernels")
            kernel_phase(gb, torch, torch.device("cuda"), A, Ab, results)
        if "tropical" in phases:
            log("phase: tropical")
            tropical_phase(gb, torch, torch.device("cuda"), results)
        if "pagerank_zipf" in phases:
            log("phase: pagerank zipf")
            pagerank_phase(gb, torch, K, src, dst, n, A, "zipf", 20, results,
                           totals)
        if "bfs" in phases:
            log("phase: bfs zipf")
            bfs_phase(gb, torch, K, src, dst, n, Ab, results, totals)
        if "pagerank_rmat" in phases:
            log("phase: pagerank rmat")
            rs, rd, rn = build_rmat(17)
            routdeg = np.bincount(rs, minlength=rn).astype(np.float32)
            rw = (1.0 / routdeg[rs]).astype(np.float32)
            R = gb.Matrix.from_coo(rs, rd, rw, dtype="FP32", nrows=rn, ncols=rn)
            pagerank_phase(gb, torch, K, rs, rd, rn, R, "rmat", 20, results,
                           totals)
            del R
        if "sssp" in phases:
            log("phase: sssp zipf")
            sssp_phase(gb, torch, K, src, dst, w, n, A, results, totals)
        if "reduce" in phases:
            log("phase: reduce zipf")
            reduce_phase(gb, torch, K, src, dst, w, n, A, Ab, results, totals)
        if "ss_io" in phases:
            log("phase: ss_io")
            ss_io_phase(gb, torch, K, src, dst, w, n, A, Ab, results, totals)
        if "complex_udt" in phases:
            log("phase: complex_udt")
            complex_udt_phase(gb, torch, K, src, dst, w, n, A, results,
                              totals)
        del A, Ab
        if "hypersparse" in phases:
            log("phase: hypersparse")
            hypersparse_phase(gb, torch, K, torch.device("cuda"), results,
                              totals)
        if "sparse_algorithms" in phases:
            log("phase: sparse algorithms")
            sparse_algorithms_phase(gb, torch, K, src, dst, n, results,
                                    totals)

        if "apsp" in phases:
            log("phase: apsp")
            apsp_phase(gb, torch, K, results, totals)

        if "index" in phases:
            log("phase: index")
            index_phase(gb, torch, K, src, dst, w, n, results, totals)

        if "positional_agg" in phases:
            log("phase: positional_agg")
            positional_agg_phase(gb, torch, K, src, dst, n, results, totals)

        if "operators" in phases:
            log("phase: operators")
            operators_phase(gb, torch, K, src, dst, n, results, totals)

        if "infix" in phases:
            log("phase: infix")
            infix_phase(gb, torch, K, src, dst, w, n, results, totals)

    kernels = []
    for name, row in results.get("kernels", {}).items():
        row["launches"] = totals.get(name, 0)
        kernels.append(row)
    results["wall_s"] = time.perf_counter() - t_start
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(results, f, indent=1)
    log(f"wall {results['wall_s']:.1f} s")
    log(f"gpu: {gpu_line()}")
    print(json.dumps({"kernels": kernels}), flush=True)
    if phases != PHASES:
        log(f"partial run ({','.join(phases)}): no verdict")
        return
    never = [k["name"] for k in kernels if k["launches"] == 0]
    if len(kernels) != len(KERNELS) or never:
        fail(f"kernels missing from the line or never launched: {never}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
