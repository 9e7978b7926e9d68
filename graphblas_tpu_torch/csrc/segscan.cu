// K6: flat inclusive segmented scan over L elements, several channels, each
// with its own combine.
//
// Replaces graphblas_tpu/core/engine/sortpipe.py:_segscan_pallas.  A
// segment starts where `barrier` is set (and at element 0, whether set or
// not); out[i] = combine(out[i-1], x[i]) inside a segment.  Up to MAXCH
// 32-bit channels share the barrier; each channel's combine is `first`
// (keep the left operand: a fill-forward), or a monoid on its carrier type
// (integer plus for the count channel).  `combine(left, right)` is applied
// in that order everywhere, so combines need not commute.
//
// Bound: bytes.  The function reads the barrier and each channel once and
// writes each channel once: 1 + 2 nv words per element.
//
// The carry.  The Pallas kernel walks the (256,128) blocks in order with a
// scalar carry.  Blocks on the GPU run in no order, and a segment has no
// length limit (on the zipf graph's reduce, 59% of the elements lie in
// segments over 64 tiles long), so the scan is one pass with a decoupled
// look-back (Merrill and Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", NVIDIA NVR-2016-002), adapted to segments.  One
// launch per group of channels, one tile of 4096 elements per block:
//   1. thread 0 takes the next tile from an atomic counter, so a block
//      only ever waits on tiles that running blocks have claimed;
//   2. 256 data threads load the tile once, each 4 groups of 4 consecutive
//      elements (every warp load and store is 512 contiguous bytes), and
//      scan it in registers, by warp shuffles and shared memory;
//   3. data thread 0 publishes the tile's aggregate, the fold from its last
//      barrier (or its first element).  A tile that holds a barrier, and
//      tile 0, know their inclusive prefix already: it is the aggregate,
//      published as such;
//   4. meanwhile a 9th warp looks back, unless the tile's first element
//      starts a segment: it reads 32 predecessors at a time, up to the
//      nearest one that has published its inclusive prefix (every tile
//      holding a barrier has), and folds that prefix and the aggregates
//      after it one at a time from the oldest, so that FP32 sums do not
//      depend on the timing.  It publishes the tile's inclusive prefix;
//   5. the data threads combine that carry into the elements before the
//      tile's first barrier and write each output once.
// A published value shares a 64-bit word with its flag, stored and loaded
// whole, so no fence orders them.  The words and the counter start at zero:
// the entry point clears them (one memset) before each launch.
//
// The combines are template arguments: the (monoid, count) pairs that row
// folds meet and the (first, first) fill run them inline; every other
// channel tuple reads its ops at run time through one out-of-line body,
// which keeps the build to seconds.
//
// The fold order differs from the Pallas kernel's roll tree: FP32
// plus/times agree to rounding, the rest exactly; every run gives the same
// bits.
#include <type_traits>

#include "common.cuh"

#define SEG_BLOCK 4096   // elements per tile; n is a multiple of it
#define SP_THREADS 256   // data threads of a block of the single pass
#define SP_GROUPS (SEG_BLOCK / (4 * SP_THREADS))  // groups of 4 a thread
#define CC_FIRST 255     // combine code: keep the left operand
#define FULL 0xffffffffu

// Flat combine ops.  The entry point maps (carrier type, monoid) onto
// them.
enum SegOp {
  SO_FIRST, SO_ADD, SO_MUL, SO_AND, SO_OR, SO_MIN_I, SO_MAX_I, SO_MIN_U,
  SO_MAX_U, SO_ADD_F, SO_MUL_F, SO_MIN_F, SO_MAX_F, SO_XOR, SO_XNOR_B,
  SO_INVALID,
  SO_DYN  // the op is read at run time from SegChans::cc
};

struct SegChans {
  const uint32_t* in[MAXCH];
  uint32_t* out[MAXCH];
  int cc[MAXCH];  // a SegOp per channel
};

static int seg_op(int code) {
  if (code == CC_FIRST) return SO_FIRST;
  const int dt = code >> 4, mo = code & 15;
  if (dt == DT_F32) {
    switch (mo) {
      case MO_PLUS: return SO_ADD_F;
      case MO_TIMES: return SO_MUL_F;
      case MO_MIN: return SO_MIN_F;
      case MO_MAX: return SO_MAX_F;
    }
    return SO_INVALID;
  }
  if (dt != DT_I32 && dt != DT_U32 && dt != DT_BOOL) return SO_INVALID;
  switch (mo) {
    case MO_PLUS: return SO_ADD;
    case MO_TIMES: case MO_LAND: return SO_MUL;  // booleans ride as 0/1
    case MO_BAND: return SO_AND;
    case MO_BOR: return SO_OR;
    case MO_BXOR: case MO_LXOR: return SO_XOR;
    case MO_LXNOR: return SO_XNOR_B;  // booleans ride as 0/1
    case MO_LOR: return SO_MAX_U;
    case MO_MIN: return dt == DT_U32 ? SO_MIN_U : SO_MIN_I;
    case MO_MAX: return dt == DT_U32 ? SO_MAX_U : SO_MAX_I;
  }
  return SO_INVALID;
}

// combine(left, right) of one channel with its op read at run time.  Not
// inlined: the scans below call it at some eighty unrolled sites per
// kernel, and one shared body keeps the build to seconds (a switch
// inlined at every site kept nvcc busy for over ten minutes).
__device__ __noinline__ uint32_t comb(int op, uint32_t x, uint32_t y) {
  switch (op) {
    case SO_FIRST: return x;
    case SO_ADD: return x + y;
    case SO_MUL: return x * y;
    case SO_AND: return x & y;
    case SO_OR: return x | y;
    case SO_MIN_I: return (int)x < (int)y ? x : y;
    case SO_MAX_I: return (int)x > (int)y ? x : y;
    case SO_MIN_U: return x < y ? x : y;
    case SO_MAX_U: return x > y ? x : y;
    case SO_ADD_F: return f_bits(as_f(x) + as_f(y));
    case SO_MUL_F: return f_bits(as_f(x) * as_f(y));
    case SO_MIN_F: return f_bits(fmin_nan(as_f(x), as_f(y)));
    case SO_MAX_F: return f_bits(fmax_nan(as_f(x), as_f(y)));
    case SO_XOR: return x ^ y;
    case SO_XNOR_B: return (x ^ y) ^ 1u;
  }
  return y;
}

// combine(left, right) with the op OP known when the kernel is compiled,
// inlined; SO_DYN calls the shared body above with the run-time op dyn.
template <int OP>
__device__ __forceinline__ uint32_t comb_t(int dyn, uint32_t x, uint32_t y) {
  if constexpr (OP == SO_DYN) return comb(dyn, x, y);
  else if constexpr (OP == SO_FIRST) return x;
  else if constexpr (OP == SO_ADD) return x + y;
  else if constexpr (OP == SO_MUL) return x * y;
  else if constexpr (OP == SO_AND) return x & y;
  else if constexpr (OP == SO_OR) return x | y;
  else if constexpr (OP == SO_MIN_I) return (int)x < (int)y ? x : y;
  else if constexpr (OP == SO_MAX_I) return (int)x > (int)y ? x : y;
  else if constexpr (OP == SO_MIN_U) return x < y ? x : y;
  else if constexpr (OP == SO_MAX_U) return x > y ? x : y;
  else if constexpr (OP == SO_ADD_F) return f_bits(as_f(x) + as_f(y));
  else if constexpr (OP == SO_MUL_F) return f_bits(as_f(x) * as_f(y));
  else if constexpr (OP == SO_MIN_F) return f_bits(fmin_nan(as_f(x), as_f(y)));
  else if constexpr (OP == SO_MAX_F) return f_bits(fmax_nan(as_f(x), as_f(y)));
  else if constexpr (OP == SO_XOR) return x ^ y;
  else return (x ^ y) ^ 1u;
}

// The combines of a launch's channels, one template argument each.  The
// channel index c is a constant once the channel loops are unrolled, so
// the switch folds away and every site runs one op inline.
template <int O0, int O1 = SO_DYN, int O2 = SO_DYN, int O3 = SO_DYN>
struct Ops {
  __device__ static __forceinline__ uint32_t comb(const int* cc, int c,
                                                  uint32_t x, uint32_t y) {
    switch (c) {
      case 0: return comb_t<O0>(cc[0], x, y);
      case 1: return comb_t<O1>(cc[1], x, y);
      case 2: return comb_t<O2>(cc[2], x, y);
      default: return comb_t<O3>(cc[3], x, y);
    }
  }
};
using DynOps = Ops<SO_DYN>;

// The barrier of the block's first 32 NW threads, the data warps (named
// barrier 1: the look-back warp does not take part).
template <int NW>
__device__ __forceinline__ void data_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(32 * NW) : "memory");
}

// Segmented scan over a block of NW warps in which each thread holds G
// items, item (g, thread) at position g * 32 NW + thread.  In: f[g], v[g]
// = the item's own flag and values.  Out: f[g], v[g] = the inclusive scan
// through the item; (ex_has, ex_f, ex_v)[g] = the scan through the item
// before it (ex_has false for the first); sw[G NW - 1] the scan through
// the whole block.  One warp scans the G NW warp totals, 32 at a time.
// sw: G * NW * (NV + 1) words.
template <class OPS, int NV, int NW, int G>
__device__ __forceinline__ void block_scan(const int* cc, int* f,
                                           uint32_t (*v)[NV], bool* ex_has,
                                           int* ex_f, uint32_t (*ex_v)[NV],
                                           uint32_t* sw) {
  constexpr int E = NW * G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < G; g++) {
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int pf = __shfl_up_sync(FULL, f[g], s);
#pragma unroll
      for (int c = 0; c < NV; c++) {
        const uint32_t pv = __shfl_up_sync(FULL, v[g][c], s);
        if (lane >= s && !f[g]) v[g][c] = OPS::comb(cc, c, pv, v[g][c]);
      }
      if (lane >= s) f[g] |= pf;
    }
  }
  data_sync<NW>();  // sw may still be read from an earlier call
  if (lane == 31) {
#pragma unroll
    for (int g = 0; g < G; g++) {
      uint32_t* e = sw + (g * NW + warp) * (NV + 1);
      e[0] = (uint32_t)f[g];
#pragma unroll
      for (int c = 0; c < NV; c++) e[1 + c] = v[g][c];
    }
  }
  data_sync<NW>();
  if (warp == 0) {  // scan the E totals, 32 at a time with a carry
    int cf = 0;
    uint32_t cv[NV];
#pragma unroll
    for (int r = 0; r < E; r += 32) {
      // lanes past the last total sit after every live one: a flag keeps
      // them inert
      const int i = r + lane;
      int wf = i < E ? (int)sw[i * (NV + 1)] : 1;
      uint32_t wv[NV];
#pragma unroll
      for (int c = 0; c < NV; c++) wv[c] = i < E ? sw[i * (NV + 1) + 1 + c] : 0u;
#pragma unroll
      for (int s = 1; s < 32 && s < E; s <<= 1) {
        const int pf = __shfl_up_sync(FULL, wf, s);
#pragma unroll
        for (int c = 0; c < NV; c++) {
          const uint32_t pv = __shfl_up_sync(FULL, wv[c], s);
          if (lane >= s && !wf) wv[c] = OPS::comb(cc, c, pv, wv[c]);
        }
        if (lane >= s) wf |= pf;
      }
      if (r > 0) {
#pragma unroll
        for (int c = 0; c < NV; c++)
          if (!wf) wv[c] = OPS::comb(cc, c, cv[c], wv[c]);
        wf |= cf;
      }
      if (i < E) {
        sw[i * (NV + 1)] = (uint32_t)wf;
#pragma unroll
        for (int c = 0; c < NV; c++) sw[i * (NV + 1) + 1 + c] = wv[c];
      }
      cf = __shfl_sync(FULL, wf, 31);
#pragma unroll
      for (int c = 0; c < NV; c++) cv[c] = __shfl_sync(FULL, wv[c], 31);
    }
  }
  data_sync<NW>();
#pragma unroll
  for (int g = 0; g < G; g++) {
    const int e = g * NW + warp;  // this warp's total among the E
    const uint32_t* prev = sw + (e - 1) * (NV + 1);
    if (e > 0) {  // fold the totals before this warp's in
#pragma unroll
      for (int c = 0; c < NV; c++)
        if (!f[g]) v[g][c] = OPS::comb(cc, c, prev[1 + c], v[g][c]);
      f[g] |= (int)prev[0];
    }
    // the scan through the previous item
    ex_f[g] = __shfl_up_sync(FULL, f[g], 1);
#pragma unroll
    for (int c = 0; c < NV; c++) ex_v[g][c] = __shfl_up_sync(FULL, v[g][c], 1);
    ex_has[g] = e > 0 || lane > 0;
    if (lane == 0 && e > 0) {
      ex_f[g] = (int)prev[0];
#pragma unroll
      for (int c = 0; c < NV; c++) ex_v[g][c] = prev[1 + c];
    }
  }
}

// A thread's 4 consecutive elements as loaded: the barrier words and each
// channel's values, 16 bytes each.  Nothing reads them until scan_items,
// so the loads of a tile stay in flight while the tile before it is
// scanned.
template <int NV>
struct Items {
  int4 b;
  uint4 x[NV];
};

template <int NV>
__device__ __forceinline__ void load_items(const SegChans& ch,
                                           const int* __restrict__ barrier,
                                           size_t e0, Items<NV>& it) {
  it.b = *reinterpret_cast<const int4*>(barrier + e0);
#pragma unroll
  for (int c = 0; c < NV; c++)
    it.x[c] = *reinterpret_cast<const uint4*>(ch.in[c] + e0);
}

// The thread's elements: local inclusive scan in x, the fold from its last
// barrier (or its first element) in v, whether it has a barrier in f, and
// the index of its first barrier (4 if none) in first.
template <class OPS, int NV>
__device__ __forceinline__ void scan_items(const int* cc, const Items<NV>& it,
                                           uint32_t (*x)[4], uint32_t* v,
                                           int& f, int& first) {
  const int b[4] = {it.b.x, it.b.y, it.b.z, it.b.w};
  first = 4;
#pragma unroll
  for (int k = 3; k >= 0; k--)
    if (b[k] != 0) first = k;
  f = first < 4;
#pragma unroll
  for (int c = 0; c < NV; c++) {
    x[c][0] = it.x[c].x; x[c][1] = it.x[c].y;
    x[c][2] = it.x[c].z; x[c][3] = it.x[c].w;
#pragma unroll
    for (int k = 1; k < 4; k++)
      if (b[k] == 0) x[c][k] = OPS::comb(cc, c, x[c][k - 1], x[c][k]);
    v[c] = x[c][3];
  }
}

// Combine the prefix entering the thread (the block's carry, if cin, then
// the threads before it) into its elements before its first barrier, and
// store them.
template <class OPS, int NV>
__device__ __forceinline__ void apply_store(const SegChans& ch, size_t e0,
                                            uint32_t (*x)[4], int first,
                                            bool ex_has, int ex_f,
                                            const uint32_t* ex_v, bool cin,
                                            const uint32_t* carry) {
#pragma unroll
  for (int c = 0; c < NV; c++) {
    uint32_t pre = ex_v[c];
    bool have = ex_has;
    if (cin && !(ex_has && ex_f)) {
      pre = ex_has ? OPS::comb(ch.cc, c, carry[c], pre) : carry[c];
      have = true;
    }
    uint4 o;
    uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int k = 0; k < 4; k++)
      op[k] = (have && k < first) ? OPS::comb(ch.cc, c, pre, x[c][k]) : x[c][k];
    *reinterpret_cast<uint4*>(ch.out[c] + e0) = o;
  }
}

// ---------------------------------------------------------------------- //
// the single pass

enum { ST_AGG = 1, ST_PRE = 2 };  // status of a tile; 0: nothing yet

// Publish a tile's values (its aggregate or its inclusive prefix), one
// word per channel, each a word of st_word (common.cuh) with flag 1: each
// tile has one word per channel for its aggregate and one for its
// inclusive prefix.  One thread.
template <int NV>
__device__ __forceinline__ void publish(unsigned long long* dst, int ntiles,
                                        int tile, const uint32_t* v) {
#pragma unroll
  for (int c = 0; c < NV; c++) st_word(dst + (size_t)c * ntiles + tile, v[c], 1);
}

// One window of 32 predecessors of a tile, lane l taking tile base - l:
// waits until every tile nearer than the nearest one with a published
// prefix has published its aggregate (with `prefix`, until the window
// holds such a tile too), and leaves each lane's value (its prefix, else
// its aggregate) in w.  A tile's prefix counts once the words of all its
// channels carry it.  Returns the lane of the nearest prefix, or 32 if
// there is none.  Tiles before 0 act as prefixes and hold nothing.
template <int NV>
__device__ __forceinline__ int window(const unsigned long long* agg,
                                      const unsigned long long* pre,
                                      int ntiles, int base, bool prefix,
                                      uint32_t* w) {
  const int lane = threadIdx.x & 31;
  const int t = base - lane;
  unsigned st, pre_m;
  for (int spins = 0;; spins++) {
    st = ST_PRE;
    if (t >= 0) {
      unsigned long long pw[NV], aw[NV];
      bool all_p = true, all_a = true;
#pragma unroll
      for (int c = 0; c < NV; c++) {
        pw[c] = ld_word(pre + (size_t)c * ntiles + t);
        aw[c] = ld_word(agg + (size_t)c * ntiles + t);
      }
#pragma unroll
      for (int c = 0; c < NV; c++) {
        all_p &= (pw[c] & 1) != 0;
        all_a &= (aw[c] & 1) != 0;
      }
      st = all_p ? ST_PRE : all_a ? ST_AGG : 0;
#pragma unroll
      for (int c = 0; c < NV; c++) w[c] = (uint32_t)((all_p ? pw[c] : aw[c]) >> 32);
    }
    pre_m = __ballot_sync(FULL, st == ST_PRE);
    const unsigned wait_m = __ballot_sync(FULL, st == 0);
    if (!(wait_m & ((pre_m & (0u - pre_m)) - 1u)) && (pre_m || !prefix))
      break;
    // a claimed tile publishes within microseconds: fail, never hang
    if (spins == 1 << 26) __trap();
  }
  return pre_m ? __ffs(pre_m) - 1 : 32;
}

// The inclusive prefix of tile - 1, in every lane of the calling warp: the
// published prefix of the nearest predecessor that has one (every tile
// holding a barrier has), then the aggregates of the tiles after it,
// folded one at a time from the oldest.  These are the operations, in the
// order, of the chain prefix(t) = prefix(t - 1) + aggregate(t), so the
// result does not depend on which prefixes were published in time, and
// FP32 sums come out the same bits on every run.  It looks at most 64
// tiles back: without a prefix among the nearest 32 it waits for one among
// the 32 before them.
template <class OPS, int NV>
__device__ __forceinline__ void look_back(const int* cc,
                                          const unsigned long long* agg,
                                          const unsigned long long* pre,
                                          int ntiles, int tile, uint32_t* run) {
  uint32_t w[NV], near[NV];
  int stop = window<NV>(agg, pre, ntiles, tile - 1, false, w);
  const bool two = stop == 32;
  if (two) {
#pragma unroll
    for (int c = 0; c < NV; c++) near[c] = w[c];
    stop = window<NV>(agg, pre, ntiles, tile - 33, true, w);
  }
#pragma unroll
  for (int c = 0; c < NV; c++) run[c] = __shfl_sync(FULL, w[c], stop);
  for (int l = stop - 1; l >= 0; l--) {
#pragma unroll
    for (int c = 0; c < NV; c++)
      run[c] = OPS::comb(cc, c, run[c], __shfl_sync(FULL, w[c], l));
  }
  if (two) {
    for (int l = 31; l >= 0; l--) {
#pragma unroll
      for (int c = 0; c < NV; c++)
        run[c] = OPS::comb(cc, c, run[c], __shfl_sync(FULL, near[c], l));
    }
  }
}

// The single pass: a block of SP_THREADS data threads, each holding
// SP_GROUPS groups of 4 consecutive elements (group g of thread t at
// 4 (g SP_THREADS + t) in the tile), and one look-back warp, which starts
// as soon as the tile is claimed (it reads the tile's first barrier word
// itself).  The data warps synchronise among themselves (named barrier 1)
// until both halves meet before the stores; the tile's aggregate is
// published without waiting on anything.
template <class OPS, int NV>
__global__ void __launch_bounds__(SP_THREADS + 32) segscan_kernel(
    SegChans ch, const int* __restrict__ barrier, unsigned* counter,
    unsigned long long* agg, unsigned long long* pre, int ntiles) {
  constexpr int NW = SP_THREADS / 32, G = SP_GROUPS;
  __shared__ uint32_t sw[G * NW * (NV + 1)];
  __shared__ uint32_t carry[NV];
  __shared__ int s_tile, s_cin;
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const int tile = s_tile;
  const size_t base = (size_t)tile * SEG_BLOCK;
  const uint32_t* tot = sw + (G * NW - 1) * (NV + 1);  // the tile's fold
  if (threadIdx.x >= SP_THREADS) {  // the look-back warp
    const bool cin = tile > 0 && barrier[base] == 0;
    uint32_t run[NV];
    if (cin) look_back<OPS, NV>(ch.cc, agg, pre, ntiles, tile, run);
    if (threadIdx.x == SP_THREADS) {
      s_cin = cin;
#pragma unroll
      for (int c = 0; c < NV; c++) carry[c] = run[c];
    }
    __syncthreads();  // meets the data warps: the tile's fold is in sw
    if (threadIdx.x == SP_THREADS && cin && tot[0] == 0) {
      uint32_t incl[NV];
#pragma unroll
      for (int c = 0; c < NV; c++)
        incl[c] = OPS::comb(ch.cc, c, run[c], tot[1 + c]);
      publish<NV>(pre, ntiles, tile, incl);
    }
    return;
  }
  const size_t e0 = base + 4 * threadIdx.x;
  Items<NV> items[G];
#pragma unroll
  for (int g = 0; g < G; g++)
    load_items<NV>(ch, barrier, e0 + 4 * SP_THREADS * g, items[g]);
  uint32_t x[G][NV][4], v[G][NV], ex_v[G][NV];
  int f[G], first[G], ex_f[G];
  bool ex_has[G];
#pragma unroll
  for (int g = 0; g < G; g++)
    scan_items<OPS, NV>(ch.cc, items[g], x[g], v[g], f[g], first[g]);
  block_scan<OPS, NV, NW, G>(ch.cc, f, v, ex_has, ex_f, ex_v, sw);
  if (threadIdx.x == 0)
    publish<NV>(tile == 0 || tot[0] != 0 ? pre : agg, ntiles, tile, tot + 1);
  __syncthreads();  // meets the look-back warp: the carry is in shared memory
#pragma unroll
  for (int g = 0; g < G; g++)
    apply_store<OPS, NV>(ch, e0 + 4 * SP_THREADS * g, x[g], first[g],
                         ex_has[g], ex_f[g], ex_v[g], s_cin != 0, carry);
}

// ---------------------------------------------------------------------- //
// entry points

// Calls run(Ops<...>{}, std::integral_constant<int, NV>{}) with the
// inline combines of the channel tuples the main paths use: the (monoid,
// count) pairs of row folds (plus, min, max on FP32, lor, integer plus)
// and the (first, first) fill; every other tuple reads its ops at run time.
template <class F>
static void dispatch(const SegChans& ch, int nv, F&& run) {
  using Two = std::integral_constant<int, 2>;
  const int a = ch.cc[0], b = nv == 2 ? ch.cc[1] : -1;
  if (b == SO_ADD && a == SO_ADD_F) run(Ops<SO_ADD_F, SO_ADD>{}, Two{});
  else if (b == SO_ADD && a == SO_MIN_F) run(Ops<SO_MIN_F, SO_ADD>{}, Two{});
  else if (b == SO_ADD && a == SO_MAX_F) run(Ops<SO_MAX_F, SO_ADD>{}, Two{});
  else if (b == SO_ADD && a == SO_MAX_U) run(Ops<SO_MAX_U, SO_ADD>{}, Two{});
  else if (b == SO_ADD && a == SO_ADD) run(Ops<SO_ADD, SO_ADD>{}, Two{});
  else if (b == SO_FIRST && a == SO_FIRST) run(Ops<SO_FIRST, SO_FIRST>{}, Two{});
  else if (nv == 1) run(DynOps{}, std::integral_constant<int, 1>{});
  else if (nv == 2) run(DynOps{}, Two{});
  else if (nv == 3) run(DynOps{}, std::integral_constant<int, 3>{});
  else run(DynOps{}, std::integral_constant<int, 4>{});
}

static int channels(SegChans& ch, void** ins, void** outs, const int* codes,
                    int nv, int n) {
  if (nv < 1 || nv > MAXCH || n % SEG_BLOCK) return (int)cudaErrorInvalidValue;
  for (int c = 0; c < MAXCH; c++) {
    ch.in[c] = c < nv ? (const uint32_t*)ins[c] : nullptr;
    ch.out[c] = c < nv ? (uint32_t*)outs[c] : nullptr;
    ch.cc[c] = c < nv ? seg_op(codes[c]) : SO_FIRST;
    if (ch.cc[c] == SO_INVALID) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// One launch (and one memset of its scratch).  n must be a multiple of
// 4096; scratch holds 4 nv (n / 4096) + 1 words: per tile and channel a
// word for its aggregate and one for its inclusive prefix, then the tile
// counter.
extern "C" int segscan(const void* barrier, void** ins, void** outs,
                       const int* codes, int nv, void* scratch, int n,
                       void* stream) {
  SegChans ch;
  const int rc = channels(ch, ins, outs, codes, nv, n);
  if (rc) return rc;
  const int ntiles = n / SEG_BLOCK;
  if (ntiles == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* agg = (unsigned long long*)scratch;
  unsigned long long* pre = agg + (size_t)nv * ntiles;
  unsigned* counter = (unsigned*)(pre + (size_t)nv * ntiles);
  cudaMemsetAsync(scratch, 0, 16 * (size_t)nv * ntiles + 4, st);
  dispatch(ch, nv, [&](auto ops, auto k) {
    segscan_kernel<decltype(ops), decltype(k)::value>
        <<<ntiles, SP_THREADS + 32, 0, st>>>(ch, (const int*)barrier, counter,
                                             agg, pre, ntiles);
  });
  return (int)cudaGetLastError();
}
