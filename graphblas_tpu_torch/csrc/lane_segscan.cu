// K5: per-lane segmented monoid scan down the rows, with an optional
// validity channel; one kernel launch (after one memset of its scratch), a
// single pass.
//
// Replaces graphblas_tpu/core/engine/lanepipe.py:lane_segscan.  All arrays
// are (R,128), R a multiple of 128.  Every lane (column) is scanned down
// the rows with the monoid, restarting where `barrier` is set; row 0 of a
// lane starts a run whether or not its barrier is set.  With `ok` given, a
// second int32 channel is scanned over the same runs with max, for any
// int32 values.  The values may be anything: the sparse-vector branch
// masks them to the identity before the scan, but the kernel does not rely
// on it.
//
// Bound: bytes.  The function reads barrier, values (and ok) once and
// writes values (and ok) once: 5 words a slot with the validity channel, 3
// without; at the zipf plan's R = 33,792, 86.5 MB (0.0258 ms at 3.35 TB/s)
// and 51.9 MB (0.0155 ms).
//
// The design.  One 512-thread block a (128,128) tile.  Nothing is
// permuted, so no tile goes into shared memory: the data stay in registers
// from their load to their store, and shared memory holds only the chunk
// folds and the look-back buffer.  Warp c of the block owns chunk c, rows
// 8c .. 8c + 7 of the tile; its thread g owns lanes 4g .. 4g + 3, so every
// global access is 16 bytes a thread and one 512-byte row a warp (K1's
// layout).
//   1. Thread 0 claims the next tile from an atomic counter, so a block
//      only ever waits on tiles that running blocks have claimed.
//   2. Every input is read once, all of a thread's 24 loads in flight
//      together; the barrier becomes a mask of 8 bits a lane.
//   3. A thread scans its chunk in registers, 4 lanes by 8 rows on each
//      channel.  The 16 chunk folds of a lane meet in shared memory, where
//      a segmented Hillis-Steele scan (4 steps, every thread busy) gives
//      each chunk the fold of the chunks above it back to the nearest
//      barrier, and the tile's aggregate per lane.
//   4. The carry, by a look-back per lane and per channel (K4's, shared
//      in lane_scan.cuh): per tile, channel and lane one 64-bit word
//      holds a value and its status, stored and loaded whole, so no fence
//      orders them.  Thread (channel, lane) publishes the lane's aggregate,
//      as the inclusive prefix where the lane holds a barrier in the tile
//      or the tile is tile 0; a lane whose row 0 has no barrier walks back,
//      8 words loaded at a time, to the nearest published prefix and folds
//      it and the aggregates after it one at a time from the oldest: the
//      chain prefix(t) = prefix(t - 1) + aggregate(t) in its own order, so
//      FP32 sums come out the same bits on every run.  It then publishes
//      the lane's prefix where the lane had none.  A lane reads at most
//      LB_WINDOW words; past that it waits for the prefix of the tile at
//      the window's edge, so any barrier pattern is taken (the lanepipe's
//      runs are at most SPLIT_DEG + 1 = 2049 rows, 17 tiles).  The validity
//      channel has its own words: its values are any int32, so it cannot
//      ride in the status half of the value's word.  A spin that outlasts a
//      claimed tile's publication by orders of magnitude traps.
//   5. The carry is combined into the rows before each chunk's first
//      barrier, and each output is written once.
// The entry point clears the words and the counter with one memset before
// the launch, so a call puts two operations on the stream.
//
// The combines are template arguments for FP32 min (SSSP's sparse-vector
// branch, the main path) and FP32 plus; every other (type, monoid, packed)
// triple goes through one out-of-line combine, which keeps the build to
// seconds.  The validity channel's max is inline.
//
// What limits it (measured on an H100; PERF.md).  A tile's two channels
// fill 128 registers of 512 threads: one block an SM, so the zipf plan's
// 264 tiles run in two waves, and a block's phases run in series (per
// block, median: loads 8 us, scan 5 us, look-back 1 us, carry and stores
// 3 us).  Persistent blocks fed by bulk copies (TMA) overlapped the next
// tile's loads with the scan but came out slower: the look-back then
// waited behind the copies in flight and on the slowest predecessor (up
// to 10 us a tile).
//
// The fold order differs from the Pallas kernel's roll tree: FP32 plus and
// times agree to rounding, everything else exactly.
#include "lane_scan.cuh"

#define LS_RPT 8                  // rows a thread scans, 4 lanes each
#define LS_C (128 / LS_RPT)       // chunks of a tile: the warps of a block
#define LS_NT (32 * LS_C)         // threads of a block

// Lane j of a thread's four (j known when the loops are unrolled).
__device__ __forceinline__ uint32_t& at(uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

template <int OP, bool WITH_H>
__global__ void __launch_bounds__(LS_NT, 1) lane_segscan_kernel(
    const uint4* __restrict__ barrier, const uint4* __restrict__ vals,
    const uint4* __restrict__ ok, uint4* __restrict__ out,
    uint4* __restrict__ outh, unsigned* counter, unsigned long long* words,
    int code) {
  constexpr int NCH = WITH_H ? 2 : 1;
  constexpr int NLB = 128 * NCH;  // look-back threads: one a lane and channel
  constexpr int SCAN_WORDS = LS_C * 128 * NCH + LS_C * 32;
  constexpr int LB_WORDS = LB_WINDOW * NLB;
  // the chunk folds, then (once they are read) the look-back buffer
  __shared__ __align__(16) uint32_t sm[SCAN_WORDS > LB_WORDS ? SCAN_WORDS
                                                              : LB_WORDS];
  uint4* sv = reinterpret_cast<uint4*>(sm);  // [chunk][lane group] values
  uint4* sh = sv + LS_C * 32;                // ok
  uint32_t* sf = sm + LS_C * 128 * NCH;      // barrier bits, lane 4g + j: bit j
  __shared__ uint32_t s_carry[NLB];
  __shared__ uint32_t s_r0[32];  // row 0 of the tile holds a barrier, per lane
  __shared__ int s_tile;
  const int tid = threadIdx.x;
  if (tid == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const int tile = s_tile;
  const int g = tid & 31, c = tid >> 5;
  const size_t q0 = ((size_t)tile * 128 + c * LS_RPT) * 32 + g;

  // 2. every input read once, all in flight together
  uint4 v[LS_RPT], h[LS_RPT];
  uint4 b[LS_RPT];
#pragma unroll
  for (int k = 0; k < LS_RPT; k++) {
    b[k] = __ldg(barrier + q0 + k * 32);
    v[k] = __ldg(vals + q0 + k * 32);
    if (WITH_H) h[k] = __ldg(ok + q0 + k * 32);
  }
  uint32_t bm[4] = {0, 0, 0, 0};  // bit k: row k of the chunk holds a barrier
#pragma unroll
  for (int k = 0; k < LS_RPT; k++)
#pragma unroll
    for (int j = 0; j < 4; j++)
      bm[j] |= (uint32_t)(at(b[k], j) != 0) << k;

  // 3. the chunk's scan in registers
  uint32_t f = 0, r0 = 0;  // bit j: lane 4g + j has a barrier in the chunk, in row 0
#pragma unroll
  for (int j = 0; j < 4; j++) {
#pragma unroll
    for (int k = 1; k < LS_RPT; k++) {
      if (!((bm[j] >> k) & 1)) {
        at(v[k], j) = comb<OP>(code, at(v[k - 1], j), at(v[k], j));
        if (WITH_H) at(h[k], j) = comb<SC_MAX_I>(code, at(h[k - 1], j), at(h[k], j));
      }
    }
    f |= (uint32_t)(bm[j] != 0) << j;
    r0 |= (bm[j] & 1) << j;
  }
  uint4 a = v[LS_RPT - 1], ah = WITH_H ? h[LS_RPT - 1] : make_uint4(0, 0, 0, 0);
  sv[c * 32 + g] = a;
  if (WITH_H) sh[c * 32 + g] = ah;
  sf[c * 32 + g] = f;
  if (c == 0) s_r0[g] = r0;
  __syncthreads();

  //    the chunk folds' segmented scan: chunk c ends up holding the fold of
  //    chunks 0..c back to the nearest barrier, and whether there is one
#pragma unroll
  for (int s = 1; s < LS_C; s <<= 1) {
    uint4 pv = a, ph = ah;
    uint32_t pf = 0;
    const bool use = c >= s;
    if (use) {
      pv = sv[(c - s) * 32 + g];
      if (WITH_H) ph = sh[(c - s) * 32 + g];
      pf = sf[(c - s) * 32 + g];
    }
    __syncthreads();
    if (use) {
#pragma unroll
      for (int j = 0; j < 4; j++) {
        if (!((f >> j) & 1)) {
          at(a, j) = comb<OP>(code, at(pv, j), at(a, j));
          if (WITH_H) at(ah, j) = comb<SC_MAX_I>(code, at(ph, j), at(ah, j));
        }
      }
      f |= pf;
      sv[c * 32 + g] = a;
      if (WITH_H) sh[c * 32 + g] = ah;
      sf[c * 32 + g] = f;
    }
    __syncthreads();
  }
  // the fold of the chunks above this one (none for chunk 0)
  uint4 e = make_uint4(0, 0, 0, 0), eh = e;
  uint32_t ef = 0;
  if (c > 0) {
    e = sv[(c - 1) * 32 + g];
    if (WITH_H) eh = sh[(c - 1) * 32 + g];
    ef = sf[(c - 1) * 32 + g];
  }
  // the tile's aggregate of the look-back thread's lane and channel
  const int ll = tid & 127, ch = tid >> 7;
  uint32_t agg = 0;
  bool has = false;
  if (tid < NLB) {
    agg = sm[(ch * LS_C + LS_C - 1) * 128 + ll];
    has = (sf[(LS_C - 1) * 32 + (ll >> 2)] >> (ll & 3)) & 1;
  }
  __syncthreads();  // the chunk folds are read: the look-back buffer is free

  // 4. publication and look-back, a thread a lane and channel
  if (tid < NLB) {
    const size_t stride = (size_t)NCH * 128;
    unsigned long long* w = words + (size_t)tile * stride + ch * 128 + ll;
    st_word(w, agg, tile == 0 || has ? ST_PRE : ST_AGG);
    const bool in = tile > 0 && !((s_r0[ll >> 2] >> (ll & 3)) & 1);
    uint32_t cy = 0;
    if (in) {
      if (ch == 0) {
        cy = look_back<OP>(code, w, stride, tile, sm + tid, NLB);
        if (!has) st_word(w, comb<OP>(code, cy, agg), ST_PRE);
      } else {
        cy = look_back<SC_MAX_I>(code, w, stride, tile, sm + tid, NLB);
        if (!has) st_word(w, comb<SC_MAX_I>(code, cy, agg), ST_PRE);
      }
    }
    s_carry[tid] = cy;
  }
  __syncthreads();

  // 5. the carry into the rows before the chunk's first barrier; one store
  //    of each output
  r0 = s_r0[g];
#pragma unroll
  for (int j = 0; j < 4; j++) {
    bool have = c > 0;  // the fold of the chunks above
    uint32_t pre = at(e, j), hpre = at(eh, j);
    if (!((ef >> j) & 1) && tile > 0 && !((r0 >> j) & 1)) {
      const uint32_t cy = s_carry[4 * g + j];
      pre = have ? comb<OP>(code, cy, pre) : cy;
      if (WITH_H) {
        const uint32_t hy = s_carry[128 + 4 * g + j];
        hpre = have ? comb<SC_MAX_I>(code, hy, hpre) : hy;
      }
      have = true;
    }
    const uint32_t first = bm[j] ? __ffs(bm[j]) - 1 : LS_RPT;
#pragma unroll
    for (int k = 0; k < LS_RPT; k++) {
      if (have && k < first) {
        at(v[k], j) = comb<OP>(code, pre, at(v[k], j));
        if (WITH_H) at(h[k], j) = comb<SC_MAX_I>(code, hpre, at(h[k], j));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < LS_RPT; k++) {
    out[q0 + k * 32] = v[k];
    if (WITH_H) outh[q0 + k * 32] = h[k];
  }
}

template <int OP, bool WITH_H>
static int launch(int ntiles, cudaStream_t st, const void* bar,
                  const void* vals, const void* ok, void* out, void* outh,
                  unsigned* counter, unsigned long long* words, int code) {
  lane_segscan_kernel<OP, WITH_H><<<ntiles, LS_NT, 0, st>>>(
      (const uint4*)bar, (const uint4*)vals, (const uint4*)ok, (uint4*)out,
      (uint4*)outh, counter, words, code);
  return (int)cudaGetLastError();
}

template <int OP>
static int launch_h(bool with_h, int ntiles, cudaStream_t st, const void* bar,
                    const void* vals, const void* ok, void* out, void* outh,
                    unsigned* counter, unsigned long long* words, int code) {
  return with_h ? launch<OP, true>(ntiles, st, bar, vals, ok, out, outh,
                                   counter, words, code)
                : launch<OP, false>(ntiles, st, bar, vals, ok, out, outh,
                                    counter, words, code);
}

// One kernel launch, after one memset of its scratch.  scratch holds
// 8 * (nch * 128 * ntiles + 1) bytes, nch = 2 with the validity channel
// and 1 without: per tile, channel and lane a published word, then the
// tile counter.  Every array 16-byte aligned; ok and outh are null when the
// validity channel is not scanned.
extern "C" int lane_segscan(const void* barrier, const void* vals,
                            const void* ok, void* scratch, void* out,
                            void* outh, int ntiles, int dt, int mo, int packed,
                            void* stream) {
  if (dt < DT_F32 || dt > DT_BOOL || mo < MO_PLUS || mo > MO_BOR)
    return (int)cudaErrorInvalidValue;
  if (ntiles <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool with_h = ok != nullptr;
  const size_t nw = (size_t)ntiles * (with_h ? 2 : 1) * 128;
  unsigned long long* words = (unsigned long long*)scratch;
  unsigned* counter = (unsigned*)(words + nw);
  cudaError_t err = cudaMemsetAsync(scratch, 0, 8 * (nw + 1), st);
  if (err != cudaSuccess) return (int)err;
  const int code = dt | mo << 4 | (packed ? 1 : 0) << 8;
#define ARGS with_h, ntiles, st, barrier, vals, ok, out, outh, counter, words, code
  if (dt == DT_F32 && mo == MO_MIN && !packed) return launch_h<SC_MIN_F>(ARGS);
  if (dt == DT_F32 && mo == MO_PLUS && !packed) return launch_h<SC_ADD_F>(ARGS);
  return launch_h<SC_DYN>(ARGS);
#undef ARGS
}
