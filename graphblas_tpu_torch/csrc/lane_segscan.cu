// K5: per-lane segmented monoid scan down the rows, with an optional
// validity channel.
//
// Replaces graphblas_tpu/core/engine/lanepipe.py:lane_segscan.  All arrays
// are (R,128), R a multiple of 128.  Every lane (column) is scanned down
// the rows with the monoid, restarting where `barrier` is set; row 0 of a
// lane starts a run whether or not its barrier is set.  With `ok` given, a
// second int32 channel is scanned over the same runs with max.  The values
// may be anything: the sparse-vector branch masks them to the identity
// before the scan, but the kernel does not rely on it.
//
// The carry.  The Pallas kernel carries each lane's running fold through a
// sequential grid; Hopper runs blocks in no fixed order.  Here the carry
// takes two launches over (128,128) tiles (fused_scan.cu, K4, takes it by
// a look-back in one):
//   1. lane_summary: per tile and lane, the fold of the tile's rows from
//      its last barrier (or from its row 0) for each channel, and whether
//      the lane has a barrier in the tile;
//   2. lane_final: per tile and lane, the carry-in is found by walking back
//      over earlier tiles' summaries to the nearest one with a barrier (in
//      the lanepipe's S layout a run is at most SPLIT_DEG + 1 rows, so the
//      walk is at most 17 tiles), then the tile is scanned with it.
// Each launch reads only what the previous one wrote.
//
// Within a tile the 1024 threads split each lane into 8 chunks of 16 rows:
// a thread scans its chunk in registers (a warp reads 32 neighbouring
// lanes of one row: coalesced), the 8 chunk folds of a lane meet in shared
// memory, and a thread picks up the fold of the chunks above it back to
// the nearest barrier.  The fold order differs from the Pallas kernel's
// roll tree: FP32 plus/times agree to rounding, everything else exactly.
//
// Bound: bytes.  The function reads barrier, values (and ok) once and
// writes values (and ok) once: 5 words per slot with the validity channel,
// 3 without.  The two launches read the inputs twice: 8 (5) words moved.
#include "common.cuh"

#define CH_ROWS 16               // rows per thread
#define NCH (128 / CH_ROWS)      // chunks per lane and tile

__device__ __forceinline__ uint32_t imax_bits(uint32_t x, uint32_t y) {
  return (int)x > (int)y ? x : y;
}

template <int DT, bool WITH_H>
__global__ void __launch_bounds__(NT) lane_summary_kernel(
    const int* __restrict__ barrier, const uint32_t* __restrict__ vals,
    const uint32_t* __restrict__ ok, uint32_t* __restrict__ last,
    uint32_t* __restrict__ lasth, int* __restrict__ hasbar, int mo,
    int packed) {
  __shared__ uint32_t sv[NCH][128];
  __shared__ uint32_t sh[NCH][128];
  __shared__ int sf[NCH][128];
  const int l = threadIdx.x & 127;
  const int c = threadIdx.x >> 7;
  const size_t base = (size_t)blockIdx.x * TILE_ELEMS + (size_t)c * CH_ROWS * 128 + l;
  uint32_t acc = 0, hacc = 0;
  int any = 0;
#pragma unroll
  for (int k = 0; k < CH_ROWS; k++) {
    const size_t s = base + (size_t)k * 128;
    const bool b = barrier[s] != 0;
    const uint32_t x = vals[s];
    acc = (k == 0 || b) ? x : combine_any<DT>(mo, packed, acc, x);
    if (WITH_H) {
      const uint32_t h = ok[s];
      hacc = (k == 0 || b) ? h : imax_bits(hacc, h);
    }
    any |= b;
  }
  sv[c][l] = acc;
  if (WITH_H) sh[c][l] = hacc;
  sf[c][l] = any;
  __syncthreads();
  if (c == 0) {
    for (int j = 1; j < NCH; j++) {
      const bool f = sf[j][l] != 0;
      acc = f ? sv[j][l] : combine_any<DT>(mo, packed, acc, sv[j][l]);
      if (WITH_H) hacc = f ? sh[j][l] : imax_bits(hacc, sh[j][l]);
      any |= f;
    }
    const size_t o = (size_t)blockIdx.x * 128 + l;
    last[o] = acc;
    if (WITH_H) lasth[o] = hacc;
    hasbar[o] = any;
  }
}

template <int DT, bool WITH_H>
__global__ void __launch_bounds__(NT) lane_final_kernel(
    const int* __restrict__ barrier, const uint32_t* __restrict__ vals,
    const uint32_t* __restrict__ ok, const uint32_t* __restrict__ last,
    const uint32_t* __restrict__ lasth, const int* __restrict__ hasbar,
    uint32_t* __restrict__ out, uint32_t* __restrict__ outh, int mo,
    int packed) {
  __shared__ uint32_t sv[NCH][128];
  __shared__ uint32_t sh[NCH][128];
  __shared__ int sf[NCH][128];
  __shared__ uint32_t cv[128];   // carry into the tile, per lane
  __shared__ uint32_t chh[128];
  __shared__ int chave[128];
  const int l = threadIdx.x & 127;
  const int c = threadIdx.x >> 7;
  const int tile = blockIdx.x;
  const size_t base = (size_t)tile * TILE_ELEMS + (size_t)c * CH_ROWS * 128 + l;
  uint32_t v[CH_ROWS], h[CH_ROWS];
  uint32_t acc = 0, hacc = 0;
  int first = CH_ROWS;  // first row of the chunk with a barrier
#pragma unroll
  for (int k = 0; k < CH_ROWS; k++) {
    const size_t s = base + (size_t)k * 128;
    const bool b = barrier[s] != 0;
    const uint32_t x = vals[s];
    acc = (k == 0 || b) ? x : combine_any<DT>(mo, packed, acc, x);
    v[k] = acc;
    if (WITH_H) {
      const uint32_t y = ok[s];
      hacc = (k == 0 || b) ? y : imax_bits(hacc, y);
      h[k] = hacc;
    }
    if (b && first == CH_ROWS) first = k;
  }
  sv[c][l] = acc;
  if (WITH_H) sh[c][l] = hacc;
  sf[c][l] = first < CH_ROWS;
  if (c == 0) {
    // carry into the tile: fold of earlier tiles back to the nearest barrier
    bool have = false;
    uint32_t carry = 0, hcarry = 0;
    for (int j = tile - 1; j >= 0; j--) {
      const size_t o = (size_t)j * 128 + l;
      const uint32_t x = last[o];
      carry = have ? combine_any<DT>(mo, packed, x, carry) : x;
      if (WITH_H) {
        const uint32_t y = lasth[o];
        hcarry = have ? imax_bits(y, hcarry) : y;
      }
      have = true;
      if (hasbar[o]) break;
    }
    cv[l] = carry;
    if (WITH_H) chh[l] = hcarry;
    chave[l] = have;
  }
  __syncthreads();
  // prefix of this chunk: chunks above it in the tile, then the tile carry
  bool have = false, closed = false;
  uint32_t pre = 0, hpre = 0;
  for (int j = c - 1; j >= 0; j--) {
    const uint32_t x = sv[j][l];
    pre = have ? combine_any<DT>(mo, packed, x, pre) : x;
    if (WITH_H) hpre = have ? imax_bits(sh[j][l], hpre) : sh[j][l];
    have = true;
    if (sf[j][l]) { closed = true; break; }
  }
  if (!closed && chave[l]) {
    pre = have ? combine_any<DT>(mo, packed, cv[l], pre) : cv[l];
    if (WITH_H) hpre = have ? imax_bits(chh[l], hpre) : chh[l];
    have = true;
  }
#pragma unroll
  for (int k = 0; k < CH_ROWS; k++) {
    const size_t s = base + (size_t)k * 128;
    const bool open = have && k < first;
    out[s] = open ? combine_any<DT>(mo, packed, pre, v[k]) : v[k];
    if (WITH_H) outh[s] = open ? imax_bits(hpre, h[k]) : h[k];
  }
}

template <int DT, bool WITH_H>
static void launch(int ntiles, cudaStream_t st, const int* bar,
                   const uint32_t* vals, const uint32_t* ok, uint32_t* last,
                   uint32_t* lasth, int* hasbar, uint32_t* out, uint32_t* outh,
                   int mo, int packed) {
  lane_summary_kernel<DT, WITH_H><<<ntiles, NT, 0, st>>>(
      bar, vals, ok, last, lasth, hasbar, mo, packed);
  lane_final_kernel<DT, WITH_H><<<ntiles, NT, 0, st>>>(
      bar, vals, ok, last, lasth, hasbar, out, outh, mo, packed);
}

// Two launches: lane_summary then lane_final (the caller counts both).
// ok, lasth and outh are null when the validity channel is not scanned.
extern "C" int lane_segscan(const void* barrier, const void* vals,
                            const void* ok, void* last, void* lasth,
                            void* hasbar, void* out, void* outh, int ntiles,
                            int dt, int mo, int packed, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define ARGS                                                                \
  ntiles, st, (const int*)barrier, (const uint32_t*)vals,                   \
      (const uint32_t*)ok, (uint32_t*)last, (uint32_t*)lasth, (int*)hasbar, \
      (uint32_t*)out, (uint32_t*)outh, mo, packed
#define BOTH(DT)                                 \
  if (ok != nullptr) launch<DT, true>(ARGS);     \
  else launch<DT, false>(ARGS);                  \
  break;
  if (ntiles > 0) {
    switch (dt) {
      case DT_F32: BOTH(DT_F32)
      case DT_I32: BOTH(DT_I32)
      case DT_U32: BOTH(DT_U32)
      case DT_BOOL: BOTH(DT_BOOL)
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef BOTH
#undef ARGS
  return (int)cudaGetLastError();
}
