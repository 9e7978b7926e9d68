// K4: route stage C + per-lane segmented monoid scan + extract stage A.
//
// Replaces graphblas_tpu/core/engine/lanepipe.py:fused_permC_scan_permA.
// On each (128,128) tile: apply the route's stage-C tile permutation, scan
// every lane (column) down the rows with the monoid, restarting where
// `barrier` is set, and apply the extract's stage-A tile permutation to
// the scanned tile.  The scan's carry runs down each lane across ALL
// tiles.  The Pallas kernel carries it through a sequential grid; Hopper
// runs blocks in no fixed order, so here the carry takes two launches:
//   1. scan_summary: per tile and lane, the fold of the tile's rows (from
//      its last barrier, or from row 0) and whether the lane has a barrier;
//   2. scan_final: per tile and lane, the carry-in is found by walking
//      back over earlier tiles' summaries until one with a barrier (runs
//      are at most SPLIT_DEG + 1 rows, so the walk is short), then the
//      tile is scanned with that carry and written through extract stage A.
// Each launch only reads what the previous launch wrote, so no order
// between blocks is assumed.  The fold order differs from the Pallas
// kernel's roll-based tree, so FP32 sums agree to rounding; integer and
// BOOL results are exact.
//
// Bound: bytes.  Launch 1 reads the values and the route index; launch 2
// reads them again with the barrier and extract index and writes the
// output: about 7 words per element where the bound counts 5.  The lane
// scan itself is sequential over 128 rows per tile in shared memory.
#include "common.cuh"

// Route stage C of one tile into registers: v[k] = vals[tile][src(k)].
__device__ __forceinline__ void permuted_tile(int* buf, const int* pcr,
                                              const int* vals, uint32_t* v) {
  load_tile(buf, pcr);
  __syncthreads();
  int src[EPT];
#pragma unroll
  for (int k = 0; k < EPT; k++) {
    const int e = threadIdx.x + k * NT;
    src[k] = tile_perm_src(buf, e >> 7, e & 127);
  }
  __syncthreads();
  load_tile(buf, vals);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < EPT; k++) v[k] = (uint32_t)buf[src[k]];
  __syncthreads();
}

// Barrier bits of one tile, per lane: bm[(r >> 5) * 128 + l] bit (r & 31).
__device__ __forceinline__ void barrier_bits(uint32_t* bm, const int* bar) {
  for (int i = threadIdx.x; i < 4 * 128; i += NT) bm[i] = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < EPT; k++) {
    const int e = threadIdx.x + k * NT;
    if (bar[e] != 0) atomicOr(&bm[(e >> 12) * 128 + (e & 127)], 1u << ((e >> 7) & 31));
  }
  __syncthreads();
}

template <int DT>
__global__ void __launch_bounds__(NT) scan_summary_kernel(
    const int* __restrict__ pcr, const int* __restrict__ barrier,
    const int* __restrict__ vals, uint32_t* __restrict__ last,
    int* __restrict__ hasbar, int mo, int packed) {
  extern __shared__ int4 smem4[];
  int* buf = reinterpret_cast<int*>(smem4);
  __shared__ uint32_t bm[4 * 128];
  const size_t base = (size_t)blockIdx.x * TILE_ELEMS;
  uint32_t v[EPT];
  permuted_tile(buf, pcr + base, vals + base, v);
#pragma unroll
  for (int k = 0; k < EPT; k++) buf[threadIdx.x + k * NT] = (int)v[k];
  barrier_bits(bm, barrier + base);
  if (threadIdx.x < 128) {
    const int l = threadIdx.x;
    uint32_t acc = 0, any = 0;
    for (int r = 0; r < 128; r++) {
      const uint32_t x = (uint32_t)buf[r * 128 + l];
      const uint32_t b = (bm[(r >> 5) * 128 + l] >> (r & 31)) & 1u;
      acc = (r == 0 || b) ? x : combine_any<DT>(mo, packed, acc, x);
      any |= b;
    }
    last[(size_t)blockIdx.x * 128 + l] = acc;
    hasbar[(size_t)blockIdx.x * 128 + l] = (int)any;
  }
}

template <int DT>
__global__ void __launch_bounds__(NT) scan_final_kernel(
    const int* __restrict__ pcr, const int* __restrict__ barrier,
    const int* __restrict__ pae, const int* __restrict__ vals,
    const uint32_t* __restrict__ last, const int* __restrict__ hasbar,
    int* __restrict__ out, int mo, int packed) {
  extern __shared__ int4 smem4[];
  int* buf = reinterpret_cast<int*>(smem4);
  __shared__ uint32_t bm[4 * 128];
  const int tile = blockIdx.x;
  const size_t base = (size_t)tile * TILE_ELEMS;
  uint32_t v[EPT];
  permuted_tile(buf, pcr + base, vals + base, v);
  load_tile(buf, pae + base);
  __syncthreads();
  int src[EPT];
#pragma unroll
  for (int k = 0; k < EPT; k++) {
    const int e = threadIdx.x + k * NT;
    src[k] = tile_perm_src(buf, e >> 7, e & 127);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < EPT; k++) buf[threadIdx.x + k * NT] = (int)v[k];
  barrier_bits(bm, barrier + base);
  if (threadIdx.x < 128) {
    const int l = threadIdx.x;
    // carry-in: fold of earlier tiles back to the nearest barrier
    bool have = false;
    uint32_t carry = 0;
    for (int j = tile - 1; j >= 0; j--) {
      const uint32_t x = last[(size_t)j * 128 + l];
      carry = have ? combine_any<DT>(mo, packed, x, carry) : x;
      have = true;
      if (hasbar[(size_t)j * 128 + l]) break;
    }
    uint32_t acc = 0;
    for (int r = 0; r < 128; r++) {
      const uint32_t x = (uint32_t)buf[r * 128 + l];
      const uint32_t b = (bm[(r >> 5) * 128 + l] >> (r & 31)) & 1u;
      if (b) acc = x;
      else if (r == 0) acc = have ? combine_any<DT>(mo, packed, carry, x) : x;
      else acc = combine_any<DT>(mo, packed, acc, x);
      buf[r * 128 + l] = (int)acc;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < EPT; k++) out[base + threadIdx.x + k * NT] = buf[src[k]];
}

template <int DT>
static void launch(int ntiles, cudaStream_t st, const int* pcr, const int* bar,
                   const int* pae, const int* vals, uint32_t* last, int* hasbar,
                   int* out, int mo, int packed) {
  const int smem = TILE_ELEMS * 4;
  cudaFuncSetAttribute(scan_summary_kernel<DT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(scan_final_kernel<DT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  scan_summary_kernel<DT><<<ntiles, NT, smem, st>>>(pcr, bar, vals, last,
                                                    hasbar, mo, packed);
  scan_final_kernel<DT><<<ntiles, NT, smem, st>>>(pcr, bar, pae, vals, last,
                                                  hasbar, out, mo, packed);
}

// Two launches: scan_summary then scan_final (the caller counts both).
extern "C" int fused_scan(const void* pcr, const void* barrier, const void* pae,
                          const void* vals, void* last, void* hasbar, void* out,
                          int ntiles, int dt, int mo, int packed, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define ARGS                                                              \
  ntiles, st, (const int*)pcr, (const int*)barrier, (const int*)pae,      \
      (const int*)vals, (uint32_t*)last, (int*)hasbar, (int*)out, mo, packed
  if (ntiles > 0) {
    switch (dt) {
      case DT_F32: launch<DT_F32>(ARGS); break;
      case DT_I32: launch<DT_I32>(ARGS); break;
      case DT_U32: launch<DT_U32>(ARGS); break;
      case DT_BOOL: launch<DT_BOOL>(ARGS); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef ARGS
  return (int)cudaGetLastError();
}
