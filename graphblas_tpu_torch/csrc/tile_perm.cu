// K2: within-tile permutation of (128,128) tiles, 1..TP_MAXCH channels.
//
// Replaces graphblas_tpu/core/engine/permute.py:_tile_perm_pallas (body
// _tile_perm_body), stages A and C of every Clos permutation.  The Pallas
// kernel composes three lane gathers and two transposes because a TPU has
// no sublane gather; here the composition is one closed-form index (the
// tile-permutation closed form of common.cuh), on a swizzled copy of the
// index tile.
//
// Bound: bytes.  Each element is read once and written once, plus one read
// of the packed index: 4 * (1 + 2 * nch) bytes per element.
//
// Design: 1024-thread blocks, every load of a block in flight at once.
// A block a tile that loads the index tile, then each channel's tile, one
// memory round trip after another, and keeps the index tile row-major,
// where the lookup p[m*128 + r] puts a warp's 32 lanes (same r, 32 values
// of m) on one shared-memory bank, takes twice this design's time at 34
// tiles.  Spreading each tile over a
// cluster of 8 CTAs that read the values through distributed shared memory
// costs a remote 4-byte read per output: 3.4x slower on the route (PERF.md).
// Here:
//   1. each channel's tile goes to its own buffer by cp.async, and the
//      index tile, loaded 16 bytes a thread four at a time, is stored with
//      word c of row r at column c ^ (r & 31): every lookup of the closed
//      form then reads a warp's words from distinct banks, up to
//      collisions of the data;
//   2. each thread resolves the sources of its outputs while the channel
//      tiles are still in flight, then, after one wait, moves them for
//      every channel, writing coalesced rows.
// Shared memory holds the index and TP_MAXCH = 2 channel tiles (192 KB),
// so a block fills an SM.  The lookups, some 6000 shared-memory cycles a
// tile, then bound a block; where the tiles are at most half the SMs (the
// extract's stage C, trimmed to 34 tiles) each tile's outputs are split
// over two blocks, each staging the whole tile (the second copy comes from
// L2).  More parts a tile measured slower at 34 tiles (PERF.md).
#include "common.cuh"

#define TP_MAXCH 2  // channel tiles beside the index tile in shared memory

struct Chans {
  const int* in[TP_MAXCH];
  int* out[TP_MAXCH];
};

// word (r, c) of the swizzled index tile
__device__ __forceinline__ int swz(const int* sp, int r, int c) {
  return sp[r * 128 + (c ^ (r & 31))];
}

template <int PARTS>
__global__ void __launch_bounds__(NT) tile_perm_kernel(const int* __restrict__ p,
                                                       Chans ch, int nch) {
  extern __shared__ int4 smem4[];
  int* sp = reinterpret_cast<int*>(smem4);  // index tile, swizzled
  int* sx = sp + TILE_ELEMS;                // channel tiles
  const size_t base = (size_t)(blockIdx.x / PARTS) * TILE_ELEMS;
  const int first = (blockIdx.x % PARTS) * (TILE_ELEMS / PARTS);
  const int tid = threadIdx.x, lane = tid & 31;

  // 1. channel tiles by cp.async, the index tile through registers
#pragma unroll
  for (int c = 0; c < TP_MAXCH; c++) {
    if (c >= nch) break;
#pragma unroll
    for (int k = 0; k < TILE_ELEMS / 4 / NT; k++) {
      const int i = tid + k * NT;
      cp_async16(sx + c * TILE_ELEMS + 4 * i, ch.in[c] + base + 4 * i);
    }
  }
  const int4* p4 = reinterpret_cast<const int4*>(p + base);
  int4 v[TILE_ELEMS / 4 / NT];
#pragma unroll
  for (int k = 0; k < TILE_ELEMS / 4 / NT; k++) v[k] = __ldg(p4 + tid + k * NT);
#pragma unroll
  for (int k = 0; k < TILE_ELEMS / 4 / NT; k++) {
    const int i = tid + k * NT;  // a warp covers one row: r = i / 32
    const int r = i >> 5, c0 = lane * 4;
#pragma unroll
    for (int s = 0; s < 4; s++) {
      const int e = (s + (lane >> 3)) & 3;
      sp[r * 128 + ((c0 + e) ^ (r & 31))] = int4_word(v[k], e);
    }
  }
  __syncthreads();  // the index tile is in place; the channels may not be

  // 2. this block's part of the outputs, resolved while the channel tiles
  //    arrive:  out[r, l] = x[b, A[b, m]],  b = B[m, r],  m = C[r, l]
  constexpr int K = EPT / PARTS;
  int src[K];
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int e = first + tid + k * NT;
    const int r = e >> 7, l = e & 127;
    const int m = (swz(sp, r, l) >> 14) & 127;
    const int b = (swz(sp, m, r) >> 7) & 127;
    src[k] = b * 128 + (swz(sp, b, m) & 127);
  }
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int c = 0; c < TP_MAXCH; c++) {
    if (c >= nch) break;
    int* out = ch.out[c] + base + first;
    const int* x = sx + c * TILE_ELEMS;
#pragma unroll
    for (int k = 0; k < K; k++) out[tid + k * NT] = x[src[k]];
  }
}

template <int PARTS>
static int launch(const int* p, const Chans& ch, int nch, int ntiles, int smem,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tile_perm_kernel<PARTS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tile_perm_kernel<PARTS><<<ntiles * PARTS, NT, smem, stream>>>(p, ch, nch);
  return (int)cudaGetLastError();
}

// Channels one launch of tile_perm moves.
extern "C" int tile_perm_channels() { return TP_MAXCH; }

extern "C" int tile_perm(const void* p, void** ins, void** outs, int nch,
                         int ntiles, void* stream) {
  if (nch < 1 || nch > TP_MAXCH) return (int)cudaErrorInvalidValue;
  if (ntiles <= 0) return 0;
  int sms = 0;
  cudaError_t err = device_attr<cudaDevAttrMultiProcessorCount>(&sms);
  if (err != cudaSuccess) return (int)err;
  Chans ch;
  for (int c = 0; c < TP_MAXCH; c++) {
    ch.in[c] = c < nch ? (const int*)ins[c] : nullptr;
    ch.out[c] = c < nch ? (int*)outs[c] : nullptr;
  }
  const int smem = (1 + nch) * TILE_ELEMS * 4;
  const cudaStream_t st = (cudaStream_t)stream;
  if (2 * ntiles <= sms)
    return launch<2>((const int*)p, ch, nch, ntiles, smem, st);
  return launch<1>((const int*)p, ch, nch, ntiles, smem, st);
}
