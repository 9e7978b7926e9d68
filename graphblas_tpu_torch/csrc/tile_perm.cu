// K2: within-tile permutation of (128,128) tiles, 1..MAXCH channels.
//
// Replaces graphblas_tpu/core/engine/permute.py:_tile_perm_pallas (body
// _tile_perm_body), stages A and C of every Clos permutation.  The Pallas
// kernel composes three lane gathers and two transposes because a TPU has
// no sublane gather; here the composition is one closed-form index
// (tile_perm_src in common.cuh).
//
// Bound: bytes.  Each element is read once and written once (plus one read
// of the 32-bit packed index), all in coalesced 16-byte rows of the tile;
// the scatter-free gather happens in shared memory.
//
// Design: one block per tile.  The packed index tile is staged in shared
// memory, every thread resolves the sources of its 16 outputs into
// registers, and the same 64 KB buffer is then reused to stage each
// channel's input tile, so a block needs 64 KB of shared memory and three
// blocks fit on an SM.  Blocks are independent: nothing carries over.
#include "common.cuh"

struct Chans {
  const int* in[MAXCH];
  int* out[MAXCH];
};

__global__ void __launch_bounds__(NT) tile_perm_kernel(const int* __restrict__ p,
                                                       Chans ch, int nch) {
  extern __shared__ int4 smem4[];
  int* buf = reinterpret_cast<int*>(smem4);
  const size_t base = (size_t)blockIdx.x * TILE_ELEMS;
  load_tile(buf, p + base);
  __syncthreads();
  int src[EPT];
#pragma unroll
  for (int k = 0; k < EPT; k++) {
    int e = threadIdx.x + k * NT;
    src[k] = tile_perm_src(buf, e >> 7, e & 127);
  }
  for (int c = 0; c < nch; c++) {
    __syncthreads();  // every read of buf (index or previous channel) done
    load_tile(buf, ch.in[c] + base);
    __syncthreads();
    int* out = ch.out[c] + base;
#pragma unroll
    for (int k = 0; k < EPT; k++) out[threadIdx.x + k * NT] = buf[src[k]];
  }
}

extern "C" int tile_perm(const void* p, void** ins, void** outs, int nch,
                         int ntiles, void* stream) {
  const int smem = TILE_ELEMS * 4;
  cudaFuncSetAttribute(tile_perm_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  Chans ch;
  for (int c = 0; c < MAXCH; c++) {
    ch.in[c] = c < nch ? (const int*)ins[c] : nullptr;
    ch.out[c] = c < nch ? (int*)outs[c] : nullptr;
  }
  if (ntiles > 0)
    tile_perm_kernel<<<ntiles, NT, smem, (cudaStream_t)stream>>>(
        (const int*)p, ch, nch);
  return (int)cudaGetLastError();
}
