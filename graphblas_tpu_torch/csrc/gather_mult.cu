// K1: gather + typed multiply into the lanepipe's G layout.
//
// Replaces graphblas_tpu/core/engine/lanepipe.py:gather_mult.  For each
// edge slot (r, l) of G block blk = r / 256 with window base w = meta[blk,0]:
//   arow = locidx[r, l],  col = idx1[blk*128 + arow, l]
//   g    = u2[w*128 + arow, col],  ok = okg[r, l] && u2ok[...] (unless full_u)
//   z    = mult(avals[r, l], g) for mxv, mult(g, avals[r, l]) for vxm
// and writes z, or the monoid identity where !ok; with `packed` (BOOL
// monoids) it writes the codes 0 (no value) / 1 + z instead.  With permA,
// the route permutation's stage A is applied to each 128-row output tile
// on the way out (the tile-permutation closed form of common.cuh), so the
// route can skip its own stage A.  With okp (the sparse-vector path of a
// non-BOOL monoid) it also writes the validity ok of every slot as int32
// 0/1, through the same stage A as the values.
//
// Bound: bytes.  Per slot it reads locidx, okg and avals (and the permA
// index) once, writes one word (two with okp), and reads u through idx1
// (and its validity table unless full_u); u is a few MB
// and stays in L2.  Design: one block per 128-row tile; each thread
// computes 16 slots into registers, then, with permA, the tile goes
// through shared memory (64 KB, reused for the index tile) and is written
// out in coalesced rows.  Blocks are independent.
#include "common.cuh"

template <int DT>
__global__ void __launch_bounds__(NT) gather_mult_kernel(
    const int* __restrict__ meta, const uint32_t* __restrict__ u2,
    const int* __restrict__ u2ok, const int* __restrict__ idx1,
    const int* __restrict__ locidx, const int* __restrict__ okg,
    const uint32_t* __restrict__ avals, const int* __restrict__ permA,
    uint32_t* __restrict__ out, int* __restrict__ okp, int op, int mxv,
    int packed, int full_u, uint32_t ident) {
  extern __shared__ int4 smem4[];
  int* buf = reinterpret_cast<int*>(smem4);
  const int tile = blockIdx.x;
  const int blk = tile >> 1;  // 256-row G blocks hold two 128-row tiles
  const size_t base = (size_t)tile * TILE_ELEMS;
  const size_t wrow = (size_t)meta[blk * 3] * 128;
  uint32_t val[EPT];
  uint32_t okbits = 0;  // bit k: slot k of this thread is valid
#pragma unroll
  for (int k = 0; k < EPT; k++) {
    const int e = threadIdx.x + k * NT;
    const size_t s = base + e;
    const int arow = locidx[s];
    const int col = idx1[((size_t)blk * 128 + arow) * 128 + (e & 127)];
    const size_t uo = (wrow + arow) * 128 + col;
    bool ok = okg[s] != 0;
    if (!full_u) ok = ok && u2ok[uo] != 0;
    const uint32_t g = u2[uo];
    const uint32_t a = avals[s];
    const uint32_t z = mxv ? mult_bits<DT>(op, a, g) : mult_bits<DT>(op, g, a);
    val[k] = packed ? (ok ? z + 1u : 0u) : (ok ? z : ident);
    okbits |= (uint32_t)ok << k;
  }
  if (permA == nullptr) {
#pragma unroll
    for (int k = 0; k < EPT; k++) {
      out[base + threadIdx.x + k * NT] = val[k];
      if (okp != nullptr) okp[base + threadIdx.x + k * NT] = (okbits >> k) & 1u;
    }
    return;
  }
  load_tile(buf, permA + base);
  __syncthreads();
  int src[EPT];
#pragma unroll
  for (int k = 0; k < EPT; k++) {
    const int e = threadIdx.x + k * NT;
    src[k] = tile_perm_src(buf, e >> 7, e & 127);
  }
  __syncthreads();
  uint32_t* tb = reinterpret_cast<uint32_t*>(buf);
#pragma unroll
  for (int k = 0; k < EPT; k++) tb[threadIdx.x + k * NT] = val[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < EPT; k++) out[base + threadIdx.x + k * NT] = tb[src[k]];
  if (okp == nullptr) return;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < EPT; k++) tb[threadIdx.x + k * NT] = (okbits >> k) & 1u;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < EPT; k++)
    okp[base + threadIdx.x + k * NT] = (int)tb[src[k]];
}

template <int DT>
static void launch(int ntiles, cudaStream_t st, const int* meta,
                   const uint32_t* u2, const int* u2ok, const int* idx1,
                   const int* locidx, const int* okg, const uint32_t* avals,
                   const int* permA, uint32_t* out, int* okp, int op, int mxv,
                   int packed, int full_u, uint32_t ident) {
  const int smem = TILE_ELEMS * 4;
  cudaFuncSetAttribute(gather_mult_kernel<DT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  gather_mult_kernel<DT><<<ntiles, NT, smem, st>>>(
      meta, u2, u2ok, idx1, locidx, okg, avals, permA, out, okp, op, mxv,
      packed, full_u, ident);
}

extern "C" int gather_mult(const void* meta, const void* u2, const void* u2ok,
                           const void* idx1, const void* locidx,
                           const void* okg, const void* avals,
                           const void* permA, void* out, void* okp,
                           int ntiles, int dt, int op, int mxv, int packed,
                           int full_u, int ident_bits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define ARGS                                                                \
  ntiles, st, (const int*)meta, (const uint32_t*)u2, (const int*)u2ok,      \
      (const int*)idx1, (const int*)locidx, (const int*)okg,                \
      (const uint32_t*)avals, (const int*)permA, (uint32_t*)out, (int*)okp, \
      op, mxv, packed, full_u, (uint32_t)ident_bits
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
