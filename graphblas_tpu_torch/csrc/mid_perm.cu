// K3: Clos stage B, an independent permutation inside each of the 16384
// rows of T ports (padded to T_pad by the plan), 1..MAXCH channels.
//
// Replaces graphblas_tpu/core/engine/permute.py:_mid_perm_pallas.  The
// Pallas kernel runs a per-group lane gather, a select across the T/128
// groups and a second lane gather; here the three steps are one index:
//   out[r, g*128+l] = y[r, s*128 + A[r, s*128+m]]
//   m = B3[r, g*128+l],  s = S[r, g*128+m]
// with A = bits 0-6, B3 = bits 7-13 and S = bits 14-20 of the packed row.
// Port columns at or past T read as 0 (the plan's dummies), and output
// columns at or past out_T (TW) are neither computed nor written.
//
// Bound: bytes.  Each input element is read once, each output written
// once, plus the packed index row.  Design: a block stages MP_ROWS rows of
// the index and of each channel in shared memory with coalesced loads and
// gathers from there; rows are independent, so blocks share nothing.
#include "common.cuh"

#define MP_ROWS 4
#define MP_NT 256

struct Chans {
  const int* in[MAXCH];
  int* out[MAXCH];
};

__global__ void __launch_bounds__(MP_NT) mid_perm_kernel(
    const int* __restrict__ p, Chans ch, int nch, int T, int T_pad, int TW) {
  extern __shared__ int4 smem4[];
  int* sp = reinterpret_cast<int*>(smem4);  // MP_ROWS * T_pad
  int* sy = sp + MP_ROWS * T_pad;           // MP_ROWS * T
  const size_t r0 = (size_t)blockIdx.x * MP_ROWS;
  for (int i = threadIdx.x; i < MP_ROWS * T_pad; i += MP_NT)
    sp[i] = p[r0 * T_pad + i];
  for (int c = 0; c < nch; c++) {
    __syncthreads();
    const int* y = ch.in[c] + r0 * T;
    for (int i = threadIdx.x; i < MP_ROWS * T; i += MP_NT) sy[i] = y[i];
    __syncthreads();
    int* out = ch.out[c] + r0 * TW;
    for (int i = threadIdx.x; i < MP_ROWS * TW; i += MP_NT) {
      int rr = i / TW;
      int j = i - rr * TW;
      const int* pr = sp + rr * T_pad;
      int g = j >> 7;
      int m = (pr[j] >> 7) & 127;
      int s = (pr[g * 128 + m] >> 14) & 127;
      int col = s * 128 + (pr[s * 128 + m] & 127);
      out[i] = col < T ? sy[rr * T + col] : 0;
    }
  }
}

extern "C" int mid_perm(const void* p, void** ins, void** outs, int nch,
                        int nrows, int T, int T_pad, int TW, void* stream) {
  const int smem = MP_ROWS * (T_pad + T) * 4;
  cudaFuncSetAttribute(mid_perm_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  Chans ch;
  for (int c = 0; c < MAXCH; c++) {
    ch.in[c] = c < nch ? (const int*)ins[c] : nullptr;
    ch.out[c] = c < nch ? (int*)outs[c] : nullptr;
  }
  if (nrows > 0 && TW > 0)
    mid_perm_kernel<<<nrows / MP_ROWS, MP_NT, smem, (cudaStream_t)stream>>>(
        (const int*)p, ch, nch, T, T_pad, TW);
  return (int)cudaGetLastError();
}
