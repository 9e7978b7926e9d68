// K3: Clos stage B, an independent permutation inside each of the 16384
// rows of T ports (padded to T_pad by the plan), 1..MAXCH channels.
//
// Replaces graphblas_tpu/core/engine/permute.py:_mid_perm_pallas.  The
// Pallas kernel runs a per-group lane gather, a select across the T/128
// groups and a second lane gather; here the three steps are one index:
//   out_port[r, g*128+l] = y[r, s*128 + A[r, s*128+m]]
//   m = B3[r, g*128+l],  s = S[r, g*128+m]
// with A = bits 0-6, B3 = bits 7-13 and S = bits 14-20 of the packed row.
// Port columns at or past T read as 0 (the plan's dummies), and output
// ports at or past out_T (TW) are neither computed nor written.
//
// Layout: the Pallas kernel works on the port layout y (16384, T).  The
// JAX package moves there and back with XLA transposes around the kernel
// (its "exchanges"), because a TPU kernel moves data fast only by lane
// gathers.  This kernel works on the tile layout the rest of the pipeline
// holds: x (T*128, 128) -> out (TW*128, 128), with x[t, r] = y[r, t] and
// out[j, r] = out_port[r, j].  A block of R consecutive rows r reads x as T
// segments of 4R contiguous bytes and writes out as TW such segments, so
// the transposes, two copies of every channel on each side, are folded in.
//
// Bound: bytes.  At most the index is read once (4 * T_pad bytes a row),
// each input word once and each output word once; a trimmed output needs
// only the index words and inputs its sources name.  Design: a block owns
// R consecutive rows.  It stages the R index rows (16-byte loads, stored
// with a one-word-per-warp-lane rotation into rows padded by JW = 32/R
// words, so that step 3's first lookup and the stores are free of bank
// conflicts) and every channel's R x T inputs (cp.async, all in flight
// together), then resolves each output's source once and moves it for
// every channel.  A warp covers R consecutive rows and JW ports, and the
// outputs leave as 4R-byte segments.  No division per element: (r, j) come
// from the thread and loop indices.  R = 8 (21 KB of shared memory a block
// at the zipf route, eight blocks an SM) was the fastest of 32, 16, 8 and
// 4 rows (PERF.md); R = 4 serves routes whose 8 rows overflow a
// block.
#include "common.cuh"

#define MP_NT 256
#define MP_NW (MP_NT / 32)

struct Chans {
  const int* in[MAXCH];
  int* out[MAXCH];
};

template <int R>
__global__ void __launch_bounds__(MP_NT) mid_perm_kernel(
    const int* __restrict__ p, Chans ch, int nch, int T, int T128, int TW) {
  constexpr int JW = 32 / R;  // ports per warp and step
  extern __shared__ int4 smem4[];
  const int T_pad = T128 * 128;
  const int PS = T_pad + JW;  // padded index row stride, in words
  int* sp = reinterpret_cast<int*>(smem4);  // R index rows
  int* sy = sp + R * PS;                    // per channel R*T words
  const int r0 = blockIdx.x * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. inputs by cp.async: sy[t*R + r] = x[t, r0 + r]
#pragma unroll
  for (int c = 0; c < MAXCH; c++) {
    if (c >= nch) break;
    int* dst = sy + c * R * T;
    for (int i = tid; i < T * (R / 4); i += MP_NT) {
      const int t = i / (R / 4), q = i % (R / 4);
      cp_async16(dst + t * R + 4 * q,
                 ch.in[c] + (size_t)t * TILE_ELEMS + r0 + 4 * q);
    }
  }
  // 2. index rows: 16-byte loads, four at a time per thread in flight,
  // word e of lane's vector stored in turn (s + lane / 8) % 4
  {
    const int4* p4 = reinterpret_cast<const int4*>(p + (size_t)r0 * T_pad);
    const int nvec = R * T128 * 32;
    constexpr int PB = 4;
    for (int i0 = tid; i0 < nvec; i0 += PB * MP_NT) {
      int4 v[PB];
#pragma unroll
      for (int b = 0; b < PB; b++)
        if (i0 + b * MP_NT < nvec) v[b] = __ldg(p4 + i0 + b * MP_NT);
#pragma unroll
      for (int b = 0; b < PB; b++) {
        const int i = i0 + b * MP_NT;
        if (i >= nvec) break;
        const int k = i >> 5;     // warp-uniform 32-vector chunk
        const int r = k / T128;
        const int c0 = ((k - r * T128) * 32 + lane) * 4;
        int* row = sp + r * PS + c0;
#pragma unroll
        for (int s = 0; s < 4; s++) {
          const int e = (s + (lane >> 3)) & 3;
          row[e] = int4_word(v[b], e);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. resolve each output's source once, move it for every channel
  const int r = lane % R, jj = lane / R;
  const int* pr = sp + r * PS;
  for (int j = warp * JW + jj; j < TW; j += MP_NW * JW) {
    const int m = (pr[j] >> 7) & 127;
    const int s = (pr[(j & ~127) + m] >> 14) & 127;
    const int col = s * 128 + (pr[s * 128 + m] & 127);
    const size_t o = (size_t)j * TILE_ELEMS + r0 + r;
#pragma unroll
    for (int c = 0; c < MAXCH; c++)
      if (c < nch) ch.out[c][o] = col < T ? sy[c * R * T + col * R + r] : 0;
  }
}

// shared memory of a block of R rows moving nch channels
static int smem_bytes(int R, int T, int T128, int nch) {
  return 4 * (R * (T128 * 128 + 32 / R) + nch * R * T);
}

// The launch shape for nch channels: the first R of 8, 4 whose block holds
// min(nch, MAXCH) channels in the device's shared memory, else the first
// that holds one channel; *per = the channels one launch moves (0 if no
// block holds one channel).
static cudaError_t shape(int T, int T128, int nch, int* R, int* per) {
  int smax = 0;
  cudaError_t err =
      device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>(&smax);
  if (err != cudaSuccess) return err;
  const int want = nch < MAXCH ? nch : MAXCH;
  *R = 0;
  *per = 0;
  for (int rows = 8; rows >= 4; rows /= 2) {
    int fit = 0;
    while (fit < want && smem_bytes(rows, T, T128, fit + 1) <= smax) fit++;
    if (fit == want) {
      *R = rows;
      *per = fit;
      return cudaSuccess;
    }
    if (fit > 0 && *R == 0) {
      *R = rows;
      *per = fit;
    }
  }
  return cudaSuccess;
}

template <int R>
static int launch(const void* p, void** ins, void** outs, int nch, int T,
                  int T128, int TW, void* stream) {
  const int smem = smem_bytes(R, T, T128, nch);
  cudaError_t err = cudaFuncSetAttribute(
      mid_perm_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Chans ch;
  for (int c = 0; c < MAXCH; c++) {
    ch.in[c] = c < nch ? (const int*)ins[c] : nullptr;
    ch.out[c] = c < nch ? (int*)outs[c] : nullptr;
  }
  if (TW > 0)
    mid_perm_kernel<R><<<TILE_ELEMS / R, MP_NT, smem, (cudaStream_t)stream>>>(
        (const int*)p, ch, nch, T, T128, TW);
  return (int)cudaGetLastError();
}

// Channels that one launch of mid_perm_tiles moves, out of nch, at this
// route's shape: 0 if no block holds one channel, -error if the device
// could not be read.
extern "C" int mid_perm_channels(int T, int T128, int nch) {
  int R = 0, per = 0;
  cudaError_t err = shape(T, T128, nch, &R, &per);
  return err != cudaSuccess ? -(int)err : per;
}

// ins (T*128, 128), outs (TW*128, 128); nch at most mid_perm_channels()
extern "C" int mid_perm_tiles(const void* p, void** ins, void** outs, int nch,
                              int T, int T128, int TW, void* stream) {
  if (nch < 1 || T > T128 * 128) return (int)cudaErrorInvalidValue;
  int R = 0, per = 0;
  cudaError_t err = shape(T, T128, nch, &R, &per);
  if (err != cudaSuccess) return (int)err;
  if (per < nch) return (int)cudaErrorInvalidValue;
  if (R == 8) return launch<8>(p, ins, outs, nch, T, T128, TW, stream);
  return launch<4>(p, ins, outs, nch, T, T128, TW, stream);
}
