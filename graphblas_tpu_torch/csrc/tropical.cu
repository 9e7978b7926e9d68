// K7: dense tropical matrix product C[i,j] = red_k comb(A[i,k], B[k,j]),
// red in {min, max}, comb in {plus, min, max, times, first, second}, over
// float or double.
//
// Replaces graphblas_tpu/core/engine/kernels/tropical.py:tropical_matmul
// (body _kernel).  The Pallas kernel walks a (m/256, n/256, k/128) grid in
// order and revisits its output block along k, because the TPU runs the
// grid sequentially and keeps a whole block in VMEM.  Here the k loop lives
// inside the block, the running result stays in registers and C is written
// once; nothing carries over between blocks.
//
// Bound: operations.  At 8192^3 the product is 5.5e11 pairs of two FP32
// instructions (comb, then red: a min cannot fuse with an add), against
// 0.8 GB of operands and result.  Design: the shape of a classic SGEMM.  A
// block of 256 threads owns a 128x128 tile of C (128x64 for double), stages
// 16 k-slices of A (transposed) and B through shared memory, and each
// thread keeps an 8x8 (8x4) register tile as two 4-wide groups 64 (32)
// apart, so shared-memory reads are 16-byte and conflict-free.  Every
// operand is loaded once per 128 pairs it takes part in.  Ragged edges are
// guarded at the loads (out-of-range operands read as red's identity) and
// at the stores: no padded copies of the operands.
//
// Two entry points.  tropical_matmul takes missing entries encoded as red's
// identity, like the Pallas kernel; min and max propagate NaN like
// jnp.minimum / torch.minimum.  tropical_matmul_masked takes the two
// validity planes (one byte per entry) and skips every pair with a missing
// operand, so stored infinities and NaNs behave as in the bitmap engine's
// blocked product; its comb min/max are fmin/fmax, the GraphBLAS binary
// ops.  A k-slice whose stored operands are all finite takes the same
// two-instruction inner loop (missing operands replaced by the identity at
// the load); only a slice that holds a stored inf or NaN pays for the
// per-pair select.  Output validity is not computed here.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define RED_MIN 0
#define RED_MAX 1

// combine codes; must match graphblas_tpu_torch/core/engine/tropical.py
#define CB_PLUS 0
#define CB_MIN 1
#define CB_MAX 2
#define CB_TIMES 3
#define CB_FIRST 4
#define CB_SECOND 5
#define CB_FMIN 6
#define CB_FMAX 7

#define BK 16
#define NTHREADS 256
#define PAD 4

// NaN-propagating min/max.  sm_80+ has them as one instruction for float.
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ double min_nan(double a, double b) {
  return (b < a || b != b) ? b : a;
}
__device__ __forceinline__ double max_nan(double a, double b) {
  return (b > a || b != b) ? b : a;
}
__device__ __forceinline__ float min_num(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ float max_num(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double min_num(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ double max_num(double a, double b) { return fmax(a, b); }

__device__ __forceinline__ float pos_inf(float) { return __int_as_float(0x7f800000); }
__device__ __forceinline__ double pos_inf(double) {
  return __longlong_as_double(0x7ff0000000000000LL);
}

template <int RED, typename T>
__device__ __forceinline__ T identity() {
  return RED == RED_MIN ? pos_inf(T(0)) : -pos_inf(T(0));
}

template <int RED, typename T>
__device__ __forceinline__ T red(T acc, T p) {
  return RED == RED_MIN ? min_nan(acc, p) : max_nan(acc, p);
}

template <int CB, typename T>
__device__ __forceinline__ T comb(T a, T b) {
  switch (CB) {
    case CB_PLUS: return a + b;
    case CB_MIN: return min_nan(a, b);
    case CB_MAX: return max_nan(a, b);
    case CB_TIMES: return a * b;
    case CB_FIRST: return a;
    case CB_SECOND: return b;
    case CB_FMIN: return min_num(a, b);
    default: return max_num(a, b);
  }
}

// TM x TN results per thread; the block's tile is (16 TM) x (16 TN).
template <typename T, int TM, int TN, int RED, int CB, bool MASKED>
__global__ void __launch_bounds__(NTHREADS)
tropical_kernel(const T* __restrict__ A, const T* __restrict__ B,
                const uint8_t* __restrict__ Av, const uint8_t* __restrict__ Bv,
                T* __restrict__ C, int M, int N, int K) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  __shared__ __align__(16) T As[BK][BM + PAD];  // A tile, transposed
  __shared__ __align__(16) T Bs[BK][BN];
  __shared__ uint8_t Aok[MASKED ? BK : 1][MASKED ? BM + PAD : 1];
  __shared__ uint8_t Bok[MASKED ? BK : 1][MASKED ? BN : 1];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const T ident = identity<RED, T>();
  // past the end of k both operands are padding: the identity for A and,
  // for B, the value whose comb with it is the identity again
  // ((-inf) * (-inf) would win a max)
  const T bpad = CB == CB_TIMES ? pos_inf(T(0)) : ident;

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; i++)
#pragma unroll
    for (int j = 0; j < TN; j++) acc[i][j] = ident;

  for (int k0 = 0; k0 < K; k0 += BK) {
    int danger = 0;
#pragma unroll
    for (int i = 0; i < BM * BK / NTHREADS; i++) {
      int idx = tid + i * NTHREADS;
      int r = idx / BK, kk = idx % BK;
      int gr = m0 + r, gk = k0 + kk;
      bool in = gr < M && gk < K;
      size_t off = (size_t)gr * K + gk;
      T v = in ? A[off] : ident;
      if constexpr (MASKED) {
        uint8_t ok = in ? Av[off] : (uint8_t)0;
        if (!ok) v = ident;
        else if (!isfinite(v)) danger = 1;
        Aok[kk][r] = ok;
      }
      As[kk][r] = v;
    }
#pragma unroll
    for (int i = 0; i < BN * BK / NTHREADS; i++) {
      int idx = tid + i * NTHREADS;
      int kk = idx / BN, c = idx % BN;
      int gk = k0 + kk, gc = n0 + c;
      bool in = gk < K && gc < N;
      size_t off = (size_t)gk * N + gc;
      T v = in ? B[off] : bpad;
      if constexpr (MASKED) {
        uint8_t ok = in ? Bv[off] : (uint8_t)0;
        if (!ok) v = ident;
        else if (!isfinite(v)) danger = 1;
        Bok[kk][c] = ok;
      }
      Bs[kk][c] = v;
    }
    int slow = 0;
    if constexpr (MASKED) slow = __syncthreads_or(danger);
    else __syncthreads();

    if (!slow) {
      // missing operands hold the identity and every stored one is finite
      // (or, unmasked, the caller encoded them so): comb then red per pair
#pragma unroll
      for (int kk = 0; kk < BK; kk++) {
        T a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; i++)
          a[i] = As[kk][(i / 4) * (BM / 2) + ty * 4 + (i % 4)];
#pragma unroll
        for (int j = 0; j < TN; j++)
          b[j] = Bs[kk][(j / 4) * (BN / 2) + tx * 4 + (j % 4)];
#pragma unroll
        for (int i = 0; i < TM; i++)
#pragma unroll
          for (int j = 0; j < TN; j++)
            acc[i][j] = red<RED, T>(acc[i][j], comb<CB, T>(a[i], b[j]));
      }
    } else if constexpr (MASKED) {
      // a stored inf or NaN in this slice: skip missing pairs one by one
#pragma unroll 2
      for (int kk = 0; kk < BK; kk++) {
        T a[TM], b[TN];
        uint8_t ua[TM], ub[TN];
#pragma unroll
        for (int i = 0; i < TM; i++) {
          int r = (i / 4) * (BM / 2) + ty * 4 + (i % 4);
          a[i] = As[kk][r];
          ua[i] = Aok[kk][r];
        }
#pragma unroll
        for (int j = 0; j < TN; j++) {
          int c = (j / 4) * (BN / 2) + tx * 4 + (j % 4);
          b[j] = Bs[kk][c];
          ub[j] = Bok[kk][c];
        }
#pragma unroll
        for (int i = 0; i < TM; i++)
#pragma unroll
          for (int j = 0; j < TN; j++) {
            T p = (ua[i] & ub[j]) ? comb<CB, T>(a[i], b[j]) : ident;
            acc[i][j] = red<RED, T>(acc[i][j], p);
          }
      }
    }
    __syncthreads();  // the tiles are overwritten by the next slice
  }

#pragma unroll
  for (int i = 0; i < TM; i++) {
    int gr = m0 + (i / 4) * (BM / 2) + ty * 4 + (i % 4);
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; j++) {
      int gc = n0 + (j / 4) * (BN / 2) + tx * 4 + (j % 4);
      if (gc < N) C[(size_t)gr * N + gc] = acc[i][j];
    }
  }
}

struct Args {
  const void *a, *b, *av, *bv;
  void* c;
  int m, n, k;
  cudaStream_t stream;
};

template <typename T, int TM, int TN, int RED, int CB, bool MASKED>
static void launch(const Args& g) {
  dim3 grid((g.n + 16 * TN - 1) / (16 * TN), (g.m + 16 * TM - 1) / (16 * TM));
  tropical_kernel<T, TM, TN, RED, CB, MASKED><<<grid, NTHREADS, 0, g.stream>>>(
      (const T*)g.a, (const T*)g.b, (const uint8_t*)g.av, (const uint8_t*)g.bv,
      (T*)g.c, g.m, g.n, g.k);
}

#define PLAIN_CASE(R, CBV) \
  case (R) * 8 + (CBV): launch<T, TM, TN, R, CBV, false>(g); return true;
#define MASKED_CASE(R, CBV) \
  case (R) * 8 + (CBV): launch<T, TM, TN, R, CBV, true>(g); return true;

template <typename T, int TM, int TN>
static bool dispatch_plain(int red, int cb, const Args& g) {
  switch (red * 8 + cb) {
    PLAIN_CASE(RED_MIN, CB_PLUS) PLAIN_CASE(RED_MIN, CB_MIN)
    PLAIN_CASE(RED_MIN, CB_MAX) PLAIN_CASE(RED_MIN, CB_TIMES)
    PLAIN_CASE(RED_MIN, CB_FIRST) PLAIN_CASE(RED_MIN, CB_SECOND)
    PLAIN_CASE(RED_MAX, CB_PLUS) PLAIN_CASE(RED_MAX, CB_MIN)
    PLAIN_CASE(RED_MAX, CB_MAX) PLAIN_CASE(RED_MAX, CB_TIMES)
    PLAIN_CASE(RED_MAX, CB_FIRST) PLAIN_CASE(RED_MAX, CB_SECOND)
  }
  return false;
}

// the four semirings whose missing-as-identity encoding is sound
template <typename T, int TM, int TN>
static bool dispatch_masked(int red, int cb, const Args& g) {
  switch (red * 8 + cb) {
    MASKED_CASE(RED_MIN, CB_PLUS) MASKED_CASE(RED_MAX, CB_PLUS)
    MASKED_CASE(RED_MIN, CB_FMAX) MASKED_CASE(RED_MAX, CB_FMIN)
  }
  return false;
}

static int run(const Args& g, int red, int cb, int is_double, bool masked) {
  if (g.m <= 0 || g.n <= 0) return 0;
  bool known;
  if (masked)
    known = is_double ? dispatch_masked<double, 8, 4>(red, cb, g)
                      : dispatch_masked<float, 8, 8>(red, cb, g);
  else
    known = is_double ? dispatch_plain<double, 8, 4>(red, cb, g)
                      : dispatch_plain<float, 8, 8>(red, cb, g);
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int tropical_matmul(const void* a, const void* b, void* c, int m,
                               int n, int k, int red, int cb, int is_double,
                               void* stream) {
  Args g{a, b, nullptr, nullptr, c, m, n, k, (cudaStream_t)stream};
  return run(g, red, cb, is_double, false);
}

extern "C" int tropical_matmul_masked(const void* a, const void* b,
                                      const void* av, const void* bv, void* c,
                                      int m, int n, int k, int red, int cb,
                                      int is_double, void* stream) {
  Args g{a, b, av, bv, c, m, n, k, (cudaStream_t)stream};
  return run(g, red, cb, is_double, true);
}
