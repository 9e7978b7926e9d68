// Shared device code for the lanepipe kernels: the within-tile permutation
// closed form and the monoid combines (K1's typed multiply is in
// gather_mult.cu).
//
// All kernels move 32-bit words.  Values travel as raw bits (uint32_t) and
// are reinterpreted per carrier type: FP32 as float, INT32 as int, UINT32 as
// unsigned, BOOL as int 0/1.  The codes below must match the tables in
// graphblas_tpu_torch/core/engine/kernels.py.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_ELEMS 16384  // one (128,128) tile
#define NT 1024           // threads per tile block
#define EPT (TILE_ELEMS / NT)
#define MAXCH 4           // channels per permutation launch

// carrier type codes
#define DT_F32 0
#define DT_I32 1
#define DT_U32 2
#define DT_BOOL 3

// monoid codes
#define MO_PLUS 0
#define MO_TIMES 1
#define MO_MIN 2
#define MO_MAX 3
#define MO_LOR 4
#define MO_LAND 5
#define MO_BAND 6
#define MO_BOR 7
#define MO_LXOR 8
#define MO_LXNOR 9  // also the BOOL monoid eq
#define MO_BXOR 10

// The tile-permutation closed form: output element (r, l) of the packed
// three-phase tile permutation p (A = bits 0-6, B = 7-13, C = 14-20) is
//   out[r, l] = x[B[m, r], A[B[m, r], m]],  m = C[r, l]
// which is the lane gather / transpose / lane gather / transpose / lane
// gather of graphblas_tpu/core/engine/permute.py:_tile_perm_body written as
// one index.  ab_src computes it on a swizzled 16-bit copy of the tile in
// shared memory: ab_store keeps the A and B fields of word p at (r, c) in
// column c ^ ((r & 31) << 1), so the lookup B[m, r] across a warp's 32
// values of m reads 32 distinct banks when the m are distinct mod 32 (a
// row-major copy puts them all on one bank).  The caller keeps m = C[r, l]
// itself.
__device__ __forceinline__ int ab_col(int r, int c) {
  return c ^ ((r & 31) << 1);
}

__device__ __forceinline__ void ab_store(uint16_t* s, int r, int c, int p) {
  s[r * 128 + ab_col(r, c)] = (uint16_t)(p & 0x3fff);
}

__device__ __forceinline__ int ab_at(const uint16_t* s, int r, int c) {
  return s[r * 128 + ab_col(r, c)];
}

__device__ __forceinline__ int ab_src(const uint16_t* s, int r, int m) {
  const int b = (ab_at(s, m, r) >> 7) & 127;
  return b * 128 + (ab_at(s, b, m) & 127);
}

// A published value for a look-back: the 32-bit value in the high half of
// a 64-bit word, a nonzero flag in the low half.  The word is stored and
// loaded whole (a naturally aligned 64-bit access is single-copy atomic),
// so a reader that sees the flag sees the value written with it, and no
// fence is needed.
__device__ __forceinline__ void st_word(unsigned long long* p, uint32_t v,
                                        uint32_t flag) {
  const unsigned long long w = (unsigned long long)v << 32 | flag;
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" :: "l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_word(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w) : "l"(p)
               : "memory");
  return w;
}

__device__ __forceinline__ float as_f(uint32_t x) { return __uint_as_float(x); }
__device__ __forceinline__ uint32_t f_bits(float x) { return __float_as_uint(x); }

// NaN-propagating min/max, as jnp.minimum / torch.minimum (the monoids)
__device__ __forceinline__ float fmin_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}
__device__ __forceinline__ float fmax_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// monoid combine(left, right) on carrier bits
template <int DT>
__device__ __forceinline__ uint32_t combine_bits(int mo, uint32_t x, uint32_t y) {
  if (DT == DT_F32) {
    float a = as_f(x), b = as_f(y);
    switch (mo) {
      case MO_PLUS: return f_bits(a + b);
      case MO_TIMES: return f_bits(a * b);
      case MO_MIN: return f_bits(fmin_nan(a, b));
      case MO_MAX: return f_bits(fmax_nan(a, b));
    }
    return 0;
  } else {
    switch (mo) {
      case MO_PLUS: return x + y;
      case MO_TIMES: return x * y;
      case MO_BAND: return x & y;
      case MO_BOR: return x | y;
      case MO_BXOR: return x ^ y;
      // booleans ride as 0/1: lor = max, land = product
      case MO_LOR: return x > y ? x : y;
      case MO_LAND: return x * y;
      case MO_LXOR: return x ^ y;
      case MO_LXNOR: return (x ^ y) ^ 1u;
      case MO_MIN:
        if (DT == DT_U32) return x < y ? x : y;
        return (int)x < (int)y ? x : y;
      case MO_MAX:
        if (DT == DT_U32) return x > y ? x : y;
        return (int)x > (int)y ? x : y;
    }
    return 0;
  }
}

// Packed BOOL codes: 0 = no value, 1 + v = value v; 0 is the identity.
template <int DT>
__device__ __forceinline__ uint32_t combine_any(int mo, bool packed, uint32_t x,
                                                uint32_t y) {
  if (!packed) return combine_bits<DT>(mo, x, y);
  if (x == 0) return y;
  if (y == 0) return x;
  return combine_bits<DT_I32>(mo, x - 1, y - 1) + 1;
}

// Asynchronous 16-byte copy from global to shared memory (bypassing L1);
// both addresses 16-byte aligned.  cp_async_wait_all waits for all of the
// thread's copies; a __syncthreads after it publishes them to the block.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Word e (0..3) of v.  Kernels that store a 16-byte load word by word
// rotate e with the lane, (s + lane / 8) % 4 at step s, so that a warp's
// 32 stores of one step fall in 32 different banks.
__device__ __forceinline__ int int4_word(const int4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// *value = attribute ATTR of the current device, queried once per device
// (a launch policy asks on every call).
template <cudaDeviceAttr ATTR>
static cudaError_t device_attr(int* value) {
  static int cache[64];  // 0: not read yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaDeviceGetAttribute(value, ATTR, dev);
  if (!cache[dev]) {
    err = cudaDeviceGetAttribute(&cache[dev], ATTR, dev);
    if (err != cudaSuccess) return err;
  }
  *value = cache[dev];
  return cudaSuccess;
}

