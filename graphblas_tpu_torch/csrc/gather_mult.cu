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
// Bound: bytes.  The function reads locidx, okg, avals and the permA index
// once a slot, the G block's column map idx1 and the window of u once a
// block, and writes one word a slot (two with okp): 95.1 MB at the zipf
// plan, 0.0284 ms at 3.35 TB/s.
//
// The design, as the Pallas kernel's: the column map is gathered once into
// a table z[a][l] = u2[(w*128 + a)*128 + idx1[blk*128 + a, l]] in shared
// memory, and each slot then reads z[arow][l]: no slot waits on a chain of
// global loads.  One 1024-thread block a G block (two 128-row tiles), so z
// is built once; 212 KB of shared memory, one block an SM, and the zipf
// plan's 129 G blocks run in one wave.  Thread (q, c) of a tile owns lanes
// 4q .. 4q + 3 of rows 8c .. 8c + 7, so every global access is 16 bytes
// and a warp's covers one 512-byte row.
//   1. Every read starts at once: idx1's 64 KB by cp.async into tile 1's
//      output buffer; the thread's permA, locidx and okg words.  The A and
//      B fields of permA go to K4's swizzled 16-bit copy (common.cuh), the
//      C fields (the thread's own lookups) and arow | ok << 7 stay in
//      registers, a byte a slot.
//   2. z: thread (q, w) builds lanes 4q .. 4q + 3 of rows w + 32 i.  Lane l
//      sits at column (l % 4) * 32 + l / 4 (zpos), so the 32 lookups of a
//      warp for one row and one j = l % 4 hit 32 banks whatever the rows.
//      Its validity (unless full_u) is a byte table in the plain layout,
//      where the 32 lanes 4q + j of a warp's lookups hit 32 banks too.
//   3. Each slot: avals, z and its validity from shared memory, the
//      multiply.
//   4. With permA, tile 0 is staged in z's buffer and tile 1 in idx1's,
//      and written out through stage A: each output slot's source is
//      computed once, for the value and, with okp, for its validity
//      (staged as one 32-bit word of bits a thread).
//
// The multiplies of the main paths are template arguments: FP32 times
// (PageRank), BOOL land (BFS), FP32 plus (SSSP's min_plus), where matrix,
// vector, multiply and monoid share the type.  Everything else goes
// through one out-of-line multiply (mult_dyn), which keeps the build to
// seconds (a run-time switch inlined at every unrolled site does not):
// every builtin binary op on the types of at most 32 bits, each operand
// cast from its own type to the op's, the product narrowed to the op's
// return type (INT8 sums wrap before a min sees them) and cast to the
// monoid's, as core/engine/sortpipe.py multiply computes it.
#include "common.cuh"

#define K1_NT 1024  // threads a block: one G block, two tiles
// dynamic shared memory: z (then tile 0 out), idx1 (then tile 1 out), the
// two tiles' A|B copies, z's validity bytes, the ok words of the threads
#define K1_SMEM \
  (2 * TILE_ELEMS * 4 + 2 * TILE_ELEMS * 2 + TILE_ELEMS + K1_NT * 4)

enum MulOp { MU_TIMES_F, MU_PLUS_F, MU_LAND_B, MU_DYN };

// ---------------------------------------------------------------------- //
// The out-of-line multiply: every builtin binary op on every type of at
// most 32 bits, with each operand in its own type.  A 32-bit word holds a
// value of type T_* as the engine's carrier does: FP32 as float bits, BOOL
// as 0/1, every integer sign- or zero-extended.  The codes must match
// graphblas_tpu_torch/core/engine/kernels.py.
enum { T_F32, T_I32, T_U32, T_BOOL, T_I8, T_I16, T_U8, T_U16 };
enum {
  OP_FIRST, OP_SECOND, OP_PAIR, OP_ANY, OP_PLUS, OP_MINUS, OP_RMINUS,
  OP_TIMES, OP_CDIV, OP_RDIV, OP_TRUEDIV, OP_RTRUEDIV, OP_MIN, OP_MAX,
  OP_POW, OP_ISEQ, OP_ISNE, OP_ISGT, OP_ISLT, OP_ISGE, OP_ISLE, OP_LOR,
  OP_LAND, OP_LXOR, OP_LXNOR, OP_BOR, OP_BAND, OP_BXOR, OP_BXNOR, OP_BGET,
  OP_BSET, OP_BCLR, OP_BSHIFT, OP_ATAN2, OP_HYPOT, OP_FMOD, OP_REMAINDER,
  OP_LDEXP, OP_COPYSIGN, OP_EQ, OP_NE, OP_GT, OP_LT, OP_GE, OP_LE,
  OP_COUNT
};

__device__ __forceinline__ int t_bits(int t) {
  return t == T_I8 || t == T_U8 ? 8 : t == T_I16 || t == T_U16 ? 16 : 32;
}

__device__ __forceinline__ bool t_signed(int t) {
  return t == T_I32 || t == T_I8 || t == T_I16;
}

// an integer's value from its word
__device__ __forceinline__ long long t_ext(uint32_t v, int t) {
  return t == T_U32 ? (long long)v : (long long)(int)v;
}

// a 64-bit integer wrapped to type t (a C cast), as its word
__device__ __forceinline__ uint32_t t_wrap(long long w, int t) {
  switch (t) {
    case T_I8: return (uint32_t)(int)(signed char)w;
    case T_I16: return (uint32_t)(int)(short)w;
    case T_U8: return (uint32_t)(w & 0xff);
    case T_U16: return (uint32_t)(w & 0xffff);
    case T_BOOL: return w != 0;
    default: return (uint32_t)w;
  }
}

// a float truncated toward zero and saturated to integer type t, NaN -> 0
// (core/dtypes.py float_to_int)
__device__ uint32_t t_sat(double f, int t) {
  const int nb = t_bits(t);
  const double lo = t_signed(t) ? -ldexp(1.0, nb - 1) : 0.0;
  const double hi = t_signed(t) ? ldexp(1.0, nb - 1) - 1 : ldexp(1.0, nb) - 1;
  if (f != f) return 0u;
  return t_wrap(f <= lo ? (long long)lo : f >= hi ? (long long)hi
                                                    : (long long)f, t);
}

// GraphBLAS's casts (core/dtypes.py normalize): integers wrap, floats
// saturate, nonzero -> true
__device__ uint32_t t_cast(uint32_t v, int from, int to) {
  if (from == to) return v;
  if (to == T_BOOL) return from == T_F32 ? as_f(v) != 0.0f : v != 0;
  if (to == T_F32)
    return f_bits(from == T_U32 ? (float)v : (float)(int)v);
  if (from == T_F32) return t_sat(as_f(v), to);
  return t_wrap(t_ext(v, from), to);
}

// 2 ** k for k in [-126, 127], exactly
__device__ __forceinline__ float pow2f(int k) {
  return __int_as_float((k + 127) << 23);
}

__device__ uint32_t mult_f32(int op, float a, float b) {
  // one rounding an operation, as the plain version's separate torch ops
  // (no contraction into an fma)
  switch (op) {
    case OP_FIRST: case OP_ANY: return f_bits(a);
    case OP_SECOND: return f_bits(b);
    case OP_PAIR: return f_bits(1.0f);
    case OP_PLUS: return f_bits(__fadd_rn(a, b));
    case OP_MINUS: return f_bits(__fsub_rn(a, b));
    case OP_RMINUS: return f_bits(__fsub_rn(b, a));
    case OP_TIMES: return f_bits(__fmul_rn(a, b));
    case OP_CDIV: case OP_TRUEDIV: return f_bits(__fdiv_rn(a, b));
    case OP_RDIV: case OP_RTRUEDIV: return f_bits(__fdiv_rn(b, a));
    // the binary ops min/max ignore a NaN operand (GraphBLAS, fmin)
    case OP_MIN: return f_bits(fminf(a, b));
    case OP_MAX: return f_bits(fmaxf(a, b));
    case OP_POW: return f_bits(powf(a, b));
    case OP_ISEQ: return f_bits(a == b ? 1.0f : 0.0f);
    case OP_ISNE: return f_bits(a != b ? 1.0f : 0.0f);
    case OP_ISGT: return f_bits(a > b ? 1.0f : 0.0f);
    case OP_ISLT: return f_bits(a < b ? 1.0f : 0.0f);
    case OP_ISGE: return f_bits(a >= b ? 1.0f : 0.0f);
    case OP_ISLE: return f_bits(a <= b ? 1.0f : 0.0f);
    // the operands' truth values, as 1 or 0 in the type (a NaN is true)
    case OP_LOR: return f_bits(a != 0.0f || b != 0.0f ? 1.0f : 0.0f);
    case OP_LAND: return f_bits(a != 0.0f && b != 0.0f ? 1.0f : 0.0f);
    case OP_LXOR: return f_bits((a != 0.0f) != (b != 0.0f) ? 1.0f : 0.0f);
    case OP_LXNOR: return f_bits((a != 0.0f) == (b != 0.0f) ? 1.0f : 0.0f);
    case OP_ATAN2: return f_bits(atan2f(a, b));
    case OP_HYPOT: return f_bits(hypotf(a, b));
    case OP_FMOD: return f_bits(fmodf(a, b));
    // IEEE remainder as torch computes it: x - round_half_even(x / y) * y
    case OP_REMAINDER:
      return f_bits(__fsub_rn(a, __fmul_rn(rintf(__fdiv_rn(a, b)), b)));
    // x * 2 ** trunc(y), the exponent saturated to int32 and cut to
    // [-300, 300], in three exact power-of-two steps (ufuncs.ldexp)
    case OP_LDEXP: {
      const int e = min(max((int)t_sat(b, T_I32), -300), 300);
      const int a1 = e / 3, a2 = (e - a1) / 2, a3 = e - a1 - a2;
      return f_bits(__fmul_rn(__fmul_rn(__fmul_rn(a, pow2f(a1)), pow2f(a2)),
                              pow2f(a3)));
    }
    case OP_COPYSIGN: return f_bits(copysignf(a, b));
    case OP_EQ: return a == b;
    case OP_NE: return a != b;
    case OP_GT: return a > b;
    case OP_LT: return a < b;
    case OP_GE: return a >= b;
    case OP_LE: return a <= b;
  }
  return 0;
}

__device__ uint32_t mult_bool(int op, uint32_t a, uint32_t b) {
  switch (op) {
    case OP_FIRST: case OP_ANY: return a;
    case OP_SECOND: return b;
    case OP_PAIR: return 1u;
    case OP_TIMES: case OP_MIN: case OP_LAND: return a & b;
    case OP_PLUS: case OP_MAX: case OP_LOR: return a | b;
    case OP_MINUS: case OP_RMINUS: case OP_LXOR: case OP_ISNE: case OP_NE:
      return a ^ b;
    case OP_CDIV: return b ? a : 1u;
    case OP_RDIV: return a ? b : 1u;
    case OP_POW: return a | (b ^ 1u);
    case OP_ISEQ: case OP_LXNOR: case OP_EQ: return (a ^ b) ^ 1u;
    case OP_ISGT: case OP_GT: return a > b;
    case OP_ISLT: case OP_LT: return a < b;
    case OP_ISGE: case OP_GE: return a >= b;
    case OP_ISLE: case OP_LE: return a <= b;
  }
  return 0;
}

// C-truncated x / y with SuiteSparse's x / 0 (0, or the type's extremum)
__device__ long long idiv(long long x, long long y, int t) {
  if (y != 0) return x / y;
  if (x == 0) return 0;
  const int nb = t_bits(t);
  if (!t_signed(t)) return (long long)((1ull << nb) - 1);
  return x > 0 ? (1ll << (nb - 1)) - 1 : -(1ll << (nb - 1));
}

__device__ uint32_t mult_int(int op, int t, long long x, long long y) {
  const int nb = t_bits(t);
  switch (op) {
    case OP_FIRST: case OP_ANY: return t_wrap(x, t);
    case OP_SECOND: return t_wrap(y, t);
    case OP_PAIR: return 1u;
    case OP_PLUS: return t_wrap(x + y, t);
    case OP_MINUS: return t_wrap(x - y, t);
    case OP_RMINUS: return t_wrap(y - x, t);
    case OP_TIMES: return t_wrap(x * y, t);
    case OP_CDIV: return t_wrap(idiv(x, y, t), t);
    case OP_RDIV: return t_wrap(idiv(y, x, t), t);
    case OP_MIN: return t_wrap(x < y ? x : y, t);
    case OP_MAX: return t_wrap(x > y ? x : y, t);
    // through float64, truncated, as ufuncs.power
    case OP_POW: return t_sat(pow((double)x, (double)y), t);
    case OP_ISEQ: case OP_EQ: return x == y;
    case OP_ISNE: case OP_NE: return x != y;
    case OP_ISGT: case OP_GT: return x > y;
    case OP_ISLT: case OP_LT: return x < y;
    case OP_ISGE: case OP_GE: return x >= y;
    case OP_ISLE: case OP_LE: return x <= y;
    case OP_LOR: return x != 0 || y != 0;
    case OP_LAND: return x != 0 && y != 0;
    case OP_LXOR: return (x != 0) != (y != 0);
    case OP_LXNOR: return (x != 0) == (y != 0);
    case OP_BOR: return t_wrap(x | y, t);
    case OP_BAND: return t_wrap(x & y, t);
    case OP_BXOR: return t_wrap(x ^ y, t);
    case OP_BXNOR: return t_wrap(~(x ^ y), t);
    // a bit position outside [0, width) shifts everything out
    case OP_BGET:
      if (y >= 0 && y < nb) return t_wrap((x >> y) & 1, t);
      return t_signed(t) && x < 0;
    case OP_BSET: return t_wrap(y >= 0 && y < nb ? x | (1ll << y) : x, t);
    case OP_BCLR: return t_wrap(y >= 0 && y < nb ? x & ~(1ll << y) : x, t);
    case OP_BSHIFT: {  // left for y >= 0, right (arithmetic if signed)
      const long long m = y < 0 ? -y : y;
      if (y >= 0) return m >= nb ? 0u : t_wrap(x << m, t);
      if (m >= nb) return t_signed(t) && x < 0 ? t_wrap(-1, t) : 0u;
      return t_wrap(x >> m, t);
    }
  }
  return 0;
}

// code = x type | y type << 3 | op's first input type << 6 | second << 9
//        | op's return type << 12 | monoid type << 15 | op << 18
__device__ __noinline__ uint32_t mult_dyn(int code, uint32_t x, uint32_t y) {
  const int xt = code & 7, yt = (code >> 3) & 7, t1 = (code >> 6) & 7,
            t2 = (code >> 9) & 7, rt = (code >> 12) & 7, zt = (code >> 15) & 7,
            op = code >> 18;
  const uint32_t a = t_cast(x, xt, t1), b = t_cast(y, yt, t2);
  uint32_t r;
  if (t1 == T_F32) r = mult_f32(op, as_f(a), as_f(b));
  else if (t1 == T_BOOL) r = mult_bool(op, a, b);
  else r = mult_int(op, t1, t_ext(a, t1), t_ext(b, t2));
  return t_cast(r, rt, zt);
}

template <int OP>
__device__ __forceinline__ uint32_t mul(int code, uint32_t x, uint32_t y) {
  if constexpr (OP == MU_TIMES_F) return f_bits(as_f(x) * as_f(y));
  else if constexpr (OP == MU_PLUS_F) return f_bits(as_f(x) + as_f(y));
  else if constexpr (OP == MU_LAND_B) return (x != 0) & (y != 0);
  else return mult_dyn(code, x, y);
}

// arow | ok << 7 of a slot
__device__ __forceinline__ uint32_t slot_byte(int arow, int ok) {
  return ((uint32_t)arow & 127u) | (uint32_t)(ok != 0) << 7;
}

__device__ __forceinline__ uint32_t c_field(int p) { return (p >> 14) & 127; }

// z's index of row a, lane l
__device__ __forceinline__ int zpos(int a, int l) {
  return a * 128 + (l & 3) * 32 + (l >> 2);
}

template <int OP>
__global__ void __launch_bounds__(K1_NT, 1) gather_mult_kernel(
    const int* __restrict__ meta, const uint32_t* __restrict__ u2,
    const int* __restrict__ u2ok, const int* __restrict__ idx1,
    const int* __restrict__ locidx, const int* __restrict__ okg,
    const uint32_t* __restrict__ avals, const int* __restrict__ permA,
    uint32_t* __restrict__ out, int* __restrict__ okp, int code, int mxv,
    int packed, int full_u, uint32_t ident) {
  extern __shared__ int4 smem4[];
  uint32_t* z = reinterpret_cast<uint32_t*>(smem4);  // z, then tile 0 out
  uint32_t* s1 = z + TILE_ELEMS;                     // idx1, then tile 1 out
  uint16_t* sab = reinterpret_cast<uint16_t*>(s1 + TILE_ELEMS);
  uint8_t* zok = reinterpret_cast<uint8_t*>(sab + 2 * TILE_ELEMS);
  uint32_t* sok = reinterpret_cast<uint32_t*>(zok + TILE_ELEMS);
  const int tid = threadIdx.x, blk = blockIdx.x;
  const int ti = tid >> 9, tt = tid & 511;  // the thread's tile, its place in it
  const int q = tt & 31, r0 = (tt >> 5) * 8;
  const size_t e0 = ((size_t)blk * 2 + ti) * TILE_ELEMS + (size_t)r0 * 128 + 4 * q;
  uint16_t* sabt = sab + ti * TILE_ELEMS;
  uint32_t* st = ti ? s1 : z;  // the tile out, staged

  // 1. every read in flight at once
  const int* col = idx1 + (size_t)blk * TILE_ELEMS;
  for (int i = tid; i < TILE_ELEMS / 4; i += K1_NT)
    cp_async16(s1 + 4 * i, col + 4 * i);
  uint32_t lo[8], mc[8] = {};  // byte j of word k: slot (r0 + k, 4q + j)
  if (permA != nullptr) {
#pragma unroll
    for (int k = 0; k < 8; k++) {
      const int4 p = __ldg(reinterpret_cast<const int4*>(permA + e0 + k * 128));
      // ab_store of four lanes: ab_col keeps the pairs (4q, 4q + 1) and
      // (4q + 2, 4q + 3) adjacent, one 32-bit store each
      const int r = r0 + k, c0 = ab_col(r, 4 * q), c2 = ab_col(r, 4 * q + 2);
      uint32_t* row = reinterpret_cast<uint32_t*>(sabt + r * 128);
      row[c0 >> 1] = (uint32_t)(p.x & 0x3fff) | (uint32_t)(p.y & 0x3fff) << 16;
      row[c2 >> 1] = (uint32_t)(p.z & 0x3fff) | (uint32_t)(p.w & 0x3fff) << 16;
      mc[k] = c_field(p.x) | c_field(p.y) << 8 | c_field(p.z) << 16 |
              c_field(p.w) << 24;
    }
  }
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(locidx + e0 + k * 128));
    const int4 o = __ldg(reinterpret_cast<const int4*>(okg + e0 + k * 128));
    lo[k] = slot_byte(a.x, o.x) | slot_byte(a.y, o.y) << 8 |
            slot_byte(a.z, o.z) << 16 | slot_byte(a.w, o.w) << 24;
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. z from idx1: thread (q, w) builds lanes 4q .. 4q + 3 of rows
  //    w, w + 32, w + 64, w + 96
  {
    const size_t wrow = (size_t)meta[blk * 3] * 128;
    const int zq = tid & 31, w = tid >> 5;
#pragma unroll
    for (int i = 0; i < 4; i++) {
      const int a = w + 32 * i;
      const int4 cv = reinterpret_cast<const int4*>(s1 + a * 128)[zq];
      const size_t ub = (wrow + a) * 128;
      const int cc[4] = {cv.x, cv.y, cv.z, cv.w};
      uint32_t okw = 0;  // the four lanes' validity bytes
#pragma unroll
      for (int j = 0; j < 4; j++) {
        z[zpos(a, 4 * zq + j)] = __ldg(u2 + ub + cc[j]);
        if (!full_u) okw |= (uint32_t)(__ldg(u2ok + ub + cc[j]) != 0) << (8 * j);
      }
      if (!full_u) reinterpret_cast<uint32_t*>(zok)[a * 32 + zq] = okw;
    }
  }
  __syncthreads();

  // 3. each slot from the table
  uint32_t val[32];  // slot k: row r0 + k / 4, lane 4q + k % 4
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(avals + e0 + k * 128));
    val[4 * k] = a.x;
    val[4 * k + 1] = a.y;
    val[4 * k + 2] = a.z;
    val[4 * k + 3] = a.w;
  }
  uint32_t okbits = 0;  // bit k: slot k is valid
#pragma unroll
  for (int k = 0; k < 32; k++) {
    const uint32_t b = (lo[k / 4] >> (8 * (k % 4))) & 255u;
    const int arow = b & 127, l = 4 * q + k % 4;
    const uint32_t g = z[zpos(arow, l)];
    uint32_t ok = b >> 7;
    if (!full_u) ok &= zok[arow * 128 + l];
    const uint32_t x = mxv ? val[k] : g, y = mxv ? g : val[k];
    const uint32_t p = mul<OP>(code, x, y);
    val[k] = packed ? (ok ? p + 1u : 0u) : (ok ? p : ident);
    okbits |= ok << k;
  }

  // 4. out, through stage A
  if (permA == nullptr) {
#pragma unroll
    for (int k = 0; k < 8; k++) {
      *reinterpret_cast<uint4*>(out + e0 + k * 128) =
          make_uint4(val[4 * k], val[4 * k + 1], val[4 * k + 2], val[4 * k + 3]);
      if (okp != nullptr)
        *reinterpret_cast<uint4*>(okp + e0 + k * 128) =
            make_uint4((okbits >> (4 * k)) & 1u, (okbits >> (4 * k + 1)) & 1u,
                       (okbits >> (4 * k + 2)) & 1u, (okbits >> (4 * k + 3)) & 1u);
    }
    return;
  }
  __syncthreads();  // every slot has read z, every thread idx1
#pragma unroll
  for (int k = 0; k < 8; k++)
    *reinterpret_cast<uint4*>(st + (r0 + k) * 128 + 4 * q) =
        make_uint4(val[4 * k], val[4 * k + 1], val[4 * k + 2], val[4 * k + 3]);
  sok[tid] = okbits;
  __syncthreads();
  const uint32_t* sokt = sok + ti * 512;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint32_t o[4], h[4];
#pragma unroll
    for (int j = 0; j < 4; j++) {
      const int src = ab_src(sabt, r0 + k, (int)((mc[k] >> (8 * j)) & 127));
      o[j] = st[src];
      // slot (rs, ls) is bit (rs % 8) * 4 + ls % 4 of thread (ls / 4, rs / 8)
      const int rs = src >> 7, ls = src & 127;
      h[j] = (sokt[(rs >> 3) * 32 + (ls >> 2)] >> ((rs & 7) * 4 + (ls & 3))) & 1u;
    }
    *reinterpret_cast<uint4*>(out + e0 + k * 128) = make_uint4(o[0], o[1], o[2], o[3]);
    if (okp != nullptr)
      *reinterpret_cast<uint4*>(okp + e0 + k * 128) = make_uint4(h[0], h[1], h[2], h[3]);
  }
}

template <int OP>
static int launch(int nblocks, cudaStream_t st, const int* meta,
                  const uint32_t* u2, const int* u2ok, const int* idx1,
                  const int* locidx, const int* okg, const uint32_t* avals,
                  const int* permA, uint32_t* out, int* okp, int code,
                  int mxv, int packed, int full_u, uint32_t ident) {
  cudaError_t err = cudaFuncSetAttribute(
      gather_mult_kernel<OP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K1_SMEM);
  if (err != cudaSuccess) return (int)err;
  gather_mult_kernel<OP><<<nblocks, K1_NT, K1_SMEM, st>>>(
      meta, u2, u2ok, idx1, locidx, okg, avals, permA, out, okp, code, mxv,
      packed, full_u, ident);
  return (int)cudaGetLastError();
}

// One launch.  ntiles = R_g / 128, two tiles a G block.  Every pointer but
// meta, u2 and u2ok is 16-byte aligned.  fast picks a templated multiply
// (1: FP32 times, 2: FP32 plus, 3: BOOL land, every type the same);
// 0 runs mult_dyn with `code`.
extern "C" int gather_mult(const void* meta, const void* u2, const void* u2ok,
                           const void* idx1, const void* locidx,
                           const void* okg, const void* avals,
                           const void* permA, void* out, void* okp,
                           int ntiles, int code, int fast, int mxv, int packed,
                           int full_u, int ident_bits, void* stream) {
  if (fast < 0 || fast > 3 || (code >> 18) >= OP_COUNT || code < 0 ||
      ntiles % 2)
    return (int)cudaErrorInvalidValue;
  if (ntiles <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define ARGS                                                                \
  ntiles / 2, st, (const int*)meta, (const uint32_t*)u2, (const int*)u2ok,  \
      (const int*)idx1, (const int*)locidx, (const int*)okg,                \
      (const uint32_t*)avals, (const int*)permA, (uint32_t*)out, (int*)okp, \
      code, mxv, packed, full_u, (uint32_t)ident_bits
  int rc;
  if (fast == 1) rc = launch<MU_TIMES_F>(ARGS);
  else if (fast == 2) rc = launch<MU_PLUS_F>(ARGS);
  else if (fast == 3) rc = launch<MU_LAND_B>(ARGS);
  else rc = launch<MU_DYN>(ARGS);
#undef ARGS
  return rc;
}
