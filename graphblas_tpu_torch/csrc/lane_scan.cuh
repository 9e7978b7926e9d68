// The look-back of the single-pass lane scans, K4 (fused_scan.cu) and K5
// (lane_segscan.cu): their combines and the walk that takes a lane's carry
// from the words its predecessors published.
#pragma once

#include "common.cuh"

#define LB_BATCH 8    // predecessor words loaded at a time
#define LB_WINDOW 32  // words a lane reads before it waits

enum { ST_AGG = 1, ST_PRE = 2 };  // status of a published word; 0: none yet

// The combine of a launch, known when the kernel is compiled, or read at
// run time (SC_DYN); SC_MAX_U is packed BOOL lor (the unsigned max of the
// codes 0 = no value, 1 + v = value v), SC_MAX_I K5's validity channel.
enum ScanOp { SC_ADD_F, SC_MIN_F, SC_MAX_U, SC_MAX_I, SC_DYN };

// code = dt | mo << 4 | packed << 8.  Not inlined: one shared body keeps
// the build short (see ROADMAP, traps).
template <int = 0>
__device__ __noinline__ uint32_t comb_dyn(int code, uint32_t x, uint32_t y) {
  const int mo = (code >> 4) & 15;
  const bool packed = (code >> 8) & 1;
  switch (code & 15) {
    case DT_F32: return combine_any<DT_F32>(mo, packed, x, y);
    case DT_I32: return combine_any<DT_I32>(mo, packed, x, y);
    case DT_U32: return combine_any<DT_U32>(mo, packed, x, y);
    default: return combine_any<DT_BOOL>(mo, packed, x, y);
  }
}

// combine(left, right)
template <int OP>
__device__ __forceinline__ uint32_t comb(int code, uint32_t x, uint32_t y) {
  if constexpr (OP == SC_ADD_F) return f_bits(as_f(x) + as_f(y));
  else if constexpr (OP == SC_MIN_F) return f_bits(fmin_nan(as_f(x), as_f(y)));
  else if constexpr (OP == SC_MAX_U) return x > y ? x : y;
  else if constexpr (OP == SC_MAX_I) return (int)x > (int)y ? x : y;
  else return comb_dyn(code, x, y);
}

// Inclusive prefix of tile - 1 for one lane (and channel): the nearest
// predecessor's published prefix, then the aggregates after it, folded
// from the oldest, so the result is the chain prefix(t) = prefix(t - 1) +
// aggregate(t) in its own order whatever was published in time.  w: the
// tile's own word; a predecessor's lies `stride` words back per tile.  lb:
// this thread's column of the look-back buffer in shared memory, LB_WINDOW
// words `lbs` apart.  Past LB_WINDOW words the walk waits for the prefix
// of the tile at the window's edge; a spin that outlasts a claimed tile's
// publication by orders of magnitude traps.
template <int OP>
__device__ __forceinline__ uint32_t look_back(int code,
                                              const unsigned long long* w,
                                              size_t stride, int tile,
                                              uint32_t* lb, int lbs) {
  int d = 0;  // predecessors read
  bool found = false;
  while (!found) {
    unsigned long long x[LB_BATCH];
#pragma unroll
    for (int i = 0; i < LB_BATCH; i++)
      x[i] = tile - 1 - d - i >= 0 && d + i < LB_WINDOW
                 ? ld_word(w - (size_t)(d + i + 1) * stride) : 0ull;
#pragma unroll
    for (int i = 0; i < LB_BATCH; i++) {
      if (found) break;
      const unsigned long long* p = w - (size_t)(d + 1) * stride;
      // at the window's edge only a prefix will do
      const unsigned need = d == LB_WINDOW - 1 ? ST_PRE : ST_AGG;
      unsigned long long y = x[i];
      for (int spins = 0; (unsigned)(y & 3) < need; spins++) {
        if (spins == 1 << 26) __trap();  // fail, never hang
        y = ld_word(p);
      }
      lb[d * lbs] = (uint32_t)(y >> 32);
      found = (y & 3) == ST_PRE;
      d++;
    }
  }
  uint32_t run = lb[(d - 1) * lbs];
  for (int j = d - 2; j >= 0; j--) run = comb<OP>(code, run, lb[j * lbs]);
  return run;
}
