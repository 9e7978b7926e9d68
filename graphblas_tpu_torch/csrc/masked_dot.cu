// K8: the masked dot's count of matching terms, C<M> = A pair B.
//
// Replaces no TPU kernel.  The JAX package's masked dot
// (graphblas_tpu/core/engine/sparse.py) is jnp ops: it expands every term
// (the shorter of A(i, :) and B(:, j) at each mask entry (i, j)), finds each
// term's k in the other side by a binary search over both sides' keys, and
// reduces the products per entry.  The port's plain version of that
// (graphblas_tpu_torch/core/engine/sparse.py _dot_term_slots) writes some
// 60 bytes a term to device memory; triangle counting on a Kronecker graph
// of 7.6 M entries makes 4.5e8 terms, 25 GB and 65 ms.  Under a `pair`
// multiply the value at an entry follows from its number of matching
// terms alone (sparse.dot_by_counts), so this kernel counts them and
// writes one int64 per mask entry, nothing per term.
//
// Bound: the bytes read or written once are the mask's coordinates and
// the running count of its terms (24 B an entry), the int32 k (one array
// in triangle counting, where both sides are L's rows: 4 B an entry of
// L), both sides' int64 indptr, and the counts (8 B an entry): 141 MB at
// that graph, 0.042 ms at 3.35 TB/s.  The work is one binary search a term over the other
// side's row, log2(its degree) dependent loads, mostly from L2 (the keys
// are int32, 15 MB at that graph, under the 50 MB L2); the term rate is
// the yardstick (PERF.md).
//
// Design: the terms are numbered 0 .. total-1, entry by entry (cs, the
// inclusive running count of min(deg_a, deg_b), 0 where the mask fails),
// and each warp takes MD_ROUNDS rounds of 32 consecutive terms, so the
// work is balanced however skewed the degrees (0 to 25 k terms an entry).
//   1. the warp finds the owner of its first term by one binary search of
//      cs; in each round a lane finds its term's owner by a galloping
//      search from the owner of the round's first term (usually one probe),
//      and keeps the owner's row bounds while the owner stays the same;
//   2. the lane reads its term's k from the shorter row (consecutive lanes
//      read consecutive keys) and binary-searches it in the longer row's
//      own range [indptr[r], indptr[r + 1]), branchless, in 32-bit
//      positions; where one owner holds the whole round (most terms: an
//      entry averages 118), the lanes first load 32 splitters of the
//      longer row and each finds its key's 1/32 of the row by a search
//      over the lanes (shuffles), five dependent loads fewer;
//   3. the lanes of one owner are consecutive; the last lane of each run
//      adds the run's hits (a popcount of the round's ballot) with one
//      integer atomicAdd, except the run at lane 31, which carries into
//      the next round while the owner goes on (a round of one owner only
//      adds to the carry).  Integer counts make the result the same
//      whatever the order of the atomics.
// The instructions of a round, not the bytes, bound it: the keys and
// the rows' bounds come from L1 and L2 (PERF.md).
// Scratch: none (cs and the zeroed counts come from the wrapper).
#include <cuda_runtime.h>
#include <stdint.h>

#define MD_WARPS 8    // warps a block
#define MD_ROUNDS 32  // rounds of 32 terms a warp

typedef unsigned long long u64;

// The smallest e' >= e with cs[e'] > t, for t < cs[n - 1]: a galloping
// search from e, which already owns a term at or before t.
__device__ __forceinline__ int owner_from(const long long* __restrict__ cs,
                                          int n, int e, long long t) {
  if (cs[e] > t) return e;
  long long lo = e, hi, step = 1;  // cs[lo] <= t < cs[hi]
  for (;;) {
    const long long p = lo + step;
    if (p >= n - 1) {
      hi = n - 1;
      break;
    }
    if (cs[p] > t) {
      hi = p;
      break;
    }
    lo = p;
    step <<= 1;
  }
  while (hi - lo > 1) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (cs[mid] > t) hi = mid;
    else lo = mid;
  }
  return (int)hi;
}

// The first position in [lo, lo + n) whose key is >= k (lo + n if none):
// a branchless binary search, one select a step.
template <typename KT>
__device__ __forceinline__ int lower_bound(const KT* __restrict__ L, int lo,
                                           int n, KT k) {
  if (n <= 0) return lo;
  while (n > 1) {
    const int half = n >> 1;
    lo = L[lo + half] < k ? lo + half : lo;
    n -= half;
  }
  return lo + (L[lo] < k);
}

template <typename KT>
__global__ void __launch_bounds__(MD_WARPS * 32)
    masked_dot_kernel(const KT* __restrict__ ak, const KT* __restrict__ bk,
                      const long long* __restrict__ ia,
                      const long long* __restrict__ ib,
                      const long long* __restrict__ mr,
                      const long long* __restrict__ mc,
                      const long long* __restrict__ cs, int n_m,
                      long long total, u64* __restrict__ out) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * MD_WARPS + (threadIdx.x >> 5);
  const long long t0 = warp * (32LL * MD_ROUNDS);
  if (t0 >= total) return;  // the whole warp

  int e_base;  // the owner of the round's first term
  {
    int lo = 0, hi = n_m - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cs[mid] > t0) hi = mid;
      else lo = mid + 1;
    }
    e_base = lo;
  }
  // the lane's cached owner ce: its term t's key sits at s0 + (t - prev)
  // in the shorter side (A's where ua), the longer side's row at
  // [lo0, hi0); positions fit 32 bits (the wrapper checks)
  int ce = -1, s0 = 0, lo0 = 0, hi0 = 0;
  long long prev = 0;
  bool ua = true;
  int carry_e = -1;  // the owner of the round's last run, carried on
  u64 carry = 0;
  for (int r = 0; r < MD_ROUNDS; r++) {
    const long long t = t0 + r * 32 + lane;
    int e = -1;
    KT k = 0;
    if (t < total) {
      e = owner_from(cs, n_m, e_base, t);
      if (e != ce) {
        ce = e;
        prev = e > 0 ? cs[e - 1] : 0;
        const long long i = mr[e], j = mc[e];
        const int a0 = (int)ia[i], a1 = (int)ia[i + 1];
        const int b0 = (int)ib[j], b1 = (int)ib[j + 1];
        ua = a1 - a0 <= b1 - b0;
        s0 = ua ? a0 : b0;
        lo0 = ua ? b0 : a0;
        hi0 = ua ? b1 : a1;
      }
      k = (ua ? ak : bk)[s0 + (int)(t - prev)];
    }
    const int e0 = __shfl_sync(FULL, e, 0);
    const int e31 = __shfl_sync(FULL, e, 31);
    const bool one = e0 == e31 && e0 >= 0;  // one owner for the round
    const KT* __restrict__ L = ua ? bk : ak;
    int lo = lo0, hi = hi0;
    if (one && hi0 - lo0 >= 32) {
      // lo0, hi0 and ua are the warp's: 32 splitters of the longer row,
      // one a lane, narrow each lane's search to 1/32 of the row by a
      // search over the lanes
      const long long len = hi0 - lo0;
      const KT v = L[lo0 + (int)((len * lane) >> 5)];
      const KT v31 = __shfl_sync(FULL, v, 31);
      int q = 0;  // splitters below k
#pragma unroll
      for (int s = 16; s >= 1; s >>= 1) {
        const KT w = __shfl_sync(FULL, v, q + s - 1);
        if (w < k) q += s;
      }
      if (q == 31 && v31 < k) q = 32;
      if (q > 0) lo = lo0 + (int)((len * (q - 1)) >> 5) + 1;
      if (q < 32) hi = lo0 + (int)((len * q) >> 5);
    }
    bool hit = false;
    if (e >= 0) {
      const int pos = lower_bound(L, lo, hi - lo, k);
      hit = pos < hi0 && L[pos] == k;
    }
    const unsigned hits = __ballot_sync(FULL, hit);
    if (one) {  // the round's hits all go to e0
      if (carry_e != e0) {
        if (lane == 0 && carry) atomicAdd(out + carry_e, carry);
        carry = 0;
        carry_e = e0;
      }
      carry += __popc(hits);
      e_base = e0;
      continue;
    }
    // runs of lanes with one owner (the owners rise with the lane; the
    // lanes past the last term hold -1 and form the last run)
    const int e_up = __shfl_up_sync(FULL, e, 1);
    const int e_dn = __shfl_down_sync(FULL, e, 1);
    const unsigned heads = __ballot_sync(FULL, lane == 0 || e_up != e);
    const bool tail = lane == 31 || e_dn != e;
    if (carry_e >= 0 && carry_e != e0) {  // the carried run has ended
      if (lane == 0 && carry) atomicAdd(out + carry_e, carry);
      carry = 0;
      carry_e = -1;
    }
    const unsigned upto = lane == 31 ? FULL : (2u << lane) - 1;
    const int start = 31 - __clz(heads & upto);
    u64 c = __popc(hits & upto & ~((1u << start) - 1));
    if (start == 0) c += carry;  // lane 0's run goes on from the carry
    const u64 c31 = __shfl_sync(FULL, c, 31);
    if (tail && lane != 31 && e >= 0 && c) atomicAdd(out + e, c);
    if (e31 < 0) return;  // lane 31 is past the last term: nothing carries
    carry = c31;
    carry_e = e31;
    e_base = e31;
  }
  if (lane == 0 && carry) atomicAdd(out + carry_e, carry);
}

// out[e] += the number of k that A's row mr[e] and B's column mc[e] both
// store, for every mask entry e, over the terms [0, total) that cs numbers
// (cs[n_m - 1] == total); out must be zeroed first.  Keys are int32, or
// int64 where wide.  One launch; returns cudaGetLastError().
extern "C" int masked_dot(const void* ak, const void* bk, const void* ia,
                          const void* ib, const void* mr, const void* mc,
                          const void* cs, void* out, int wide, int n_m,
                          long long total, void* stream) {
  if (total <= 0 || n_m <= 0) return 0;
  const long long per_block = 32LL * MD_ROUNDS * MD_WARPS;
  const long long blocks = (total + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long* i64[5] = {(const long long*)ia, (const long long*)ib,
                             (const long long*)mr, (const long long*)mc,
                             (const long long*)cs};
  if (wide)
    masked_dot_kernel<long long><<<(unsigned)blocks, MD_WARPS * 32, 0, st>>>(
        (const long long*)ak, (const long long*)bk, i64[0], i64[1], i64[2],
        i64[3], i64[4], n_m, total, (u64*)out);
  else
    masked_dot_kernel<int><<<(unsigned)blocks, MD_WARPS * 32, 0, st>>>(
        (const int*)ak, (const int*)bk, i64[0], i64[1], i64[2], i64[3],
        i64[4], n_m, total, (u64*)out);
  return (int)cudaGetLastError();
}
