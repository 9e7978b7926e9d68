// K6: flat inclusive segmented scan over L elements, several channels, each
// with its own combine.
//
// Replaces graphblas_tpu/core/engine/sortpipe.py:_segscan_pallas.  A
// segment starts where `barrier` is set (and at element 0, whether set or
// not); out[i] = combine(out[i-1], x[i]) inside a segment.  Up to MAXCH
// 32-bit channels share the barrier; each channel's combine is `first`
// (keep the left operand: a fill-forward), or a monoid on its carrier type
// (integer plus for the count channel).  `combine(left, right)` is applied
// in that order everywhere, so combines need not commute.
//
// The carry.  The Pallas kernel walks the (256,128) blocks in order with a
// scalar carry.  A segment here has no length limit (a hub row of a
// power-law graph is one segment of several hundred thousand elements), so
// a walk back over earlier blocks per block would be quadratic.  The scan
// takes three launches whose cost does not depend on segment lengths and
// that assume no order between blocks:
//   1. seg_summary: per block of 4096 elements and channel, the fold from
//      the block's last barrier (or its first element), and whether the
//      block holds a barrier;
//   2. seg_carry: one block scans the per-block summaries (a segmented scan
//      of nblocks entries, 1024 at a time with a running carry) into the
//      carry that enters each block;
//   3. seg_apply: per block, the scan again, now with the carry combined
//      into the elements before the block's first barrier.
// Within a block a thread scans 4 consecutive elements (one 16-byte load),
// then the 1024 thread folds are scanned with warp shuffles and one step
// through shared memory.  The fold order differs from the Pallas kernel's
// roll tree: FP32 plus/times agree to rounding, the rest exactly.
//
// Bound: bytes.  The function reads the barrier and each channel once and
// writes each channel once: 1 + 2 nv words per element.  Launches 1 and 3
// both read the inputs: 2 + 3 nv words moved.
#include "common.cuh"

#define SEG_EPT 4
#define SEG_BLOCK (NT * SEG_EPT)
#define CC_FIRST 255  // combine code: keep the left operand

// Flat combine ops.  The entry point maps (carrier type, monoid) onto
// them, so that the device code switches once over a dozen cases.
enum SegOp {
  SO_FIRST, SO_ADD, SO_MUL, SO_AND, SO_OR, SO_MIN_I, SO_MAX_I, SO_MIN_U,
  SO_MAX_U, SO_ADD_F, SO_MUL_F, SO_MIN_F, SO_MAX_F, SO_INVALID
};

struct SegChans {
  const uint32_t* in[MAXCH];
  uint32_t* out[MAXCH];
  int cc[MAXCH];  // a SegOp per channel
};

static int seg_op(int code) {
  if (code == CC_FIRST) return SO_FIRST;
  const int dt = code >> 4, mo = code & 15;
  if (dt == DT_F32) {
    switch (mo) {
      case MO_PLUS: return SO_ADD_F;
      case MO_TIMES: return SO_MUL_F;
      case MO_MIN: return SO_MIN_F;
      case MO_MAX: return SO_MAX_F;
    }
    return SO_INVALID;
  }
  if (dt != DT_I32 && dt != DT_U32 && dt != DT_BOOL) return SO_INVALID;
  switch (mo) {
    case MO_PLUS: return SO_ADD;
    case MO_TIMES: case MO_LAND: return SO_MUL;  // booleans ride as 0/1
    case MO_BAND: return SO_AND;
    case MO_BOR: return SO_OR;
    case MO_LOR: return SO_MAX_U;
    case MO_MIN: return dt == DT_U32 ? SO_MIN_U : SO_MIN_I;
    case MO_MAX: return dt == DT_U32 ? SO_MAX_U : SO_MAX_I;
  }
  return SO_INVALID;
}

// combine(left, right) of one channel.  Not inlined: the scans below call
// it at some eighty unrolled sites per kernel, the kernels are bound by
// memory, and one shared body keeps the build to seconds.
__device__ __noinline__ uint32_t comb(int op, uint32_t x, uint32_t y) {
  switch (op) {
    case SO_FIRST: return x;
    case SO_ADD: return x + y;
    case SO_MUL: return x * y;
    case SO_AND: return x & y;
    case SO_OR: return x | y;
    case SO_MIN_I: return (int)x < (int)y ? x : y;
    case SO_MAX_I: return (int)x > (int)y ? x : y;
    case SO_MIN_U: return x < y ? x : y;
    case SO_MAX_U: return x > y ? x : y;
    case SO_ADD_F: return f_bits(as_f(x) + as_f(y));
    case SO_MUL_F: return f_bits(as_f(x) * as_f(y));
    case SO_MIN_F: return f_bits(fmin_nan(as_f(x), as_f(y)));
    case SO_MAX_F: return f_bits(fmax_nan(as_f(x), as_f(y)));
  }
  return y;
}

// Segmented scan of one (flag, values) item per thread over the block.
// In: f, v = the thread's own flag and values.  Out: f, v = the inclusive
// scan through this thread; (ex_has, ex_f, ex_v) = the scan through the
// thread before it (ex_has false for thread 0).  sw: 32 * (NV + 1) words.
template <int NV>
__device__ __forceinline__ void block_scan(const int* cc, int& f, uint32_t* v,
                                           bool& ex_has, int& ex_f,
                                           uint32_t* ex_v, uint32_t* sw) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int pf = __shfl_up_sync(0xffffffffu, f, s);
#pragma unroll
    for (int c = 0; c < NV; c++) {
      const uint32_t pv = __shfl_up_sync(0xffffffffu, v[c], s);
      if (lane >= s && !f) v[c] = comb(cc[c], pv, v[c]);
    }
    if (lane >= s) f |= pf;
  }
  __syncthreads();  // sw may still be read from an earlier call
  if (lane == 31) {
    sw[warp * (NV + 1)] = (uint32_t)f;
#pragma unroll
    for (int c = 0; c < NV; c++) sw[warp * (NV + 1) + 1 + c] = v[c];
  }
  __syncthreads();
  if (warp == 0) {
    int wf = (int)sw[lane * (NV + 1)];
    uint32_t wv[NV];
#pragma unroll
    for (int c = 0; c < NV; c++) wv[c] = sw[lane * (NV + 1) + 1 + c];
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int pf = __shfl_up_sync(0xffffffffu, wf, s);
#pragma unroll
      for (int c = 0; c < NV; c++) {
        const uint32_t pv = __shfl_up_sync(0xffffffffu, wv[c], s);
        if (lane >= s && !wf) wv[c] = comb(cc[c], pv, wv[c]);
      }
      if (lane >= s) wf |= pf;
    }
    sw[lane * (NV + 1)] = (uint32_t)wf;
#pragma unroll
    for (int c = 0; c < NV; c++) sw[lane * (NV + 1) + 1 + c] = wv[c];
  }
  __syncthreads();
  if (warp > 0) {  // fold the warps before this one in
    const int pf = (int)sw[(warp - 1) * (NV + 1)];
#pragma unroll
    for (int c = 0; c < NV; c++)
      if (!f) v[c] = comb(cc[c], sw[(warp - 1) * (NV + 1) + 1 + c], v[c]);
    f |= pf;
  }
  // the scan through the previous thread
  ex_f = __shfl_up_sync(0xffffffffu, f, 1);
#pragma unroll
  for (int c = 0; c < NV; c++) ex_v[c] = __shfl_up_sync(0xffffffffu, v[c], 1);
  ex_has = threadIdx.x > 0;
  if (lane == 0 && warp > 0) {
    ex_f = (int)sw[(warp - 1) * (NV + 1)];
#pragma unroll
    for (int c = 0; c < NV; c++) ex_v[c] = sw[(warp - 1) * (NV + 1) + 1 + c];
  }
}

// The thread's 4 elements: local inclusive scan in x, the fold from its
// last barrier (or its first element) in v, whether it has a barrier in f,
// and the index of its first barrier (SEG_EPT if none) in first.
template <int NV>
__device__ __forceinline__ void thread_scan(const SegChans& ch,
                                            const int* __restrict__ barrier,
                                            size_t e0, uint32_t (*x)[SEG_EPT],
                                            uint32_t* v, int& f, int& first) {
  const int4 b4 = *reinterpret_cast<const int4*>(barrier + e0);
  const int b[SEG_EPT] = {b4.x, b4.y, b4.z, b4.w};
  first = SEG_EPT;
#pragma unroll
  for (int k = SEG_EPT - 1; k >= 0; k--)
    if (b[k] != 0) first = k;
  f = first < SEG_EPT;
#pragma unroll
  for (int c = 0; c < NV; c++) {
    const uint4 x4 = *reinterpret_cast<const uint4*>(ch.in[c] + e0);
    x[c][0] = x4.x; x[c][1] = x4.y; x[c][2] = x4.z; x[c][3] = x4.w;
#pragma unroll
    for (int k = 1; k < SEG_EPT; k++)
      if (b[k] == 0) x[c][k] = comb(ch.cc[c], x[c][k - 1], x[c][k]);
    v[c] = x[c][SEG_EPT - 1];
  }
}

template <int NV>
__global__ void __launch_bounds__(NT) seg_summary_kernel(
    SegChans ch, const int* __restrict__ barrier, uint32_t* __restrict__ summ,
    int* __restrict__ sflag, int nblocks) {
  __shared__ uint32_t sw[32 * (NV + 1)];
  const size_t e0 = ((size_t)blockIdx.x * NT + threadIdx.x) * SEG_EPT;
  uint32_t x[NV][SEG_EPT], v[NV], ex_v[NV];
  int f, first, ex_f;
  bool ex_has;
  thread_scan<NV>(ch, barrier, e0, x, v, f, first);
  block_scan<NV>(ch.cc, f, v, ex_has, ex_f, ex_v, sw);
  if (threadIdx.x == NT - 1) {
    sflag[blockIdx.x] = f;
#pragma unroll
    for (int c = 0; c < NV; c++) summ[(size_t)c * nblocks + blockIdx.x] = v[c];
  }
}

// One block: carry[b] = segmented scan of the summaries through block b-1.
template <int NV>
__global__ void __launch_bounds__(NT) seg_carry_kernel(
    SegChans ch, const uint32_t* __restrict__ summ,
    const int* __restrict__ sflag, uint32_t* __restrict__ carry, int nblocks) {
  __shared__ uint32_t sw[32 * (NV + 1)];
  __shared__ uint32_t run[NV + 1];  // scan through the previous 1024 blocks
  bool run_has = false;
  for (int b0 = 0; b0 < nblocks; b0 += NT) {
    const int b = b0 + threadIdx.x;
    const bool live = b < nblocks;
    // dead threads sit after every live one; a flag keeps them inert
    int f = live ? sflag[b] : 1;
    uint32_t v[NV], ex_v[NV];
#pragma unroll
    for (int c = 0; c < NV; c++)
      v[c] = live ? summ[(size_t)c * nblocks + b] : 0u;
    int ex_f;
    bool ex_has;
    block_scan<NV>(ch.cc, f, v, ex_has, ex_f, ex_v, sw);
    // fold the running carry of earlier rounds in front
    if (run_has) {
#pragma unroll
      for (int c = 0; c < NV; c++) {
        if (!f) v[c] = comb(ch.cc[c], run[1 + c], v[c]);
        if (ex_has) {
          if (!ex_f) ex_v[c] = comb(ch.cc[c], run[1 + c], ex_v[c]);
        } else {
          ex_v[c] = run[1 + c];
        }
      }
      ex_has = true;
    }
    if (live && ex_has) {
#pragma unroll
      for (int c = 0; c < NV; c++) carry[(size_t)c * nblocks + b] = ex_v[c];
    }
    __syncthreads();  // everyone has read run
    if (threadIdx.x == NT - 1) {
#pragma unroll
      for (int c = 0; c < NV; c++) run[1 + c] = v[c];
    }
    run_has = true;
    __syncthreads();
  }
}

template <int NV>
__global__ void __launch_bounds__(NT) seg_apply_kernel(
    SegChans ch, const int* __restrict__ barrier,
    const uint32_t* __restrict__ carry, int nblocks) {
  __shared__ uint32_t sw[32 * (NV + 1)];
  const size_t e0 = ((size_t)blockIdx.x * NT + threadIdx.x) * SEG_EPT;
  uint32_t x[NV][SEG_EPT], v[NV], ex_v[NV];
  int f, first, ex_f;
  bool ex_has;
  thread_scan<NV>(ch, barrier, e0, x, v, f, first);
  block_scan<NV>(ch.cc, f, v, ex_has, ex_f, ex_v, sw);
  // prefix of this thread: the block's carry, then the threads before it
  const bool has_carry = blockIdx.x > 0;
  const bool open = ex_has ? !ex_f : true;  // no barrier before it in block
#pragma unroll
  for (int c = 0; c < NV; c++) {
    uint32_t pre = ex_v[c];
    bool have = ex_has;
    if (has_carry && open) {
      const uint32_t cin = carry[(size_t)c * nblocks + blockIdx.x];
      pre = have ? comb(ch.cc[c], cin, pre) : cin;
      have = true;
    }
    uint4 o;
    uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int k = 0; k < SEG_EPT; k++)
      op[k] = (have && k < first) ? comb(ch.cc[c], pre, x[c][k]) : x[c][k];
    *reinterpret_cast<uint4*>(ch.out[c] + e0) = o;
  }
}

template <int NV>
static void launch(const SegChans& ch, const int* barrier, uint32_t* summ,
                   int* sflag, uint32_t* carry, int nblocks, cudaStream_t st) {
  seg_summary_kernel<NV><<<nblocks, NT, 0, st>>>(ch, barrier, summ, sflag,
                                                 nblocks);
  seg_carry_kernel<NV><<<1, NT, 0, st>>>(ch, summ, sflag, carry, nblocks);
  seg_apply_kernel<NV><<<nblocks, NT, 0, st>>>(ch, barrier, carry, nblocks);
}

// Three launches (the caller counts all three).  n must be a multiple of
// 4096; summ and carry hold nv * n / 4096 words, sflag n / 4096.
extern "C" int segscan(const void* barrier, void** ins, void** outs,
                       const int* codes, int nv, void* summ, void* sflag,
                       void* carry, int n, void* stream) {
  if (nv < 1 || nv > MAXCH || n % SEG_BLOCK) return (int)cudaErrorInvalidValue;
  SegChans ch;
  for (int c = 0; c < MAXCH; c++) {
    ch.in[c] = c < nv ? (const uint32_t*)ins[c] : nullptr;
    ch.out[c] = c < nv ? (uint32_t*)outs[c] : nullptr;
    ch.cc[c] = c < nv ? seg_op(codes[c]) : SO_FIRST;
    if (ch.cc[c] == SO_INVALID) return (int)cudaErrorInvalidValue;
  }
  const int nblocks = n / SEG_BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
#define ARGS                                                             \
  ch, (const int*)barrier, (uint32_t*)summ, (int*)sflag, (uint32_t*)carry, \
      nblocks, st
  if (nblocks > 0) {
    switch (nv) {
      case 1: launch<1>(ARGS); break;
      case 2: launch<2>(ARGS); break;
      case 3: launch<3>(ARGS); break;
      case 4: launch<4>(ARGS); break;
    }
  }
#undef ARGS
  return (int)cudaGetLastError();
}
