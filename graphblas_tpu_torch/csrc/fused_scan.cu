// K4: route stage C + per-lane segmented monoid scan + extract stage A,
// one kernel launch (after one memset of its scratch), a single pass.
//
// Replaces graphblas_tpu/core/engine/lanepipe.py:fused_permC_scan_permA.
// On each (128,128) tile: apply the route's stage-C tile permutation, scan
// every lane (column) down the rows with the monoid, restarting where
// `barrier` is set, and apply the extract's stage-A tile permutation to
// the scanned tile.  The scan's carry runs down each lane across ALL tiles
// (row 0 of the array starts a run whether or not its barrier is set).
//
// Bound: bytes.  The function reads the route index, the barrier, the
// extract index and the values once and writes the output once: 5 words an
// element, 86.5 MB at the zipf plan's 264 tiles, 0.0258 ms at 3.35 TB/s.
//
// The design, one 1024-thread block a tile; thread (l, c) = (tid % 128,
// tid / 128) owns rows 16 c .. 16 c + 15 of lane l, so every warp load and
// store is one coalesced 128-byte row segment:
//   1. Thread 0 claims the next tile from an atomic counter, so a block
//      only ever waits on tiles that running blocks have claimed.
//   2. Every input is read once, all reads in flight together: the values
//      tile by cp.async into shared memory; the two index tiles and the
//      barrier words of the thread's own elements into registers.  A
//      thread keeps the C field of each index word (its own lookup) in
//      registers and stores the A and B fields, 16 bits, into a swizzled
//      copy: field (r, c) at column c ^ ((r & 31) << 1), so the lookup
//      B[m, r] across a warp's 32 values of m reads 32 distinct banks (up
//      to collisions of the data), where the plain layout put all of them
//      on one bank.  The barrier becomes a 16-bit mask, without atomics.
//   3. Route stage C gathers the thread's 16 values from the tile; the
//      thread scans them in registers, and the 8 chunk folds of a lane
//      meet in shared memory, so the scan is spread over all 1024 threads.
//   4. The carry, by a look-back (as K6's, csrc/segscan.cu, but 128 lanes
//      wide): per tile and lane, one 64-bit word holds a value and its
//      status.  Threads c = 0 publish the lane's aggregate (the fold from
//      its last barrier, or from row 0), as the inclusive prefix where the
//      lane holds a barrier in the tile or the tile is tile 0; a lane
//      whose row 0 has no barrier then walks back over its predecessors,
//      8 words loaded at a time, to the nearest published prefix, and
//      folds that prefix and the aggregates after it one at a time from
//      the oldest: the chain prefix(t) = prefix(t - 1) + aggregate(t), in
//      its own order, so FP32 sums come out the same bits on every run.
//      It then publishes the lane's prefix where the lane had none.  A
//      lane reads at most LB_WINDOW words; past that it waits for the
//      prefix of the tile at the window's edge (the lanepipe's runs are at
//      most SPLIT_DEG + 1 = 2049 rows, 17 tiles, but any barrier pattern
//      is taken).  Value and status share one word, stored and loaded
//      whole, so no fence orders them; the entry point clears the words
//      and the counter with one memset before the launch, so a call puts
//      two operations on the stream: the memset and the kernel.  A spin
//      that outlasts a claimed tile's publication by orders of magnitude
//      traps.
//   5. The carry is combined into the rows before each chunk's first
//      barrier; the scanned tile goes back into the values' shared
//      memory, and extract stage A writes each output once.
//
// The combines are template arguments for the main paths' (type, monoid,
// packed) triples: FP32 plus (PageRank), packed BOOL lor (BFS) and FP32 min
// (SSSP's dense-u iterations).  Every other triple goes through one
// out-of-line combine, which keeps the build to seconds.
//
// Against the two-launch design this replaces (0.1854 ms on an H100,
// PERF.md): it read the route index, the barrier and the values twice;
// it looked the index up row-major, 32 lanes on one bank (with a
// row-major copy this kernel took 0.080 ms against 0.051); it scanned on
// 128 of 1024 threads through a run-time combine; and it loaded tile after
// tile synchronously, building the barrier mask with shared-memory
// atomics.  What holds this design at about half its bound: 150 KB of
// shared memory a block allow one block an SM, so 264 tiles run in two
// waves whose loads and scans do not overlap.
//
// The fold order differs from the Pallas kernel's roll tree: FP32 plus and
// times agree to rounding, the rest exactly.
#include "lane_scan.cuh"

#define FS_ROWS 16                // rows a thread scans
#define FS_CHUNKS (128 / FS_ROWS) // chunks of a lane in a tile
#define FS_SMEM (TILE_ELEMS * 4 + 2 * TILE_ELEMS * 2)  // values, 2 indices

template <int OP>
__global__ void __launch_bounds__(NT, 1) fused_scan_kernel(
    const int* __restrict__ pcr, const int* __restrict__ barrier,
    const int* __restrict__ pae, const uint32_t* __restrict__ vals,
    uint32_t* __restrict__ out, unsigned* counter,
    unsigned long long* words, int code) {
  extern __shared__ int4 smem4[];
  uint32_t* sx = reinterpret_cast<uint32_t*>(smem4);  // values, then scanned
  uint16_t* sr = reinterpret_cast<uint16_t*>(sx + TILE_ELEMS);  // route A|B
  uint16_t* se = sr + TILE_ELEMS;                               // extract A|B
  __shared__ uint32_t sv[FS_CHUNKS][128];  // chunk folds
  __shared__ uint8_t sf[FS_CHUNKS][128];   // chunk holds a barrier
  __shared__ uint32_t lb[LB_WINDOW * 128];
  __shared__ uint32_t carry[128];
  __shared__ uint8_t cin[128];
  __shared__ int s_tile;
  const int tid = threadIdx.x;
  if (tid == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const int tile = s_tile;
  const size_t base = (size_t)tile * TILE_ELEMS;
  const int l = tid & 127, c = tid >> 7, r0 = c * FS_ROWS;
  const size_t e0 = base + (size_t)r0 * 128 + l;

  // 2. every input read once, all in flight together
#pragma unroll
  for (int k = 0; k < TILE_ELEMS / 4 / NT; k++) {
    const int i = tid + k * NT;
    cp_async16(sx + 4 * i, vals + base + 4 * i);
  }
  int pr[FS_ROWS], pe[FS_ROWS], bw[FS_ROWS];
#pragma unroll
  for (int k = 0; k < FS_ROWS; k++) {
    pr[k] = __ldg(pcr + e0 + k * 128);
    pe[k] = __ldg(pae + e0 + k * 128);
    bw[k] = __ldg(barrier + e0 + k * 128);
  }
  uint32_t mr[FS_ROWS / 4] = {}, me[FS_ROWS / 4] = {};  // C fields, 4 a word
  unsigned bm = 0;  // bit k: row r0 + k holds a barrier
#pragma unroll
  for (int k = 0; k < FS_ROWS; k++) {
    ab_store(sr, r0 + k, l, pr[k]);
    ab_store(se, r0 + k, l, pe[k]);
    mr[k / 4] |= (uint32_t)((pr[k] >> 14) & 127) << (8 * (k % 4));
    me[k / 4] |= (uint32_t)((pe[k] >> 14) & 127) << (8 * (k % 4));
    bm |= (unsigned)(bw[k] != 0) << k;
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. route stage C and the chunk's scan in registers
  uint32_t v[FS_ROWS];
#pragma unroll
  for (int k = 0; k < FS_ROWS; k++)
    v[k] = sx[ab_src(sr, r0 + k, (mr[k / 4] >> (8 * (k % 4))) & 127)];
#pragma unroll
  for (int k = 1; k < FS_ROWS; k++)
    if (!((bm >> k) & 1)) v[k] = comb<OP>(code, v[k - 1], v[k]);
  sv[c][l] = v[FS_ROWS - 1];
  sf[c][l] = bm != 0;
  __syncthreads();  // every gather from sx is done; the chunk folds are in

  // 4. the lane's aggregate, its publication and the carry (c = 0), while
  //    the other chunks fold the chunks above them
  bool have = false, closed = false;
  uint32_t pre = 0;
  if (c == 0) {
    uint32_t agg = sv[0][l];
    bool has = sf[0][l];
#pragma unroll
    for (int j = 1; j < FS_CHUNKS; j++) {
      agg = sf[j][l] ? sv[j][l] : comb<OP>(code, agg, sv[j][l]);
      has |= sf[j][l] != 0;
    }
    unsigned long long* w = words + (size_t)tile * 128 + l;
    st_word(w, agg, tile == 0 || has ? ST_PRE : ST_AGG);
    const bool in = tile > 0 && !(bm & 1);
    uint32_t cy = 0;
    if (in) {
      cy = look_back<OP>(code, words + (size_t)tile * 128 + l, 128, tile, lb + l, 128);
      if (!has) st_word(w, comb<OP>(code, cy, agg), ST_PRE);
    }
    carry[l] = cy;
    cin[l] = in;
  } else {
    for (int j = c - 1; j >= 0; j--) {
      const uint32_t x = sv[j][l];
      pre = have ? comb<OP>(code, x, pre) : x;
      have = true;
      if (sf[j][l]) {
        closed = true;
        break;
      }
    }
  }
  __syncthreads();

  // 5. the carry into the rows before the chunk's first barrier; the
  //    scanned tile into shared memory; extract stage A
  if (!closed && cin[l]) {
    pre = have ? comb<OP>(code, carry[l], pre) : carry[l];
    have = true;
  }
  const int first = bm ? __ffs(bm) - 1 : FS_ROWS;
#pragma unroll
  for (int k = 0; k < FS_ROWS; k++) {
    if (have && k < first) v[k] = comb<OP>(code, pre, v[k]);
    sx[(r0 + k) * 128 + l] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < FS_ROWS; k++)
    out[e0 + k * 128] = sx[ab_src(se, r0 + k, (me[k / 4] >> (8 * (k % 4))) & 127)];
}

template <int OP>
static int launch(int ntiles, cudaStream_t st, const int* pcr, const int* bar,
                  const int* pae, const uint32_t* vals, uint32_t* out,
                  unsigned* counter, unsigned long long* words, int code) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_scan_kernel<OP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FS_SMEM);
  if (err != cudaSuccess) return (int)err;
  fused_scan_kernel<OP><<<ntiles, NT, FS_SMEM, st>>>(pcr, bar, pae, vals, out,
                                                     counter, words, code);
  return (int)cudaGetLastError();
}

// One kernel launch, after one memset of its scratch.  scratch holds
// 8 * 128 * ntiles + 8 bytes: per tile and lane a published word, then the
// tile counter.
extern "C" int fused_scan(const void* pcr, const void* barrier, const void* pae,
                          const void* vals, void* scratch, void* out,
                          int ntiles, int dt, int mo, int packed, void* stream) {
  if (dt < DT_F32 || dt > DT_BOOL || mo < MO_PLUS || mo > MO_BOR)
    return (int)cudaErrorInvalidValue;
  if (ntiles <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* words = (unsigned long long*)scratch;
  unsigned* counter = (unsigned*)(words + (size_t)ntiles * 128);
  cudaError_t err = cudaMemsetAsync(scratch, 0, 8 * ((size_t)ntiles * 128 + 1), st);
  if (err != cudaSuccess) return (int)err;
  const int code = dt | mo << 4 | (packed ? 1 : 0) << 8;
#define ARGS                                                               \
  ntiles, st, (const int*)pcr, (const int*)barrier, (const int*)pae,       \
      (const uint32_t*)vals, (uint32_t*)out, counter, words, code
  int rc;
  if (dt == DT_F32 && mo == MO_PLUS && !packed) rc = launch<SC_ADD_F>(ARGS);
  else if (dt == DT_F32 && mo == MO_MIN && !packed) rc = launch<SC_MIN_F>(ARGS);
  else if (dt == DT_BOOL && mo == MO_LOR && packed) rc = launch<SC_MAX_U>(ARGS);
  else rc = launch<SC_DYN>(ARGS);
#undef ARGS
  return rc;
}
