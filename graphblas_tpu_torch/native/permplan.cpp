// Clos-route planning: edge coloring of regular bipartite multigraphs by
// Euler splitting (Konig's theorem, constructive).
//
// Used by core/engine/permute.py to decompose an arbitrary STATIC
// permutation of L = T*16384 elements into TPU-friendly stages
// (within-tile lane gathers + transposes + block exchanges), replacing the
// global lax.sorts the lanepipe engine used through round 4.  This is the
// TPU-native replacement for the data movement the reference delegates to
// SuiteSparse kernel internals (reference graphblas/core/ss/descriptor.py
// axb_method); the reference has no analogous in-tree code.
//
// clos_color: given E edges (u[i], v[i]) of a bipartite multigraph where
// every left node u and right node v has degree exactly d (a power of two),
// assign colors[i] in [0, d) such that within every left node and every
// right node all colors are distinct.  Supports many independent graphs in
// one call (offs partitions the edge arrays); nodes are numbered per-graph.
//
// Algorithm: recursively Euler-split the edge set into halves.  All
// degrees are even at every level, so the edges decompose into closed
// circuits; walking each circuit and assigning alternate edges to the two
// halves keeps degrees exactly halved on both sides.  Bipartiteness makes
// every circuit even-length, so the alternation is consistent.
// O(E log d) time; all scratch preallocated once per call (edge ids are
// 32-bit — E < 2^31 always holds at our scales).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Scratch {
  std::vector<int32_t> inc;       // 2*ne: incidence edge-slots per node
  std::vector<int64_t> node_off;  // 2*m+1
  std::vector<int64_t> cursor;    // 2*m walk cursors / fill cursors
  std::vector<uint8_t> side;      // ne
  std::vector<int32_t> part;      // ne partition buffer
};

// Split eids[0:ne] into two halves by Euler circuits; side[i] gets 0/1.
void euler_split(const int32_t* u, const int32_t* v, const int32_t* eids,
                 int64_t ne, int32_t m, Scratch& s) {
  const int64_t nn = 2 * (int64_t)m;
  std::fill(s.node_off.begin(), s.node_off.begin() + nn + 1, 0);
  for (int64_t i = 0; i < ne; ++i) {
    int32_t e = eids[i];
    s.node_off[u[e] + 1]++;
    s.node_off[(int64_t)m + v[e] + 1]++;
  }
  for (int64_t k = 0; k < nn; ++k) s.node_off[k + 1] += s.node_off[k];
  std::fill(s.cursor.begin(), s.cursor.begin() + nn, 0);
  for (int64_t i = 0; i < ne; ++i) {
    int32_t e = eids[i];
    s.inc[s.node_off[u[e]] + s.cursor[u[e]]++] = (int32_t)i;
    s.inc[s.node_off[m + v[e]] + s.cursor[m + v[e]]++] = (int32_t)i;
  }
  std::fill(s.cursor.begin(), s.cursor.begin() + nn, 0);
  std::memset(s.side.data(), 2, ne);
  for (int64_t start = 0; start < ne; ++start) {
    if (s.side[start] != 2) continue;
    int64_t i = start;
    uint8_t sd = 0;
    bool at_left = true;  // side we entered edge i from
    for (;;) {
      s.side[i] = sd;
      sd ^= 1;
      int32_t e = eids[i];
      int64_t node = at_left ? (int64_t)m + v[e] : (int64_t)u[e];
      int64_t off = s.node_off[node], end = s.node_off[node + 1];
      int64_t j = -1;
      while (off + s.cursor[node] < end) {
        int32_t cand = s.inc[off + s.cursor[node]];
        s.cursor[node]++;
        if (s.side[cand] == 2) { j = cand; break; }
      }
      if (j < 0) break;  // circuit closed (even degrees guarantee)
      i = j;
      at_left = node < (int64_t)m;
    }
  }
}

void color_rec(const int32_t* u, const int32_t* v, int32_t* eids, int64_t ne,
               int32_t m, int32_t d, int32_t c0, int32_t* colors,
               Scratch& s) {
  if (d == 1) {
    for (int64_t i = 0; i < ne; ++i) colors[eids[i]] = c0;
    return;
  }
  euler_split(u, v, eids, ne, m, s);
  // stable in-place partition by side via the scratch buffer
  int64_t n0 = 0;
  for (int64_t i = 0; i < ne; ++i)
    if (s.side[i] == 0) s.part[n0++] = eids[i];
  int64_t n1 = n0;
  for (int64_t i = 0; i < ne; ++i)
    if (s.side[i] == 1) s.part[n1++] = eids[i];
  std::memcpy(eids, s.part.data(), ne * sizeof(int32_t));
  color_rec(u, v, eids, n0, m, d / 2, c0, colors, s);
  color_rec(u, v, eids + n0, ne - n0, m, d / 2, c0 + d / 2, colors, s);
}

}  // namespace

extern "C" {

// u, v: int32[ntotal] per-graph node ids; offs: int64[ngraphs+1] edge
// partition; m: nodes per side per graph; d: colors (= uniform degree,
// power of two).  colors: int32[ntotal] out.  Returns 0 on success.
int clos_color(const int32_t* u, const int32_t* v, const int64_t* offs,
               int64_t ngraphs, int32_t m, int32_t d, int32_t* colors) {
  if (d <= 0 || (d & (d - 1)) != 0) return 1;
  int64_t max_ne = 0;
  for (int64_t g = 0; g < ngraphs; ++g) {
    int64_t ne = offs[g + 1] - offs[g];
    if (ne > max_ne) max_ne = ne;
  }
  if (max_ne > INT32_MAX) return 2;
  Scratch s;
  s.inc.resize(2 * max_ne);
  s.node_off.resize(2 * (int64_t)m + 1);
  s.cursor.resize(2 * (int64_t)m);
  s.side.resize(max_ne);
  s.part.resize(max_ne);
  std::vector<int32_t> eids(max_ne);
  for (int64_t g = 0; g < ngraphs; ++g) {
    int64_t lo = offs[g], ne = offs[g + 1] - lo;
    for (int64_t i = 0; i < ne; ++i) eids[i] = (int32_t)i;
    // per-graph local edge ids: color into a shifted view
    color_rec(u + lo, v + lo, eids.data(), ne, m, d, 0, colors + lo, s);
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Count-matrix variant: Euler-split the DEGREE MATRIX instead of the edge
// list.  Edges between the same (u, v) pair are interchangeable, so the
// recursion only needs per-cell counts: split a matrix with even row/col
// sums into two halves (even parts split evenly; odd cells form an
// even-degree graph whose cycles alternate +-1), recurse, and emit colors
// per cell at the leaves.  Work is O(active-cells * log d) of sequential
// array sweeps instead of O(E log d) of DRAM-latency pointer chasing —
// ~20x faster at bench scale.  The caller assigns emitted colors to its
// edges in (cell-sorted, emission) order.

namespace {

struct CScratch {
  // per recursion level: cell/cnt arrays (ping-pong by depth)
  std::vector<std::vector<int32_t>> cells, cnts;
  // odd-cycle walk buffers sized by max cells per call
  std::vector<int32_t> odd_idx;       // indices of odd cells
  std::vector<int64_t> node_off, cur; // 2m+1 / 2m
  std::vector<int32_t> inc;           // 2 * n_odd
  std::vector<uint8_t> side;          // n_odd
  std::vector<int64_t> cell_cursor;   // m*m write cursors (emission)
  std::vector<int64_t> cell_off;      // m*m emission offsets
  int32_t m;
  int32_t* out;                       // E-sized color emission array
};

void color_counts_rec(CScratch& s, int depth, int64_t nc, int32_t d,
                      int32_t c0) {
  std::vector<int32_t>& cells = s.cells[depth];
  std::vector<int32_t>& cnts = s.cnts[depth];
  if (d == 1) {
    // each active cell has cnt==1: emit color c0 at the cell's cursor
    for (int64_t i = 0; i < nc; ++i) {
      int32_t cell = cells[i];
      s.out[s.cell_off[cell] + s.cell_cursor[cell]++] = c0;
    }
    return;
  }
  const int32_t m = s.m;
  // odd cells
  int64_t nodd = 0;
  for (int64_t i = 0; i < nc; ++i)
    if (cnts[i] & 1) s.odd_idx[nodd++] = (int32_t)i;
  if (nodd) {
    // incidence of the odd-cell graph (nodes: rows 0..m-1, cols m..2m-1)
    const int64_t nn = 2 * (int64_t)m;
    std::fill(s.node_off.begin(), s.node_off.begin() + nn + 1, 0);
    for (int64_t k = 0; k < nodd; ++k) {
      int32_t cell = cells[s.odd_idx[k]];
      s.node_off[cell / m + 1]++;
      s.node_off[(int64_t)m + cell % m + 1]++;
    }
    for (int64_t k = 0; k < nn; ++k) s.node_off[k + 1] += s.node_off[k];
    std::fill(s.cur.begin(), s.cur.begin() + nn, 0);
    for (int64_t k = 0; k < nodd; ++k) {
      int32_t cell = cells[s.odd_idx[k]];
      s.inc[s.node_off[cell / m] + s.cur[cell / m]++] = (int32_t)k;
      s.inc[s.node_off[m + cell % m] + s.cur[m + cell % m]++] = (int32_t)k;
    }
    std::fill(s.cur.begin(), s.cur.begin() + nn, 0);
    std::memset(s.side.data(), 2, nodd);
    for (int64_t start = 0; start < nodd; ++start) {
      if (s.side[start] != 2) continue;
      int64_t i = start;
      uint8_t sd = 0;
      bool at_left = true;
      for (;;) {
        s.side[i] = sd;
        sd ^= 1;
        int32_t cell = cells[s.odd_idx[i]];
        int64_t node = at_left ? (int64_t)m + cell % m : (int64_t)(cell / m);
        int64_t off = s.node_off[node], end = s.node_off[node + 1];
        int64_t j = -1;
        while (off + s.cur[node] < end) {
          int32_t cand = s.inc[off + s.cur[node]];
          s.cur[node]++;
          if (s.side[cand] == 2) { j = cand; break; }
        }
        if (j < 0) break;
        i = j;
        at_left = node < (int64_t)m;
      }
    }
  }
  // build child lists: left = cnt/2 rounded by side, right = rest
  std::vector<int32_t>& c0cells = s.cells[depth + 1];
  std::vector<int32_t>& c0cnts = s.cnts[depth + 1];
  if ((int64_t)c0cells.size() < nc) {
    c0cells.resize(nc);
    c0cnts.resize(nc);
  }
  // mark odd side per active index (0/1); even cells split evenly
  // first child (side 0)
  int64_t oi = 0;
  int64_t n0 = 0;
  for (int64_t i = 0; i < nc; ++i) {
    int32_t c = cnts[i];
    int32_t half = c >> 1;
    int32_t extra = 0;
    if (c & 1) {
      extra = (s.side[oi] == 0) ? 1 : 0;
      ++oi;
    }
    int32_t left = half + extra;
    if (left) {
      c0cells[n0] = cells[i];
      c0cnts[n0] = left;
      ++n0;
    }
    // overwrite in place for the right child: right = c - left
    cnts[i] = c - left;
  }
  color_counts_rec(s, depth + 1, n0, d / 2, c0);
  // right child: compact this level's arrays in place
  int64_t n1 = 0;
  for (int64_t i = 0; i < nc; ++i) {
    if (cnts[i]) {
      cells[n1] = cells[i];
      cnts[n1] = cnts[i];
      ++n1;
    }
  }
  color_counts_rec(s, depth, n1, d / 2, c0 + d / 2);
}

}  // namespace

extern "C" {

// Count-matrix coloring, batched.  cell[i] = u*m + v per edge i; offs
// partitions the edge array into independent graphs.  Writes the final
// per-edge colors directly (edges within a cell are interchangeable, so
// the per-cell color multiset is dealt out in input order).  Returns 0
// on success.
int clos_color_counts(const int32_t* cell, const int64_t* offs,
                      int64_t ngraphs, int32_t m, int32_t d,
                      int32_t* out_colors) {
  if (d <= 0 || (d & (d - 1)) != 0) return 1;
  int64_t mm = (int64_t)m * m;
  CScratch s;
  s.m = m;
  int depthmax = 1;
  for (int32_t t = d; t > 1; t >>= 1) ++depthmax;
  s.cells.resize(depthmax + 1);
  s.cnts.resize(depthmax + 1);
  s.node_off.resize(2 * (int64_t)m + 1);
  s.cur.resize(2 * (int64_t)m);
  s.cell_off.resize(mm);
  s.cell_cursor.resize(mm);
  std::vector<int64_t> counts(mm);
  std::vector<int32_t> emit;
  for (int64_t g = 0; g < ngraphs; ++g) {
    int64_t lo = offs[g], ne = offs[g + 1] - lo;
    if (!ne) continue;
    if ((int64_t)emit.size() < ne) emit.resize(ne);
    s.out = emit.data();
    std::fill(counts.begin(), counts.end(), 0);
    for (int64_t i = 0; i < ne; ++i) counts[cell[lo + i]]++;
    std::fill(s.cell_cursor.begin(), s.cell_cursor.end(), 0);
    int64_t acc = 0;
    int64_t nc = 0;
    for (int64_t c = 0; c < mm; ++c) {
      s.cell_off[c] = acc;
      acc += counts[c];
      if (counts[c]) ++nc;
    }
    if ((int64_t)s.cells[0].size() < nc) {
      s.cells[0].resize(nc);
      s.cnts[0].resize(nc);
    }
    int64_t k = 0;
    for (int64_t c = 0; c < mm; ++c) {
      if (counts[c]) {
        s.cells[0][k] = (int32_t)c;
        s.cnts[0][k] = (int32_t)counts[c];
        ++k;
      }
    }
    int64_t maxcells = nc > mm ? nc : mm;
    if ((int64_t)s.odd_idx.size() < maxcells) {
      s.odd_idx.resize(maxcells);
      s.inc.resize(2 * maxcells);
      s.side.resize(maxcells);
    }
    color_counts_rec(s, 0, nc, d, 0);
    // deal the per-cell color multisets out to the edges in input order
    std::fill(s.cell_cursor.begin(), s.cell_cursor.end(), 0);
    for (int64_t i = 0; i < ne; ++i) {
      int32_t c = cell[lo + i];
      out_colors[lo + i] = emit[s.cell_off[c] + s.cell_cursor[c]++];
    }
  }
  return 0;
}

}  // extern "C"
