// Native graph-builder kernels (host side).
//
// The reference delegates all of this to the external SuiteSparse C engine
// (GrB_Matrix_build inside libgraphblas).  Here the host-side data-plane —
// edge-list sorting, duplicate detection/combination, CSR conversion —
// is implemented natively and reached via ctypes (graphblas_tpu_torch/
// native/__init__.py), with a pure-numpy fallback when the toolchain is
// absent.  A copy of graphblas_tpu/native/builder.cpp, so that the PyTorch
// package does not depend on the JAX package.
//
// All functions use int64 indices (GrB_Index) and operate on caller-owned
// buffers; values are permuted by the Python layer using the returned
// permutation so any dtype (including UDTs) works without templating.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Lexicographic (row, col) argsort via 3-pass LSD radix sort on the packed
// key row*ncols+col when it fits in 64 bits, else std::sort on pairs.
// perm_out must have length n.  Returns 0 on success.
int coo_argsort(const int64_t* rows, const int64_t* cols, int64_t n,
                int64_t nrows, int64_t ncols, int64_t* perm_out) {
  if (n <= 0) return 0;
  bool packable = ncols > 0 && nrows > 0 &&
                  (__int128)nrows * (__int128)ncols < ((__int128)1 << 62);
  if (packable) {
    std::vector<uint64_t> key(n);
    for (int64_t i = 0; i < n; ++i) {
      key[i] = (uint64_t)rows[i] * (uint64_t)ncols + (uint64_t)cols[i];
    }
    // LSD radix, 16-bit digits, skipping passes with constant digit
    std::vector<int64_t> perm(n), tmp(n);
    for (int64_t i = 0; i < n; ++i) perm[i] = i;
    uint64_t maxkey = 0;
    for (int64_t i = 0; i < n; ++i) maxkey = std::max(maxkey, key[i]);
    for (int shift = 0; shift < 64; shift += 16) {
      if ((maxkey >> shift) == 0 && shift > 0) break;
      int64_t count[65536] = {0};
      for (int64_t i = 0; i < n; ++i)
        count[(key[perm[i]] >> shift) & 0xFFFF]++;
      int64_t total = 0;
      for (int b = 0; b < 65536; ++b) {
        int64_t c = count[b];
        count[b] = total;
        total += c;
      }
      for (int64_t i = 0; i < n; ++i) {
        tmp[count[(key[perm[i]] >> shift) & 0xFFFF]++] = perm[i];
      }
      perm.swap(tmp);
    }
    std::memcpy(perm_out, perm.data(), n * sizeof(int64_t));
  } else {
    std::vector<int64_t> perm(n);
    for (int64_t i = 0; i < n; ++i) perm[i] = i;
    std::sort(perm.begin(), perm.end(), [&](int64_t a, int64_t b) {
      if (rows[a] != rows[b]) return rows[a] < rows[b];
      return cols[a] < cols[b];
    });
    std::memcpy(perm_out, perm.data(), n * sizeof(int64_t));
  }
  return 0;
}

// Given SORTED rows/cols, mark the first occurrence of each (row, col) and
// return the number of unique entries.  uniq_flag_out[i] = 1 if entry i
// starts a new coordinate.
int64_t coo_mark_unique(const int64_t* rows, const int64_t* cols, int64_t n,
                        uint8_t* uniq_flag_out) {
  if (n <= 0) return 0;
  int64_t uniq = 1;
  uniq_flag_out[0] = 1;
  for (int64_t i = 1; i < n; ++i) {
    bool nu = rows[i] != rows[i - 1] || cols[i] != cols[i - 1];
    uniq_flag_out[i] = nu ? 1 : 0;
    uniq += nu ? 1 : 0;
  }
  return uniq;
}

// CSR indptr from SORTED rows.  indptr_out has length nrows+1.
int coo_to_csr_indptr(const int64_t* rows, int64_t n, int64_t nrows,
                      int64_t* indptr_out) {
  std::memset(indptr_out, 0, (nrows + 1) * sizeof(int64_t));
  for (int64_t i = 0; i < n; ++i) indptr_out[rows[i] + 1]++;
  for (int64_t r = 0; r < nrows; ++r) indptr_out[r + 1] += indptr_out[r];
  return 0;
}

// Degree histogram (out-degrees) from unsorted rows.
int coo_degrees(const int64_t* rows, int64_t n, int64_t nrows,
                int64_t* deg_out) {
  std::memset(deg_out, 0, nrows * sizeof(int64_t));
  for (int64_t i = 0; i < n; ++i) deg_out[rows[i]]++;
  return 0;
}

}  // extern "C"
