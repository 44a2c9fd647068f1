// Native window analyzer — the host-side equivalent of the reference's
// GPU preprocessing pipeline (hybrid_all_kernel.cu:213-408):
//   fill_edgeToRow / fill_segment  -> implicit (CSR ranges per window)
//   thrust zip-sort per window     -> per-window sort of neighbour ids
//   generate_edgetocolumn          -> dedup to unique columns, and the
//                                     eid -> unique-index binary search
// The reference runs the dedup single-threaded per thread block
// (.cu:242-269); here each window is one independent task over the CSR
// slice, parallelized with OpenMP when available.
//
// Exposed via ctypes (hcspmm_tpu/format/windows.py); the vectorized
// NumPy path remains as the portable fallback and the test oracle.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Pass 1+2 fused: per window, sort+dedup the column ids of its CSR
// slice, emit unique columns (sorted) and per-edge compressed indices.
//
//   rp:  int32[n+1] CSR row pointers
//   ci:  int32[nnz] column ids
//   n:   rows; window_h: rows per window
//   unique_cols:   out int32[nnz]  (capacity; prefix used)
//   unique_ptr:    out int64[W+1]
//   edge_to_column:out int32[nnz]
// Returns 0 on success.
int32_t hcspmm_analyze_windows(const int32_t* rp, const int32_t* ci,
                               int64_t n, int32_t window_h,
                               int32_t* unique_cols, int64_t* unique_ptr,
                               int32_t* edge_to_column) {
  if (n < 0 || window_h <= 0) return 1;
  const int64_t num_windows = (n + window_h - 1) / window_h;

  // Pass 1: unique counts per window (parallel; scratch per thread).
  std::vector<int64_t> counts(num_windows, 0);
#pragma omp parallel
  {
    std::vector<int32_t> scratch;
#pragma omp for schedule(dynamic, 64)
    for (int64_t w = 0; w < num_windows; ++w) {
      const int64_t r0 = w * window_h;
      const int64_t r1 = std::min<int64_t>(r0 + window_h, n);
      const int64_t e0 = rp[r0], e1 = rp[r1];
      scratch.assign(ci + e0, ci + e1);
      std::sort(scratch.begin(), scratch.end());
      counts[w] =
          std::unique(scratch.begin(), scratch.end()) - scratch.begin();
    }
  }
  unique_ptr[0] = 0;
  for (int64_t w = 0; w < num_windows; ++w)
    unique_ptr[w + 1] = unique_ptr[w] + counts[w];

  // Pass 2: fill unique columns + per-edge compressed index (parallel).
#pragma omp parallel
  {
    std::vector<int32_t> scratch;
#pragma omp for schedule(dynamic, 64)
    for (int64_t w = 0; w < num_windows; ++w) {
      const int64_t r0 = w * window_h;
      const int64_t r1 = std::min<int64_t>(r0 + window_h, n);
      const int64_t e0 = rp[r0], e1 = rp[r1];
      scratch.assign(ci + e0, ci + e1);
      std::sort(scratch.begin(), scratch.end());
      scratch.erase(std::unique(scratch.begin(), scratch.end()),
                    scratch.end());
      int32_t* u = unique_cols + unique_ptr[w];
      std::copy(scratch.begin(), scratch.end(), u);
      for (int64_t e = e0; e < e1; ++e) {
        // the reference's binarysearch (.cu:224-241)
        edge_to_column[e] = static_cast<int32_t>(
            std::lower_bound(scratch.begin(), scratch.end(), ci[e]) -
            scratch.begin());
      }
    }
  }
  return 0;
}

// Band extents per superwindow: min/max column of each bh-row slice
// (the geometry behind the banded MXU path; format/plan.py).
int32_t hcspmm_band_extents(const int32_t* rp, const int32_t* ci,
                            int64_t n, int32_t band_h, int64_t* min_col,
                            int64_t* max_col) {
  if (n < 0 || band_h <= 0) return 1;
  const int64_t num_sw = (n + band_h - 1) / band_h;
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t s = 0; s < num_sw; ++s) {
    const int64_t r0 = s * band_h;
    const int64_t r1 = std::min<int64_t>(r0 + band_h, n);
    const int64_t e0 = rp[r0], e1 = rp[r1];
    int64_t mn = 0, mx = -1;
    if (e1 > e0) {
      mn = ci[e0];
      mx = ci[e0];
      for (int64_t e = e0 + 1; e < e1; ++e) {
        mn = std::min<int64_t>(mn, ci[e]);
        mx = std::max<int64_t>(mx, ci[e]);
      }
    }
    min_col[s] = mn;
    max_col[s] = mx;
  }
  return 0;
}

// Robust band-width quantiles per superwindow (format/plan.py
// _robust_widths, ported): rw[qi*num_sw + s] = the minimal window width
// covering ceil(q * cnt_s) of super s's edges (duplicates count), via a
// sliding window over the super's sorted columns.  Also emits per-super
// edge count and min/max column.  Empty supers get rw = 1<<40 (the
// Python path's "impossible" sentinel), cnt = 0, min = 0, max = -1.
int32_t hcspmm_band_robust(const int32_t* rp, const int32_t* ci,
                           int64_t n, int32_t band_h, const double* qs,
                           int32_t nq, int64_t* cnt, int64_t* min_col,
                           int64_t* max_col, int64_t* rw) {
  if (n < 0 || band_h <= 0 || nq < 0) return 1;
  const int64_t num_sw = (n + band_h - 1) / band_h;
  const int64_t kBig = int64_t(1) << 40;
#pragma omp parallel
  {
    std::vector<int32_t> cols;
#pragma omp for schedule(dynamic, 16)
    for (int64_t s = 0; s < num_sw; ++s) {
      const int64_t r0 = s * band_h;
      const int64_t r1 = std::min<int64_t>(r0 + band_h, n);
      const int64_t e0 = rp[r0], e1 = rp[r1];
      const int64_t m = e1 - e0;
      cnt[s] = m;
      if (m == 0) {
        min_col[s] = 0;
        max_col[s] = -1;
        for (int32_t qi = 0; qi < nq; ++qi) rw[qi * num_sw + s] = kBig;
        continue;
      }
      cols.assign(ci + e0, ci + e1);
      std::sort(cols.begin(), cols.end());
      min_col[s] = cols.front();
      max_col[s] = cols.back();
      for (int32_t qi = 0; qi < nq; ++qi) {
        int64_t k = static_cast<int64_t>(std::ceil(qs[qi] * double(m)));
        k = std::max<int64_t>(k, 1);
        int64_t best = kBig;
        for (int64_t i = 0; i + k - 1 < m; ++i)
          best = std::min<int64_t>(best, cols[i + k - 1] - cols[i] + 1);
        rw[qi * num_sw + s] = best;
      }
    }
  }
  return 0;
}

// Best align-aligned window placement per (candidate width, superwindow)
// (format/plan.py _place_band_windows, ported): candidates are the
// aligned starts at-or-below each edge column; the winner covers the
// most edges, ties broken toward the smallest start.  ``mask`` (uint8,
// may be NULL) selects the participating edges; ``cnt`` returns the
// per-super selected-edge count.  Empty supers: cov = 0, start = 0.
int32_t hcspmm_band_place(const int32_t* rp, const int32_t* ci, int64_t n,
                          int32_t band_h, int64_t align,
                          const int64_t* widths, int32_t nb,
                          const uint8_t* mask, int64_t* cov,
                          int64_t* start, int64_t* cnt) {
  if (n < 0 || band_h <= 0 || align <= 0 || nb < 0) return 1;
  const int64_t num_sw = (n + band_h - 1) / band_h;
#pragma omp parallel
  {
    std::vector<int32_t> cols;
#pragma omp for schedule(dynamic, 16)
    for (int64_t s = 0; s < num_sw; ++s) {
      const int64_t r0 = s * band_h;
      const int64_t r1 = std::min<int64_t>(r0 + band_h, n);
      const int64_t e0 = rp[r0], e1 = rp[r1];
      cols.clear();
      for (int64_t e = e0; e < e1; ++e)
        if (!mask || mask[e]) cols.push_back(ci[e]);
      const int64_t m = static_cast<int64_t>(cols.size());
      cnt[s] = m;
      if (m == 0) {
        for (int32_t b = 0; b < nb; ++b) {
          cov[b * num_sw + s] = 0;
          start[b * num_sw + s] = 0;
        }
        continue;
      }
      std::sort(cols.begin(), cols.end());
      for (int32_t b = 0; b < nb; ++b) {
        const int64_t w = widths[b];
        int64_t best_cov = -1, best_start = 0;
        int64_t hi = 0;
        for (int64_t i = 0; i < m;) {
          const int64_t a = (int64_t(cols[i]) / align) * align;
          // edges in [a, a + w): hi only moves forward (a ascends)
          if (hi < i) hi = i;
          while (hi < m && cols[hi] < a + w) ++hi;
          if (hi - i > best_cov) {
            best_cov = hi - i;
            best_start = a;
          }
          // next distinct quantized candidate
          const int64_t q = int64_t(cols[i]) / align;
          do {
            ++i;
          } while (i < m && int64_t(cols[i]) / align == q);
        }
        cov[b * num_sw + s] = best_cov;
        start[b * num_sw + s] = best_start;
      }
    }
  }
  return 0;
}

}  // extern "C"
