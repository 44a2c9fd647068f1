// LOA: graph layout reordering for hybrid SpMM row windows.
//
// Native (host-side) preprocessing component of hcspmm_tpu.  Re-designed
// equivalent of the reference's standalone reorderer (LOI.cpp:660-805,
// `reorder_plus_new_direct`): greedily regroup rows into window_h-row
// windows maximizing *computing intensity* = nnz / unique_cols per window
// (report Eq. 5/6, Alg. 5/6), so more windows qualify for the dense/MXU
// path and gather bandwidth per nnz drops.
//
// Differences from the reference (deliberate):
//  - incremental candidate scoring: after adding row v, only v's *new*
//    columns contribute cns increments (the reference rescans the whole
//    residual set every growth step, LOI.cpp:760-770 — same scores,
//    strictly less work);
//  - no fixed 18.3M-entry static arrays (LOI.cpp:96) or per-dataset
//    hard-coded sizes (LOI.cpp:808-818) — everything is sized from input;
//  - a hub cap: columns with in-degree > hub_cap are skipped during
//    candidate generation (a hub makes every row a candidate and turns
//    the greedy quadratic); the reference has no such guard;
//  - column budget: windows stop growing early when the unique-column
//    set would exceed max_cols (keeps windows MXU-bucket-sized).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Count |N(v) ^ cols| additions: for every column c in `new_cols`, every
// unvisited in-neighbor v of c gains cns[v] += 1.
inline void add_incidence(const std::vector<int32_t>& new_cols,
                          const int32_t* rp_in, const int32_t* ci_in,
                          const std::vector<uint8_t>& visited,
                          std::vector<int32_t>& cns,
                          std::vector<int32_t>& touched,
                          std::vector<uint8_t>& is_touched,
                          int32_t hub_cap) {
  for (int32_t c : new_cols) {
    int32_t indeg = rp_in[c + 1] - rp_in[c];
    if (indeg > hub_cap) continue;
    for (int32_t j = rp_in[c]; j < rp_in[c + 1]; ++j) {
      int32_t v = ci_in[j];
      if (visited[v]) continue;
      if (!is_touched[v]) {
        is_touched[v] = 1;
        touched.push_back(v);
        cns[v] = 0;
      }
      cns[v] += 1;
    }
  }
}

// Sorted-merge `nbrs \ cols` into new_cols, then cols |= nbrs.
inline void merge_columns(std::vector<int32_t>& cols,
                          const int32_t* nbrs, int32_t deg,
                          std::vector<int32_t>& new_cols,
                          std::vector<int32_t>& scratch) {
  new_cols.clear();
  size_t i = 0;
  int32_t k = 0;
  scratch.clear();
  scratch.reserve(cols.size() + deg);
  while (i < cols.size() && k < deg) {
    if (cols[i] < nbrs[k]) {
      scratch.push_back(cols[i++]);
    } else if (cols[i] > nbrs[k]) {
      scratch.push_back(nbrs[k]);
      new_cols.push_back(nbrs[k]);
      ++k;
    } else {
      scratch.push_back(cols[i]);
      ++i;
      ++k;
    }
  }
  for (; i < cols.size(); ++i) scratch.push_back(cols[i]);
  for (; k < deg; ++k) {
    scratch.push_back(nbrs[k]);
    new_cols.push_back(nbrs[k]);
  }
  cols.swap(scratch);
}

}  // namespace

extern "C" {

// Greedy LOA reorder.
//   rp/ci      : CSR of A (out-neighbors), n rows; ci sorted per row.
//   rp_in/ci_in: CSR of A^T (in-neighbors) — pass rp/ci again if symmetric.
//   window_h   : rows per window (16 in the reference format).
//   max_cols   : stop growing a window when unique cols would exceed this
//                (0 = unlimited, reference behavior).
//   hub_cap    : skip candidate generation through columns with in-degree
//                above this (0 = unlimited).
//   perm_out   : length-n output; perm_out[new_row] = old_row.
// Returns 0 on success.
int32_t loa_reorder(const int32_t* rp, const int32_t* ci,
                    const int32_t* rp_in, const int32_t* ci_in,
                    int32_t n, int32_t window_h, int32_t max_cols,
                    int32_t hub_cap, int32_t* perm_out) {
  if (n <= 0 || window_h <= 0) return 1;
  if (hub_cap <= 0) hub_cap = INT32_MAX;
  if (max_cols <= 0) max_cols = INT32_MAX;

  std::vector<uint8_t> visited(n, 0);
  std::vector<int32_t> cns(n, 0);
  std::vector<uint8_t> is_touched(n, 0);
  std::vector<int32_t> touched;
  std::vector<int32_t> cols, new_cols, scratch;
  touched.reserve(4096);

  int32_t out_pos = 0;
  int32_t next_seed = 0;

  while (out_pos < n) {
    // --- seed: next unvisited row in natural order (LOI.cpp:665-670) ---
    while (next_seed < n && visited[next_seed]) ++next_seed;
    if (next_seed >= n) break;
    int32_t seed = next_seed;
    visited[seed] = 1;
    perm_out[out_pos++] = seed;

    cols.assign(ci + rp[seed], ci + rp[seed + 1]);
    int64_t cur_eles = rp[seed + 1] - rp[seed];
    touched.clear();
    add_incidence(cols, rp_in, ci_in, visited, cns, touched, is_touched,
                  hub_cap);

    // --- grow to window_h rows by max profit (LOI.cpp:755-797) ---
    for (int32_t h = 1; h < window_h; ++h) {
      int32_t best = -1;
      float best_profit = 0.0f;
      for (int32_t v : touched) {
        if (visited[v]) continue;
        int32_t deg = rp[v + 1] - rp[v];
        int64_t ones = cur_eles + deg;
        int64_t rows = (int64_t)cols.size() + deg - cns[v];
        if (rows <= 0) rows = 1;
        float profit = (float)ones / (float)rows;
        if (profit > best_profit) {
          best_profit = profit;
          best = v;
        }
      }
      if (best < 0) break;  // no connected candidate; leave window short
      int32_t deg = rp[best + 1] - rp[best];
      if ((int64_t)cols.size() + deg - cns[best] > max_cols &&
          (int64_t)cols.size() > 0) {
        break;  // would overflow the widest MXU bucket
      }
      visited[best] = 1;
      perm_out[out_pos++] = best;
      cur_eles += deg;
      merge_columns(cols, ci + rp[best], deg, new_cols, scratch);
      add_incidence(new_cols, rp_in, ci_in, visited, cns, touched,
                    is_touched, hub_cap);
    }

    // reset candidate bookkeeping for the next window
    for (int32_t v : touched) {
      is_touched[v] = 0;
      cns[v] = 0;
    }
  }
  return 0;
}

// Window computing-intensity report: for each window of `window_h` rows of
// CSR (rp, ci), writes nnz and unique-column counts.  Used by tests and by
// the LOA objective report (reference report Eq. 5).
int32_t window_stats(const int32_t* rp, const int32_t* ci, int32_t n,
                     int32_t window_h, int32_t* nnz_out,
                     int32_t* unique_out) {
  if (n <= 0 || window_h <= 0) return 1;
  int32_t num_windows = (n + window_h - 1) / window_h;
  std::vector<int32_t> buf;
  for (int32_t w = 0; w < num_windows; ++w) {
    int32_t r0 = w * window_h;
    int32_t r1 = std::min(n, r0 + window_h);
    buf.clear();
    for (int32_t r = r0; r < r1; ++r)
      buf.insert(buf.end(), ci + rp[r], ci + rp[r + 1]);
    nnz_out[w] = (int32_t)buf.size();
    std::sort(buf.begin(), buf.end());
    unique_out[w] =
        (int32_t)(std::unique(buf.begin(), buf.end()) - buf.begin());
  }
  return 0;
}

}  // extern "C"
