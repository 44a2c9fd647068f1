// The row layout's two non-band populations for Hopper (sm_90a), bound from
// Python with ctypes (kernels/block_spmm.py holds the wrappers and the plain
// PyTorch versions).
//
// Replaces the Pallas kernels of hcspmm_tpu/kernels/block_spmm.py:
//
//   dense_bucket_spmm (pallas_call at :127), the reference's tensor-core
//   population (hybrid_all_kernel.cu:1385-1472): one window w of wh rows
//   (16 by default, any height) of a width bucket computes
//
//       out[w] = A[w] [wh, Kb] @ X[cols[w]] [Kb, D]
//
//   with A[w] a 0/1 block and cols[w] the window's Kb unique neighbour rows
//   (pad columns point at the zero row, or past the table);
//
//   ell_bucket_spmm (pallas_call at :178), the reference's CUDA-core
//   warp-per-row loop (hybrid_all_kernel.cu:964-1036): one row r of a degree
//   bucket computes out[r] = sum_k X[cols[r, k]].  The residual rows (degree
//   above every ELL width), which the reference leaves to an XLA segment_sum,
//   ride the same launch.
//
// Both are bound by bytes: each gathered row of X is read once per window or
// row (at dim 32 fp32, 128 B) against one add per element, and a window row
// holds a few non-zeros of its Kb columns.  Sums run in fp32 on the CUDA
// cores, no tensor cores and no TF32: the counterpart of the reference's
// Precision.HIGHEST in fp32; bf16 rows are widened exactly to fp32, as the
// reference widens its bf16 gather table (block_spmm.py:928-932).  Outputs
// are fp32, as the reference's.
//
// One launch covers a whole population, and each kernel writes its rows
// straight into the [N, D] result at their node ids (no buffer, no merge):
//
// - dense_window_kernel: the dense buckets of a plan (a table of at most
//   MAX_BUCKETS buckets by value; the host launches once for each such
//   group).  Persistent blocks of 4 warps take
//   (window, 32-column slab) units in a fixed stride; each stages a unit's
//   gathered X rows in shared memory by 16-byte cp.async copies (8 lanes a
//   128-byte row at D 32 fp32; zero-filled for an index outside [0, R)) with
//   the window's row masks, in a ring of STAGES units.  At one stage (the
//   fastest measured) the gathers of the next units fly in the SM's other
//   blocks, about ten, while this one is summed.  Warp v takes the window's
//   rows v, v + 4, v + 8, ... (four of a 16-row window).  Row r of a window walks
//   only the set bits of its mask (built from A at upload), in increasing k,
//   lane = column: the same chain of fp32 adds as the sum over all Kb columns
//   that skips A == 0.  Where a row is no 16-byte multiple or X is not
//   16-byte aligned, the gathers are scalar loads.
// - ell_row_kernel: a table of rows (node id, start, length) holding the ELL
//   rows and the residual rows without their pad entries, and the nodes of
//   no population as rows of length 0 (written as zeros), sorted on the host
//   into hub, middle and short rows.  A group of G lanes covers a row's
//   columns with 16-byte loads (G = 8 at D 32 fp32); a short row takes one
//   group (4 rows a warp at G 8), a middle row a warp, a hub row a block of EW
//   warps, its groups taking every S-th entry and the partial sums added in
//   a fixed tree (lanes, then warps in order).  Each group loads a batch of
//   indices, then all the batch's rows, then adds them.
//
// Every gathered index is masked: an index outside [0, R) adds nothing,
// which is what the reference's zero row gives for a pad column, so callers
// may pass the table without the zero row.  An absent edge adds nothing even
// where X is not finite, as in a CSR product.  Each output element is summed
// by one thread in a fixed order (no atomics), so two runs are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int MAX_BUCKETS = 8;   // dense buckets of one launch
constexpr int DW = 4;            // warps of a dense block
constexpr int DCOLS = 32;        // output columns of a dense unit: one a lane
// Dense units in flight a block.  One: a block's ring of more stages costs
// blocks an SM (shared memory), and on DD's row plans 2 and 3 stages ran
// slower than 1 (utils/row_variants.py re-measures it).
constexpr int STAGES = 1;
constexpr int EW = 4;            // warps of an ELL block
constexpr int EU = 4;            // entries in flight a lane group (halved at NJ 2)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void set_zero(float& v) { v = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& v) { v = __float2bfloat16(0.f); }

struct DenseTable {
  const int32_t* cols[MAX_BUCKETS];   // [Wb, Kb] neighbour rows
  const uint32_t* mask[MAX_BUCKETS];  // [Wb, wh, ceil(Kb / 32)] bit k of row r: A[r, k] != 0
  const int32_t* wid[MAX_BUCKETS];    // [windows] window ids, or null: the window's position
  int kb[MAX_BUCKETS];
  int first[MAX_BUCKETS + 1];         // first window of each bucket in the launch's order
  int nb;
};

struct Unit {
  int b, p, c0;  // bucket, window in the bucket, first column
};

__device__ __forceinline__ Unit dense_unit(const DenseTable& tab, long long u, int nslab) {
  const long long w = u / nslab;
  int b = 0;
  while (w >= tab.first[b + 1]) ++b;
  return Unit{b, (int)(w - tab.first[b]), (int)(u - w * nslab) * DCOLS};
}

// Grid: persistent blocks of DW warps, unit u = blockIdx.x + i * gridDim.x.
// Dynamic shared memory: STAGES x ([kbmax][DCOLS] of T, then [wh][nwmax]
// mask words).  Row r of window p writes node (wid ? wid[p] : p) * wh + r
// when that is below ``limit``.
template <typename T, bool V16>
__global__ void __launch_bounds__(DW * 32)
dense_window_kernel(DenseTable tab, int wh, int kbmax, int nslab, const T* __restrict__ x,
                    long long r, int d, float* __restrict__ out, long long limit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nwmax = (kbmax + 31) / 32;
  const int xstage = kbmax * DCOLS;
  const int mstage = wh * nwmax;
  T* xs0 = reinterpret_cast<T*>(smem);
  uint32_t* ms0 = reinterpret_cast<uint32_t*>(smem + (size_t)STAGES * xstage * sizeof(T));
  const long long units = (long long)tab.first[tab.nb] * nslab;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // Stage unit u's gathered rows and row masks into slot s; one cp.async
  // group a call, empty past the last unit.
  auto issue = [&](long long u, int s) {
    if (u < units) {
      const Unit t = dense_unit(tab, u, nslab);
      const int kb = tab.kb[t.b], nw = (kb + 31) >> 5;
      const int32_t* wc = tab.cols[t.b] + (long long)t.p * kb;
      T* xs = xs0 + s * xstage;
      if constexpr (V16) {
        constexpr int CE = 16 / sizeof(T), CQ = DCOLS / CE;
        for (int i = tid; i < kb * CQ; i += DW * 32) {
          const int k = i / CQ, c = t.c0 + (i % CQ) * CE;
          const int idx = wc[k];
          const bool ok = idx >= 0 && idx < r && c < d;
          cp_async16_zfill(xs + i * CE, ok ? x + (long long)idx * d + c : x, ok ? 16 : 0);
        }
      } else {
        for (int i = tid; i < kb * DCOLS; i += DW * 32) {
          const int k = i / DCOLS, c = t.c0 + i % DCOLS;
          const int idx = wc[k];
          if (idx >= 0 && idx < r && c < d)
            xs[i] = x[(long long)idx * d + c];
          else
            set_zero(xs[i]);
        }
      }
      const uint32_t* wm = tab.mask[t.b] + (long long)t.p * wh * nw;
      uint32_t* ms = ms0 + s * mstage;
      for (int i = tid; i < wh * nw; i += DW * 32) cp_async4(ms + i, wm + i);
    }
    cp_async_commit();
  };

  const long long g = gridDim.x;
  long long u = blockIdx.x;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(u + s * g, s);
  for (int i = 0; u < units; u += g, ++i) {
    issue(u + (STAGES - 1) * g, (i + STAGES - 1) % STAGES);
    cp_async_wait<STAGES - 1>();  // unit u's group has landed
    __syncthreads();
    const Unit t = dense_unit(tab, u, nslab);
    const int kb = tab.kb[t.b], nw = (kb + 31) >> 5;
    const T* xs = xs0 + (i % STAGES) * xstage + lane;
    const uint32_t* ms = ms0 + (i % STAGES) * mstage;
    const int32_t* wid = tab.wid[t.b];
    const long long base = (long long)(wid != nullptr ? wid[t.p] : t.p) * wh;
    const int c = t.c0 + lane;
    for (int rr = warp; rr < wh; rr += DW) {
      float acc = 0.f;
      for (int w = 0; w < nw; ++w)  // warp-uniform: one row a warp
        for (uint32_t m = ms[rr * nw + w]; m != 0u; m &= m - 1u)
          acc += to_float(xs[(w * 32 + __ffs(m) - 1) * DCOLS]);
      if (base + rr < limit && c < d) out[(base + rr) * d + c] = acc;
    }
    __syncthreads();  // slot i % STAGES is refilled next
  }
  cp_async_wait<0>();
}

// VE elements of a 16-byte load (V16) or one element, widened to fp32 and
// added to acc.
template <typename T, bool V16>
struct Lanes;
template <>
struct Lanes<float, true> {
  static constexpr int VE = 4;
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void add(float* acc, Raw v) {
    acc[0] += __uint_as_float(v.x), acc[1] += __uint_as_float(v.y);
    acc[2] += __uint_as_float(v.z), acc[3] += __uint_as_float(v.w);
  }
};
template <>
struct Lanes<__nv_bfloat16, true> {
  static constexpr int VE = 8;
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void add(float* acc, Raw v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // element 2q in the low half (little-endian)
      acc[2 * q] += __uint_as_float(w[q] << 16);
      acc[2 * q + 1] += __uint_as_float(w[q] & 0xffff0000u);
    }
  }
};
template <typename T>
struct Lanes<T, false> {
  static constexpr int VE = 1;
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void add(float* acc, Raw v) { acc[0] += to_float(v); }
};

__device__ __forceinline__ void store(float* o, const float* v, int ve) {
  if (ve == 1) {
    *o = v[0];
  } else {
    for (int q = 0; q < ve; q += 4)
      *reinterpret_cast<float4*>(o + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  }
}

// Grid: x = hub rows (a block each), then middle rows (a warp each), then
// short rows (a group of G lanes each); y = column slab of G * VE * NJ
// columns.  Row i's entries are cols[ptr[i] : ptr[i+1]] (ptr == nullptr:
// cols[i*de : i*de + de]); it writes node[i] (node == nullptr: i) when that
// is below ``limit``.  Rows [0, n_hub) are hubs, then n_mid middle rows, the
// rest short.
template <typename T, bool V16, int NJ>
__global__ void __launch_bounds__(EW * 32)
ell_row_kernel(const int32_t* __restrict__ node, const int32_t* __restrict__ ptr,
               const int32_t* __restrict__ cols, int de, int rows, int n_hub, int n_mid, int G,
               const T* __restrict__ x, long long r, int d, float* __restrict__ out,
               long long limit) {
  using L = Lanes<T, V16>;
  constexpr int VE = L::VE;
  constexpr int U = EU / NJ;
  __shared__ float part[EW][32 * VE * NJ];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int spw = 32 / G, g = lane & (G - 1), sg = lane / G;
  const long long mid_blocks = (n_mid + EW - 1) / EW;
  const long long bx = blockIdx.x;
  int cls;  // 2 hub, 1 middle, 0 short: block-uniform
  long long row, last;
  int sub, S;
  if (bx < n_hub) {
    cls = 2, row = bx, last = n_hub, sub = warp * spw + sg, S = EW * spw;
  } else if (bx - n_hub < mid_blocks) {
    cls = 1, row = n_hub + (bx - n_hub) * EW + warp, last = n_hub + n_mid, sub = sg, S = spw;
  } else {
    cls = 0, row = n_hub + n_mid + (bx - n_hub - mid_blocks) * (EW * spw) + warp * spw + sg;
    last = rows, sub = 0, S = 1;
  }
  const int c0 = blockIdx.y * G * VE * NJ;
  float acc[NJ][VE];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < VE; ++q) acc[j][q] = 0.f;

  if (row < last) {
    long long lo, hi;
    if (ptr != nullptr) {
      lo = ptr[row], hi = ptr[row + 1];
    } else {
      lo = row * de, hi = lo + de;
    }
    for (long long k0 = lo + sub; k0 < hi; k0 += (long long)S * U) {
      int idx[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long k = k0 + (long long)u * S;
        idx[u] = k < hi ? cols[k] : -1;
      }
      typename L::Raw v[U][NJ];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool ok = idx[u] >= 0 && idx[u] < r;
        const T* xr = x + (ok ? (long long)idx[u] * d : 0LL);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = c0 + (j * G + g) * VE;
          if (ok && c < d) v[u][j] = L::load(xr + c);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (idx[u] < 0 || idx[u] >= r) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (c0 + (j * G + g) * VE < d) L::add(acc[j], v[u][j]);
      }
    }
  }

  if (cls != 0) {  // the groups of a warp, lane l holding the sum of l, l+G, ...
    for (int off = 16; off >= G; off >>= 1)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < VE; ++q) acc[j][q] += __shfl_down_sync(0xffffffffu, acc[j][q], off);
  }
  if (cls != 2) {
    if (row >= last || (cls == 1 && sg != 0)) return;
    const long long n = node != nullptr ? node[row] : row;
    if (n >= limit) return;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = c0 + (j * G + g) * VE;
      if (c < d) store(out + n * d + c, acc[j], VE);
    }
    return;
  }
  if (sg == 0)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < VE; ++q) part[warp][(j * G + g) * VE + q] = acc[j][q];
  __syncthreads();
  const long long n = node != nullptr ? node[row] : row;
  if (n >= limit) return;
  for (int t = threadIdx.x; t < G * VE * NJ; t += EW * 32) {
    if (c0 + t >= d) continue;
    float s = part[0][t];
#pragma unroll
    for (int w = 1; w < EW; ++w) s += part[w][t];
    out[n * d + c0 + t] = s;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

template <typename T, bool V16>
cudaError_t launch_dense(const DenseTable& tab, int wh, int kbmax, int nslab, const void* x,
                         long long r, int d, void* out, long long limit, cudaStream_t s) {
  const long long units = (long long)tab.first[tab.nb] * nslab;
  const size_t smem = (size_t)STAGES * (kbmax * DCOLS * sizeof(T) +
                                        wh * ((kbmax + 31) / 32) * sizeof(uint32_t));
  auto kernel = dense_window_kernel<T, V16>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, DW * 32, smem);
  if (e != cudaSuccess) return e;
  const long long resident = (long long)per_sm * sm_count();
  if (resident <= 0) return cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)(units < resident ? units : resident);
  kernel<<<grid, DW * 32, smem, s>>>(tab, wh, kbmax, nslab, static_cast<const T*>(x), r, d,
                                     static_cast<float*>(out), limit);
  return cudaGetLastError();
}

template <typename T, bool V16, int NJ>
cudaError_t launch_ell(const void* node, const void* ptr, const void* cols, int de, int rows,
                       int n_hub, int n_mid, int G, const void* x, long long r, int d, void* out,
                       long long limit, cudaStream_t s) {
  constexpr int VE = Lanes<T, V16>::VE;
  const int slab = G * VE * NJ, spw = 32 / G;
  const long long n_short = (long long)rows - n_hub - n_mid;
  const long long blocks =
      n_hub + (n_mid + EW - 1) / EW + (n_short + EW * spw - 1) / (EW * spw);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)((d + slab - 1) / slab));
  ell_row_kernel<T, V16, NJ><<<grid, EW * 32, 0, s>>>(
      static_cast<const int32_t*>(node), static_cast<const int32_t*>(ptr),
      static_cast<const int32_t*>(cols), de, rows, n_hub, n_mid, G, static_cast<const T*>(x),
      r, d, static_cast<float*>(out), limit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_ell(const void* node, const void* ptr, const void* cols, int de, int rows,
                         int n_hub, int n_mid, const void* x, long long r, int d, void* out,
                         long long limit, cudaStream_t s) {
  // 16-byte loads when every row of x and out starts 16-byte aligned
  const bool v16 = (d * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int ve = v16 ? 16 / (int)sizeof(T) : 1;
  const int chunks = (d + ve - 1) / ve;
  int G = 1;
  while (G < 32 && G < chunks) G *= 2;
  if (v16) {
    if (chunks > 32)
      return launch_ell<T, true, 2>(node, ptr, cols, de, rows, n_hub, n_mid, G, x, r, d, out,
                                    limit, s);
    return launch_ell<T, true, 1>(node, ptr, cols, de, rows, n_hub, n_mid, G, x, r, d, out, limit,
                                  s);
  }
  if (chunks > 32)
    return launch_ell<T, false, 2>(node, ptr, cols, de, rows, n_hub, n_mid, G, x, r, d, out, limit,
                                   s);
  return launch_ell<T, false, 1>(node, ptr, cols, de, rows, n_hub, n_mid, G, x, r, d, out, limit,
                                 s);
}

}  // namespace

// The dense windows of nb buckets, in the given order: cols[b] int32 [Wb, kb[b]],
// masks[b] uint32 [Wb, wh, ceil(kb[b] / 32)], wids[b] int32 [windows[b]] or
// null (write by window position), of which the first windows[b] windows
// are launched; x: [r, d] fp32 (x_bf16 == 0) or bf16; out: fp32, row n at
// out + n * d for n < limit.  Returns a cudaError_t (0 = launched).
extern "C" int hcspmm_dense_rows(const void* const* cols, const void* const* masks,
                                 const void* const* wids, const int* kb, const int* windows,
                                 int nb, int wh, const void* x, long long r, int d, int x_bf16,
                                 void* out, long long limit, void* stream) {
  if (nb < 0 || nb > MAX_BUCKETS || wh <= 0 || d <= 0 || r < 0)
    return (int)cudaErrorInvalidValue;
  DenseTable tab{};
  int kbmax = 0;
  long long total = 0;
  tab.nb = nb;
  for (int b = 0; b < nb; ++b) {
    if (kb[b] <= 0 || windows[b] < 0) return (int)cudaErrorInvalidValue;
    tab.cols[b] = static_cast<const int32_t*>(cols[b]);
    tab.mask[b] = static_cast<const uint32_t*>(masks[b]);
    tab.wid[b] = static_cast<const int32_t*>(wids[b]);
    tab.kb[b] = kb[b];
    tab.first[b] = (int)total;
    total += windows[b];
    if (windows[b] > 0 && kb[b] > kbmax) kbmax = kb[b];
  }
  const int nslab = (d + DCOLS - 1) / DCOLS;
  if (total * nslab > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tab.first[nb] = (int)total;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elt = x_bf16 ? 2 : 4;
  const bool v16 = (d * elt) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (x_bf16)
    return (int)(v16 ? launch_dense<__nv_bfloat16, true>(tab, wh, kbmax, nslab, x, r, d, out,
                                                         limit, s)
                     : launch_dense<__nv_bfloat16, false>(tab, wh, kbmax, nslab, x, r, d, out,
                                                          limit, s));
  return (int)(v16 ? launch_dense<float, true>(tab, wh, kbmax, nslab, x, r, d, out, limit, s)
                   : launch_dense<float, false>(tab, wh, kbmax, nslab, x, r, d, out, limit, s));
}

// A table of rows: row i sums x[cols[k]] for ptr[i] <= k < ptr[i+1] (ptr
// null: i*de <= k < i*de + de) into out row node[i] (node null: i), for
// node < limit; rows [0, n_hub) are hubs (a block each), the next n_mid
// middle rows (a warp each), the rest short (a group of lanes each).  x:
// [r, d] fp32 or bf16; out: fp32.
extern "C" int hcspmm_ell_rows(const void* node, const void* ptr, const void* cols, int de,
                               int rows, int n_hub, int n_mid, const void* x, long long r, int d,
                               int x_bf16, void* out, long long limit, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || r < 0 || n_hub < 0 || n_mid < 0 || n_hub + (long long)n_mid > rows ||
      (ptr == nullptr && de <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)dispatch_ell<__nv_bfloat16>(node, ptr, cols, de, rows, n_hub, n_mid, x, r, d, out,
                                            limit, s);
  return (int)dispatch_ell<float>(node, ptr, cols, de, rows, n_hub, n_mid, x, r, d, out, limit, s);
}
