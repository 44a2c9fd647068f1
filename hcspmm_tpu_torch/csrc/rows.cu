// The row layout's two non-band populations for Hopper (sm_90a), bound from
// Python with ctypes (kernels/block_spmm.py holds the wrappers and the plain
// PyTorch versions).
//
// Replaces the Pallas kernels of hcspmm_tpu/kernels/block_spmm.py:
//
//   dense_bucket_spmm (pallas_call at :127), the reference's tensor-core
//   population (hybrid_all_kernel.cu:1385-1472): one 16-row window w of a
//   width bucket computes
//
//       out[w] = A[w] [wh, Kb] @ X[cols[w]] [Kb, D]
//
//   with A[w] an int8 0/1 block and cols[w] the window's Kb unique neighbour
//   rows (pad columns point at the zero row, or past the table);
//
//   ell_bucket_spmm (pallas_call at :178), the reference's CUDA-core
//   warp-per-row loop (hybrid_all_kernel.cu:964-1036): one row r of a degree
//   bucket computes out[r] = sum_k X[cols[r, k]].  The same kernel in its CSR
//   mode sums the residual rows (degree above every ELL width), whose edges
//   are sorted by row with row starts computed at upload; the reference leaves
//   those to an XLA segment_sum.
//
// Both are bound by bytes: each gathered row of X is read once per window or
// row (at dim 32 fp32, 128 B), against a few FMAs per element.  Sums run in
// fp32 with plain FMAs on the CUDA cores, no tensor cores and no TF32: the
// counterpart of the reference's Precision.HIGHEST in fp32; bf16 rows are
// widened with __bfloat162float, as the reference widens its bf16 gather
// table to fp32 (block_spmm.py:928-932).  Outputs are fp32, as the
// reference's.
//
// Every gathered index is masked: an index outside [0, R) adds nothing,
// which is what the reference's zero row gives for a pad column, so callers
// may pass the table without the zero row.  An absent edge (A == 0 in a
// dense window) adds nothing even where X is not finite, as in a CSR
// product.  Each output element is summed by one thread in a fixed order (no
// atomics), so two runs are bitwise equal:
//
// - dense: a block of 4 warps owns one window and a 32-column slab; the
//   window's A and its gathered X rows are staged in shared memory 64
//   columns of A at a time (the gathers of a chunk all in flight), and
//   thread (row group g, lane l) sums rows g, g+4, g+8, g+12 of column l in
//   k order, skipping A == 0 (warp-uniform);
// - ELL: a warp owns one row (8 rows per block) and loads 8 gathered rows
//   before it adds them in order; lanes cover the columns, one float each or
//   16 bytes each when D is a multiple of 4 and at least 128.  With `split`,
//   a block owns one row and its 8 warps sum 8 consecutive slices of the
//   row's entries, added together in warp order (wide ELL buckets and the
//   residual's hub rows, whose thousands of edges one warp would walk
//   alone).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DW = 4;            // warps of a dense block
constexpr int DCOLS = 32;        // output columns of a dense block
constexpr int KC = 64;           // columns of A staged at a time
constexpr int MAX_WH = 4 * DW;   // window height: 4 rows per thread
constexpr int EW = 8;            // warps of an ELL block
constexpr int U = 8;             // gathers in flight per warp (ELL)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// VEC consecutive elements from p, widened to fp32; zeros when !ok.
template <int VEC>
__device__ __forceinline__ void load_vec(float* v, const float* p, bool ok) {
  if constexpr (VEC == 4) {
    const float4 q = ok ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    v[0] = ok ? *p : 0.f;
  }
}
template <int VEC>
__device__ __forceinline__ void load_vec(float* v, const __nv_bfloat16* p, bool ok) {
  if constexpr (VEC == 4) {
    const uint2 q = ok ? *reinterpret_cast<const uint2*>(p) : make_uint2(0u, 0u);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
  } else {
    v[0] = ok ? __bfloat162float(*p) : 0.f;
  }
}

// Grid: x = window, y = 32-column slab.  Block: DW warps.
template <typename T>
__global__ void __launch_bounds__(DW * 32)
dense_rows_kernel(const int32_t* __restrict__ cols, const int8_t* __restrict__ a,
                  const T* __restrict__ x, long long r, int d, float* __restrict__ out, int wh,
                  int kb) {
  __shared__ float xg[KC][DCOLS];
  __shared__ int8_t as[MAX_WH][KC];
  const long long w = blockIdx.x;
  const int c0 = blockIdx.y * DCOLS;
  const int lane = threadIdx.x & 31;
  const int rg = threadIdx.x >> 5;
  const int32_t* wcols = cols + w * kb;
  const int8_t* wa = a + w * wh * kb;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int k0 = 0; k0 < kb; k0 += KC) {
    const int kc = min(KC, kb - k0);
    for (int i = threadIdx.x; i < MAX_WH * KC; i += DW * 32) {
      const int rr = i / KC, k = i % KC;
      as[rr][k] = (rr < wh && k < kc) ? wa[(long long)rr * kb + k0 + k] : int8_t(0);
    }
#pragma unroll
    for (int it = 0; it < KC * DCOLS / (DW * 32); ++it) {
      const int i = it * DW * 32 + threadIdx.x;
      const int k = i / DCOLS, c = i % DCOLS;
      float v = 0.f;
      if (k < kc && c0 + c < d) {
        const int idx = wcols[k0 + k];
        if (idx >= 0 && idx < r) v = to_float(x[(long long)idx * d + c0 + c]);
      }
      xg[k][c] = v;
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      const float xv = xg[k][lane];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int av = as[rg + DW * j][k];
        if (av != 0) acc[j] = fmaf(static_cast<float>(av), xv, acc[j]);
      }
    }
    __syncthreads();
  }
  const int c = c0 + lane;
  if (c < d) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rr = rg + DW * j;
      if (rr < wh) out[(w * wh + rr) * d + c] = acc[j];
    }
  }
}

// Grid: x = block of EW rows (or one row with split), y = column slab of
// 32*VEC*NJ columns.  Row r's entries are cols[ptr[r] : ptr[r+1]] (CSR mode)
// or cols[r*de : r*de + de] (ELL mode, ptr == nullptr).
template <typename T, int VEC, int NJ>
__global__ void __launch_bounds__(EW * 32)
ell_rows_kernel(const int32_t* __restrict__ ptr, const int32_t* __restrict__ cols, int de,
                const T* __restrict__ x, long long r, int d, float* __restrict__ out, int rows,
                int split) {
  constexpr int SLAB = 32 * VEC * NJ;
  __shared__ float part[EW][SLAB];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = split ? (long long)blockIdx.x : (long long)blockIdx.x * EW + warp;
  const int c0 = blockIdx.y * SLAB;
  float acc[NJ][VEC];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[j][q] = 0.f;

  if (row < rows) {
    long long lo, hi;
    if (ptr != nullptr) {
      lo = ptr[row];
      hi = ptr[row + 1];
    } else {
      lo = row * de;
      hi = lo + de;
    }
    if (split) {  // warp w sums the w-th of EW consecutive slices
      const long long len = hi - lo, step = (len + EW - 1) / EW;
      hi = lo + min(len, (warp + 1) * step);
      lo = lo + min(len, warp * step);
    }
    for (long long k = lo; k < hi; k += U) {
      int idx[U];
#pragma unroll
      for (int u = 0; u < U; ++u) idx[u] = k + u < hi ? cols[k + u] : -1;
      float v[U][NJ][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool ok = idx[u] >= 0 && idx[u] < r;
        const T* xr = x + (ok ? (long long)idx[u] * d : 0LL);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = c0 + (j * 32 + lane) * VEC;
          load_vec<VEC>(v[u][j], xr + c, ok && c < d);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (idx[u] < 0 || idx[u] >= r) continue;  // warp-uniform
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int q = 0; q < VEC; ++q) acc[j][q] += v[u][j][q];
      }
    }
  }

  if (!split) {
    if (row >= rows) return;
    float* orow = out + row * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = c0 + (j * 32 + lane) * VEC;
      if (c >= d) continue;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(orow + c) = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      } else {
        orow[c] = acc[j][0];
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < VEC; ++q) part[warp][(j * 32 + lane) * VEC + q] = acc[j][q];
  __syncthreads();
  if (row >= rows) return;
  for (int t = threadIdx.x; t < SLAB; t += EW * 32) {
    if (c0 + t >= d) continue;
    float s = part[0][t];
#pragma unroll
    for (int w = 1; w < EW; ++w) s += part[w][t];
    out[row * d + c0 + t] = s;
  }
}

template <typename T, int VEC, int NJ>
cudaError_t launch_ell(const void* ptr, const void* cols, int de, const void* x, long long r,
                       int d, void* out, int rows, int split, cudaStream_t s) {
  constexpr int SLAB = 32 * VEC * NJ;
  const dim3 grid(split ? (unsigned)rows : (unsigned)((rows + EW - 1) / EW),
                  (unsigned)((d + SLAB - 1) / SLAB));
  ell_rows_kernel<T, VEC, NJ><<<grid, EW * 32, 0, s>>>(
      static_cast<const int32_t*>(ptr), static_cast<const int32_t*>(cols), de,
      static_cast<const T*>(x), r, d, static_cast<float*>(out), rows, split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_ell(const void* ptr, const void* cols, int de, const void* x, long long r,
                         int d, void* out, int rows, int split, int vec, int nj,
                         cudaStream_t s) {
  if (vec == 4) {
    if (nj == 1) return launch_ell<T, 4, 1>(ptr, cols, de, x, r, d, out, rows, split, s);
    if (nj == 2) return launch_ell<T, 4, 2>(ptr, cols, de, x, r, d, out, rows, split, s);
    return cudaErrorInvalidValue;
  }
  if (vec != 1) return cudaErrorInvalidValue;
  if (nj == 1) return launch_ell<T, 1, 1>(ptr, cols, de, x, r, d, out, rows, split, s);
  if (nj == 2) return launch_ell<T, 1, 2>(ptr, cols, de, x, r, d, out, rows, split, s);
  if (nj == 4) return launch_ell<T, 1, 4>(ptr, cols, de, x, r, d, out, rows, split, s);
  if (nj == 8) return launch_ell<T, 1, 8>(ptr, cols, de, x, r, d, out, rows, split, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// cols: int32 [wb, kb]; a: int8 [wb, wh, kb]; x: [r, d] fp32 (x_bf16 == 0) or
// bf16; out: fp32 [wb, wh, d].  Returns a cudaError_t (0 = launched).
extern "C" int hcspmm_dense_bucket_spmm(const void* cols, const void* a, const void* x,
                                        void* out, int wb, int wh, int kb, long long r, int d,
                                        int x_bf16, void* stream) {
  if (wb <= 0) return 0;
  if (wh <= 0 || wh > MAX_WH || kb <= 0 || d <= 0 || r < 0 || (d + DCOLS - 1) / DCOLS > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)wb, (unsigned)((d + DCOLS - 1) / DCOLS));
  if (x_bf16)
    dense_rows_kernel<__nv_bfloat16><<<grid, DW * 32, 0, s>>>(
        static_cast<const int32_t*>(cols), static_cast<const int8_t*>(a),
        static_cast<const __nv_bfloat16*>(x), r, d, static_cast<float*>(out), wh, kb);
  else
    dense_rows_kernel<float><<<grid, DW * 32, 0, s>>>(
        static_cast<const int32_t*>(cols), static_cast<const int8_t*>(a),
        static_cast<const float*>(x), r, d, static_cast<float*>(out), wh, kb);
  return (int)cudaGetLastError();
}

// ptr: int32 [rows + 1] row starts into cols (CSR mode) or null (ELL mode:
// cols int32 [rows, de]); x: [r, d] fp32 or bf16; out: fp32 [rows, d].
// vec 4 needs d % 4 == 0 and x and out 16-byte aligned; the slab of
// 32*vec*nj columns is one grid row.  split != 0: one block per row.
extern "C" int hcspmm_ell_spmm(const void* ptr, const void* cols, const void* x, void* out,
                               int rows, int de, int split, long long r, int d, int vec, int nj,
                               int x_bf16, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || r < 0 || (ptr == nullptr && de <= 0) || (vec == 4 && d % 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)dispatch_ell<__nv_bfloat16>(ptr, cols, de, x, r, d, out, rows, split, vec, nj,
                                            s);
  return (int)dispatch_ell<float>(ptr, cols, de, x, r, d, out, rows, split, vec, nj, s);
}
