// Transposed-band SpMM for Hopper (sm_90a), bound from Python with ctypes.
//
// tband_kernel replaces the Pallas kernels
// hcspmm_tpu/kernels/tband.py:tband_spmm_direct (pallas_call at :217) and
// :tband_spmm_bucket (:246), pack=1; tband_fused_kernel and, for shapes whose
// staging does not fit in shared memory, tband_fused_slab_kernel (below)
// replace :tband_fused_direct (:309).  Thread
// block b of superwindow i computes a DT-row slab of
//
//     Y^T[d0:d0+DT, c_i*bh : c_i*bh+bh] = X^T[d0:d0+DT, st[i] : st[i]+W] @ A_t[i]
//
// with A_t[i] an int8 0/1 block [W, bh] and c_i = sw[i] (direct mode, the
// superwindow's own output columns) or c_i = i (bucket mode, fp32 output in
// bucket order that the caller scatters).  Sums run in fp32 with plain FMAs
// on the CUDA cores: no tensor cores and no TF32, the counterpart of the
// reference's Precision.HIGHEST (tband.py:166-168).  bf16 inputs are
// widened with __bfloat162float; outputs are rounded to nearest.
//
// Departures from the Pallas kernel: a direct-mode entry with
// sw[i] == num_sw (capacity padding, format/plan.py) writes nothing, so no
// trash block is allocated and none is sliced off.  A warp skips each row of
// the staged A_t block in which its 32 columns are all zero, so an absent
// edge adds nothing even where x is not finite (as in a CSR product), where
// the Pallas kernel's dense dot would spread a NaN over the superwindow.  The
// 4-slot DMA ring of the TPU kernel (tband.py:103-150) is not copied:
// several blocks resident on each SM hide the load latency instead.
//
// What bounds it.  At the DD-scale stand-in (Sb 1312, W 768, bh 256, dt 32,
// fp32) one apply reads 258 MB of A_t and 129 MB of X^T slices and writes
// 43 MB: 0.13 ms at 3.35 TB/s.  Multiplying the dense 0/1 block would take
// 8.3 G FMAs (0.25 ms at the card's 67 TFLOP/s fp32 peak) plus a
// shared-memory load and an int8-to-float conversion per element; the
// stand-in's A_t is 0.65% non-zero, so the row skip above removes most of
// that work.  What is left, the per-row vote and the staging of A_t and X^T
// (not double-buffered), binds it: instruction issue and load latency, not
// bytes.  Blocks that share a superwindow are adjacent in the grid, so the
// second reads A_t from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KT = 64;  // contraction rows of A_t and X^T staged per step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Grid: one block per (superwindow i, DT-row chunk), chunk fastest.
// Block: bh threads; thread j owns output column j of the superwindow.
// Shared memory: x_s [KT][DT] fp32, then a_s [KT][bh] int8.
template <typename TX, typename TO, int DT>
__global__ void __launch_bounds__(512)
tband_kernel(const int32_t* __restrict__ starts, const int32_t* __restrict__ sw,
             const int8_t* __restrict__ at, const TX* __restrict__ xt,
             TO* __restrict__ out, int w, int bh, int nchunk, long long m,
             long long out_cols, int num_sw) {
  const int i = blockIdx.x / nchunk;
  const int d0 = (blockIdx.x % nchunk) * DT;
  const int j = threadIdx.x;
  long long col0 = (long long)i * bh;
  if (sw != nullptr) {
    const int s = sw[i];
    if (s >= num_sw) return;  // capacity padding: nothing to write
    col0 = (long long)s * bh;
  }
  const long long st = starts[i];

  extern __shared__ __align__(16) unsigned char smem[];
  float* x_s = reinterpret_cast<float*>(smem);
  int8_t* a_s = reinterpret_cast<int8_t*>(smem + KT * DT * sizeof(float));

  float acc[DT];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d] = 0.f;

  const int8_t* a_blk = at + (long long)i * w * bh;
  const int nvec = KT * bh / 16;
  for (int k0 = 0; k0 < w; k0 += KT) {
    // A_t rows [k0, k0+KT): KT*bh contiguous bytes, 16 bytes per load
    const int4* a_src = reinterpret_cast<const int4*>(a_blk + (long long)k0 * bh);
    int4* a_dst = reinterpret_cast<int4*>(a_s);
    for (int v = j; v < nvec; v += blockDim.x) a_dst[v] = a_src[v];
    // X^T[d0+dd, st+k0+kk] -> x_s[kk][dd]; neighbouring threads read
    // neighbouring columns of one feature row
    for (int e = j; e < KT * DT; e += blockDim.x) {
      const int kk = e % KT;
      const int dd = e / KT;
      x_s[kk * DT + dd] = to_f32(xt[(long long)(d0 + dd) * m + st + k0 + kk]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      const int8_t av = a_s[kk * bh + j];
      // A_t is a sparse 0/1 block: a warp whose 32 columns are all zero in
      // this row skips it (the branch is uniform across the warp)
      if (!__any_sync(0xffffffffu, av != 0)) continue;
      const float a = static_cast<float>(av);
      const float4* xv = reinterpret_cast<const float4*>(x_s + kk * DT);
#pragma unroll
      for (int q = 0; q < DT / 4; ++q) {
        const float4 x4 = xv[q];  // same address for the whole warp
        acc[4 * q + 0] = fmaf(x4.x, a, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(x4.y, a, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(x4.z, a, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(x4.w, a, acc[4 * q + 3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int d = 0; d < DT; ++d) store(out + (long long)(d0 + d) * out_cols + col0 + j, acc[d]);
}

template <typename TX, typename TO, int DT>
cudaError_t launch(const void* starts, const void* sw, const void* at, const void* xt,
                   void* out, int sb, int w, int bh, int dt, long long m,
                   long long out_cols, int num_sw, cudaStream_t stream) {
  const int nchunk = dt / DT;
  const size_t smem = KT * DT * sizeof(float) + (size_t)KT * bh;
  tband_kernel<TX, TO, DT><<<(unsigned)sb * nchunk, bh, smem, stream>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(sw),
      static_cast<const int8_t*>(at), static_cast<const TX*>(xt), static_cast<TO*>(out),
      w, bh, nchunk, m, out_cols, num_sw);
  return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t dispatch_dt(const void* starts, const void* sw, const void* at, const void* xt,
                        void* out, int sb, int w, int bh, int dt, long long m,
                        long long out_cols, int num_sw, cudaStream_t stream) {
  if (dt % 32 == 0)
    return launch<TX, TO, 32>(starts, sw, at, xt, out, sb, w, bh, dt, m, out_cols, num_sw, stream);
  return launch<TX, TO, 16>(starts, sw, at, xt, out, sb, w, bh, dt, m, out_cols, num_sw, stream);
}

// The fused transposed aggregate and update (tband.py:tband_fused_direct):
// one thread block per entry i, bh threads, thread j owning output column j
// of the superwindow.  For each DT-row slab of the features it sums the band
// product as tband_kernel does, writes agg^T[d0:d0+DT, cols] and keeps it,
// rounded to W's type as the reference's agg.astype(wt.dtype) does, in
// shared memory; then out^T[h, col j] = sum_d wt[h, d] * agg^T[d, j], summed
// in fp32 in d order, with wt staged in shared memory transposed so that four
// h read as one 16-byte broadcast.  Both products sum each output element in
// one thread in a fixed order: bitwise repeatable.  The W product is dense
// (2*ht*dt*bh operations a superwindow) and the staging holds
// (KT*DT + dt*bh + dt*ht)*4 + KT*bh bytes of shared memory (156 KB at dt 96,
// ht 96, bh 256): one block per SM, so the band loop's load latency is less
// hidden than in tband_kernel.
// Shared memory: x_s [KT][DT] fp32, agg_s [dt][bh] fp32, w_s [dt][ht] fp32,
// a_s [KT][bh] int8.
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename TX, typename TO, int DT>
__global__ void __launch_bounds__(512)
tband_fused_kernel(const int32_t* __restrict__ starts, const int32_t* __restrict__ sw,
                   const int8_t* __restrict__ at, const TX* __restrict__ xt,
                   const TX* __restrict__ wt, TO* __restrict__ agg, TO* __restrict__ out, int w,
                   int bh, int dt, int ht, long long m, long long out_cols, int num_sw) {
  const int i = blockIdx.x;
  const int j = threadIdx.x;
  const int s = sw[i];
  if (s >= num_sw) return;  // capacity padding: nothing to write
  const long long col0 = (long long)s * bh;
  const long long st = starts[i];

  extern __shared__ __align__(16) unsigned char smem[];
  float* x_s = reinterpret_cast<float*>(smem);
  float* agg_s = x_s + KT * DT;
  float* w_s = agg_s + dt * bh;
  int8_t* a_s = reinterpret_cast<int8_t*>(w_s + dt * ht);

  for (int e = j; e < ht * dt; e += blockDim.x) w_s[(e % dt) * ht + e / dt] = to_f32(wt[e]);

  const int8_t* a_blk = at + (long long)i * w * bh;
  const int nvec = KT * bh / 16;
  for (int d0 = 0; d0 < dt; d0 += DT) {
    float acc[DT];
#pragma unroll
    for (int d = 0; d < DT; ++d) acc[d] = 0.f;
    for (int k0 = 0; k0 < w; k0 += KT) {
      const int4* a_src = reinterpret_cast<const int4*>(a_blk + (long long)k0 * bh);
      int4* a_dst = reinterpret_cast<int4*>(a_s);
      for (int v = j; v < nvec; v += blockDim.x) a_dst[v] = a_src[v];
      for (int e = j; e < KT * DT; e += blockDim.x) {
        const int kk = e % KT;
        const int dd = e / KT;
        x_s[kk * DT + dd] = to_f32(xt[(long long)(d0 + dd) * m + st + k0 + kk]);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KT; ++kk) {
        const int8_t av = a_s[kk * bh + j];
        if (!__any_sync(0xffffffffu, av != 0)) continue;
        const float a = static_cast<float>(av);
        const float4* xv = reinterpret_cast<const float4*>(x_s + kk * DT);
#pragma unroll
        for (int q = 0; q < DT / 4; ++q) {
          const float4 x4 = xv[q];
          acc[4 * q + 0] = fmaf(x4.x, a, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(x4.y, a, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(x4.z, a, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(x4.w, a, acc[4 * q + 3]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      store(agg + (long long)(d0 + d) * out_cols + col0 + j, acc[d]);
      agg_s[(d0 + d) * bh + j] = round_as(acc[d], wt);
    }
  }
  __syncthreads();

  for (int h0 = 0; h0 < ht; h0 += 16) {
    float o[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) o[q] = 0.f;
    for (int d = 0; d < dt; ++d) {
      const float a = agg_s[d * bh + j];
      const float4* wv = reinterpret_cast<const float4*>(w_s + d * ht + h0);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 w4 = wv[q];  // same address for the whole block
        o[4 * q + 0] = fmaf(w4.x, a, o[4 * q + 0]);
        o[4 * q + 1] = fmaf(w4.y, a, o[4 * q + 1]);
        o[4 * q + 2] = fmaf(w4.z, a, o[4 * q + 2]);
        o[4 * q + 3] = fmaf(w4.w, a, o[4 * q + 3]);
      }
    }
#pragma unroll
    for (int q = 0; q < 16; ++q) store(out + (long long)(h0 + q) * out_cols + col0 + j, o[q]);
  }
}

// The same fused product where tband_fused_kernel's staging (fused_smem)
// exceeds the 227 KB of shared memory a block may use: dt above 176 at ht 32,
// or ht above about 600 at dt 64 (bh 256).  Nothing of size dt or ht is kept
// on chip.  Thread j keeps an out^T tile of HT rows of its column in
// registers; for each DT-row slab of the features, in order, it sums the band
// product into acc[DT] as tband_fused_kernel does, writes agg^T, and adds
// W^T[h0:h0+HT, slab] . round_as(acc) into the tile, W's slab staged in
// shared memory.  The ht tiles after the first re-read the slab's aggregate
// from agg (this thread's own writes; round_as of the stored value is the
// value rounded in the first tile, in either output type) instead of
// recomputing the band product: ceil(ht / HT) - 1 extra reads of dt*bh
// values an entry, from L2.  Each out^T element is summed in d order from
// 0, the order of tband_fused_kernel, so both are bitwise repeatable.
// Shared memory: x_s [KT][DT] fp32, w_s [DT][HT] fp32, a_s [KT][bh] int8.
constexpr int HT = 32;

template <typename TX, typename TO, int DT>
__global__ void __launch_bounds__(512)
tband_fused_slab_kernel(const int32_t* __restrict__ starts, const int32_t* __restrict__ sw,
                        const int8_t* __restrict__ at, const TX* __restrict__ xt,
                        const TX* __restrict__ wt, TO* __restrict__ agg, TO* __restrict__ out,
                        int w, int bh, int dt, int ht, long long m, long long out_cols,
                        int num_sw) {
  const int i = blockIdx.x;
  const int j = threadIdx.x;
  const int s = sw[i];
  if (s >= num_sw) return;  // capacity padding: nothing to write
  const long long col0 = (long long)s * bh;
  const long long st = starts[i];

  extern __shared__ __align__(16) unsigned char smem[];
  float* x_s = reinterpret_cast<float*>(smem);
  float* w_s = x_s + KT * DT;
  int8_t* a_s = reinterpret_cast<int8_t*>(w_s + DT * HT);

  const int8_t* a_blk = at + (long long)i * w * bh;
  const int nvec = KT * bh / 16;
  for (int h0 = 0; h0 < ht; h0 += HT) {
    const int hn = min(HT, ht - h0);
    float o[HT];
#pragma unroll
    for (int q = 0; q < HT; ++q) o[q] = 0.f;
    for (int d0 = 0; d0 < dt; d0 += DT) {
      float acc[DT];
      if (h0 == 0) {
#pragma unroll
        for (int d = 0; d < DT; ++d) acc[d] = 0.f;
        for (int k0 = 0; k0 < w; k0 += KT) {
          const int4* a_src = reinterpret_cast<const int4*>(a_blk + (long long)k0 * bh);
          int4* a_dst = reinterpret_cast<int4*>(a_s);
          for (int v = j; v < nvec; v += blockDim.x) a_dst[v] = a_src[v];
          for (int e = j; e < KT * DT; e += blockDim.x) {
            const int kk = e % KT;
            const int dd = e / KT;
            x_s[kk * DT + dd] = to_f32(xt[(long long)(d0 + dd) * m + st + k0 + kk]);
          }
          __syncthreads();
#pragma unroll 4
          for (int kk = 0; kk < KT; ++kk) {
            const int8_t av = a_s[kk * bh + j];
            if (!__any_sync(0xffffffffu, av != 0)) continue;
            const float a = static_cast<float>(av);
            const float4* xv = reinterpret_cast<const float4*>(x_s + kk * DT);
#pragma unroll
            for (int q = 0; q < DT / 4; ++q) {
              const float4 x4 = xv[q];
              acc[4 * q + 0] = fmaf(x4.x, a, acc[4 * q + 0]);
              acc[4 * q + 1] = fmaf(x4.y, a, acc[4 * q + 1]);
              acc[4 * q + 2] = fmaf(x4.z, a, acc[4 * q + 2]);
              acc[4 * q + 3] = fmaf(x4.w, a, acc[4 * q + 3]);
            }
          }
          __syncthreads();
        }
#pragma unroll
        for (int d = 0; d < DT; ++d) store(agg + (long long)(d0 + d) * out_cols + col0 + j, acc[d]);
      } else {
#pragma unroll
        for (int d = 0; d < DT; ++d) acc[d] = to_f32(agg[(long long)(d0 + d) * out_cols + col0 + j]);
        __syncthreads();  // the previous slab's readers of w_s are done
      }
      // w_s[d][q] = W^T[h0 + q, d0 + d], zero past ht
      for (int e = j; e < DT * HT; e += blockDim.x) {
        const int q = e % HT;
        w_s[e] = q < hn ? to_f32(wt[(long long)(h0 + q) * dt + d0 + e / HT]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < DT; ++d) {
        const float a = round_as(acc[d], wt);
        const float4* wv = reinterpret_cast<const float4*>(w_s + d * HT);
#pragma unroll
        for (int q = 0; q < HT / 4; ++q) {
          const float4 w4 = wv[q];  // same address for the whole block
          o[4 * q + 0] = fmaf(w4.x, a, o[4 * q + 0]);
          o[4 * q + 1] = fmaf(w4.y, a, o[4 * q + 1]);
          o[4 * q + 2] = fmaf(w4.z, a, o[4 * q + 2]);
          o[4 * q + 3] = fmaf(w4.w, a, o[4 * q + 3]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < HT; ++q)
      if (q < hn) store(out + (long long)(h0 + q) * out_cols + col0 + j, o[q]);
  }
}

// Shared memory one thread block may opt in to on the current device (227 KB
// on an H100): past it the fused product runs slab by slab.
size_t max_block_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return (size_t)bytes;
}

size_t fused_smem(int dt, int ht, int bh, int DT) {
  return ((size_t)KT * DT + (size_t)dt * bh + (size_t)dt * ht) * sizeof(float) +
         (size_t)KT * bh;
}

template <typename TX, typename TO, int DT>
cudaError_t launch_fused(const void* starts, const void* sw, const void* at, const void* xt,
                         const void* wt, void* agg, void* out, int sb, int w, int bh, int dt,
                         int ht, long long m, long long out_cols, int num_sw,
                         cudaStream_t stream) {
  size_t smem = fused_smem(dt, ht, bh, DT);
  auto kernel = tband_fused_kernel<TX, TO, DT>;
  if (smem > max_block_smem()) {
    smem = ((size_t)KT * DT + (size_t)DT * HT) * sizeof(float) + (size_t)KT * bh;
    kernel = tband_fused_slab_kernel<TX, TO, DT>;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)sb, bh, smem, stream>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(sw),
      static_cast<const int8_t*>(at), static_cast<const TX*>(xt), static_cast<const TX*>(wt),
      static_cast<TO*>(agg), static_cast<TO*>(out), w, bh, dt, ht, m, out_cols, num_sw);
  return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t dispatch_fused(const void* starts, const void* sw, const void* at, const void* xt,
                           const void* wt, void* agg, void* out, int sb, int w, int bh, int dt,
                           int ht, long long m, long long out_cols, int num_sw,
                           cudaStream_t stream) {
  if (dt % 32 == 0)
    return launch_fused<TX, TO, 32>(starts, sw, at, xt, wt, agg, out, sb, w, bh, dt, ht, m,
                                    out_cols, num_sw, stream);
  return launch_fused<TX, TO, 16>(starts, sw, at, xt, wt, agg, out, sb, w, bh, dt, ht, m,
                                  out_cols, num_sw, stream);
}

}  // namespace

// starts, sw: int32 [sb] (sw may be null: bucket mode); at: int8 [sb, w, bh];
// xt: [dt, m] fp32 (x_bf16 == 0) or bf16; out: [dt, out_cols], fp32 when
// out_f32 != 0, else the type of xt.  Returns a cudaError_t (0 = launched).
// The caller guarantees st + w <= m for every entry and that every output
// block it reads is written by exactly one entry.
extern "C" int hcspmm_tband_spmm(const void* starts, const void* sw, const void* at,
                                 const void* xt, void* out, int sb, int w, int bh, int dt,
                                 long long m, long long out_cols, int num_sw, int x_bf16,
                                 int out_f32, void* stream) {
  if (sb <= 0) return 0;
  if (dt <= 0 || dt % 16 || w <= 0 || w % KT || bh <= 0 || bh % 32 || bh > 512)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_bf16) {
    if (!out_f32) return (int)cudaErrorInvalidValue;
    return (int)dispatch_dt<float, float>(starts, sw, at, xt, out, sb, w, bh, dt, m, out_cols,
                                          num_sw, s);
  }
  if (out_f32)
    return (int)dispatch_dt<__nv_bfloat16, float>(starts, sw, at, xt, out, sb, w, bh, dt, m,
                                                  out_cols, num_sw, s);
  return (int)dispatch_dt<__nv_bfloat16, __nv_bfloat16>(starts, sw, at, xt, out, sb, w, bh, dt,
                                                        m, out_cols, num_sw, s);
}

// starts, sw: int32 [sb]; at: int8 [sb, w, bh]; xt: [dt, m] fp32 or bf16;
// wt: [ht, dt] in xt's type; agg: [dt, out_cols] and out: [ht, out_cols],
// fp32 when out_f32 != 0, else xt's type.  Entries with sw >= num_sw write
// nothing.  dt and ht are multiples of 16.  Where tband_fused_kernel's shared
// memory (fused_smem) would exceed what a block may use (max_block_smem),
// tband_fused_slab_kernel runs instead.  Returns a cudaError_t.
extern "C" int hcspmm_tband_fused(const void* starts, const void* sw, const void* at,
                                  const void* xt, const void* wt, void* agg, void* out, int sb,
                                  int w, int bh, int dt, int ht, long long m, long long out_cols,
                                  int num_sw, int x_bf16, int out_f32, void* stream) {
  if (sb <= 0) return 0;
  if (dt <= 0 || dt % 16 || ht <= 0 || ht % 16 || w <= 0 || w % KT || bh <= 0 || bh % 32 ||
      bh > 512)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_bf16) {
    if (!out_f32) return (int)cudaErrorInvalidValue;
    return (int)dispatch_fused<float, float>(starts, sw, at, xt, wt, agg, out, sb, w, bh, dt,
                                             ht, m, out_cols, num_sw, s);
  }
  if (out_f32)
    return (int)dispatch_fused<__nv_bfloat16, float>(starts, sw, at, xt, wt, agg, out, sb, w,
                                                     bh, dt, ht, m, out_cols, num_sw, s);
  return (int)dispatch_fused<__nv_bfloat16, __nv_bfloat16>(starts, sw, at, xt, wt, agg, out,
                                                           sb, w, bh, dt, ht, m, out_cols,
                                                           num_sw, s);
}
