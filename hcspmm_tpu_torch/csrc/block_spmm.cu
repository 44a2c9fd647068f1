// Row-layout band SpMM for Hopper (sm_90a), bound from Python with ctypes
// (kernels/block_spmm.py holds the wrappers and the plain PyTorch versions).
//
// Replaces the Pallas kernels hcspmm_tpu/kernels/block_spmm.py:
// band_bucket_spmm_direct (pallas_call at :459) and band_bucket_spmm (:317),
// which differ only in where a result lands.  Entry i of a band bucket
// computes
//
//     out[c_i*bh : c_i*bh + bh, :] = A[i] @ X[st[i] : st[i] + Bb, :dp]
//
// with A[i] an int8 0/1 block [bh, Bb] and c_i = sw[i] (direct mode: the
// superwindow's own rows, in X's dtype or fp32) or c_i = i (bucket mode:
// fp32 blocks in bucket order, which the caller scatters).  Sums run in fp32
// with plain FMAs on the CUDA cores, no tensor cores and no TF32: the
// counterpart of the reference's Precision.HIGHEST in fp32; bf16 inputs are
// widened with __bfloat162float, as the reference's DEFAULT-precision bf16
// dot accumulates exact 0/1 x bf16 products in fp32.  Outputs are rounded to
// nearest once.
//
// The blocks are under 1% non-zero (DD's wide plan: 1.38 M edges in
// 1190 x 256 x 640 bytes of A), so the kernel does not multiply the dense
// block.  A warp owns one output row at a time: it reads the row of A as
// 4-byte words (32 lanes = 128 columns per step), votes which words hold a
// non-zero, and for each non-zero byte, in column order, adds that X row's
// slice (lane l owns columns 4l..4l+3 of each 128-column group).  A row of X
// is read once per non-zero of A; the superwindow's band (Bb rows) is small
// enough to stay in L2 while its bh rows are computed.  An absent edge adds
// nothing even where X is not finite (as in a CSR product), where the Pallas
// kernel's dense dot would spread a NaN over the superwindow.
//
// Departures from the Pallas kernel: a direct-mode entry with
// sw[i] == num_sw (capacity padding, format/plan.py) writes nothing, so no
// trash block is allocated and none is sliced off; the 4-deep DMA ring of
// the TPU kernel (block_spmm.py:_band_body_deep) is not copied: many warps
// resident on each SM hide the load latency instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;          // warps per thread block
constexpr int ROWS = 32;          // output rows of one entry per thread block

struct F4 {
  float v[4];
};

__device__ __forceinline__ F4 load4(const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  return F4{{q.x, q.y, q.z, q.w}};
}
__device__ __forceinline__ F4 load4(const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return F4{{a.x, a.y, b.x, b.y}};
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<uint32_t*>(&lo);
  q.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}

// Grid: x = (entry i, 32-row chunk of its bh rows), chunk fastest; y = slab
// of NG*128 output columns.  Block: WARPS warps; warp w computes rows
// w, w + WARPS, ... of the chunk.
template <typename TX, typename TO, int NG>
__global__ void __launch_bounds__(WARPS * 32)
band_kernel(const int32_t* __restrict__ starts, const int32_t* __restrict__ sw,
            const int8_t* __restrict__ a, const TX* __restrict__ x, TO* __restrict__ out,
            int bh, int bb, int dp, int nchunk, int num_sw) {
  const int i = blockIdx.x / nchunk;
  const int r_lo = (blockIdx.x % nchunk) * ROWS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long blk = i;
  if (sw != nullptr) {
    blk = sw[i];
    if (blk >= num_sw) return;  // capacity padding: nothing to write
  }
  const long long st = starts[i];
  const int col0 = blockIdx.y * NG * 128 + 4 * lane;
  const int r_hi = min(r_lo + ROWS, bh);

  for (int r = r_lo + warp; r < r_hi; r += WARPS) {
    const int8_t* arow = a + ((long long)i * bh + r) * bb;
    float acc[NG][4];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[g][q] = 0.f;

    for (int k0 = 0; k0 < bb; k0 += 128) {
      const int k = k0 + 4 * lane;
      const uint32_t word = k < bb ? *reinterpret_cast<const uint32_t*>(arow + k) : 0u;
      // words in column order; the loop below is uniform across the warp
      for (unsigned nz = __ballot_sync(0xffffffffu, word != 0u); nz; nz &= nz - 1) {
        const int src = __ffs(nz) - 1;
        const uint32_t w = __shfl_sync(0xffffffffu, word, src);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int av = static_cast<int8_t>((w >> (8 * b)) & 0xffu);
          if (av == 0) continue;
          const float af = static_cast<float>(av);
          const TX* xr = x + (st + k0 + 4 * src + b) * dp + col0;
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            const F4 v = load4(xr + g * 128);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[g][q] = fmaf(v.v[q], af, acc[g][q]);
          }
        }
      }
    }
    TO* orow = out + (blk * bh + r) * dp + col0;
#pragma unroll
    for (int g = 0; g < NG; ++g) store4(orow + g * 128, acc[g]);
  }
}

template <typename TX, typename TO, int NG>
cudaError_t launch(const void* starts, const void* sw, const void* a, const void* x, void* out,
                   int sb, int bh, int bb, int dp, int num_sw, cudaStream_t stream) {
  const int nchunk = (bh + ROWS - 1) / ROWS;
  const dim3 grid((unsigned)sb * nchunk, (unsigned)(dp / (NG * 128)));
  band_kernel<TX, TO, NG><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(sw),
      static_cast<const int8_t*>(a), static_cast<const TX*>(x), static_cast<TO*>(out), bh, bb,
      dp, nchunk, num_sw);
  return cudaGetLastError();
}

// The widest column slab (at most 4 groups of 128, so each lane keeps 16
// fp32 sums) whose group count divides dp / 128.
template <typename TX, typename TO>
cudaError_t dispatch_ng(const void* starts, const void* sw, const void* a, const void* x,
                        void* out, int sb, int bh, int bb, int dp, int num_sw,
                        cudaStream_t stream) {
  const int groups = dp / 128;
  if (groups % 4 == 0)
    return launch<TX, TO, 4>(starts, sw, a, x, out, sb, bh, bb, dp, num_sw, stream);
  if (groups % 3 == 0)
    return launch<TX, TO, 3>(starts, sw, a, x, out, sb, bh, bb, dp, num_sw, stream);
  if (groups % 2 == 0)
    return launch<TX, TO, 2>(starts, sw, a, x, out, sb, bh, bb, dp, num_sw, stream);
  return launch<TX, TO, 1>(starts, sw, a, x, out, sb, bh, bb, dp, num_sw, stream);
}

}  // namespace

// starts, sw: int32 [sb] (sw may be null: bucket mode); a: int8 [sb, bh, bb];
// x: [m, dp] fp32 (x_bf16 == 0) or bf16; out: [rows, dp], fp32 when
// out_f32 != 0, else the type of x.  Returns a cudaError_t (0 = launched).
// The caller checks on the host that st + bb <= m for every entry, that
// sw lies in [0, num_sw], and that every output block it reads is written
// by exactly one entry.
extern "C" int hcspmm_band_spmm(const void* starts, const void* sw, const void* a,
                                const void* x, void* out, int sb, int bh, int bb, int dp,
                                int num_sw, int x_bf16, int out_f32, void* stream) {
  if (sb <= 0) return 0;
  if (bh <= 0 || bb <= 0 || bb % 4 || dp <= 0 || dp % 128 ||
      (long long)sb * ((bh + ROWS - 1) / ROWS) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_bf16) {
    if (!out_f32) return (int)cudaErrorInvalidValue;
    return (int)dispatch_ng<float, float>(starts, sw, a, x, out, sb, bh, bb, dp, num_sw, s);
  }
  if (out_f32)
    return (int)dispatch_ng<__nv_bfloat16, float>(starts, sw, a, x, out, sb, bh, bb, dp, num_sw,
                                                  s);
  return (int)dispatch_ng<__nv_bfloat16, __nv_bfloat16>(starts, sw, a, x, out, sb, bh, bb, dp,
                                                        num_sw, s);
}
