// Row-layout band SpMM for Hopper (sm_90a), bound from Python with ctypes
// (kernels/block_spmm.py holds the wrappers and the plain PyTorch versions).
//
// Four kernels share one inner loop, ``add_row``: a warp owns one output row
// and adds, for each non-zero of that row of an int8 0/1 block of A, the X
// row it names.  It reads the row of A as 4-byte words (32 lanes = 128
// columns per step), votes which words hold a non-zero, and for each
// non-zero byte, in column order, adds that X row's slice with fp32 FMAs
// (lane l owns columns 4l..4l+3 of each 128-column group).  Sums run in fp32
// with plain FMAs on the CUDA cores, no tensor cores and no TF32: the
// counterpart of the reference's Precision.HIGHEST in fp32; bf16 inputs are
// widened with __bfloat162float, as the reference's DEFAULT-precision bf16
// dot accumulates exact 0/1 x bf16 products in fp32.  Outputs are rounded
// to nearest once.  Every output element is summed by one thread in a fixed
// order, so results are bitwise repeatable.  An absent edge adds nothing even
// where X is not finite (as in a CSR product), where the Pallas kernels'
// dense dots would spread a NaN over the superwindow.
//
// band_kernel replaces hcspmm_tpu/kernels/block_spmm.py:
//   band_bucket_spmm_direct (pallas_call at :459), band_bucket_spmm (:317)
//   and band_bucket_spmm_grouped (:414), which differ only in where a result
//   lands and how many entries a grid step owns.  Entry i computes
//
//       out[c_i*bh : c_i*bh + bh, :] = A[i] @ X[st[i] : st[i] + Bb, :dp]
//
//   with c_i = sw[i] (direct mode: the superwindow's own rows, in X's dtype
//   or fp32), or c_i = i (bucket mode: fp32 blocks in bucket order, which the
//   caller scatters; grouped mode: identity order, one thread block owning
//   ``group`` consecutive entries, as a grid step of the Pallas kernel owns
//   G superwindows).  An entry whose c_i >= num_sw (capacity padding,
//   format/plan.py) writes nothing, so no trash block is allocated.
// tiled_kernel replaces band_tiled_spmm (pallas_call at :597): superwindow s
//   sums its run of (superwindow, 128-row X tile) pairs, ptr[s] <= p <
//   ptr[s+1], each pair's A tile [bh, 128] against X[tile[p]*128 : +128], in
//   pair order, and writes its block once.  The TPU kernel's ring-cache
//   fetch schedule (tp_fetch / tp_late) changes no value and is not used:
//   consecutive superwindows read overlapping tiles, which L2 keeps.
// fused_kernel replaces band_fused_spmm_direct (pallas_call at :666): the
//   band aggregate agg = A[i] @ X[st : st+Bb] of a 32-row chunk is written
//   out and kept in shared memory, rounded to W's type as the reference's
//   ``agg.astype(w.dtype)`` does, then multiplied by W [dp, hp] read through
//   L2: out = agg @ W, summed in fp32 in k order; fused_slab_kernel is its
//   form for dp above 1792, where 32 aggregate rows outgrow shared memory.
//
// What bounds them.  The blocks are under 1% non-zero (DD's wide plan:
// 1.38 M edges in 1190 x 256 x 640 bytes of A), so no kernel multiplies the
// dense block; a row of X is read once per non-zero of A and the
// superwindow's band (Bb rows) stays in L2 while its bh rows are computed.
// Reading A (every byte, to find the non-zeros) is the bytes floor; the
// per-non-zero gathers and the instruction issue of the vote loop keep the
// kernels above it.  The fused kernel's W product is dense: 2*bh*dp*hp
// operations per superwindow on the CUDA cores, which at hidden 256 bounds
// it by operations, not bytes.  The 4-deep DMA ring of the TPU kernels
// (block_spmm.py:_band_body_deep) is not copied: many warps resident on each
// SM hide the load latency instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;          // warps per thread block
constexpr int ROWS = 32;          // output rows of one entry per thread block
constexpr int TILE = 128;         // X rows (A columns) of one tiled pair

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
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// v rounded to T and widened back: the reference's agg.astype(w.dtype)
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// acc += A_row @ X[0 : bb] for one row of an int8 block (bb bytes, a
// multiple of 4, 4-byte aligned); xb points at X's first band row, offset to
// this lane's first column (rows dp elements apart).
template <typename TX, int NG>
__device__ __forceinline__ void add_row(const int8_t* __restrict__ arow, int bb,
                                        const TX* __restrict__ xb, long long dp, int lane,
                                        float (&acc)[NG][4]) {
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
        const TX* xr = xb + (long long)(k0 + 4 * src + b) * dp;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const F4 v = load4(xr + g * 128);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[g][q] = fmaf(v.v[q], af, acc[g][q]);
        }
      }
    }
  }
}

// Grid: x = (group of entries, 32-row chunk of their bh rows), chunk
// fastest; y = slab of NG*128 output columns.  Block: WARPS warps; warp w
// computes rows w, w + WARPS, ... of the chunk, for each entry of its group.
template <typename TX, typename TO, int NG>
__global__ void __launch_bounds__(WARPS * 32)
band_kernel(const int32_t* __restrict__ starts, const int32_t* __restrict__ sw,
            const int8_t* __restrict__ a, const TX* __restrict__ x, TO* __restrict__ out,
            int bh, int bb, int dp, int nchunk, int num_sw, int group) {
  const int gi = blockIdx.x / nchunk;
  const int r_lo = (blockIdx.x % nchunk) * ROWS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.y * NG * 128 + 4 * lane;
  const int r_hi = min(r_lo + ROWS, bh);

  for (int j = 0; j < group; ++j) {
    const long long i = (long long)gi * group + j;
    const long long blk = sw != nullptr ? sw[i] : i;
    if (blk >= num_sw) continue;  // capacity padding: nothing to write
    const long long st = starts[i];
    for (int r = r_lo + warp; r < r_hi; r += WARPS) {
      float acc[NG][4] = {};
      add_row<TX, NG>(a + (i * bh + r) * bb, bb, x + st * dp + col0, dp, lane, acc);
      TO* orow = out + (blk * bh + r) * dp + col0;
#pragma unroll
      for (int g = 0; g < NG; ++g) store4(orow + g * 128, acc[g]);
    }
  }
}

// Grid: x = (superwindow s, 32-row chunk), chunk fastest; y = column slab.
template <typename TX, typename TO, int NG>
__global__ void __launch_bounds__(WARPS * 32)
tiled_kernel(const int32_t* __restrict__ ptr, const int32_t* __restrict__ tile,
             const int8_t* __restrict__ a, const TX* __restrict__ x, TO* __restrict__ out,
             int bh, int dp, int nchunk) {
  const long long s = blockIdx.x / nchunk;
  const int r_lo = (blockIdx.x % nchunk) * ROWS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.y * NG * 128 + 4 * lane;
  const int r_hi = min(r_lo + ROWS, bh);
  const int p0 = ptr[s];
  const int p1 = ptr[s + 1];

  for (int r = r_lo + warp; r < r_hi; r += WARPS) {
    float acc[NG][4] = {};
    for (int p = p0; p < p1; ++p)
      add_row<TX, NG>(a + ((long long)p * bh + r) * TILE, TILE,
                      x + (long long)tile[p] * TILE * dp + col0, dp, lane, acc);
    TO* orow = out + (s * bh + r) * dp + col0;
#pragma unroll
    for (int g = 0; g < NG; ++g) store4(orow + g * 128, acc[g]);
  }
}

// Grid: x = (entry i, 32-row chunk), chunk fastest.  Block: WARPS warps.
// Shared memory: agg_s [ROWS][dp] fp32.  Phase 1 (warp per row, NG*128
// columns at a time): the aggregate rows, written to ``agg`` and, rounded to
// W's type, to agg_s.  Phase 2: thread t owns column c0 + (t % 128) of out
// and 16 of the chunk's rows (t / 128 picks which half), and sums agg_s[r, k]
// * W[k, c] over k in order; the warp's threads read the same agg_s words
// (a broadcast) and neighbouring W columns.
template <typename TX, typename TO, int NG>
__global__ void __launch_bounds__(WARPS * 32)
fused_kernel(const int32_t* __restrict__ starts, const int32_t* __restrict__ sw,
             const int8_t* __restrict__ a, const TX* __restrict__ x, const TX* __restrict__ w,
             TO* __restrict__ agg, TO* __restrict__ out, int bh, int bb, int dp, int hp,
             int nchunk, int num_sw) {
  const int i = blockIdx.x / nchunk;
  const int r_lo = (blockIdx.x % nchunk) * ROWS;
  const long long blk = sw[i];
  if (blk >= num_sw) return;  // capacity padding: nothing to write
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = min(ROWS, bh - r_lo);
  const long long st = starts[i];
  extern __shared__ __align__(16) float agg_s[];

  for (int c = 0; c < dp; c += NG * 128) {
    const int col = c + 4 * lane;
    for (int r = warp; r < ROWS; r += WARPS) {
      float acc[NG][4] = {};
      if (r < rows) {
        add_row<TX, NG>(a + ((long long)i * bh + r_lo + r) * bb, bb, x + st * dp + col, dp,
                        lane, acc);
        TO* arow = agg + (blk * bh + r_lo + r) * dp + col;
#pragma unroll
        for (int g = 0; g < NG; ++g) store4(arow + g * 128, acc[g]);
      }
#pragma unroll
      for (int g = 0; g < NG; ++g)
        *reinterpret_cast<float4*>(agg_s + r * dp + col + g * 128) =
            make_float4(round_as(acc[g][0], w), round_as(acc[g][1], w),
                        round_as(acc[g][2], w), round_as(acc[g][3], w));
    }
  }
  __syncthreads();

  const int half = threadIdx.x >> 7;
  const float* as = agg_s + half * 16 * dp;
  for (int c0 = 0; c0 < hp; c0 += 128) {
    const int c = c0 + (threadIdx.x & 127);
    const bool on = c < hp;
    float o[16] = {};
    for (int k = 0; k < dp; k += 4) {
      float wk[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) wk[q] = on ? to_f32(w[(long long)(k + q) * hp + c]) : 0.f;
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        const float4 av = *reinterpret_cast<const float4*>(as + rr * dp + k);
        o[rr] = fmaf(av.x, wk[0], o[rr]);
        o[rr] = fmaf(av.y, wk[1], o[rr]);
        o[rr] = fmaf(av.z, wk[2], o[rr]);
        o[rr] = fmaf(av.w, wk[3], o[rr]);
      }
    }
    if (on) {
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        const int r = half * 16 + rr;
        if (r < rows) store1(out + (blk * bh + r_lo + r) * hp + c, o[rr]);
      }
    }
  }
}

// fused_kernel where 32 rows of dp columns do not fit in shared memory (dp
// above 1792).  Phase 1 writes the aggregate rows to ``agg`` only; phase 2
// sums out over k in order, as fused_kernel does, from slabs of KS columns
// of those rows re-read from ``agg`` (this block's own writes, visible after
// __syncthreads) and rounded to W's type into agg_s: round_as of the stored
// value equals round_as of the fp32 sum in either output type.  The slabs
// are re-read once per 128 columns of out (hp / 128 times an entry's chunk)
// from L2.  Shared memory: agg_s [ROWS][KS] fp32.
constexpr int KS = 512;

template <typename TX, typename TO, int NG>
__global__ void __launch_bounds__(WARPS * 32)
fused_slab_kernel(const int32_t* __restrict__ starts, const int32_t* __restrict__ sw,
                  const int8_t* __restrict__ a, const TX* __restrict__ x,
                  const TX* __restrict__ w, TO* __restrict__ agg, TO* __restrict__ out, int bh,
                  int bb, int dp, int hp, int nchunk, int num_sw) {
  const int i = blockIdx.x / nchunk;
  const int r_lo = (blockIdx.x % nchunk) * ROWS;
  const long long blk = sw[i];
  if (blk >= num_sw) return;  // capacity padding: nothing to write
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = min(ROWS, bh - r_lo);
  const long long st = starts[i];
  TO* arows = agg + (blk * bh + r_lo) * dp;
  extern __shared__ __align__(16) float agg_s[];

  for (int c = 0; c < dp; c += NG * 128) {
    const int col = c + 4 * lane;
    for (int r = warp; r < rows; r += WARPS) {
      float acc[NG][4] = {};
      add_row<TX, NG>(a + ((long long)i * bh + r_lo + r) * bb, bb, x + st * dp + col, dp, lane,
                      acc);
#pragma unroll
      for (int g = 0; g < NG; ++g) store4(arows + (long long)r * dp + col + g * 128, acc[g]);
    }
  }
  __syncthreads();

  const int half = threadIdx.x >> 7;
  for (int c0 = 0; c0 < hp; c0 += 128) {
    const int c = c0 + (threadIdx.x & 127);
    const bool on = c < hp;
    float o[16] = {};
    for (int k0 = 0; k0 < dp; k0 += KS) {
      const int ks = min(KS, dp - k0);
      __syncthreads();  // the previous slab's readers are done
      for (int e = threadIdx.x; e < ROWS * ks; e += WARPS * 32) {
        const int r = e / ks;
        agg_s[e] = r < rows ? round_as(to_f32(arows[(long long)r * dp + k0 + e % ks]), w) : 0.f;
      }
      __syncthreads();
      const float* as = agg_s + half * 16 * ks;
      for (int k = 0; k < ks; k += 4) {
        float wk[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wk[q] = on ? to_f32(w[(long long)(k0 + k + q) * hp + c]) : 0.f;
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) {
          const float4 av = *reinterpret_cast<const float4*>(as + rr * ks + k);
          o[rr] = fmaf(av.x, wk[0], o[rr]);
          o[rr] = fmaf(av.y, wk[1], o[rr]);
          o[rr] = fmaf(av.z, wk[2], o[rr]);
          o[rr] = fmaf(av.w, wk[3], o[rr]);
        }
      }
    }
    if (on) {
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        const int r = half * 16 + rr;
        if (r < rows) store1(out + (blk * bh + r_lo + r) * hp + c, o[rr]);
      }
    }
  }
}

template <typename TX, typename TO, int NG>
cudaError_t launch_band(const void* starts, const void* sw, const void* a, const void* x,
                        void* out, int sb, int bh, int bb, int dp, int num_sw, int group,
                        cudaStream_t stream) {
  const int nchunk = (bh + ROWS - 1) / ROWS;
  const dim3 grid((unsigned)(sb / group) * nchunk, (unsigned)(dp / (NG * 128)));
  band_kernel<TX, TO, NG><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(sw),
      static_cast<const int8_t*>(a), static_cast<const TX*>(x), static_cast<TO*>(out), bh, bb,
      dp, nchunk, num_sw, group);
  return cudaGetLastError();
}

template <typename TX, typename TO, int NG>
cudaError_t launch_tiled(const void* ptr, const void* tile, const void* a, const void* x,
                         void* out, int num_sw, int bh, int dp, cudaStream_t stream) {
  const int nchunk = (bh + ROWS - 1) / ROWS;
  const dim3 grid((unsigned)num_sw * nchunk, (unsigned)(dp / (NG * 128)));
  tiled_kernel<TX, TO, NG><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const int32_t*>(ptr), static_cast<const int32_t*>(tile),
      static_cast<const int8_t*>(a), static_cast<const TX*>(x), static_cast<TO*>(out), bh, dp,
      nchunk);
  return cudaGetLastError();
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

template <typename TX, typename TO, int NG>
cudaError_t launch_fused(const void* starts, const void* sw, const void* a, const void* x,
                         const void* w, void* agg, void* out, int sb, int bh, int bb, int dp,
                         int hp, int num_sw, cudaStream_t stream) {
  const int nchunk = (bh + ROWS - 1) / ROWS;
  size_t smem = (size_t)ROWS * dp * sizeof(float);
  auto kernel = fused_kernel<TX, TO, NG>;
  if (smem > max_block_smem()) {
    smem = (size_t)ROWS * KS * sizeof(float);
    kernel = fused_slab_kernel<TX, TO, NG>;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)sb * nchunk, WARPS * 32, smem, stream>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(sw),
      static_cast<const int8_t*>(a), static_cast<const TX*>(x), static_cast<const TX*>(w),
      static_cast<TO*>(agg), static_cast<TO*>(out), bh, bb, dp, hp, nchunk, num_sw);
  return cudaGetLastError();
}

// The widest column slab (at most 4 groups of 128, so each lane keeps 16
// fp32 sums) whose group count divides dp / 128; calls F::template
// run<NG>().
template <typename F>
cudaError_t dispatch_ng(int dp, F f) {
  const int groups = dp / 128;
  if (groups % 4 == 0) return f.template run<4>();
  if (groups % 3 == 0) return f.template run<3>();
  if (groups % 2 == 0) return f.template run<2>();
  return f.template run<1>();
}

// The (X, out) type pairs the kernels are built for: fp32 -> fp32,
// bf16 -> bf16 and bf16 -> fp32.  Calls F::template run<TX, TO>().
template <typename F>
cudaError_t dispatch_types(int x_bf16, int out_f32, F f) {
  if (!x_bf16) {
    if (!out_f32) return cudaErrorInvalidValue;
    return f.template run<float, float>();
  }
  if (out_f32) return f.template run<__nv_bfloat16, float>();
  return f.template run<__nv_bfloat16, __nv_bfloat16>();
}

struct BandArgs {
  const void *starts, *sw, *a, *x;
  void* out;
  int sb, bh, bb, dp, num_sw, group;
  cudaStream_t stream;
  template <typename TX, typename TO>
  struct ByNg {
    const BandArgs& b;
    template <int NG>
    cudaError_t run() const {
      return launch_band<TX, TO, NG>(b.starts, b.sw, b.a, b.x, b.out, b.sb, b.bh, b.bb, b.dp,
                                     b.num_sw, b.group, b.stream);
    }
  };
  template <typename TX, typename TO>
  cudaError_t run() const { return dispatch_ng(dp, ByNg<TX, TO>{*this}); }
};

struct TiledArgs {
  const void *ptr, *tile, *a, *x;
  void* out;
  int num_sw, bh, dp;
  cudaStream_t stream;
  template <typename TX, typename TO>
  struct ByNg {
    const TiledArgs& t;
    template <int NG>
    cudaError_t run() const {
      return launch_tiled<TX, TO, NG>(t.ptr, t.tile, t.a, t.x, t.out, t.num_sw, t.bh, t.dp,
                                      t.stream);
    }
  };
  template <typename TX, typename TO>
  cudaError_t run() const { return dispatch_ng(dp, ByNg<TX, TO>{*this}); }
};

struct FusedArgs {
  const void *starts, *sw, *a, *x, *w;
  void *agg, *out;
  int sb, bh, bb, dp, hp, num_sw;
  cudaStream_t stream;
  template <typename TX, typename TO>
  struct ByNg {
    const FusedArgs& f;
    template <int NG>
    cudaError_t run() const {
      return launch_fused<TX, TO, NG>(f.starts, f.sw, f.a, f.x, f.w, f.agg, f.out, f.sb, f.bh,
                                      f.bb, f.dp, f.hp, f.num_sw, f.stream);
    }
  };
  template <typename TX, typename TO>
  cudaError_t run() const { return dispatch_ng(dp, ByNg<TX, TO>{*this}); }
};

}  // namespace

// starts, sw: int32 [sb] (sw may be null: block id = entry index);
// a: int8 [sb, bh, bb]; x: [m, dp] fp32 (x_bf16 == 0) or bf16; out:
// [rows, dp], fp32 when out_f32 != 0, else the type of x.  Entries whose
// block id is >= num_sw write nothing; a thread block owns ``group``
// consecutive entries (sb % group == 0).  Returns a cudaError_t (0 =
// launched).  The caller checks on the host that st + bb <= m for every
// entry, that sw lies in [0, num_sw], and that every output block it reads
// is written by exactly one entry.
extern "C" int hcspmm_band_spmm(const void* starts, const void* sw, const void* a,
                                const void* x, void* out, int sb, int bh, int bb, int dp,
                                int num_sw, int group, int x_bf16, int out_f32, void* stream) {
  if (sb <= 0) return 0;
  if (bh <= 0 || bb <= 0 || bb % 4 || dp <= 0 || dp % 128 || group <= 0 || sb % group ||
      (long long)(sb / group) * ((bh + ROWS - 1) / ROWS) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const BandArgs args{starts, sw, a, x, out, sb, bh, bb, dp, num_sw, group,
                      static_cast<cudaStream_t>(stream)};
  return (int)dispatch_types(x_bf16, out_f32, args);
}

// ptr: int32 [num_sw + 1] pair runs (non-decreasing, ptr[num_sw] = pairs);
// tile: int32 [pairs] 128-row X tile of each pair; a: int8 [pairs, bh, 128];
// x: [m, dp]; out: [num_sw, bh, dp] (types as hcspmm_band_spmm).  The caller
// checks on the host that every tile lies inside x and every run is
// non-empty (an empty superwindow has one zero pair).
extern "C" int hcspmm_tiled_spmm(const void* ptr, const void* tile, const void* a,
                                 const void* x, void* out, int num_sw, int bh, int dp,
                                 int x_bf16, int out_f32, void* stream) {
  if (num_sw <= 0) return 0;
  if (bh <= 0 || dp <= 0 || dp % 128 ||
      (long long)num_sw * ((bh + ROWS - 1) / ROWS) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const TiledArgs args{ptr, tile, a, x, out, num_sw, bh, dp, static_cast<cudaStream_t>(stream)};
  return (int)dispatch_types(x_bf16, out_f32, args);
}

// starts, sw: int32 [sb]; a: int8 [sb, bh, bb]; x: [m, dp]; w: [dp, hp] in
// x's type; agg: [rows, dp] and out: [rows, hp], fp32 when out_f32 != 0,
// else x's type.  Entries with sw >= num_sw write nothing.  fused_kernel
// keeps 128*dp bytes in shared memory (dp <= 1792 on an H100); past what a
// block may use (max_block_smem) fused_slab_kernel runs.  Returns a
// cudaError_t.
extern "C" int hcspmm_band_fused(const void* starts, const void* sw, const void* a,
                                 const void* x, const void* w, void* agg, void* out, int sb,
                                 int bh, int bb, int dp, int hp, int num_sw, int x_bf16,
                                 int out_f32, void* stream) {
  if (sb <= 0) return 0;
  if (bh <= 0 || bb <= 0 || bb % 4 || dp <= 0 || dp % 128 || hp <= 0 ||
      (long long)sb * ((bh + ROWS - 1) / ROWS) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const FusedArgs args{starts, sw, a, x, w, agg, out, sb, bh, bb, dp, hp, num_sw,
                       static_cast<cudaStream_t>(stream)};
  return (int)dispatch_types(x_bf16, out_f32, args);
}
