// Row-layout spill merge for Hopper (sm_90a), bound from Python with ctypes
// (kernels/dstream.py holds the wrappers and the plain PyTorch versions).
//
// Replaces the Pallas kernels hcspmm_tpu/kernels/dstream.py:bstream_merge
// (pallas_call at :283, with its clip-mode take at :263) and dstream_merge
// (:457, take at :434), which differ only in how a slot names its
// destination row.  In place, for every slot e of the chunk stream (128
// slots per chunk c = e / 128):
//
//     out[row(e), :] += xsrc[min(gcols[e], R - 1), :]
//
// block form (bstream): row = blk[c] * span + local[e], sentinel span;
// tile form  (dstream): row = blk[c / G] * span + lt[c] * 128 + local[e],
//                       sentinel 128 (never "row 0 of the next tile");
// span = G * 128.  A sentinel slot is skipped, never multiplied, so a
// non-finite value in its (real) column adds nothing, where the reference's
// one-hot dot would spread 0 * NaN.  The gather happens here, from xsrc
// itself: no [C*128, dp] gathered copy is written and read back (at GH's
// scale, dp 256 fp32, that copy would be about 2.4 GB per SpMM).  A bf16
// xsrc is widened in registers, so the reference's ds_gather_f32 cast
// changes no value here and is not made.
//
// blk does not decrease, so the chunks of one destination block form one
// run [run_start[r], run_start[r+1]), computed on the host at upload.  One
// thread block owns (run r, 32-column slab): it reads the block's slab into
// an fp32 accumulator in shared memory once ([span][32] fp32, 128 KB at
// span 1024; a whole [span, dp] block would not fit), adds every slot of
// the run, and writes the slab once in out's dtype.  Sums are deterministic
// and in slot order: warp w owns the rows with row % NW == w, scans the
// run's slots 64 at a time (two ballots), and adds its own slots in slot
// order, with up to U gathers in flight before their adds.  So each
// (row, column) is updated by one thread in slot order, the order of a
// sequential index_add, and two runs are bitwise equal.  Bytes: every
// touched block read and written once per call, each real slot's row slice
// read once per slab; the slot indices are re-read by each warp from L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLAB = 32;  // output columns per thread block: one per lane
constexpr int NW = 16;    // warps per thread block
constexpr int U = 4;      // gathers a warp issues before it adds them

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Destination row within the block of slot e, or -1 for a sentinel slot.
__device__ __forceinline__ int dest_row(const int32_t* __restrict__ local,
                                        const int32_t* __restrict__ lt, long long e, int span,
                                        bool tile) {
  const int loc = local[e];
  if (tile) return loc < 128 ? lt[e >> 7] * 128 + loc : -1;
  return loc < span ? loc : -1;
}

// Grid: (runs, ceil(dp / SLAB)); block: NW warps.  Dynamic shared memory:
// the accumulator [span][SLAB] fp32.
template <typename TX, typename TO>
__global__ void __launch_bounds__(NW * 32)
merge_kernel(const int32_t* __restrict__ gcols, const int32_t* __restrict__ local,
             const int32_t* __restrict__ blk, const int32_t* __restrict__ lt,
             const int32_t* __restrict__ run_start, const TX* __restrict__ xsrc,
             TO* __restrict__ out, int span, int group, int tile, long long xrows, int dp) {
  extern __shared__ float acc[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = run_start[blockIdx.x];
  const int c1 = run_start[blockIdx.x + 1];
  const long long b = tile ? blk[c0 / group] : blk[c0];
  const int col = blockIdx.y * SLAB + lane;
  const bool live_col = col < dp;
  TO* dst = out + b * span * dp + col;

  for (int r = warp; r < span; r += NW)
    acc[r * SLAB + lane] = live_col ? to_f32(dst[(long long)r * dp]) : 0.f;
  __syncthreads();

  const TX* xcol = xsrc + col;
  // c1 - c0 chunks of 128 slots: every lane takes the same number of steps,
  // so the full-mask warp intrinsics below are well formed
  for (long long e0 = (long long)c0 * 128; e0 < (long long)c1 * 128; e0 += 64) {
    const long long ea = e0 + lane;
    const long long eb = ea + 32;
    const int ra = dest_row(local, lt, ea, span, tile);
    const int rb = dest_row(local, lt, eb, span, tile);
    const bool ma = ra >= 0 && (ra & (NW - 1)) == warp;
    const bool mb = rb >= 0 && (rb & (NW - 1)) == warp;
    unsigned long long mine = (unsigned long long)__ballot_sync(0xffffffffu, ma) |
                              ((unsigned long long)__ballot_sync(0xffffffffu, mb) << 32);
    if (!mine) continue;
    const long long ga = min((long long)(ma ? gcols[ea] : 0), xrows - 1);
    const long long gb = min((long long)(mb ? gcols[eb] : 0), xrows - 1);
    while (mine) {
      int row[U];
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // the next owned slot in slot order (bits 0-31: ea, 32-63: eb)
        const int s = mine ? __ffsll((long long)mine) - 1 : 0;
        const bool have = mine != 0ull;
        mine &= mine - 1;
        const int src = s & 31;
        const int r_a = __shfl_sync(0xffffffffu, ra, src);
        const int r_b = __shfl_sync(0xffffffffu, rb, src);
        const long long g_a = __shfl_sync(0xffffffffu, ga, src);
        const long long g_b = __shfl_sync(0xffffffffu, gb, src);
        row[u] = have ? (s < 32 ? r_a : r_b) : -1;
        const long long g = s < 32 ? g_a : g_b;
        v[u] = (have && live_col) ? to_f32(xcol[g * dp]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (row[u] >= 0) acc[row[u] * SLAB + lane] += v[u];
    }
  }
  __syncthreads();
  if (live_col)
    for (int r = warp; r < span; r += NW) store(dst + (long long)r * dp, acc[r * SLAB + lane]);
}

template <typename TX, typename TO>
cudaError_t launch(const void* gcols, const void* local, const void* blk, const void* lt,
                   const void* run_start, const void* xsrc, void* out, int runs, int span,
                   int group, int tile, long long xrows, int dp, cudaStream_t stream) {
  const size_t smem = (size_t)span * SLAB * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_kernel<TX, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)runs, (unsigned)((dp + SLAB - 1) / SLAB));
  merge_kernel<TX, TO><<<grid, NW * 32, smem, stream>>>(
      static_cast<const int32_t*>(gcols), static_cast<const int32_t*>(local),
      static_cast<const int32_t*>(blk), static_cast<const int32_t*>(lt),
      static_cast<const int32_t*>(run_start), static_cast<const TX*>(xsrc),
      static_cast<TO*>(out), span, group, tile, xrows, dp);
  return cudaGetLastError();
}

}  // namespace

// gcols: int32 [C*128] rows of xsrc (clamped to xrows - 1 here); local: int32,
// slot e's entry at flat index e (block form [>= C, 128], tile form
// [>= C/G, G*128]); blk: int32 nondecreasing, one per chunk (block form) or
// per step of G chunks (tile form); lt: int32 [C] (tile form, else unused);
// run_start: int32 [runs + 1] chunk offsets; xsrc: [xrows, dp]; out:
// [M, dp] with M a multiple of span = group * 128.  x_bf16 / out_bf16 pick
// bfloat16 over fp32 for xsrc / out.  Returns a cudaError_t (0 = launched).
// The caller checks every index on the host before upload.
extern "C" int hcspmm_row_merge(const void* gcols, const void* local, const void* blk,
                                const void* lt, const void* run_start, const void* xsrc,
                                void* out, int runs, int group, int tile, long long xrows,
                                int dp, int x_bf16, int out_bf16, void* stream) {
  if (runs <= 0 || dp <= 0) return 0;
  const int span = group * 128;
  if (group <= 0 || group > 8 || xrows <= 0 || (tile && lt == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && out_bf16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(gcols, local, blk, lt, run_start, xsrc,
                                                     out, runs, span, group, tile, xrows, dp, s);
  if (x_bf16)
    return (int)launch<__nv_bfloat16, float>(gcols, local, blk, lt, run_start, xsrc, out, runs,
                                             span, group, tile, xrows, dp, s);
  if (out_bf16)
    return (int)launch<float, __nv_bfloat16>(gcols, local, blk, lt, run_start, xsrc, out, runs,
                                             span, group, tile, xrows, dp, s);
  return (int)launch<float, float>(gcols, local, blk, lt, run_start, xsrc, out, runs, span,
                                   group, tile, xrows, dp, s);
}
