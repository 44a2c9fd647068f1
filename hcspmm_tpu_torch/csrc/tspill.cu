// Spill chain of the transposed-band SpMM for Hopper (sm_90a), bound from
// Python with ctypes (kernels/tspill.py holds the wrappers and the plain
// PyTorch versions).  Four kernels, each replacing one Pallas kernel of
// hcspmm_tpu/kernels/tspill.py:
//
// zero_kernel     <- zero_lane_blocks (:55).  Zero lanes [ids[i]*w, +w) of
//   every row of buf [dt, M], in place.  One block per (id, 8-row slab),
//   16-byte stores.  Pure writes: 2*dt*w*n_ids*4 bytes at fp32 is well
//   under a microsecond of bandwidth at the real plans, so launch cost binds.
//
// zero_rows_kernel <- zero_row_blocks (:84), the wide layout's twin.  Zero
//   rows [ids[i]*w, +w) of buf [M, dp], in place: the rows of one id are
//   one contiguous w*dp-element range, so a grid over (id, slice) writes it
//   with 16-byte stores.  At GH's wide plan (105 runs of 8 x 256 rows, dp
//   256, fp32) that is 220 MB: about 70 us at 3.35 TB/s.
//
// mxgather_kernel <- mxgather_lanes (:280).  Compact table
//   out[:, c*k+j] = xt[:, lo[c] + rel[c, j]], 0 where rel == -1, in xt's
//   dtype; the output keeps the reference's width ceil(C/4)*4*k with zero
//   tail chunks, because the T2 pieces of the plan slice it at offsets
//   computed for that width.  The TPU kernel streams slab DMAs through a
//   one-hot MXU dot; here one thread owns one output slot and copies it for
//   an 8-row slab of dt: the copy is exact (the reference's one-hot dot
//   passes no precision and rounds fp32 to bf16 only on a TPU).  Reads of
//   one chunk fall in one span-wide window of sorted columns, so a warp's
//   loads hit few sectors; it is bound by those scattered 4-byte reads and
//   the coalesced writes of the table.
//
// merge_kernel    <- tbstream_merge (:151).  In place
//   buf[:, blk[c]*span + local[c, j]] += gathered[:, c*bw + j] for every
//   slot whose local < span (span = group*128; the sentinel span drops the
//   pad slots).  blk does not decrease, so the chunks of one destination
//   block form one run [run_start[r], run_start[r+1]) (computed on the host
//   from blk).  As in the reference, each block is read once into an fp32
//   accumulator, every chunk of its run is added, and it is written once in
//   buf's dtype.  A [dt, span] block does not fit in shared memory (span
//   reaches 4096 lanes: 512 KB at dt 32), so one warp owns one feature row
//   of the block and a thread block holds NW rows, NW * span * 4 <= 64 KB.
//   Sums are deterministic: a warp reads 32 slots at a time; lanes with the
//   same destination find each other with __match_any_sync, and the lowest
//   of them adds the group's values to the accumulator in slot order.  So
//   each (row, lane) of the block is updated by one thread in slot order,
//   the same order as a sequential index_add, and two runs are bitwise
//   equal.  A pad slot is skipped, never multiplied: a non-finite value in
//   its (real) column adds nothing, where the reference's one-hot dot would
//   spread 0 * NaN.  Bytes: the gathered stream is read once and every
//   touched block read and written once; the slot indices are re-read by
//   each of the NW warps from L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// zero_lane_blocks
// ---------------------------------------------------------------------------

constexpr int ZROWS = 8;  // feature rows per thread block

// Grid: (n ids, ceil(dt / ZROWS)).  buf is viewed as 16-byte vectors:
// row_vecs per row, w_vecs per zeroed block.
__global__ void zero_kernel(const int32_t* __restrict__ ids, uint4* __restrict__ buf,
                            long long row_vecs, int w_vecs, int dt) {
  const long long col0 = (long long)ids[blockIdx.x] * w_vecs;
  const int r0 = blockIdx.y * ZROWS;
  const int rows = min(ZROWS, dt - r0);
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int e = threadIdx.x; e < rows * w_vecs; e += blockDim.x) {
    const int r = e / w_vecs;
    buf[(long long)(r0 + r) * row_vecs + col0 + (e - r * w_vecs)] = z;
  }
}

// ---------------------------------------------------------------------------
// zero_row_blocks
// ---------------------------------------------------------------------------

constexpr int ZSLICES = 64;  // thread blocks per id at most

// Grid: (n ids, slices); each id's range is blk_vecs 16-byte vectors.
__global__ void zero_rows_kernel(const int32_t* __restrict__ ids, uint4* __restrict__ buf,
                                 long long blk_vecs) {
  uint4* base = buf + (long long)ids[blockIdx.x] * blk_vecs;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (long long e = (long long)blockIdx.y * blockDim.x + threadIdx.x; e < blk_vecs;
       e += (long long)gridDim.y * blockDim.x)
    base[e] = z;
}

// ---------------------------------------------------------------------------
// mxgather_lanes
// ---------------------------------------------------------------------------

constexpr int MROWS = 8;  // feature rows per thread

// Grid: (ceil(S / blockDim), ceil(dt / MROWS)), S = cp*k output slots.
// T is the element's bit pattern (uint32_t for fp32, uint16_t for bf16):
// the gather is a copy, and +0.0 is all-zero bits in both types.
template <typename T>
__global__ void mxgather_kernel(const T* __restrict__ xt, const int32_t* __restrict__ lo,
                                const int32_t* __restrict__ rel, T* __restrict__ out, int c,
                                int k, long long m, long long slots, int dt) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= slots) return;
  const int ch = (int)(s / k);
  int r = -1;
  long long col = 0;
  if (ch < c) {  // rel is [C, 1, k] contiguous: slot s of chunk ch is rel[s]
    r = rel[s];
    col = (long long)lo[ch] + r;
  }
  const int r0 = blockIdx.y * MROWS;
#pragma unroll
  for (int d = 0; d < MROWS; ++d) {
    if (r0 + d < dt) {
      const T v = r >= 0 ? xt[(long long)(r0 + d) * m + col] : T(0);
      out[(long long)(r0 + d) * slots + s] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// tbstream_merge
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Grid: (runs, dt / NW); block: NW warps, warp w owns feature row
// blockIdx.y*NW + w.  Dynamic shared memory: NW accumulators of span fp32,
// then NW 32-float scratch rows.
template <typename T>
__global__ void __launch_bounds__(512)
merge_kernel(const T* __restrict__ gathered, const int32_t* __restrict__ local,
             const int32_t* __restrict__ blk, const int32_t* __restrict__ run_start,
             T* __restrict__ buf, int span, int bw, long long gw, long long m) {
  extern __shared__ float smem[];
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long d = (long long)blockIdx.y * nw + warp;
  float* acc = smem + warp * span;
  float* scratch = smem + nw * span + warp * 32;
  const int c0 = run_start[blockIdx.x];
  const int c1 = run_start[blockIdx.x + 1];
  T* dst = buf + d * m + (long long)blk[c0] * span;

  for (int l = lane; l < span; l += 32) acc[l] = to_f32(dst[l]);
  __syncwarp();
  const T* g = gathered + d * gw;
  // bw is a multiple of 128, so every lane takes the same number of steps
  // and the full-mask warp intrinsics below are well formed
  for (long long e = (long long)c0 * bw + lane; e < (long long)c1 * bw; e += 32) {
    const int loc = local[e];
    const bool live = loc < span;
    const float v = to_f32(g[e]);
    // dead slots get distinct negative keys, so they never group
    const unsigned peers = __match_any_sync(0xffffffffu, live ? loc : -1 - lane);
    scratch[lane] = v;
    __syncwarp();
    if (live && __ffs(peers) - 1 == lane) {
      float a = acc[loc];
      for (unsigned p = peers; p; p &= p - 1) a += scratch[__ffs(p) - 1];
      acc[loc] = a;
    }
    __syncwarp();
  }
  for (int l = lane; l < span; l += 32) store(dst + l, acc[l]);
}

template <typename T>
cudaError_t launch_merge(const void* gathered, const void* local, const void* blk,
                         const void* run_start, void* buf, int runs, int span, int bw,
                         long long gw, int dt, long long m, int nw, cudaStream_t stream) {
  const size_t smem = (size_t)nw * (span + 32) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  merge_kernel<T><<<dim3((unsigned)runs, (unsigned)(dt / nw)), nw * 32, smem, stream>>>(
      static_cast<const T*>(gathered), static_cast<const int32_t*>(local),
      static_cast<const int32_t*>(blk), static_cast<const int32_t*>(run_start),
      static_cast<T*>(buf), span, bw, gw, m);
  return cudaGetLastError();
}

}  // namespace

// Each entry point returns a cudaError_t (0 = launched).  The callers check
// every index on the host before upload (kernels/tspill.py); the kernels
// read them unchecked.

// buf: [dt, m] of elem_bytes-wide elements; ids: int32 [n]; zeroes lanes
// [ids[i]*w, ids[i]*w + w).  w * elem_bytes and m * elem_bytes must be
// multiples of 16.
extern "C" int hcspmm_zero_lane_blocks(void* buf, const void* ids, int n, int dt, long long m,
                                       int w, int elem_bytes, void* stream) {
  if (n <= 0 || dt <= 0) return 0;
  const long long wb = (long long)w * elem_bytes;
  const long long rb = m * elem_bytes;
  if (w <= 0 || wb % 16 || rb % 16 || dt > 65535 * ZROWS) return (int)cudaErrorInvalidValue;
  zero_kernel<<<dim3((unsigned)n, (unsigned)((dt + ZROWS - 1) / ZROWS)), 256, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<uint4*>(buf), rb / 16, (int)(wb / 16), dt);
  return (int)cudaGetLastError();
}

// buf: [m, dp] of elem_bytes-wide elements; ids: int32 [n]; zeroes rows
// [ids[i]*w, ids[i]*w + w).  w * dp * elem_bytes must be a multiple of 16.
extern "C" int hcspmm_zero_row_blocks(void* buf, const void* ids, int n, long long dp, int w,
                                      int elem_bytes, void* stream) {
  if (n <= 0 || dp <= 0) return 0;
  const long long bytes = (long long)w * dp * elem_bytes;
  if (w <= 0 || bytes % 16) return (int)cudaErrorInvalidValue;
  const long long vecs = bytes / 16;
  const int threads = 256;
  const long long slices = (vecs + threads - 1) / threads;
  zero_rows_kernel<<<dim3((unsigned)n, (unsigned)(slices < ZSLICES ? slices : ZSLICES)),
                     threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<uint4*>(buf), vecs);
  return (int)cudaGetLastError();
}

// xt: [dt, m]; lo: int32 [c]; rel: int32 [c, 1, k]; out: [dt, cp*k] with
// cp >= c (chunks c..cp-1 are written as zeros).  elem_bytes 4 or 2.
extern "C" int hcspmm_mxgather_lanes(const void* xt, const void* lo, const void* rel, void* out,
                                     int c, int cp, int k, int dt, long long m, int elem_bytes,
                                     void* stream) {
  const long long slots = (long long)cp * k;
  if (slots <= 0 || dt <= 0) return 0;
  if (k <= 0 || cp < c || dt > 65535 * MROWS) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((unsigned)((slots + threads - 1) / threads),
                  (unsigned)((dt + MROWS - 1) / MROWS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    mxgather_kernel<uint32_t><<<grid, threads, 0, s>>>(
        static_cast<const uint32_t*>(xt), static_cast<const int32_t*>(lo),
        static_cast<const int32_t*>(rel), static_cast<uint32_t*>(out), c, k, m, slots, dt);
  } else if (elem_bytes == 2) {
    mxgather_kernel<uint16_t><<<grid, threads, 0, s>>>(
        static_cast<const uint16_t*>(xt), static_cast<const int32_t*>(lo),
        static_cast<const int32_t*>(rel), static_cast<uint16_t*>(out), c, k, m, slots, dt);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// gathered: [dt, gw] (gw >= chunks * bw); local: int32 [>= chunks, bw];
// blk: int32 [chunks] nondecreasing; run_start: int32 [runs + 1];
// buf: [dt, m], same dtype as gathered (bf16 != 0: bfloat16, else fp32).
// nw warps per block (a power of two dividing dt); span = group * 128.
extern "C" int hcspmm_tbstream_merge(const void* gathered, const void* local, const void* blk,
                                     const void* run_start, void* buf, int runs, int span,
                                     int bw, long long gw, int dt, long long m, int nw,
                                     int bf16, void* stream) {
  if (runs <= 0 || dt <= 0) return 0;
  if (span <= 0 || span % 128 || bw <= 0 || bw % 128 || nw <= 0 || nw > 16 || dt % nw ||
      dt / nw > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_merge<__nv_bfloat16>(gathered, local, blk, run_start, buf, runs, span,
                                            bw, gw, dt, m, nw, s);
  return (int)launch_merge<float>(gathered, local, blk, run_start, buf, runs, span, bw, gw, dt,
                                  m, nw, s);
}
