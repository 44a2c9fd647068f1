// Spill chain of the transposed-band SpMM for Hopper (sm_90a), bound from
// Python with ctypes (kernels/tspill.py holds the wrappers and the plain
// PyTorch versions).  Three kernels, each replacing one Pallas kernel of
// hcspmm_tpu/kernels/tspill.py (the fourth, zero_lane_blocks, is folded into
// csrc/tband.cu's band kernel):
//
// zero_rows_kernel <- zero_row_blocks (:84), the wide layout's zero-fill.  Zero
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
// merge_kernel    <- tbstream_merge (:151), with the gather before it folded
//   in.  In place buf[d, lane(e)] += src[d, idx(e)] for every real slot e,
//   idx(e) = gidx[e] (a column of the mxgather table or of X^T itself,
//   composed on the host at upload) or e (src is the gathered stream).  The
//   slots of a destination block arrive sorted by destination lane and pads
//   only trail the block's last chunk, so each lane's slots are one
//   contiguous range: the host turns local/blk into a segment table at
//   upload (kernels/tspill.py:lane_segments; -1 marks a run of pad slots, and
//   a lane with two segments is refused), and this kernel reads neither
//   local nor blk.  One thread owns (feature row d, segment): it reads
//   buf[d, lane] once, adds the segment's src values in slot order with MU
//   gathers in flight, and writes it once in buf's dtype; a warp holds 32
//   consecutive segments of one row d, so its reads and writes of buf fall
//   on neighbouring lanes.  A segment longer than long_min slots is listed
//   in seg_long and gets a warp per row instead, whose lanes stride its
//   slots and add their fp32 partials in a fixed butterfly order.  No
//   atomics, so two runs are bitwise equal; lanes no slot names are not
//   read.  A pad slot is skipped, never multiplied: a non-finite value in
//   its (real) column adds nothing, where the reference's one-hot dot would
//   spread 0 * NaN.  Bytes: each real slot's dt values of src (scattered
//   4- or 2-byte reads, as the take it replaces made) and index, each
//   touched (row, lane) read and written once: no gathered [dt, C*bw] copy
//   is written and read back.
//
// Scaled forms (the normalised operator D A D X^T, D a diagonal fp32 scale
// over the M lanes that tband_kernel's scaled mode applies to the band part
// of buf already): mxgather_kernel writes each gathered value times the
// scale of its source lane lo[c] + rel, rounded once to xt's type (the
// composed form's X^T D, gathered: bit for bit); zeros stay zero.
// merge_kernel sums a lane's slots from 0 and adds rscale[lane] * sum into
// buf (one fmaf), in short and long segments alike; where it gathers from
// X^T itself (a plan with no T1 table), each slot's value is first
// multiplied by cscale of its column gidx[e] (fmaf into the sum).  Still fp32
// adds in slot order, no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// v times s, rounded to v's type, as bit patterns (fp32, bf16)
__device__ __forceinline__ uint32_t scaled_bits(uint32_t v, float s) {
  return __float_as_uint(__uint_as_float(v) * s);
}
__device__ __forceinline__ uint16_t scaled_bits(uint16_t v, float s) {
  return __bfloat16_as_ushort(__float2bfloat16(__uint_as_float((uint32_t)v << 16) * s));
}

// Grid: (ceil(S / blockDim), ceil(dt / MROWS)), S = cp*k output slots.
// T is the element's bit pattern (uint32_t for fp32, uint16_t for bf16):
// the gather is a copy, and +0.0 is all-zero bits in both types.  SCALED:
// each value times scale[col] (one load a slot), rounded to T's type.
template <typename T, bool SCALED>
__global__ void mxgather_kernel(const T* __restrict__ xt, const int32_t* __restrict__ lo,
                                const int32_t* __restrict__ rel, T* __restrict__ out, int c,
                                int k, long long m, long long slots, int dt,
                                const float* __restrict__ scale) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= slots) return;
  const int ch = (int)(s / k);
  int r = -1;
  long long col = 0;
  if (ch < c) {  // rel is [C, 1, k] contiguous: slot s of chunk ch is rel[s]
    r = rel[s];
    col = (long long)lo[ch] + r;
  }
  const float sc = SCALED && r >= 0 ? __ldg(scale + col) : 1.f;
  const int r0 = blockIdx.y * MROWS;
#pragma unroll
  for (int d = 0; d < MROWS; ++d) {
    if (r0 + d < dt) {
      T v = r >= 0 ? xt[(long long)(r0 + d) * m + col] : T(0);
      if (SCALED && r >= 0) v = scaled_bits(v, sc);
      out[(long long)(r0 + d) * slots + s] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// tbstream_merge
// ---------------------------------------------------------------------------

constexpr int MW = 8;  // feature rows a thread block: one warp each
constexpr int MU = 4;  // slot gathers a thread issues before it adds them

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The fp32 sum of one slot's value: v, or (CSCALE) fmaf(v, cs, acc).
template <bool CSCALE>
__device__ __forceinline__ float add_slot(float acc, float v, float cs) {
  return CSCALE ? fmaf(v, cs, acc) : acc + v;
}

// Grid: x = n_long blocks (one long segment each), then ceil(segs / 32)
// blocks of 32 short segments; y = ceil(dt / MW); warp w owns row
// blockIdx.y * MW + w.  SCALED: a lane's slots summed from 0, then buf +=
// rscale[lane] * sum; CSCALE (SCALED only): each slot's value times
// cscale[its column of src], loaded with it.
template <typename T, bool SCALED, bool CSCALE>
__global__ void __launch_bounds__(MW * 32)
merge_kernel(const T* __restrict__ src, const int32_t* __restrict__ gidx,
             const int32_t* __restrict__ seg_lane, const int32_t* __restrict__ seg_ptr,
             const int32_t* __restrict__ seg_long, T* __restrict__ buf, int segs, int n_long,
             int long_min, long long srcw, long long m, int dt, const float* __restrict__ rscale,
             const float* __restrict__ cscale) {
  static_assert(SCALED || !CSCALE, "a column scale comes with a row scale");
  const int lane = threadIdx.x & 31;
  const long long d = (long long)blockIdx.y * MW + (threadIdx.x >> 5);
  if (d >= dt) return;  // uniform across the warp
  const T* srow = src + d * srcw;

  if ((int)blockIdx.x >= n_long) {
    const long long s = (long long)(blockIdx.x - n_long) * 32 + lane;
    if (s >= segs) return;
    const int l = seg_lane[s];
    const int e0 = seg_ptr[s];
    const int e1 = seg_ptr[s + 1];
    if (l < 0 || e1 - e0 > long_min) return;  // pad run, or a long warp's
    T* p = buf + d * m + l;
    // SCALED: the lane's value and scale load with the first gathers, the
    // sum starts from 0
    const float old = to_f32(*p);
    const float rs = SCALED ? __ldg(rscale + l) : 0.f;
    float acc = SCALED ? 0.f : old;
    for (int e = e0; e < e1; e += MU) {
      float v[MU], cs[MU];
#pragma unroll
      for (int u = 0; u < MU; ++u) {
        const int col = e + u < e1 ? (gidx != nullptr ? gidx[e + u] : e + u) : -1;
        v[u] = col >= 0 ? to_f32(srow[col]) : 0.f;
        cs[u] = CSCALE && col >= 0 ? __ldg(cscale + col) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < MU; ++u)
        if (e + u < e1) acc = add_slot<CSCALE>(acc, v[u], cs[u]);
    }
    store(p, SCALED ? fmaf(acc, rs, old) : acc);
    return;
  }

  const int s = seg_long[blockIdx.x];
  const int e0 = seg_ptr[s];
  const int e1 = seg_ptr[s + 1];
  float part = 0.f;
  for (int e = e0 + lane; e < e1; e += 32 * MU) {
    float v[MU], cs[MU];
#pragma unroll
    for (int u = 0; u < MU; ++u) {
      const int k = e + 32 * u;
      const int col = k < e1 ? (gidx != nullptr ? gidx[k] : k) : -1;
      v[u] = col >= 0 ? to_f32(srow[col]) : 0.f;
      cs[u] = CSCALE && col >= 0 ? __ldg(cscale + col) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < MU; ++u) part = add_slot<CSCALE>(part, v[u], cs[u]);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) {
    const int l = seg_lane[s];
    T* p = buf + d * m + l;
    store(p, SCALED ? fmaf(part, __ldg(rscale + l), to_f32(*p)) : to_f32(*p) + part);
  }
}

template <typename T, bool SCALED, bool CSCALE>
cudaError_t launch_merge(const void* src, const void* gidx, const void* seg_lane,
                         const void* seg_ptr, const void* seg_long, void* buf, int segs,
                         int n_long, int long_min, long long srcw, long long m, int dt,
                         const float* rscale, const float* cscale, cudaStream_t stream) {
  const dim3 grid((unsigned)(n_long + (segs + 31) / 32), (unsigned)((dt + MW - 1) / MW));
  merge_kernel<T, SCALED, CSCALE><<<grid, MW * 32, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const int32_t*>(gidx),
      static_cast<const int32_t*>(seg_lane), static_cast<const int32_t*>(seg_ptr),
      static_cast<const int32_t*>(seg_long), static_cast<T*>(buf), segs, n_long, long_min, srcw,
      m, dt, rscale, cscale);
  return cudaGetLastError();
}

// The merge's three forms: unscaled; scaled (rscale); scaled with column
// scales (rscale and cscale).
template <typename T>
cudaError_t merge_forms(const void* src, const void* gidx, const void* seg_lane,
                        const void* seg_ptr, const void* seg_long, void* buf, int segs,
                        int n_long, int long_min, long long srcw, long long m, int dt,
                        const float* rscale, const float* cscale, cudaStream_t stream) {
  auto run = rscale == nullptr   ? launch_merge<T, false, false>
             : cscale == nullptr ? launch_merge<T, true, false>
                                 : launch_merge<T, true, true>;
  return run(src, gidx, seg_lane, seg_ptr, seg_long, buf, segs, n_long, long_min, srcw, m, dt,
             rscale, cscale, stream);
}

template <typename T>
cudaError_t launch_mxgather(const void* xt, const void* lo, const void* rel, void* out, int c,
                            int k, long long m, long long slots, int dt, const float* scale,
                            dim3 grid, int threads, cudaStream_t s) {
  auto kernel = scale != nullptr ? mxgather_kernel<T, true> : mxgather_kernel<T, false>;
  kernel<<<grid, threads, 0, s>>>(static_cast<const T*>(xt), static_cast<const int32_t*>(lo),
                                  static_cast<const int32_t*>(rel), static_cast<T*>(out), c, k,
                                  m, slots, dt, scale);
  return cudaGetLastError();
}

}  // namespace

// Each entry point returns a cudaError_t (0 = launched).  The callers check
// every index on the host before upload (kernels/tspill.py); the kernels
// read them unchecked.

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
// cp >= c (chunks c..cp-1 are written as zeros).  elem_bytes 4 or 2.  scale
// (may be null): fp32 [m], each gathered value times its source lane's.
extern "C" int hcspmm_mxgather_lanes(const void* xt, const void* lo, const void* rel, void* out,
                                     int c, int cp, int k, int dt, long long m, int elem_bytes,
                                     const void* scale, void* stream) {
  const long long slots = (long long)cp * k;
  if (slots <= 0 || dt <= 0) return 0;
  if (k <= 0 || cp < c || dt > 65535 * MROWS) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((unsigned)((slots + threads - 1) / threads),
                  (unsigned)((dt + MROWS - 1) / MROWS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (elem_bytes == 4)
    return (int)launch_mxgather<uint32_t>(xt, lo, rel, out, c, k, m, slots, dt, sc, grid,
                                          threads, s);
  if (elem_bytes == 2)
    return (int)launch_mxgather<uint16_t>(xt, lo, rel, out, c, k, m, slots, dt, sc, grid,
                                          threads, s);
  return (int)cudaErrorInvalidValue;
}

// src: [dt, srcw]; gidx: int32 slot -> column of src, or null (column =
// slot); seg_lane: int32 [segs] destination lanes of buf (-1: a pad run);
// seg_ptr: int32 [segs + 1] slot offsets; seg_long: int32 [n_long] the
// segments longer than long_min slots; buf: [dt, m], src's dtype (bf16 != 0:
// bfloat16, else fp32).  rscale (may be null: unscaled): fp32 [m], each
// lane's sum times rscale[lane] into buf; cscale (only with rscale; may be
// null): fp32 [srcw], each slot's value times its column's.
extern "C" int hcspmm_tbstream_merge(const void* src, const void* gidx, const void* seg_lane,
                                     const void* seg_ptr, const void* seg_long, void* buf,
                                     int segs, int n_long, int long_min, long long srcw,
                                     long long m, int dt, int bf16, const void* rscale,
                                     const void* cscale, void* stream) {
  if (segs <= 0 || dt <= 0) return 0;
  if (n_long < 0 || long_min < 1 || (dt + MW - 1) / MW > 65535 ||
      (cscale != nullptr && rscale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rs = static_cast<const float*>(rscale);
  const float* cs = static_cast<const float*>(cscale);
  if (bf16)
    return (int)merge_forms<__nv_bfloat16>(src, gidx, seg_lane, seg_ptr, seg_long, buf, segs,
                                           n_long, long_min, srcw, m, dt, rs, cs, s);
  return (int)merge_forms<float>(src, gidx, seg_lane, seg_ptr, seg_long, buf, segs, n_long,
                                 long_min, srcw, m, dt, rs, cs, s);
}
