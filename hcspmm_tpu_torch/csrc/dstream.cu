// Row-layout spill merge for Hopper (sm_90a), bound from Python with ctypes
// (kernels/dstream.py holds the wrappers and the plain PyTorch versions).
//
// Replaces the Pallas kernels hcspmm_tpu/kernels/dstream.py:bstream_merge
// (pallas_call at :283, with its clip-mode take at :263) and dstream_merge
// (:457, take at :434), which differ only in how a slot names its
// destination row.  In place, for every real slot e of the chunk stream:
//
//     out[row(e), :] += xsrc[min(gcols[e], R - 1), :]
//
// The streams are sorted by destination row and pads only trail a tile's or
// a block's last chunk, so each row's slots are one contiguous range: the
// merge is a CSR row sum.  The host turns local/blk/lt into a destination
// segment table at upload (kernels/dstream.py:row_segments): segment s
// covers slots [seg_ptr[s], seg_ptr[s+1]) of row seg_row[s], or of nothing
// where seg_row[s] is -1 (a run of sentinel slots, never read); the check
// there refuses a row with two segments, so every row has one owner.  This
// kernel reads neither local, blk nor lt.
//
// One group of g lanes (g * 8 columns, 8 per lane: two 16-byte loads of
// fp32, one of bf16) owns a segment's row for one column slab: it reads the
// row of out once, adds each slot's xsrc row in slot order with U gathers in
// flight, and writes the row once in out's dtype.  Rows no slot names are
// never read.  A segment longer than long_min slots (a hub row) is listed in
// seg_long and gets a whole thread block instead: its groups sum contiguous
// pieces of the slots into fp32 partials, which one thread per column adds
// to the row in group order.  Sums are fp32, in a fixed order, with no
// atomics: two runs are bitwise equal.  A sentinel slot is skipped, never
// multiplied, so a non-finite value in its (real) column adds nothing, where
// the reference's one-hot dot would spread 0 * NaN.  A bf16 xsrc is widened
// in registers, so the reference's ds_gather_f32 cast changes no value here.
//
// Scaled form (SCALED; the normalised operator D A D X, D a diagonal scale
// that the band kernel applies to the band part of out already): a
// segment's slots are summed as fmaf(x, cscale[col], sum) from 0, col the
// slot's (clamped) row of xsrc, and the row gets out[row] + rscale[row] *
// sum, one fmaf, in short and long segments alike.
//
// What bounds it: bytes, once enough segments are in flight.  Each touched
// row of out is read and written once, each real slot's xsrc row (dp * elt
// bytes) read once, plus 4 bytes of index a slot and 8 a segment.  The
// gathers are whole-row reads of at least 128 bytes, but each segment is a
// chain of three dependent reads (its table entry, its slot indices, its
// rows), so the launch bounds hold a thread to 64 registers and four blocks
// of 8 warps stay resident on an SM: with one resident block of 16 warps
// (74-82 registers a thread) the merge was bound by latency (PERF.md §6).
// The grid covers segments, so no destination block's run of chunks
// serialises on one SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps a thread block, four resident on an SM
constexpr int VEC = 8;        // columns a lane owns
constexpr int U = 4;          // slot gathers a group issues before it adds them

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// v = the n (<= VEC) values at p widened to fp32, zeros past n; vector mode
// (VECTOR: n == VEC and p 16-byte aligned) with 16-byte loads.
template <bool VECTOR>
__device__ __forceinline__ void load8(const float* p, int n, float (&v)[VEC]) {
  if (VECTOR) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = i < n ? p[i] : 0.f;
  }
}
template <bool VECTOR>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, int n, float (&v)[VEC]) {
  if (VECTOR) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = i < n ? __bfloat162float(p[i]) : 0.f;
  }
}
template <bool VECTOR>
__device__ __forceinline__ void store8(float* p, int n, const float (&v)[VEC]) {
  if (VECTOR) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (i < n) p[i] = v[i];
  }
}
template <bool VECTOR>
__device__ __forceinline__ void store8(__nv_bfloat16* p, int n, const float (&v)[VEC]) {
  if (VECTOR) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (i < n) p[i] = __float2bfloat16(v[i]);
  }
}

// acc += the xsrc rows of slots [e0, e1) at this lane's columns, in slot
// order, U gathers in flight; SCALED, each times its row's cscale (loaded
// with the gathers).
template <bool VECTOR, bool SCALED, typename TX>
__device__ __forceinline__ void add_slots(const int32_t* __restrict__ gcols,
                                          const TX* __restrict__ xcol, long long e0,
                                          long long e1, long long xrows, long long dp, int n,
                                          float (&acc)[VEC], const float* __restrict__ cscale) {
  for (long long e = e0; e < e1; e += U) {
    long long g[U];
#pragma unroll
    for (int u = 0; u < U; ++u) g[u] = e + u < e1 ? min((long long)gcols[e + u], xrows - 1) : -1;
    float v[U][VEC];
    float cs[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (g[u] >= 0) load8<VECTOR>(xcol + g[u] * dp, n, v[u]);
      if (SCALED) cs[u] = g[u] >= 0 ? __ldg(cscale + g[u]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (g[u] >= 0) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          if (SCALED)
            acc[i] = fmaf(v[u][i], cs[u], acc[i]);
          else
            acc[i] += v[u][i];
        }
      }
  }
}

// Grid: x = n_long blocks (one long segment each), then ceil(S / (THREADS /
// g)) blocks of short segments; y = column slab of g * VEC columns.
// Dynamic shared memory (long blocks): THREADS * VEC fp32 partials.
template <bool VECTOR, typename TX, typename TO, bool SCALED>
__global__ void __launch_bounds__(THREADS, 4)
merge_kernel(const int32_t* __restrict__ gcols, const int32_t* __restrict__ seg_row,
             const int32_t* __restrict__ seg_ptr, const int32_t* __restrict__ seg_long,
             const TX* __restrict__ xsrc, TO* __restrict__ out, int segs, int n_long,
             int long_min, int g, long long xrows, int dp, const float* __restrict__ cscale,
             const float* __restrict__ rscale) {
  const int groups = THREADS / g;
  const int q = threadIdx.x / g;
  const int col = blockIdx.y * g * VEC + (threadIdx.x % g) * VEC;
  const int n = min(VEC, dp - col);

  if ((int)blockIdx.x >= n_long) {
    const long long s = (long long)(blockIdx.x - n_long) * groups + q;
    if (s >= segs || n <= 0) return;
    const long long row = seg_row[s];
    const int e0 = seg_ptr[s];
    const int e1 = seg_ptr[s + 1];
    if (row < 0 || e1 - e0 > long_min) return;  // sentinel run, or a long block's
    TO* orow = out + row * dp + col;
    float acc[VEC];
    if (SCALED) {
      // the slots' sum first, then the row (read after it: fewer registers live)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
      add_slots<VECTOR, SCALED>(gcols, xsrc + col, e0, e1, xrows, dp, n, acc, cscale);
      const float rs = __ldg(rscale + row);
      float o[VEC];
      load8<VECTOR>(orow, n, o);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(acc[i], rs, o[i]);
    } else {
      load8<VECTOR>(orow, n, acc);
      add_slots<VECTOR, SCALED>(gcols, xsrc + col, e0, e1, xrows, dp, n, acc, cscale);
    }
    store8<VECTOR>(orow, n, acc);
    return;
  }

  // a long segment: group q sums its contiguous piece of the slots
  extern __shared__ float part[];  // [groups][g * VEC]
  const int s = seg_long[blockIdx.x];
  const long long row = seg_row[s];
  const long long e0 = seg_ptr[s];
  const long long len = seg_ptr[s + 1] - e0;
  float acc[VEC] = {};
  if (n > 0)
    add_slots<VECTOR, SCALED>(gcols, xsrc + col, e0 + len * q / groups,
                              e0 + len * (q + 1) / groups, xrows, dp, n, acc, cscale);
  const int slab = g * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) part[q * slab + (threadIdx.x % g) * VEC + i] = acc[i];
  __syncthreads();
  const int c = blockIdx.y * slab + threadIdx.x;
  if (threadIdx.x < slab && c < dp) {
    TO* o = out + row * dp + c;
    float a = to_f32(*o);
    if (SCALED) {
      float sum = 0.f;
      for (int p = 0; p < groups; ++p) sum += part[p * slab + threadIdx.x];
      a = fmaf(sum, __ldg(rscale + row), a);
    } else {
      for (int p = 0; p < groups; ++p) a += part[p * slab + threadIdx.x];
    }
    store1(o, a);
  }
}

template <bool VECTOR, typename TX, typename TO, bool SCALED>
cudaError_t launch(const void* gcols, const void* seg_row, const void* seg_ptr,
                   const void* seg_long, const void* xsrc, void* out, int segs, int n_long,
                   int long_min, long long xrows, int dp, const float* cscale,
                   const float* rscale, cudaStream_t stream) {
  int g = 1;  // lanes a segment: the fewest whose VEC columns each cover dp, at most 32
  while (g < 32 && g * VEC < dp) g *= 2;
  const int groups = THREADS / g;
  const dim3 grid((unsigned)(n_long + (segs + groups - 1) / groups),
                  (unsigned)((dp + g * VEC - 1) / (g * VEC)));
  const size_t smem = n_long ? (size_t)THREADS * VEC * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_kernel<VECTOR, TX, TO, SCALED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  merge_kernel<VECTOR, TX, TO, SCALED><<<grid, THREADS, smem, stream>>>(
      static_cast<const int32_t*>(gcols), static_cast<const int32_t*>(seg_row),
      static_cast<const int32_t*>(seg_ptr), static_cast<const int32_t*>(seg_long),
      static_cast<const TX*>(xsrc), static_cast<TO*>(out), segs, n_long, long_min, g, xrows,
      dp, cscale, rscale);
  return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t dispatch(int vector, const void* gcols, const void* seg_row, const void* seg_ptr,
                     const void* seg_long, const void* xsrc, void* out, int segs, int n_long,
                     int long_min, long long xrows, int dp, const float* cscale,
                     const float* rscale, cudaStream_t stream) {
  auto run = rscale != nullptr
                 ? (vector ? launch<true, TX, TO, true> : launch<false, TX, TO, true>)
                 : (vector ? launch<true, TX, TO, false> : launch<false, TX, TO, false>);
  return run(gcols, seg_row, seg_ptr, seg_long, xsrc, out, segs, n_long, long_min, xrows, dp,
             cscale, rscale, stream);
}

}  // namespace

// gcols: int32 slot indices into xsrc (clamped to xrows - 1 here); seg_row:
// int32 [segs] destination rows of out (-1: a sentinel run); seg_ptr: int32
// [segs + 1] slot offsets into gcols; seg_long: int32 [n_long] the segments
// longer than long_min slots; xsrc: [xrows, dp]; out: [rows, dp].  x_bf16 /
// out_bf16 pick bfloat16 over fp32 for xsrc / out; vector != 0 promises dp
// % 8 == 0 and 16-byte aligned xsrc and out.  cscale and rscale, both or
// neither (null: the unscaled kernel): fp32 [xrows], a scale for each row
// of xsrc, and fp32, one for each row of out; they take the scaled form
// above.  Returns a cudaError_t (0 =
// launched).  The caller checks every index on the host before upload.
extern "C" int hcspmm_row_merge(const void* gcols, const void* seg_row, const void* seg_ptr,
                                const void* seg_long, const void* xsrc, void* out, int segs,
                                int n_long, int long_min, long long xrows, int dp, int x_bf16,
                                int out_bf16, int vector, const void* cscale, const void* rscale,
                                void* stream) {
  if (segs <= 0 || dp <= 0) return 0;
  if (xrows <= 0 || n_long < 0 || long_min < 1 || (vector && dp % VEC) ||
      (cscale == nullptr) != (rscale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cs = static_cast<const float*>(cscale);
  const float* rs = static_cast<const float*>(rscale);
  if (x_bf16 && out_bf16)
    return (int)dispatch<__nv_bfloat16, __nv_bfloat16>(vector, gcols, seg_row, seg_ptr, seg_long,
                                                       xsrc, out, segs, n_long, long_min, xrows,
                                                       dp, cs, rs, s);
  if (x_bf16)
    return (int)dispatch<__nv_bfloat16, float>(vector, gcols, seg_row, seg_ptr, seg_long, xsrc,
                                               out, segs, n_long, long_min, xrows, dp, cs, rs, s);
  if (out_bf16)
    return (int)dispatch<float, __nv_bfloat16>(vector, gcols, seg_row, seg_ptr, seg_long, xsrc,
                                               out, segs, n_long, long_min, xrows, dp, cs, rs, s);
  return (int)dispatch<float, float>(vector, gcols, seg_row, seg_ptr, seg_long, xsrc, out, segs,
                                     n_long, long_min, xrows, dp, cs, rs, s);
}
