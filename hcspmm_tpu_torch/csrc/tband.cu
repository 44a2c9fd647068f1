// Transposed-band SpMM for Hopper (sm_90a), bound from Python with ctypes.
//
// tband_kernel replaces the Pallas kernels
// hcspmm_tpu/kernels/tband.py:tband_spmm_direct (pallas_call at :217) and
// :tband_spmm_bucket (:246), pack=1; tband_fused_kernel and, for shapes whose
// staging does not fit in shared memory, tband_fused_slab_kernel (below)
// replace :tband_fused_direct (:309).  For entry i and a DT-row slab of the
// features, tband_kernel computes
//
//     Y^T[d0:d0+DT, c_i*bh : c_i*bh+bh] = X^T[d0:d0+DT, st[i] : st[i]+W] @ A_t[i]
//
// with A_t[i] an int8 0/1 block [W, bh] and c_i = sw[i] (direct mode, the
// superwindow's own output columns) or c_i = i (bucket mode, fp32 output in
// bucket order that the caller scatters).  Sums run in fp32 on the CUDA
// cores: no tensor cores and no TF32, the counterpart of the reference's
// Precision.HIGHEST (tband.py:166-168).  bf16 inputs are widened exactly;
// outputs are rounded to nearest.
//
// The direct mode also takes over hcspmm_tpu/kernels/tspill.py:zero_lane_blocks
// (pallas_call at :75), which the reference runs after it: the blocks of the
// superwindows no entry owns (runs of eight, then singles) are zero items of
// the same launch, written by the consumers before their first stage lands,
// with no copy and no stage.  At DD's plan that is 14 x [32, 2048] and 10 x
// [32, 256] fp32 values, 4 MB: about a microsecond of the card's bandwidth,
// where the two launches it replaces cost about 0.03 ms each.
//
// Departures from the Pallas kernel: a direct-mode entry with
// sw[i] == num_sw (capacity padding, format/plan.py) writes nothing, so no
// trash block is allocated and none is sliced off.  Only rows of A_t that
// hold a non-zero in a warp's 32 columns are visited, and a thread adds x
// only where its own A_t byte is non-zero, so an absent edge adds nothing
// even where x is not finite (as in a CSR product), where the Pallas
// kernel's dense dot would spread a NaN over the superwindow.
//
// What bounds it, and the design.  At the DD-scale blocks stand-in (Sb 1312,
// W 768, bh 256, dt 32, fp32) one apply must read 258 MB of A_t (the int8
// block whole: the tband_pack=1 contract) and 43 MB of X^T and write 43 MB:
// 0.103 ms at 3.35 TB/s.  The useful arithmetic is 2*nnz*dt = 0.1 GFLOP.
// The port's first kernel staged each 64-row
// step synchronously between two __syncthreads(), its transposing store of
// X^T hitting one shared-memory bank 32 times over, and voted on every row:
// 0.409 ms.
// This one is persistent (two blocks an SM walk the (entry, feature slab)
// items, slab fastest) with warp roles:
//   - one producer lane keeps a ring of S stages (2-6, as many as leave two
//     blocks an SM in shared memory: 3 at bh 256, dt 32, fp32) filled by the
//     Tensor Memory Accelerator: per stage, bh/CW tensor copies of the
//     64-row A_t slab (CW = 128, 64 or 32 columns a box, swizzled to match)
//     and 64*elt/128 of the X^T slab [DT][64] (128-byte swizzle),
//     completion counted in bytes on the stage's "full" mbarrier.  It
//     reissues a stage as soon as the consumers' "empty" mbarrier says they
//     are done with it, so the next entry's slabs load while this entry's
//     sums are stored.  No __syncthreads() after the start;
//   - bh/COLS consumer warps; warp w owns output columns [COLS w, COLS w +
//     COLS), COLS 16 up to bh 256 (else 32).  Per stage it builds a 64-bit
//     mask of the rows in which any of its columns is non-zero (lane l
//     loads rows l and l+32, 16 bytes at a time, then two ballots; the
//     swizzle spreads the lanes over all banks) and walks the set bits in
//     increasing k.  For row k, lane l < COLS reads column COLS w + l's byte
//     (one ballot gives the row's non-zero columns), lane l reads feature
//     row d0+l's x straight from the landed X^T box, and for each non-zero
//     column c the lanes add x into the warp's sums [c][d0+l], kept in
//     shared memory (stride DT+1: conflict-free by feature and, for the
//     coalesced store at the entry's end, by column).  The next row's two
//     loads go out before this row's sums.
// Each output element is summed over its non-zero rows in increasing k with
// fmaf, as the first kernel and tband_fused_kernel do, so the fp32 result
// is theirs bit for bit, and repeatable.
// What bounds it now is the consumers, beside copies that run near the
// bytes bound: their work is uneven (the graph's diagonal blocks cross
// some warps' columns and miss others'), and a warp may run at most S-1
// stages ahead of the slowest.  Warps of 16 columns halve each warp's rows
// and double the warps that hide the loads' latency: on an H100 80GB HBM3
// at 700 W (chip_smoke.py, two calls) the blocks stand-in took 0.197 ms in
// fp32 against 0.219 with 32 columns a warp.
// Tried on the way and slower: row-by-row bulk copies of A_t (96 requests a
// stage: the copy engine's cost per request bound it even with the sums
// switched off); the producer transposing X^T to [64][DT] for one thread
// per column (the DT/4 broadcast loads a visited row saturate shared
// memory; reading the landed [DT][64] slab with one broadcast load per
// feature instead was slower still); the sums in registers behind a jump
// table; one block an SM with 6 stages, or three with 2; updating two
// columns at a time; a ring capped at 2 stages.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int KT = 64;  // contraction rows of A_t and X^T staged per step
constexpr int MAX_BH = 512;
constexpr int MAX_STAGES = 6;
constexpr int BAR_BYTES = 128;     // the ring's mbarriers
constexpr int SWIZZLE_ATOM = 1024;  // a swizzled tensor copy's destination alignment
static_assert(2 * MAX_STAGES * 8 <= BAR_BYTES, "the mbarriers outgrow BAR_BYTES");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Byte offset ``o`` of a box row-major in shared memory, as a copy with the
// 32-, 64- or 128-byte swizzle (``mask`` 1, 3 or 7: its 16-byte chunks a
// row, less one) places it: the chunk index is XORed with the 128-byte
// line's index within the 1024-byte atom.
__device__ __forceinline__ int swz(int o, int mask) { return o ^ (((o >> 7) & mask) << 4); }

__device__ __forceinline__ uint4 lds128(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The (entry, feature slab) items of one thread block, slab fastest: items
// blockIdx.x, blockIdx.x + gridDim.x, ..., those of capacity-padding
// entries (sw >= num_sw) skipped; each item is W/KT steps.  The producer and
// the consumers walk the same sequence.
struct Items {
  int item, nitems, nchunk, nsteps, step, num_sw;
  const int32_t* sw;

  __device__ Items(int nitems_, int nchunk_, int nsteps_, const int32_t* sw_, int num_sw_)
      : item(blockIdx.x), nitems(nitems_), nchunk(nchunk_), nsteps(nsteps_), step(0),
        num_sw(num_sw_), sw(sw_) {
    skip();
  }
  __device__ void skip() {
    while (item < nitems && sw != nullptr && sw[item / nchunk] >= num_sw) item += gridDim.x;
  }
  __device__ bool valid() const { return item < nitems; }
  __device__ int entry() const { return item / nchunk; }
  __device__ int d0(int dt_slab) const { return (item % nchunk) * dt_slab; }
  __device__ bool last_step() const { return step == nsteps - 1; }
  __device__ void next() {
    if (++step == nsteps) {
      step = 0;
      item += gridDim.x;
      skip();
    }
  }
};

// Shared memory of one block, from the first 1024-aligned address of the
// dynamic window (SWIZZLE_ATOM bytes are reserved for that): ``stages`` ring
// stages, each the A_t slab as bh/CW boxes [KT][CW] int8 and the X^T slab as
// KT/XW boxes [DT][XW] of TX (XW = 128 bytes of TX), all as the tensor
// copies land them; then each consumer warp's sums, [32 columns][DT + 1]
// fp32 (the pad word makes both the by-feature updates and the by-column
// stores conflict-free); then BAR_BYTES of mbarriers.
template <typename TX, int DT>
struct Layout {
  static constexpr int XW = 128 / (int)sizeof(TX);
  static constexpr int ACC_STRIDE = DT + 1;
  static __host__ __device__ int stage_bytes(int bh) {
    return KT * bh + KT * DT * (int)sizeof(TX);
  }
  static __host__ __device__ int acc_bytes(int bh) { return bh * ACC_STRIDE * (int)sizeof(float); }
  static __host__ __device__ size_t smem(int bh, int stages) {
    return SWIZZLE_ATOM + (size_t)stages * stage_bytes(bh) + acc_bytes(bh) + BAR_BYTES;
  }
};

// Grid: persistent, a few blocks an SM (launch_config).  Block: bh/COLS
// consumer warps and a producer warp, whose first lane produces.  Consumer
// warp w owns output columns [COLS w, COLS w + COLS) (COLS 16 up to bh 256,
// twice the warps to share a stage's uneven rows; else 32): for A_t reads
// lane l < COLS stands for column COLS w + l, for X^T reads and sums lane l
// stands for feature row d0 + l.
// ``amap``: A_t as [Sb*W rows, bh] int8, box [KT][cw]; ``xmap``: X^T as
// [dt rows, M] of TX, box [DT][XW], 128-byte swizzle.
// Direct mode only: ``miss8`` (n8 ids, runs of eight superwindows) and
// ``miss1`` (n1 ids) name the superwindows no entry owns.  Their blocks are
// zero items, (superwindow, feature slab) pairs the consumers of block b
// write first (items b, b + gridDim.x, ...), while the producer fills the
// ring: each warp stores zeros over rows of [DT][bh], 16 bytes a lane.  They
// take no copy and no stage.
template <typename TX, typename TO, int DT, int COLS>
__global__ void __launch_bounds__(MAX_BH + 32)
tband_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap xmap,
             const int32_t* __restrict__ starts, const int32_t* __restrict__ sw,
             const int32_t* __restrict__ miss8, int n8, const int32_t* __restrict__ miss1,
             int n1, TO* __restrict__ out, int sb, int w, int bh, int cw, int nchunk,
             long long out_cols, int num_sw, int stages) {
  using L = Layout<TX, DT>;
  constexpr int XW = L::XW;
  extern __shared__ __align__(16) unsigned char tband_smem[];
  unsigned char* ring =
      tband_smem + ((SWIZZLE_ATOM - smem_addr(tband_smem) % SWIZZLE_ATOM) % SWIZZLE_ATOM);
  const int stage_bytes = L::stage_bytes(bh);
  float* sums = reinterpret_cast<float*>(ring + stages * stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage_bytes + L::acc_bytes(bh));
  uint64_t* empty = full + MAX_STAGES;  // [stages]: consumers done with the stage
  const int nwarps = bh / COLS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], nwarps);
    }
    bar_init_fence();
  }
  __syncthreads();  // the only block-wide barrier: the mbarriers exist

  const int nsteps = w / KT;
  if (warp == nwarps) {
    // ---- producer: one lane issues every copy ----
    if (lane != 0) return;
    Items it(sb * nchunk, nchunk, nsteps, sw, num_sw);
    for (int t = 0; it.valid(); ++t) {
      const int slot = t % stages;
      // step t reuses the stage of step t - stages
      if (t >= stages) bar_wait(&empty[slot], (t / stages - 1) & 1);
      fence_proxy_async();
      unsigned char* a_dst = ring + slot * stage_bytes;
      unsigned char* x_dst = a_dst + KT * bh;
      const int i = it.entry(), k0 = it.step * KT, x0 = starts[i] + k0;
      bar_arrive_expect(&full[slot], stage_bytes);
      for (int c = 0; c < bh; c += cw) tensor_load(a_dst + KT * c, &amap, c, i * w + k0, &full[slot]);
      for (int h = 0; h < KT / XW; ++h)
        tensor_load(x_dst + h * DT * 128, &xmap, x0 + h * XW, it.d0(DT), &full[slot]);
      it.next();
    }
    return;
  }

  // ---- consumer warps: the zero items, then the band ----
  const int nzero = (8 * n8 + n1) * nchunk;
  const int vecs = bh * (int)sizeof(TO) / 16;  // 16-byte stores a row of a block
  for (int z = blockIdx.x; z < nzero; z += gridDim.x) {
    const int j = z / nchunk, d0 = z % nchunk * DT;
    const long long s = j < 8 * n8 ? 8LL * miss8[j / 8] + j % 8 : (long long)miss1[j - 8 * n8];
    for (int d = warp; d < DT; d += nwarps) {
      uint4* row = reinterpret_cast<uint4*>(out + (d0 + d) * out_cols + s * bh);
      for (int v = lane; v < vecs; v += 32) row[v] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  Items it(sb * nchunk, nchunk, nsteps, sw, num_sw);
  const int amask = cw / 16 - 1;
  // this warp's columns lie in one A_t box, at byte c0 of its rows
  const int box = warp * COLS / cw * KT * cw, c0 = warp * COLS % cw;
  const int xrow = lane * 128;  // feature row ``lane`` in an X^T box, before the swizzle
  float* acc = sums + warp * COLS * L::ACC_STRIDE;  // [column][feature]
  for (int c = 0; c < COLS; ++c)
    if (lane < DT) acc[c * L::ACC_STRIDE + lane] = 0.f;
  for (int t = 0; it.valid(); ++t) {
    const int slot = t % stages;
    bar_wait(&full[slot], (t / stages) & 1);
    const unsigned char* a_s = ring + slot * stage_bytes + box;
    const unsigned char* x_s = ring + slot * stage_bytes + KT * bh;
    // rows of this stage in which any of the warp's columns is non-zero
    unsigned any_lo = 0u, any_hi = 0u;
#pragma unroll
    for (int h = 0; h < COLS; h += 16) {
      const uint4 p = lds128(a_s + swz(lane * cw + c0 + h, amask));
      const uint4 r = lds128(a_s + swz((lane + 32) * cw + c0 + h, amask));
      any_lo |= p.x | p.y | p.z | p.w;
      any_hi |= r.x | r.y | r.z | r.w;
    }
    const unsigned lo = __ballot_sync(0xffffffffu, any_lo != 0u);
    const unsigned hi = __ballot_sync(0xffffffffu, any_hi != 0u);
    unsigned long long rows = lo | (unsigned long long)hi << 32;
    // column COLS w + lane's byte of row k, and feature row ``lane``'s x of it
    auto byte_of = [&](int k) {
      return lane < COLS ? (int)static_cast<int8_t>(a_s[swz(k * cw + c0 + lane, amask)]) : 0;
    };
    auto x_of = [&](int k) {
      return lane < DT ? to_f32(*reinterpret_cast<const TX*>(
                             x_s + k / XW * DT * 128 + swz(xrow + k % XW * (int)sizeof(TX), 7)))
                       : 0.f;
    };
    if (rows) {
      int k = __ffsll((long long)rows) - 1;
      int av = byte_of(k);
      float x = x_of(k);
      for (;;) {
        rows &= rows - 1;
        // the next row's two loads go out before this row's sums
        int av_next = 0;
        float x_next = 0.f;
        if (rows) {
          k = __ffsll((long long)rows) - 1;
          av_next = byte_of(k);
          x_next = x_of(k);
        }
        // the row's non-zero columns, in increasing order
        for (unsigned cols = __ballot_sync(0xffffffffu, av != 0); cols; cols &= cols - 1) {
          const int c = __ffs(cols) - 1;
          const float a = static_cast<float>(__shfl_sync(0xffffffffu, av, c));
          if (lane < DT) {
            float* s_cd = acc + c * L::ACC_STRIDE + lane;
            *s_cd = fmaf(x, a, *s_cd);
          }
        }
        if (!rows) break;
        av = av_next;
        x = x_next;
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[slot]);
    if (it.last_step()) {
      // column COLS w + lane's sums, one feature row a store
      const int i = it.entry(), d0 = it.d0(DT);
      TO* o = out + (long long)(sw != nullptr ? sw[i] : i) * bh + warp * COLS + lane;
      if (lane < COLS) {
#pragma unroll 4
        for (int d = 0; d < DT; ++d) {
          store(o + (long long)(d0 + d) * out_cols, acc[lane * L::ACC_STRIDE + d]);
          acc[lane * L::ACC_STRIDE + d] = 0.f;
        }
      }
      __syncwarp();
    }
    it.next();
  }
}

// Consumer columns a warp at band height bh (tband_kernel's COLS).
constexpr int cols_of(int bh) { return bh <= 256 ? 16 : 32; }

// Stages, shared memory and resident blocks an SM of tband_kernel<TX, TO,
// DT, cols_of(bh)> at band height bh on the current device: as many stages
// (2..MAX_STAGES) as leave two blocks an SM in shared memory.  Kept per
// instantiation, band height and device, so a launch queries nothing.
struct Config {
  int dev = -1, stages = 0, blocks_per_sm = 0, sms = 0;
  size_t smem = 0;
};

template <typename TX, typename TO, int DT, int COLS>
cudaError_t launch_config(int bh, Config* cfg) {
  using L = Layout<TX, DT>;
  static Config cache[MAX_BH / 32 + 1];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  Config& c = cache[bh / 32];
  if (c.dev == dev) {
    *cfg = c;
    return cudaSuccess;
  }
  int per_sm = 0, reserved = 0, optin = 0, sms = 0, blocks = 0;
  e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long fit = ((long long)per_sm / 2 - reserved - (long long)L::smem(bh, 0)) /
                        L::stage_bytes(bh);
  const int stages = (int)(fit < 2 ? 2 : fit > MAX_STAGES ? MAX_STAGES : fit);
  const size_t smem = L::smem(bh, stages);
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  auto kernel = tband_kernel<TX, TO, DT, COLS>;
  // the cap is the kernel's, not this band height's: let it take any
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, bh / COLS * 32 + 32,
                                                      smem);
  if (e != cudaSuccess) return e;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  c.stages = stages;
  c.smem = smem;
  c.blocks_per_sm = blocks;
  c.sms = sms;
  c.dev = dev;  // last: the entry is complete
  *cfg = c;
  return cudaSuccess;
}

// The superwindows a direct launch zeroes (tband_kernel's zero items).
struct Missing {
  const int32_t *ids8, *ids1;
  int n8, n1;
};

template <typename TX, typename TO, int DT, int COLS>
cudaError_t launch_cols(const void* starts, const void* sw, const void* at, const void* xt,
                        void* out, int sb, int w, int bh, int dt, long long m,
                        long long out_cols, int num_sw, Missing miss, cudaStream_t stream) {
  Config c;
  cudaError_t e = launch_config<TX, TO, DT, COLS>(bh, &c);
  if (e != cudaSuccess) return e;
  const int cw = bh % 128 == 0 ? 128 : bh % 64 == 0 ? 64 : 32;
  const CUtensorMapSwizzle aswz = cw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : cw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUtensorMapDataType xtype =
      sizeof(TX) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap amap = {}, xmap = {};  // no entry (only zero items): no copy reads them
  if (sb > 0 &&
      (!encode_2d(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, at, (long long)sb * w, bh, KT, cw,
                  aswz) ||
       !encode_2d(&xmap, xtype, (int)sizeof(TX), xt, dt, m, DT, Layout<TX, DT>::XW,
                  CU_TENSOR_MAP_SWIZZLE_128B)))
    return cudaErrorInvalidValue;
  const int nchunk = dt / DT;
  const long long items = ((long long)sb + 8LL * miss.n8 + miss.n1) * nchunk;
  const long long slots = (long long)c.blocks_per_sm * c.sms;
  tband_kernel<TX, TO, DT, COLS>
      <<<(unsigned)(items < slots ? items : slots), bh / COLS * 32 + 32, c.smem, stream>>>(
          amap, xmap, static_cast<const int32_t*>(starts), static_cast<const int32_t*>(sw),
          miss.ids8, miss.n8, miss.ids1, miss.n1, static_cast<TO*>(out), sb, w, bh, cw, nchunk,
          out_cols, num_sw, c.stages);
  return cudaGetLastError();
}

template <typename TX, typename TO, int DT>
cudaError_t launch(const void* starts, const void* sw, const void* at, const void* xt,
                   void* out, int sb, int w, int bh, int dt, long long m,
                   long long out_cols, int num_sw, Missing miss, cudaStream_t stream) {
  if (cols_of(bh) == 16)
    return launch_cols<TX, TO, DT, 16>(starts, sw, at, xt, out, sb, w, bh, dt, m, out_cols,
                                       num_sw, miss, stream);
  return launch_cols<TX, TO, DT, 32>(starts, sw, at, xt, out, sb, w, bh, dt, m, out_cols,
                                     num_sw, miss, stream);
}

template <typename TX, typename TO, int DT>
cudaError_t config_of(int bh, Config* c) {
  return cols_of(bh) == 16 ? launch_config<TX, TO, DT, 16>(bh, c)
                           : launch_config<TX, TO, DT, 32>(bh, c);
}

template <typename TX, typename TO>
cudaError_t dispatch_dt(const void* starts, const void* sw, const void* at, const void* xt,
                        void* out, int sb, int w, int bh, int dt, long long m,
                        long long out_cols, int num_sw, Missing miss, cudaStream_t stream) {
  if (dt % 32 == 0)
    return launch<TX, TO, 32>(starts, sw, at, xt, out, sb, w, bh, dt, m, out_cols, num_sw, miss,
                              stream);
  return launch<TX, TO, 16>(starts, sw, at, xt, out, sb, w, bh, dt, m, out_cols, num_sw, miss,
                            stream);
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
// out_f32 != 0, else the type of xt.  Direct mode also zeroes the blocks of
// the missing superwindows: columns [8*bh*miss8[i], +8*bh) and [bh*miss1[i],
// +bh) of every row (miss8: int32 [n8], miss1: int32 [n1]; null when empty).
// Returns a cudaError_t (0 = launched).  The caller guarantees st + w <= m for
// every entry, that every output block it reads is written by exactly one
// entry or missing id, and that the ids lie inside out.
extern "C" int hcspmm_tband_spmm(const void* starts, const void* sw, const void* at,
                                 const void* xt, void* out, int sb, int w, int bh, int dt,
                                 long long m, long long out_cols, int num_sw, const void* miss8,
                                 int n8, const void* miss1, int n1, int x_bf16, int out_f32,
                                 void* stream) {
  if (sb <= 0 && n8 <= 0 && n1 <= 0) return 0;
  if (sb < 0 || n8 < 0 || n1 < 0 || dt <= 0 || dt % 16 || w <= 0 || w % KT || bh <= 0 ||
      bh % 32 || bh > MAX_BH || ((n8 || n1) && sw == nullptr))
    return (int)cudaErrorInvalidValue;
  // the bulk copies need 16-byte aligned sources: A_t rows (bh % 32 == 0)
  // and X^T pieces (st % 128 == 0, checked at upload) then are; the zero
  // items store 16 bytes a lane
  if ((uintptr_t)at % 16 || (uintptr_t)xt % 16 || m * (x_bf16 ? 2 : 4) % 16 ||
      (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  const Missing miss{static_cast<const int32_t*>(miss8), static_cast<const int32_t*>(miss1), n8,
                     n1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_bf16) {
    if (!out_f32) return (int)cudaErrorInvalidValue;
    return (int)dispatch_dt<float, float>(starts, sw, at, xt, out, sb, w, bh, dt, m, out_cols,
                                          num_sw, miss, s);
  }
  if (out_f32)
    return (int)dispatch_dt<__nv_bfloat16, float>(starts, sw, at, xt, out, sb, w, bh, dt, m,
                                                  out_cols, num_sw, miss, s);
  return (int)dispatch_dt<__nv_bfloat16, __nv_bfloat16>(starts, sw, at, xt, out, sb, w, bh, dt,
                                                        m, out_cols, num_sw, miss, s);
}

// The band kernel's launch configuration at band height bh, feature dim dt
// and the given types on the current device: ring stages, dynamic shared
// memory bytes and resident blocks an SM.  Returns a cudaError_t.
extern "C" int hcspmm_tband_config(int bh, int dt, int x_bf16, int out_f32, int* stages,
                                   long long* smem, int* blocks_per_sm) {
  if (dt <= 0 || dt % 16 || bh <= 0 || bh % 32 || bh > MAX_BH || (!x_bf16 && !out_f32))
    return (int)cudaErrorInvalidValue;
  Config c;
  cudaError_t e;
  if (!x_bf16)
    e = dt % 32 ? config_of<float, float, 16>(bh, &c) : config_of<float, float, 32>(bh, &c);
  else if (out_f32)
    e = dt % 32 ? config_of<__nv_bfloat16, float, 16>(bh, &c)
                : config_of<__nv_bfloat16, float, 32>(bh, &c);
  else
    e = dt % 32 ? config_of<__nv_bfloat16, __nv_bfloat16, 16>(bh, &c)
                : config_of<__nv_bfloat16, __nv_bfloat16, 32>(bh, &c);
  *stages = c.stages;
  *smem = (long long)c.smem;
  *blocks_per_sm = c.blocks_per_sm;
  return (int)e;
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
