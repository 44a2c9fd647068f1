// Row-layout band SpMM for Hopper (sm_90a), bound from Python with ctypes
// (kernels/block_spmm.py holds the wrappers and the plain PyTorch versions).
//
// Every kernel here computes, for an int8 0/1 block of A, the product of
// each row with X: for each non-zero of the row, in column order, the X row
// it names is added with fp32 FMAs (lane l owns columns 4l..4l+3 of each
// 128-column group).  Sums run in fp32 with plain FMAs on the CUDA cores, no
// tensor cores and no TF32: the counterpart of the reference's
// Precision.HIGHEST in fp32; bf16 inputs are widened with __bfloat162float,
// as the reference's DEFAULT-precision bf16 dot accumulates exact 0/1 x bf16
// products in fp32.  Outputs are rounded to nearest once.  Every output
// element is summed by one thread, from 0.f over its row's non-zeros in
// increasing k, so results are bitwise repeatable and equal across the
// kernels.  An absent edge adds nothing even where X is not finite (as in a
// CSR product), where the Pallas kernels' dense dots would spread a NaN over
// the superwindow.
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
//   caller scatters; grouped mode: identity order, ``group`` consecutive
//   entries a unit of work, as a grid step of the Pallas kernel owns G
//   superwindows).  An entry whose c_i >= num_sw (capacity padding,
//   format/plan.py) writes nothing, so no trash block is allocated.
// tiled_kernel replaces band_tiled_spmm (pallas_call at :597): superwindow s
//   sums its run of (superwindow, 128-row X tile) pairs, ptr[s] <= p <
//   ptr[s+1], each pair's A tile [bh, 128] against X[tile[p]*128 : +128], in
//   pair order, and writes its block once.  The TPU kernel's ring-cache
//   fetch schedule (tp_fetch / tp_late) changes no value and is not used:
//   consecutive superwindows read overlapping tiles, which L2 keeps.
// band_fused_kernel replaces band_fused_spmm_direct (pallas_call at :666):
//   the band aggregate agg = A[i] @ X[st : st+Bb], written out, and out =
//   round_as(agg) @ W [dp, hp] (the reference's ``agg.astype(w.dtype)``),
//   summed in fp32 in k order, in one launch (its design below).
//   tiled_kernel reads its rows of A from device memory a warp at a time
//   (add_row).
// A as stored (template PACK, the plan's a_dtype): int8, one byte a column
// (PACK 1), or the reference's int4 (a_dtype='int4', PACK 2): nibbles,
// column 2j in the low nibble of byte j and 2j + 1 in the high one, so a
// 16-byte chunk holds 32 consecutive columns and a row half the bytes.  Each
// kernel reads A as stored: the tensor maps and cp.async copies move bytes
// (Bb / PACK a row), a lane masks the non-zero nibbles of its chunks (32
// bits a chunk) and walks them in increasing k, and a value, where one is
// not 0/1, is the nibble sign-extended.  The sums and their order do not
// depend on PACK, so a PACK 2 launch equals the PACK 1 launch on the same
// blocks bit for bit.
//
// What bounds them.  The blocks are under 1% non-zero (DD's wide plan:
// 1.38 M edges in 1190 x 256 x 640 bytes of A), so no kernel multiplies the
// dense block (a dense bf16 product on the tensor cores would take about as
// long as the bytes floor, and could not keep fp32 bitwise): a row of X is
// read once per non-zero of A, from L2, where the superwindow's band (Bb
// rows) stays while its bh rows are computed.  Reading A whole (every byte,
// to find the non-zeros) is the larger part of the bytes floor at dp 128:
// at the blocks stand-in 215 MB of A beside 171 MB of X and 172 MB of
// output, 0.167 ms at 3.35 TB/s.  The fused kernel's update is dense:
// 2*bh*dp*hp operations per superwindow on the CUDA cores, which at hidden
// 256 bounds it by operations, not bytes.
//
// band_kernel's design.  The first kernel gave each output row a warp that
// read its row of A from device memory 128 bytes at a time, voted on the
// words, then for each non-zero issued one dependent 16-byte-a-lane load of
// X and its FMAs: about one load a warp in flight, so the A scan ran at
// device-memory latency (2.2x the bound at dp 128, behind torch.sparse.mm).
// Now blocks are persistent (three an SM where the registers allow: at one
// column group; two at more) and take (entry group, 32-row chunk) units,
// chunk fastest, so an entry's X band stays in L2 while its chunks run:
//   - the producer lane takes each unit from a work counter (an atomic
//     add), so a block that drew dense units takes fewer (dealt
//     round-robin instead, the uneven plans of DD and GH ran markedly
//     slower, the uniform blocks stand-in no faster).  It keeps a ring of
//     2-8 stages of A tiles [32, Bb] filled ahead of the consumers by
//     Tensor Memory Accelerator copies (a 2-D tensor map over A as [Sb*bh,
//     Bb], boxes of at most 256 bytes: Bb 640 is 5 boxes of 128), under a
//     full and an empty mbarrier a stage, and writes each stage's item into
//     a header;
//     where Bb is no 16-byte multiple (TMA cannot take the stride) the
//     producer warp's 32 lanes stage it by 4-byte cp.async instead;
//   - eight consumer warps take an item's rows in turn.  A warp reads its
//     row from shared memory, 32 bytes a lane, turns each lane's bytes into
//     a mask of non-zeros (a carry-free byte test and one multiply), and
//     walks the non-zeros in increasing k with ballots and one shuffle per
//     lane that holds any; it adds them U = 4 at a time (2 at 3-4 column
//     groups), each lane issuing the batch's U*NG 16-byte loads of X (L2
//     only: a row is rarely read twice on one SM) before its FMAs.  Rows
//     are stored 16 bytes a lane, coalesced.  No __syncthreads() after the
//     start; a wait that never completes traps instead of hanging.
//   The sums, their order and the rounding are the first kernel's, so the
//   fp32 output is its output bit for bit, and equals band_fused_kernel's
//   aggregate and tiled_kernel's result on full-cover plans.
// What bounds it now (chip_smoke.py, fp32, an H100 80GB HBM3): at GH's plan
// (Sb 4824, Bb 1024) it runs within 1.10x of its bytes bound, A's 1.26 GB
// the larger part; at the blocks stand-in and DD (about 5 non-zeros a row
// of 640 bytes) 1.45-1.47x, where each row's fixed work (reading and
// masking its bytes, the walk, the store) and the gathers' L2 latency, not
// bytes, set the pace.
// What bounded it on the way, found with throwaway builds on an H100 (their
// numbers not kept): with the gathers removed the first ring kernel still
// took most of its time at the blocks stand-in, so instruction issue, not
// memory, bound it: each row's non-zeros were first listed in shared memory
// (a count a lane, a warp scan, each lane writing its own), several hundred
// instructions a row; the ballot walk takes about half.  Also tried and
// slower: 12 or 16 consumer warps (their register caps spill), batches of 8
// or 16 at one column group, 64-row stages, and more stages than leave
// three blocks an SM.
//
// band_fused_kernel's design.  The update is dense: at the blocks stand-in
// with dp 256 and hp 256 it is 44 GFLOP, 0.66 ms at 67 TFLOP/s, beside the
// band part's 0.27 ms of bytes; at dp 3712 638 GFLOP, 9.5 ms.  So the FMAs
// bound it, and on this card the FMAs of a register-tiled product are in
// turn bound by shared memory: a k step of an a x b tile a thread reads
// a + b words for a*b FMAs, and the SM delivers 32 words a clock against
// 128 FMAs, so only tiles of 64 FMAs a step or more leave the FMA pipe
// room.  The first fused kernel (one thread an output column, 16 rows) read W four
// k at a time from L2 for 64 FMAs and ran at a fraction of the rate (2.14
// ms at dp 256).  Now:
//   - one persistent block an SM of BAND_WARPS warps, all in both phases,
//     so that each thread may keep an 8 x 16 tile of out (8 x 8 where hp <=
//     128) in 255 registers: two k steps of it unrolled hold 128 sums, 24
//     operands and the next slab's loads.  A producer warp (band_kernel's
//     ring) would put three warps on one scheduler and cap a thread at 168
//     registers, two blocks at 96: both spilled the tile;
//   - units of FR = 128 rows of an entry from the work counter; the unit's
//     rows of A arrive as one tile (halved for very wide bands) by tensor
//     copies, band_kernel's boxes, under one mbarrier, or by cp.async where
//     Bb is no 16-byte multiple; each warp walks its rows' non-zeros with
//     band_row's ballots (batches twice band_kernel's at one column group)
//     and stores the aggregate rows.  After a barrier the next unit's tile
//     is requested, so that its copy runs during this unit's update;
//   - the update reads the unit's aggregate rows back from L2 (this block
//     wrote them, past the barrier), rounded to W's type, and W through L1,
//     8 rows of k a slab into shared memory, double-buffered with the next
//     slab's loads in flight during this slab's FMAs (agg^T as [8][128], W
//     as [8][256]); a k step reads two 16-byte words of agg^T and four of W
//     for 128 FMAs.  Each out element is one fmaf chain over k in order.
// Tried on the way and slower (throwaway builds on an H100 80GB HBM3, dp
// 256, hp 256, fp32): the update inside band_kernel's ring with a producer
// warp, two blocks an SM, tiles of 8 x 4 and 8 x 8 (2.8-3.9 ms: the
// register caps spilled them, and the two blocks' phases, both bound by
// issue and shared memory, did not overlap); one block of that form at 168
// registers (2.3-2.45); two blocks an SM of this kernel (128 registers:
// the band part took 0.48 ms, but the update's 8 x 8 tile spilled, 2.41 in
// all); the slabs by cp.async two slabs ahead (no faster: the loads were
// not what stalled); full unrolling of the k steps (the compiler hoisted
// every step's loads and spilled).  Left: the band part
// takes about 0.6 ms here against band_kernel's 0.37 (eight warps an SM
// hide its gathers' latency less than twenty-four), and the update runs
// near half the FMA rate, the shared-memory bound above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

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
// A gather of X (16 bytes of fp32 or 8 of bf16 a lane), cached in L2 only:
// a gathered row is rarely read again by the same SM, and loads in flight
// would otherwise hold lines of the L1 that shared memory leaves.
__device__ __forceinline__ F4 gather4(const float* p) {
  const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
  return F4{{q.x, q.y, q.z, q.w}};
}
__device__ __forceinline__ F4 gather4(const __nv_bfloat16* p) {
  const uint2 q = __ldcg(reinterpret_cast<const uint2*>(p));
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

// A as stored (PACK 1: an int8 a column; PACK 2: int4 nibbles, column 2j in
// the low nibble of byte j and column 2j + 1 in its high nibble, so that a
// 16-byte chunk holds 32 consecutive columns; format/streams.py:pack_a_int4).
// The value of a nibble as the reference's signed int4.
__device__ __forceinline__ int nibble_value(uint32_t v) { return (int)((v & 15u) ^ 8u) - 8; }

// acc += A_row @ X[0 : bb] for one row of a block of A (bb columns, a
// multiple of 4; the row 4-byte aligned at PACK 1, 2-byte at PACK 2); xb
// points at X's first band row, offset to this lane's first column (rows dp
// elements apart).  Lane l reads columns k0 + 4l .. k0 + 4l + 3: 4 bytes, or
// 2 at PACK 2.
template <typename TX, int NG, int PACK>
__device__ __forceinline__ void add_row(const int8_t* __restrict__ arow, int bb,
                                        const TX* __restrict__ xb, long long dp, int lane,
                                        float (&acc)[NG][4]) {
  for (int k0 = 0; k0 < bb; k0 += 128) {
    const int k = k0 + 4 * lane;
    uint32_t word = 0u;
    if (k < bb)
      word = PACK == 1 ? *reinterpret_cast<const uint32_t*>(arow + k)
                       : *reinterpret_cast<const uint16_t*>(arow + k / 2);
    // words in column order; the loop below is uniform across the warp
    for (unsigned nz = __ballot_sync(0xffffffffu, word != 0u); nz; nz &= nz - 1) {
      const int src = __ffs(nz) - 1;
      const uint32_t w = __shfl_sync(0xffffffffu, word, src);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int av = PACK == 1 ? static_cast<int8_t>((w >> (8 * b)) & 0xffu)
                                 : nibble_value(w >> (4 * b));
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

// ---- band_kernel: persistent, an asynchronous ring of A tiles ----

constexpr int BAND_WARPS = 8;        // consumer warps of a block (and one producer warp)
constexpr int BAND_MAX_STAGES = 8;
constexpr int SEG = 1024;            // bytes of an A row a warp scans at once: 32 a lane
constexpr int RING_ALIGN = 128;      // a tensor copy's destination alignment
constexpr int BAND_BAR_BYTES = 3 * BAND_MAX_STAGES * 8;  // full, empty, item headers

// Non-zeros added per batch (their U*NG loads issued before their FMAs):
// 4-8 16-byte loads a lane in flight.
template <int NG>
__host__ __device__ constexpr int batch_of() {
  return NG <= 2 ? 4 : 2;
}

// Dynamic shared memory of band_kernel beside its ring: alignment slack, the
// mbarriers and each stage's item header (kernels/block_spmm.py mirrors it).
constexpr int BAND_FIXED_SMEM = RING_ALIGN + BAND_BAR_BYTES;

// A staged row of A: byte k at (k >> shift) * box_stride + (k & mask), boxes
// of 2^shift bytes (tensor copies), or one box (shift 31: cp.async).
struct RowMap {
  int shift, mask, box_stride;
  __device__ int operator()(int k) const { return (k >> shift) * box_stride + (k & mask); }
};

// The non-zero columns of the 16 bytes of a staged row at byte k (0 past
// the row's rb bytes) as a mask, column i of the chunk at bit i: 16 bits
// (PACK 1) or 32 (PACK 2); ``ones`` is cleared if any column is not 0 or 1.
template <int PACK>
__device__ __forceinline__ uint32_t chunk_mask(const unsigned char* arow, RowMap at, int k,
                                               int rb, bool& ones) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (k < rb) {
    v = *reinterpret_cast<const uint4*>(arow + at(k));
    // the words past rb (rb % 16 == 4, 8 or 12) are not A's
    if (k + 4 >= rb) v.y = 0u;
    if (k + 8 >= rb) v.z = 0u;
    if (k + 12 >= rb) v.w = 0u;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t m = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (PACK == 1) {
      // the high bit of each byte: set iff the byte is non-zero (no carry
      // crosses a byte); the multiply gathers the four high bits into bits 28-31
      const uint32_t hi = (((w[q] & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w[q]) & 0x80808080u;
      m |= (hi * 0x00204081u) >> 28 << (4 * q);
      ones &= (w[q] & 0xfefefefeu) == 0u;
    } else {
      // the high bit of each nibble, set iff the nibble is non-zero (no
      // carry crosses a nibble), moved to bit 4i for nibble i; then the
      // eight bits gathered into bits 0-7 in three shift steps
      uint32_t h = ((((w[q] & 0x77777777u) + 0x77777777u) | w[q]) & 0x88888888u) >> 3;
      h = (h | h >> 3) & 0x03030303u;
      h = (h | h >> 6) & 0x000f000fu;
      h = (h | h >> 12) & 0xffu;
      m |= h << (8 * q);
      ones &= (w[q] & 0xeeeeeeeeu) == 0u;
    }
  }
  return m;
}

// The non-zeros of one SEG-byte step of a staged row, in increasing k, one
// at a time; warp-uniform (the lanes holding non-zeros come from ballots,
// each one's column mask from a shuffle).  A lane's chunks are at bytes
// 16*lane (low half) and 512 + 16*lane (high half) of the step: at PACK 1
// ``lo`` holds both 16-bit masks (the high half's in its upper bits), at
// PACK 2 ``lo`` and ``hi`` one 32-bit mask each.
template <int PACK>
struct NonZeros {
  uint32_t lo, hi, lanes, lanes_hi, bits;
  int base, half;

  __device__ bool next(int k0, int& k) {
    while (bits == 0u) {
      if (lanes == 0u) {
        if (half || lanes_hi == 0u) return false;
        half = 1;
        lanes = lanes_hi;
      }
      const int src = __ffs(lanes) - 1;
      lanes &= lanes - 1u;
      if (PACK == 1)
        bits = __shfl_sync(0xffffffffu, lo, src) >> (16 * half) & 0xffffu;
      else
        bits = __shfl_sync(0xffffffffu, half ? hi : lo, src);
      base = k0 + (512 * half + 16 * src) * PACK;
    }
    k = base + __ffs(bits) - 1;
    bits &= bits - 1u;
    return true;
  }
};

// The value of column k of a staged row (a broadcast read).
template <int PACK>
__device__ __forceinline__ float a_value(const unsigned char* arow, RowMap at, int k) {
  if (PACK == 1) return static_cast<float>(static_cast<int8_t>(arow[at(k)]));
  return static_cast<float>(nibble_value(arow[at(k >> 1)] >> (4 * (k & 1))));
}

// acc += A_row @ X[0 : bb] for one row of A staged in shared memory (at)
// as stored (bb columns in bb / PACK bytes).  xb points at X's first band
// row, offset to this lane's first column.  Per SEG bytes (SEG * PACK
// columns) each lane reads its two 16-byte chunks and masks their non-zero
// columns; the warp then takes the non-zeros in increasing k, U at a time:
// each one's value of A (1 where the step holds only 0/1 columns, else a
// broadcast read of the staged row) and its X row's U*NG loads are issued
// before the batch's FMAs, which run in k order.  SCALED: each value of A
// is multiplied by cs[k], the column scale of X's band row k (one broadcast
// load a non-zero, issued with its X row's), so the FMA takes the scale as
// its operand; where the step holds only 0/1 columns the operand is cs[k]
// itself, with no multiply.
template <typename TX, int NG, int U, int PACK, bool SCALED = false>
__device__ __forceinline__ void band_row(const unsigned char* arow, RowMap at, int bb,
                                         const TX* xb, long long dp, int lane,
                                         float (&acc)[NG][4], const float* cs = nullptr) {
  const int rb = bb / PACK;
  for (int k0 = 0; k0 < rb; k0 += SEG) {
    bool ones = true;
    const uint32_t lo = chunk_mask<PACK>(arow, at, k0 + 16 * lane, rb, ones);
    // at PACK 2 a row of Bb <= 1024 (512 bytes) leaves the high half empty:
    // the warp (uniformly) skips it
    const uint32_t hi = PACK == 1 || k0 + 512 < rb
                            ? chunk_mask<PACK>(arow, at, k0 + 512 + 16 * lane, rb, ones)
                            : 0u;
    ones = __all_sync(0xffffffffu, ones);
    NonZeros<PACK> nz{PACK == 1 ? lo | hi << 16 : lo, PACK == 1 ? 0u : hi,
                      __ballot_sync(0xffffffffu, lo != 0u), __ballot_sync(0xffffffffu, hi != 0u),
                      0u, 0, 0};
    for (bool more = true; more;) {
      bool ok[U];
      float af[U];
      F4 v[U][NG];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        int k = 0;
        ok[u] = more && nz.next(k0 * PACK, k);
        more = ok[u];
        if (ok[u]) {
          if (SCALED) {
            const float c = __ldg(cs + k);
            af[u] = ones ? c : a_value<PACK>(arow, at, k) * c;
          } else {
            af[u] = ones ? 1.f : a_value<PACK>(arow, at, k);
          }
          const TX* xr = xb + (long long)k * dp;
#pragma unroll
          for (int g = 0; g < NG; ++g) v[u][g] = gather4(xr + g * 128);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (ok[u]) {
#pragma unroll
          for (int g = 0; g < NG; ++g)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[g][q] = fmaf(v[u][g].v[q], af[u], acc[g][q]);
        }
      }
    }
  }
}

// Grid: persistent, a few blocks an SM.  Block: BAND_WARPS consumer warps
// and a producer warp.  Work comes in units: (group of ``group``
// consecutive entries, chunk of ``rows`` output rows), chunk fastest, so
// that an entry's X band stays in L2 while its chunks run; a unit's items
// are its entries in order (direct and bucket modes: group 1), those whose
// block id is >= num_sw (capacity padding) skipped.  The producer takes the
// next unit from ``counter`` (zero at launch; each block takes one when it
// needs one, so blocks that drew heavy units take fewer), and for each item
// writes the item's (entry, first row) into its ring stage's header and
// fills the stage: A's rows [rows, bb] of the entry as stored (rb = bb /
// PACK bytes a row) as nbox boxes [rows][box_w], a tensor copy each
// (``tma``; amap: A as [Sb*bh rows, rb] bytes, box [rows][box_w] bytes;
// boxes reaching past rb land zeros), or, where rb is no 16-byte multiple,
// 4-byte cp.async copies by the producer warp's 32 lanes (box_w >= rb, one
// box).  A header of entry -1 ends the block.
// Consumer warp w takes the item's rows w, w + BAND_WARPS, ...: for each
// NG*128-column slab of dp it sums the row (band_row) and stores it, 16
// bytes a lane (fp32).
// SCALED (a diagonal scale D over X's and out's rows, D X and D out: the
// normalised operator D A D X): X's band row k enters the sums times
// scale[st + k], and each sum is multiplied once by scale[ssw[i] * bh + r]
// at its store, r the row within the block: the superwindow's own row,
// which in bucket mode is ssw[i] and not the block id i.  A row past
// scale_rows (capacity padding in bucket mode, whose blocks the caller
// drops) is scaled by 0.
template <typename TX, typename TO, int NG, int PACK, bool SCALED>
__global__ void __launch_bounds__((BAND_WARPS + 1) * 32, 2)
band_kernel(const __grid_constant__ CUtensorMap amap, const int32_t* __restrict__ starts,
            const int32_t* __restrict__ sw, const int8_t* __restrict__ a,
            const TX* __restrict__ x, TO* __restrict__ out, int* __restrict__ counter, int sb,
            int bh, int bb, int dp, int num_sw, int group, int rows, int box_w, int nbox,
            int stages, int tma, const float* __restrict__ scale,
            const int32_t* __restrict__ ssw, long long scale_rows) {
  extern __shared__ __align__(16) unsigned char band_smem[];
  unsigned char* ring =
      band_smem + (RING_ALIGN - smem_addr(band_smem) % RING_ALIGN) % RING_ALIGN;
  const int box_stride = rows * box_w;
  const int stage_bytes = box_stride * nbox;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage_bytes);
  uint64_t* empty = full + BAND_MAX_STAGES;  // [stages]: consumers done with the stage
  int2* header = reinterpret_cast<int2*>(empty + BAND_MAX_STAGES);  // [stages]: (entry, row0)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nchunk = (bh + rows - 1) / rows;
  const int nunits = sb / group * nchunk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // tma: the producer lane's arrival (with the bytes); cp.async: each
      // producer lane's copies and lane 0's arrival after the header
      bar_init(&full[s], tma ? 1 : 33);
      bar_init(&empty[s], BAND_WARPS);
    }
    bar_init_fence();
  }
  __syncthreads();  // the only block-wide barrier: the mbarriers exist

  if (warp == BAND_WARPS) {
    // ---- producer: lane 0 takes units and issues the tensor copies; with
    // cp.async every lane copies ----
    if (tma && lane != 0) return;
    const long long total_rows = (long long)sb * bh;
    const int rb = bb / PACK;
    const int words = rb / 4;
    int t = 0;
    // the next free stage, once the consumers are done with its last item
    auto claim = [&]() {
      const int slot = t % stages;
      if (t >= stages) bar_wait(&empty[slot], (t / stages - 1) & 1);
      return slot;
    };
    for (;;) {
      int unit = lane == 0 ? atomicAdd(counter, 1) : 0;
      if (!tma) unit = __shfl_sync(0xffffffffu, unit, 0);
      if (unit >= nunits) break;
      for (int j = 0; j < group; ++j) {
        const int i = unit / nchunk * group + j;
        if ((sw != nullptr ? sw[i] : i) >= num_sw) continue;  // capacity padding
        const int slot = claim();
        const int row0 = unit % nchunk * rows;
        unsigned char* dst = ring + slot * stage_bytes;
        const long long r0 = (long long)i * bh + row0;
        if (lane == 0) header[slot] = make_int2(i, row0);
        if (tma) {
          fence_proxy_async();
          bar_arrive_expect(&full[slot], stage_bytes);
          for (int b = 0; b < nbox; ++b)
            tensor_load(dst + b * box_stride, &amap, b * box_w, (int)r0, &full[slot]);
        } else {
          for (int e = lane; e < rows * words; e += 32) {
            const int r = e / words, q = e - r * words;
            if (r0 + r < total_rows) cp_async4(dst + r * box_w + 4 * q, a + (r0 + r) * rb + 4 * q);
          }
          cp_async_arrive(&full[slot]);
          if (lane == 0) bar_arrive(&full[slot]);
        }
        ++t;
      }
    }
    const int slot = claim();
    if (lane == 0) header[slot] = make_int2(-1, 0);
    if (!tma) cp_async_arrive(&full[slot]);
    if (lane == 0) bar_arrive(&full[slot]);
    return;
  }

  // ---- consumer warps ----
  constexpr int U = batch_of<NG>();
  const RowMap at{nbox > 1 ? __ffs(box_w) - 1 : 31, nbox > 1 ? box_w - 1 : 0x7fffffff,
                  box_stride};
  for (int t = 0;; ++t) {
    const int slot = t % stages;
    bar_wait(&full[slot], (t / stages) & 1);
    const int2 item = header[slot];
    if (item.x < 0) break;
    const unsigned char* stage = ring + slot * stage_bytes;
    const long long blk = sw != nullptr ? sw[item.x] : item.x;
    const int r0 = item.y;
    const TX* xb = x + (long long)starts[item.x] * dp + 4 * lane;
    const float* cs = SCALED ? scale + starts[item.x] : nullptr;
    const long long srow0 = SCALED ? (long long)ssw[item.x] * bh + r0 : 0;
    for (int rr = warp; rr < rows && r0 + rr < bh; rr += BAND_WARPS) {
      TO* orow = out + (blk * bh + r0 + rr) * dp + 4 * lane;
      const float rs = SCALED && srow0 + rr < scale_rows ? __ldg(scale + srow0 + rr) : 0.f;
      for (int c = 0; c < dp; c += NG * 128) {
        float acc[NG][4] = {};
        band_row<TX, NG, U, PACK, SCALED>(stage + rr * box_w, at, bb, xb + c, dp, lane, acc, cs);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          if (SCALED) {
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[g][q] *= rs;
          }
          store4(orow + c + g * 128, acc[g]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[slot]);
  }
}

// ---- band_fused_kernel: the band product and the update in one launch ----

constexpr int FR = 128;  // output rows of a fused unit: the rows of its update tile
constexpr int FK = 8;    // contraction rows (of agg^T and W) a staged slab holds
constexpr int FC = 256;  // out columns a pass of the update covers (128 where hp <= 128)
constexpr int FUSED_THREADS = BAND_WARPS * 32;
// the update's slabs: two of agg^T [FK][FR] and two of W [FK][FC], fp32
constexpr int FUSED_SLAB_SMEM = 2 * FK * (FR + FC) * (int)sizeof(float);
// alignment slack for the A tile, its mbarrier and the next unit's id
constexpr int FUSED_FIXED_SMEM = RING_ALIGN + 64;

// The fused kernel's A tile: ``arows`` rows of A [arows][Bb] as nbox boxes
// of box_w bytes (tensor copies, one mbarrier) or one row-padded box
// (4-byte cp.async by every thread).
struct Tile {
  int arows, box_w, nbox, tma;
};

// Loads rows [r0, r0 + arows) of A (as stored: [Sb*bh, rb] bytes) into
// ``dst``: thread 0 issues the tensor copies, completed on ``full``; or every
// thread issues its share of 4-byte cp.async copies, completed by
// cp_async_wait_all.
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap& amap,
                                          const int8_t* a, long long r0, long long total_rows,
                                          int rb, Tile t, uint64_t* full) {
  if (t.tma) {
    if (threadIdx.x == 0) {
      fence_proxy_async();
      bar_arrive_expect(full, t.arows * t.box_w * t.nbox);
      for (int b = 0; b < t.nbox; ++b)
        tensor_load(dst + b * t.arows * t.box_w, &amap, b * t.box_w, (int)r0, full);
    }
  } else {
    const int words = rb / 4;
    for (int e = threadIdx.x; e < t.arows * words; e += FUSED_THREADS) {
      const int r = e / words, q = e - r * words;
      if (r0 + r < total_rows) cp_async4(dst + r * t.box_w + 4 * q, a + (r0 + r) * rb + 4 * q);
    }
  }
}

// The consumer side of load_tile: the tile has landed for every thread.
__device__ __forceinline__ void wait_tile(Tile t, uint64_t* full, unsigned& parity) {
  if (t.tma) {
    bar_wait(full, parity);
    parity ^= 1u;
  } else {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
  }
}

// The next unit with a real entry (capacity padding skipped) from the work
// counter, or -1; thread 0 only.
__device__ __forceinline__ int claim_unit(int* counter, const int32_t* sw, int nunits,
                                          int nchunk, int num_sw) {
  for (;;) {
    const int u = atomicAdd(counter, 1);
    if (u >= nunits) return -1;
    if (sw[u / nchunk] < num_sw) return u;
  }
}

// out[r, :hp] = round_as(agg[r, :dp]) @ w for the unit's rows r < nr (agg:
// this block's own rows of the aggregate, written before the last barrier;
// out: row 0 of the unit's rows of the update), by all FUSED_THREADS
// threads.  Per COLS-column pass (FC, or 128 where hp <= 128) each thread
// keeps an 8 x COLS/16 tile of out in registers: rows 8*rg .. 8*rg + 7 (rg =
// 2*warp + lane/16) and the column groups 64*g + 4*cg .. + 3 (cg = lane %
// 16).  Both operands go
// through shared memory FK rows of k at a time, double-buffered, the next
// slab's loads (agg^T from L2, W through L1) in flight during this slab's
// FMAs: agg^T as [FK][FR] (rows past nr zero), W as [FK][COLS] (columns
// past hp zero).  A k step reads two 16-byte words of agg^T and COLS/64 of
// W for 8 x COLS/16 FMAs.  Each out element is one fmaf chain over k = 0,
// 1, ..., dp - 1.
template <typename TX, typename TO, int COLS>
__device__ __forceinline__ void w_product(const TO* __restrict__ agg, int nr,
                                          const TX* __restrict__ w, TO* __restrict__ out, int dp,
                                          int hp, float* fbuf) {
  constexpr int NJ = COLS / 16;                   // out columns a thread
  constexpr int WR = FUSED_THREADS / COLS;        // W rows a staging step
  float* as = fbuf;                // [2][FK][FR]
  float* ws = fbuf + 2 * FK * FR;  // [2][FK][COLS]
  const int tid = threadIdx.x, lane = tid % 32;
  const int cg = lane % 16, rg = tid / 32 * 2 + lane / 16;
  const int sr = tid % FR, sk = tid / FR * 4;  // staging: agg row sr, k sk .. sk + 3
  const int wc = tid % COLS, wk = tid / COLS;  // staging: W column wc, k wk + WR*q
  const int nslab = dp / FK;
  const TO* arow = agg + (long long)sr * dp + sk;
  for (int c0 = 0; c0 < hp; c0 += COLS) {
    float acc[8][NJ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    const bool w_on = c0 + wc < hp;
    const TX* wcol = w + (long long)wk * hp + c0 + wc;
    F4 pa = sr < nr ? gather4(arow) : F4{{0.f, 0.f, 0.f, 0.f}};
    float pw[FK / WR];
#pragma unroll
    for (int q = 0; q < FK / WR; ++q)
      pw[q] = w_on ? to_f32(wcol[(long long)WR * q * hp]) : 0.f;
    for (int s = 0; s < nslab; ++s) {
      {  // the slab fetched last goes into buffer s & 1
        float* a_s = as + (s & 1) * FK * FR + sk * FR + sr;
        float* w_s = ws + (s & 1) * FK * COLS + wk * COLS + wc;
#pragma unroll
        for (int q = 0; q < 4; ++q) a_s[q * FR] = round_as(pa.v[q], w);
#pragma unroll
        for (int q = 0; q < FK / WR; ++q) w_s[WR * q * COLS] = pw[q];
      }
      __syncthreads();
      if (s + 1 < nslab) {  // the next slab's loads, in flight during this one's FMAs
        const long long k1 = (long long)(s + 1) * FK;
        if (sr < nr) pa = gather4(arow + k1);
        if (w_on) {
#pragma unroll
          for (int q = 0; q < FK / WR; ++q) pw[q] = to_f32(wcol[(k1 + WR * q) * hp]);
        }
      }
      const float* a_s = as + (s & 1) * FK * FR + 8 * rg;
      const float* w_s = ws + (s & 1) * FK * COLS + 4 * cg;
      // unrolled by two only: fully unrolled, the compiler hoists every
      // step's loads ahead of the FMAs and runs out of registers
#pragma unroll 2
      for (int kk = 0; kk < FK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(a_s + kk * FR);
        const float4 a1 = *reinterpret_cast<const float4*>(a_s + kk * FR + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float bv[NJ];
#pragma unroll
        for (int g = 0; g < NJ / 4; ++g) {
          const float4 b = *reinterpret_cast<const float4*>(w_s + kk * COLS + 64 * g);
          bv[4 * g] = b.x;
          bv[4 * g + 1] = b.y;
          bv[4 * g + 2] = b.z;
          bv[4 * g + 3] = b.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();  // the last slab's readers are done before the buffers refill
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 8 * rg + i;
      if (r < nr) {
        TO* orow = out + (long long)r * hp;
#pragma unroll
        for (int g = 0; g < NJ / 4; ++g) {
          const int c = c0 + 64 * g + 4 * cg;
          const float v[4] = {acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                              acc[i][4 * g + 3]};
          if (hp % 4 == 0) {
            if (c < hp) store4(orow + c, v);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (c + q < hp) store1(orow + c + q, v[q]);
          }
        }
      }
    }
  }
}

// The band product and the update in one launch (band_fused_spmm_direct):
// agg rows = A[i] @ X[st : st + Bb] as band_kernel sums them, and out =
// round_as(agg) @ W.  Grid: persistent, one block an SM (the update's
// 8 x 16 register tile wants more registers than a second block would
// leave).  Block: BAND_WARPS warps, all of them in each phase.  Units:
// (entry, FR-row chunk), chunk fastest, from the work counter.  A unit's
// rows of A arrive as tiles of ``arows`` rows (all FR at the plans' band
// widths) by tensor copies (cp.async where Bb is no 16-byte multiple); warp
// w sums the tile's rows w, w + BAND_WARPS, ... with band_row's ballot walk
// and stores them to ``agg``; after a barrier, the first tile of the next
// unit is requested, so that its copy runs during this unit's update
// (w_product), which reads the rows back from L2.
template <typename TX, typename TO, int NG, int PACK>
__global__ void __launch_bounds__(FUSED_THREADS, 1)
band_fused_kernel(const __grid_constant__ CUtensorMap amap, const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ sw, const int8_t* __restrict__ a,
                  const TX* __restrict__ x, const TX* __restrict__ w, TO* __restrict__ agg,
                  TO* __restrict__ out, int* __restrict__ counter, int sb, int bh, int bb,
                  int dp, int hp, int num_sw, Tile t) {
  extern __shared__ __align__(16) unsigned char fused_shared[];
  unsigned char* tile =
      fused_shared + (RING_ALIGN - smem_addr(fused_shared) % RING_ALIGN) % RING_ALIGN;
  const int tile_bytes = t.arows * t.box_w * t.nbox;
  uint64_t* full = reinterpret_cast<uint64_t*>(tile + tile_bytes);
  int* next_unit = reinterpret_cast<int*>(full + 1);
  float* fbuf = reinterpret_cast<float*>(tile + tile_bytes + 64);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nchunk = (bh + FR - 1) / FR;
  const int nunits = sb * nchunk;
  const long long total_rows = (long long)sb * bh;
  const int rb = bb / PACK;
  // at one column group, twice band_kernel's batch: one block an SM leaves
  // registers for more loads in flight a warp (at more, the tile spills)
  constexpr int U = NG == 1 ? 2 * batch_of<NG>() : batch_of<NG>();
  const RowMap at{t.nbox > 1 ? __ffs(t.box_w) - 1 : 31, t.nbox > 1 ? t.box_w - 1 : 0x7fffffff,
                  t.arows * t.box_w};

  if (threadIdx.x == 0) {
    bar_init(full, 1);
    bar_init_fence();
    *next_unit = claim_unit(counter, sw, nunits, nchunk, num_sw);
  }
  __syncthreads();
  int unit = *next_unit;
  if (unit >= 0)
    load_tile(tile, amap, a, (long long)(unit / nchunk) * bh + unit % nchunk * FR, total_rows, rb,
              t, full);
  unsigned parity = 0u;
  while (unit >= 0) {
    const int i = unit / nchunk, u0 = unit % nchunk * FR;
    const int nr = min(FR, bh - u0);
    const long long blk = sw[i];
    const TX* xb = x + (long long)starts[i] * dp + 4 * lane;
    for (int c0r = 0; c0r < nr; c0r += t.arows) {
      wait_tile(t, full, parity);
      for (int rr = warp; rr < t.arows && c0r + rr < nr; rr += BAND_WARPS) {
        TO* orow = agg + (blk * bh + u0 + c0r + rr) * dp + 4 * lane;
        for (int c = 0; c < dp; c += NG * 128) {
          float acc[NG][4] = {};
          band_row<TX, NG, U, PACK>(tile + rr * t.box_w, at, bb, xb + c, dp, lane, acc);
#pragma unroll
          for (int g = 0; g < NG; ++g) store4(orow + c + g * 128, acc[g]);
        }
      }
      __syncthreads();  // the tile's readers are done (and the unit's rows are out)
      if (c0r + t.arows < nr) {
        load_tile(tile, amap, a, (long long)i * bh + u0 + c0r + t.arows, total_rows, rb, t,
                  full);
      } else {
        if (threadIdx.x == 0) *next_unit = claim_unit(counter, sw, nunits, nchunk, num_sw);
        __syncthreads();
        const int nu = *next_unit;
        if (nu >= 0)
          load_tile(tile, amap, a, (long long)(nu / nchunk) * bh + nu % nchunk * FR, total_rows,
                    rb, t, full);
      }
    }
    if (hp <= 128)
      w_product<TX, TO, 128>(agg + (blk * bh + u0) * dp, nr, w, out + (blk * bh + u0) * hp, dp,
                             hp, fbuf);
    else
      w_product<TX, TO, FC>(agg + (blk * bh + u0) * dp, nr, w, out + (blk * bh + u0) * hp, dp,
                            hp, fbuf);
    unit = *next_unit;  // written before w_product's barriers
  }
}

// Grid: x = (superwindow s, 32-row chunk), chunk fastest; y = column slab.
// A tile's row is TILE columns as stored: TILE / PACK bytes.
template <typename TX, typename TO, int NG, int PACK>
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
      add_row<TX, NG, PACK>(a + ((long long)p * bh + r) * (TILE / PACK), TILE,
                      x + (long long)tile[p] * TILE * dp + col0, dp, lane, acc);
    TO* orow = out + (s * bh + r) * dp + col0;
#pragma unroll
    for (int g = 0; g < NG; ++g) store4(orow + g * 128, acc[g]);
  }
}

// The device's SMs and shared memory: band_kernel's launch reads them per
// device once.
struct Device {
  int dev = -1, sms = 0, per_sm = 0, reserved = 0, optin = 0;
};

cudaError_t device_of(Device* out) {
  static Device cache[16];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 16 && cache[dev].dev == dev) {
    *out = cache[dev];
    return cudaSuccess;
  }
  Device d;
  e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&d.per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&d.reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  d.dev = dev;
  if (dev < 16) cache[dev] = d;
  *out = d;
  return cudaSuccess;
}

// The ring's shape, chosen on the host (kernels/block_spmm.py:band_launch).
struct Ring {
  int rows, box_w, nbox, stages, tma;
};

template <typename TX, typename TO, int NG, int PACK, bool SCALED>
cudaError_t launch_band(const void* starts, const void* sw, const void* a, const void* x,
                        void* out, void* counter, int sb, int bh, int bb, int dp, int num_sw,
                        int group, Ring ring, const void* scale, const void* ssw,
                        long long scale_rows, cudaStream_t stream) {
  Device d;
  cudaError_t e = device_of(&d);
  if (e != cudaSuccess) return e;
  const size_t smem =
      BAND_FIXED_SMEM + (size_t)ring.stages * ring.rows * ring.box_w * ring.nbox;
  if (smem > (size_t)d.optin) return cudaErrorInvalidValue;
  auto kernel = band_kernel<TX, TO, NG, PACK, SCALED>;
  // the cap is the kernel's, not this shape's: let it take any
  static int opted[16] = {};
  if (d.dev < 16 && !opted[d.dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, d.optin);
    if (e != cudaSuccess) return e;
    opted[d.dev] = 1;
  }
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, (BAND_WARPS + 1) * 32, smem);
  if (e != cudaSuccess) return e;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  CUtensorMap amap = {};
  if (ring.tma && !encode_2d(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a, (long long)sb * bh,
                             bb / PACK, ring.rows, ring.box_w, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const long long units = (long long)(sb / group) * ((bh + ring.rows - 1) / ring.rows);
  const long long slots = (long long)blocks * d.sms;
  band_kernel<TX, TO, NG, PACK, SCALED><<<(unsigned)(units < slots ? units : slots),
                                          (BAND_WARPS + 1) * 32, smem, stream>>>(
      amap, static_cast<const int32_t*>(starts), static_cast<const int32_t*>(sw),
      static_cast<const int8_t*>(a), static_cast<const TX*>(x), static_cast<TO*>(out),
      static_cast<int*>(counter), sb, bh, bb, dp, num_sw, group, ring.rows, ring.box_w, ring.nbox,
      ring.stages, ring.tma, static_cast<const float*>(scale), static_cast<const int32_t*>(ssw),
      scale_rows);
  return cudaGetLastError();
}

// Dynamic shared memory of band_fused_kernel with A tile ``t`` (the host
// sizes it: kernels/block_spmm.py:fused_launch).
size_t fused_smem(const Tile& t) {
  return FUSED_FIXED_SMEM + (size_t)t.arows * t.box_w * t.nbox + FUSED_SLAB_SMEM;
}

// Resident blocks an SM of band_fused_kernel<TX, TO, NG, PACK> with
// ``smem`` bytes on device ``d``; the kernel's shared-memory cap is raised
// to the device's opt-in most on first use.
template <typename TX, typename TO, int NG, int PACK>
cudaError_t fused_blocks(const Device& d, size_t smem, int* blocks) {
  if (smem > (size_t)d.optin) return cudaErrorInvalidValue;
  auto kernel = band_fused_kernel<TX, TO, NG, PACK>;
  static int opted[16] = {};
  if (d.dev < 16 && !opted[d.dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, d.optin);
    if (e != cudaSuccess) return e;
    opted[d.dev] = 1;
  }
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, FUSED_THREADS, smem);
  if (e != cudaSuccess) return e;
  return *blocks < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <typename TX, typename TO, int NG, int PACK>
cudaError_t launch_fused(const void* starts, const void* sw, const void* a, const void* x,
                         const void* w, void* agg, void* out, void* counter, int sb, int bh,
                         int bb, int dp, int hp, int num_sw, Tile t, int* blocks_out,
                         cudaStream_t stream) {
  Device d;
  cudaError_t e = device_of(&d);
  if (e != cudaSuccess) return e;
  const size_t smem = fused_smem(t);
  int blocks = 0;
  e = fused_blocks<TX, TO, NG, PACK>(d, smem, &blocks);
  if (e != cudaSuccess) return e;
  if (blocks_out != nullptr) *blocks_out = blocks;
  CUtensorMap amap = {};
  if (t.tma && !encode_2d(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a, (long long)sb * bh,
                          bb / PACK, t.arows, t.box_w, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const long long units = (long long)sb * ((bh + FR - 1) / FR);
  const long long slots = (long long)blocks * d.sms;
  band_fused_kernel<TX, TO, NG, PACK><<<(unsigned)(units < slots ? units : slots),
                                        FUSED_THREADS, smem, stream>>>(
      amap, static_cast<const int32_t*>(starts), static_cast<const int32_t*>(sw),
      static_cast<const int8_t*>(a), static_cast<const TX*>(x), static_cast<const TX*>(w),
      static_cast<TO*>(agg), static_cast<TO*>(out), static_cast<int*>(counter), sb, bh, bb, dp,
      hp, num_sw, t);
  return cudaGetLastError();
}

template <typename TX, typename TO, int NG, int PACK>
cudaError_t launch_tiled(const void* ptr, const void* tile, const void* a, const void* x,
                         void* out, int num_sw, int bh, int dp, cudaStream_t stream) {
  const int nchunk = (bh + ROWS - 1) / ROWS;
  const dim3 grid((unsigned)num_sw * nchunk, (unsigned)(dp / (NG * 128)));
  tiled_kernel<TX, TO, NG, PACK><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const int32_t*>(ptr), static_cast<const int32_t*>(tile),
      static_cast<const int8_t*>(a), static_cast<const TX*>(x), static_cast<TO*>(out), bh, dp,
      nchunk);
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
  void *out, *counter;
  int sb, bh, bb, dp, num_sw, group, pack;
  Ring ring;
  const void *scale, *ssw;
  long long scale_rows;
  cudaStream_t stream;
  template <typename TX, typename TO>
  struct ByNg {
    const BandArgs& b;
    template <int NG>
    cudaError_t run() const {
      auto launch = b.scale != nullptr
                        ? (b.pack == 2 ? launch_band<TX, TO, NG, 2, true>
                                       : launch_band<TX, TO, NG, 1, true>)
                        : (b.pack == 2 ? launch_band<TX, TO, NG, 2, false>
                                       : launch_band<TX, TO, NG, 1, false>);
      return launch(b.starts, b.sw, b.a, b.x, b.out, b.counter, b.sb, b.bh, b.bb, b.dp, b.num_sw,
                    b.group, b.ring, b.scale, b.ssw, b.scale_rows, b.stream);
    }
  };
  template <typename TX, typename TO>
  cudaError_t run() const { return dispatch_ng(dp, ByNg<TX, TO>{*this}); }
};

struct FusedArgs {
  const void *starts, *sw, *a, *x, *w;
  void *agg, *out, *counter;
  int sb, bh, bb, dp, hp, num_sw, pack;
  Tile tile;
  int* blocks_out;
  cudaStream_t stream;
  template <typename TX, typename TO>
  struct ByNg {
    const FusedArgs& f;
    template <int NG>
    cudaError_t run() const {
      auto launch = f.pack == 2 ? launch_fused<TX, TO, NG, 2> : launch_fused<TX, TO, NG, 1>;
      return launch(f.starts, f.sw, f.a, f.x, f.w, f.agg, f.out, f.counter, f.sb, f.bh, f.bb, f.dp,
                    f.hp, f.num_sw, f.tile, f.blocks_out, f.stream);
    }
  };
  template <typename TX, typename TO>
  cudaError_t run() const { return dispatch_ng(dp, ByNg<TX, TO>{*this}); }
};

// The ring's arguments as hcspmm_band_spmm's note states them (bb columns
// of A stored PACK to a byte: rb = bb / pack bytes a row).
bool ring_ok(const void* a, int sb, int bh, int bb, int pack, int dp, int rows, int box_w,
             int nbox, int stages, int tma) {
  if ((pack != 1 && pack != 2) || bb % (4 * pack)) return false;
  const int rb = bb / pack;
  if (bh <= 0 || rb <= 0 || dp <= 0 || dp % 128 || rows < 1 || rows > 256 ||
      stages < 2 || stages > BAND_MAX_STAGES || box_w % 16 || (long long)sb * bh > 0x7fffffffLL)
    return false;
  return tma ? !(rb % 16 || (uintptr_t)a % 16 || box_w <= 0 || box_w > 256 || nbox < 1 ||
                 (nbox > 1 && (box_w & (box_w - 1))) || (long long)nbox * box_w < rb ||
                 (long long)(nbox - 1) * box_w >= rb)
             : (nbox == 1 && box_w >= rb);
}

struct TiledArgs {
  const void *ptr, *tile, *a, *x;
  void* out;
  int num_sw, bh, dp, pack;
  cudaStream_t stream;
  template <typename TX, typename TO>
  struct ByNg {
    const TiledArgs& t;
    template <int NG>
    cudaError_t run() const {
      auto launch = t.pack == 2 ? launch_tiled<TX, TO, NG, 2> : launch_tiled<TX, TO, NG, 1>;
      return launch(t.ptr, t.tile, t.a, t.x, t.out, t.num_sw, t.bh, t.dp, t.stream);
    }
  };
  template <typename TX, typename TO>
  cudaError_t run() const { return dispatch_ng(dp, ByNg<TX, TO>{*this}); }
};

}  // namespace

// starts, sw: int32 [sb] (sw may be null: block id = entry index);
// a: [sb, bh, bb] as stored: int8 (pack 1) or int4 nibbles, uint8 [sb, bh,
// bb / 2] (pack 2; the nibble order above); x: [m, dp] fp32 (x_bf16 == 0) or
// bf16; out:
// [rows, dp], fp32 when out_f32 != 0, else the type of x; counter: one int32,
// 0 at launch, the blocks' work counter.  Entries whose
// block id is >= num_sw write nothing; a unit of work is ``group``
// consecutive entries (sb % group == 0).  rows, box_w, nbox, stages and tma
// shape the ring (kernels/block_spmm.py:band_launch): a stage is A's rows
// [rows] of an entry as nbox boxes of box_w bytes, by tensor copies (tma: a
// 16-aligned, rb = bb / pack bytes a row with rb % 16 == 0, box_w a
// 16-multiple <= 256 and a power of two where nbox > 1, nbox * box_w >= rb)
// or by cp.async (box_w a 16-multiple >= rb, nbox 1); bb is a multiple of 4 *
// pack.  scale (may be null: the unscaled kernel): fp32 [scale_rows], a
// diagonal scale over x's rows and the superwindows' rows, applied to X's
// band rows in the sums and to each output row at its store (band_kernel's
// SCALED); ssw: int32 [sb], each entry's superwindow, whose rows' scales
// its block takes (sw itself in direct mode; bucket mode writes block i but
// scales it by superwindow ssw[i]'s rows).  Returns a cudaError_t
// (0 = launched).  The caller checks on the host that st + bb <= m for every
// entry, that sw lies in [0, num_sw], and that every output block it reads
// is written by exactly one entry; with scale, that scale_rows covers x's m
// rows.
extern "C" int hcspmm_band_spmm(const void* starts, const void* sw, const void* a,
                                const void* x, void* out, void* counter, int sb, int bh, int bb,
                                int dp, int num_sw, int group, int rows, int box_w, int nbox,
                                int stages, int tma, int pack, int x_bf16, int out_f32,
                                const void* scale, const void* ssw, long long scale_rows,
                                void* stream) {
  if (sb <= 0) return 0;
  if (counter == nullptr || group <= 0 || sb % group ||
      !ring_ok(a, sb, bh, bb, pack, dp, rows, box_w, nbox, stages, tma) ||
      (scale != nullptr && (ssw == nullptr || scale_rows <= 0)))
    return (int)cudaErrorInvalidValue;
  const BandArgs args{starts, sw, a, x, out, counter, sb, bh, bb, dp, num_sw, group, pack,
                      Ring{rows, box_w, nbox, stages, tma}, scale, ssw, scale_rows,
                      static_cast<cudaStream_t>(stream)};
  return (int)dispatch_types(x_bf16, out_f32, args);
}

// The current device's SMs, shared memory an SM, reserved a block and the
// most a block may opt in to (band_kernel's ring is sized from them on the
// host).  Returns a cudaError_t.
extern "C" int hcspmm_band_device(int* sms, int* per_sm, int* reserved, int* optin) {
  Device d;
  const cudaError_t e = device_of(&d);
  *sms = d.sms;
  *per_sm = d.per_sm;
  *reserved = d.reserved;
  *optin = d.optin;
  return (int)e;
}

// ptr: int32 [num_sw + 1] pair runs (non-decreasing, ptr[num_sw] = pairs);
// tile: int32 [pairs] 128-row X tile of each pair; a: [pairs, bh, 128] as
// stored, int8 (pack 1) or uint8 nibbles [pairs, bh, 64] (pack 2); x: [m,
// dp]; out: [num_sw, bh, dp] (types as hcspmm_band_spmm).  The caller
// checks on the host that every tile lies inside x and every run is
// non-empty (an empty superwindow has one zero pair).
extern "C" int hcspmm_tiled_spmm(const void* ptr, const void* tile, const void* a,
                                 const void* x, void* out, int num_sw, int bh, int dp, int pack,
                                 int x_bf16, int out_f32, void* stream) {
  if (num_sw <= 0) return 0;
  if (bh <= 0 || dp <= 0 || dp % 128 || (pack != 1 && pack != 2) ||
      (long long)num_sw * ((bh + ROWS - 1) / ROWS) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const TiledArgs args{ptr, tile, a, x, out, num_sw, bh, dp, pack,
                       static_cast<cudaStream_t>(stream)};
  return (int)dispatch_types(x_bf16, out_f32, args);
}

// starts, sw: int32 [sb]; a: [sb, bh, bb] as hcspmm_band_spmm's, stored at
// ``pack``; x: [m, dp]; w: [dp, hp] in
// x's type; agg: [rows, dp] and out: [rows, hp], fp32 when out_f32 != 0,
// else x's type; counter as hcspmm_band_spmm's.  Entries with sw >= num_sw
// write nothing.  band_fused_kernel: units of FR rows of an entry, A staged
// in tiles of ``arows`` rows shaped as hcspmm_band_spmm's ring stages
// (kernels/block_spmm.py:fused_launch).  ``blocks_per_sm`` (may be null)
// gets the resident blocks an SM the card's occupancy gave the launch, which
// sized its grid by them.  Returns a cudaError_t.
extern "C" int hcspmm_band_fused(const void* starts, const void* sw, const void* a,
                                 const void* x, const void* w, void* agg, void* out,
                                 void* counter, int sb, int bh, int bb, int dp, int hp,
                                 int num_sw, int arows, int box_w, int nbox, int tma, int pack,
                                 int x_bf16, int out_f32, int* blocks_per_sm, void* stream) {
  if (sb <= 0) return 0;
  if (counter == nullptr || sw == nullptr || w == nullptr || hp <= 0 ||
      !ring_ok(a, sb, bh, bb, pack, dp, arows, box_w, nbox, 2, tma))
    return (int)cudaErrorInvalidValue;
  const FusedArgs args{starts, sw, a, x, w, agg, out, counter, sb, bh, bb, dp, hp, num_sw, pack,
                       Tile{arows, box_w, nbox, tma}, blocks_per_sm,
                       static_cast<cudaStream_t>(stream)};
  return (int)dispatch_types(x_bf16, out_f32, args);
}
