// Transposed-band SpMM for Hopper (sm_90a), bound from Python with ctypes.
//
// tband_kernel replaces the Pallas kernels
// hcspmm_tpu/kernels/tband.py:tband_spmm_direct (pallas_call at :217) and
// :tband_spmm_bucket (:246), pack=1, and, in its fused forms (FUSE below),
// :tband_fused_direct (:309).  For entry i and a DT-row slab of the
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
// A_t comes in the plan's stored encoding (tband_kernel's PACK, the
// reference's tband_pack): 1, int8 [Sb, W, bh]; 2, uint8 [Sb, W, bh/2], the
// low nibble of byte j holding column j and the high nibble column j + bh/2;
// 8, uint8 [Sb, W/8, bh], bit g of byte row r holding row g*(W/8) + r.  The
// reference expands a packed block in the kernel body (_expand_a,
// tband.py:84); here the consumers read their columns' nibbles or bits from
// the packed stage itself, and nothing is expanded, in shared or global
// memory.  Each output element is the same fmaf chain over its non-zero rows
// in increasing k at every pack, so packs 2 and 8 give pack 1's output bit
// for bit.
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
// fmaf, as the first kernel did, so the fp32 result is its bit for bit (and
// the fused forms' aggregate), and repeatable.
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
//
// The packed stages.  Pack 2: a stage holds the slab's 64 rows of bh/2
// bytes, in boxes of CW = 128, 64, 32 or 16 bytes (the largest that divides
// bh/2; a 16-byte box takes no swizzle): half pack 1's bytes.  Each 16-column
// chunk of a warp lies in one half of the block, so its row-mask loads keep
// one nibble of each byte, and lane l shifts its column's nibble out of its
// byte.  Pack 8: logical rows [k0, k0 + 64) lie in byte rows (k0 + j) mod G
// (G = W/8) of planes (k0 + j) / G, in runs that end where a plane does; the
// producer copies each run to stage rows j onward in boxes of 64, 32, 16 or
// 8 rows (G is a multiple of 8, and 8 rows of a box are one swizzle atom), so
// stage row j holds logical row k0 + j in one of its bits.  The stage keeps
// pack 1's size; the eight reads of a byte row fall within one entry's walk
// and come from L2, so device memory gives W*bh/8 bytes of A_t an entry.
// Lane l tests bit (k0 + k) / G of its column's byte of row k (a multiply
// by G's reciprocal, no division and no shuffle).
//
// The scaled mode (SCALED, band form only: the normalised operator D A D X,
// D a diagonal fp32 scale over the M lanes, 1 on the pad lanes): the
// producer lands the stage's KT column scales, scale[st[i] + k0 ...], with
// its boxes (one 256-byte bulk copy, counted on the stage's barrier); lane l
// multiplies its x of row k by the row's scale as it reads it (a broadcast
// read of shared memory beside the x read), one multiply a row a lane ahead
// of the column loop, and each column's sums are multiplied by the output
// lane's scale, scale[ssw[i] * bh + c], at the store (0 past the scale:
// bucket mode's capacity padding, whose blocks the caller drops).  Read
// from global memory in the row loop instead, the scale's latency cost the
// kernel 20% at GH's gcn6 plan.
// x * scale rounds once, as the composed form's X * D does, and the sums
// are the same fmaf chains, so in fp32 a column's value equals the composed
// form's (D X, the unscaled kernel, times D) bit for bit.  The zero items
// stay zero.  The fused forms have no scaled mode (they run unnormalised).
//
// The fused forms (tband_fused_direct: agg^T as above and out^T = W^T
// round_as(agg^T), round_as the reference's agg.astype(wt.dtype)).  At the
// blocks stand-in (dt 32, ht 32) the update is 0.69 GFLOP, 0.010 ms at the
// fp32 FMA rate, beside the band's 0.103 ms of bytes and 43 MB more of
// out^T: the band bounds it, and the update must hide in it.  At dt 64 /
// ht 608 (a GCN backward with a wide input) it is 26 GFLOP, 0.39 ms: the
// FMAs bound it.  The first fused kernel gave each entry a block of bh threads and
// staged A_t and X^T synchronously, re-reading A_t for every 32-feature
// slab, with the whole aggregate and W^T in shared memory (one block an SM
// at dt 96): 0.508 ms at dt 32, 2.95 at dt 96.  Now the band kernel's ring
// does the band part unchanged, and the block's unit of work is the entry
// (or the (entry, 32-row out^T tile) pair), whose slabs it walks in order:
//   - ONE (one slab, ht <= 32) and SLAB (ht <= 32, more slabs; or any ht,
//     in 32-row tiles, past WHOLE's room): at each slab's end a warp stores
//     agg^T for its columns, then adds W^T[:, slab] round_as(agg^T) for
//     them into out^T's 32-row tile, two columns and HR rows a lane
//     (o[HR][2]: two FMAs a W^T value, W^T staged once a block as [dt][32
//     x tiles] fp32 where it fits beside two blocks an SM, else read
//     through L1).  SLAB keeps the tile in registers across the
//     slabs; ONE holds it only at the slab's end, so that the band's loop
//     keeps its registers.  No barrier: each warp owns its columns.
//   - WHOLE (ht > 32, where the entry's whole aggregate [bh][dt + 1] fits
//     one block): the slabs' sums stay in shared memory; at the entry's end
//     a barrier of the consumer warps, then each warp takes 8-row tiles of
//     out^T over all bh columns (8 x 4 a lane per 128 columns), so that each
//     W^T row is read by one warp (through L1, one broadcast load of two
//     features).
// The aggregate's sums are the band kernel's, so in fp32 it equals
// tband_spmm_direct's output bit for bit; each out^T element is one fmaf
// chain over d = 0, 1, ..., dt - 1.  Measured on an H100 80GB HBM3 at
// 700 W (throwaway builds, chip_smoke.py's shapes): the update's W^T read
// through L1 by every warp cost 0.063 ms at dt 32 / ht 32 (the band kernel
// 0.199, fused 0.273); staged in shared memory, the fused launch took
// 0.232.  WHOLE with W^T read by every warp for its own columns took 5.3
// ms at dt 64 / ht 608 (each warp re-read W^T's 155 KB from L2); split by
// out^T rows, 1.8.  ONE against SLAB in one slab (chip_smoke.py's forms
// A/B, dt 32 / ht 32, medians of 7 interleaved rounds): fp32 0.2304 against
// 0.2376 ms, bf16 0.2351 against 0.2470 (WHOLE 0.3853, 0.4186): SLAB's tile
// held across the band's loop spills 4-12 bytes at two blocks an SM; ONE's
// does not.

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

// The items of one thread block: items blockIdx.x, blockIdx.x + gridDim.x,
// ..., those of capacity-padding entries (sw >= num_sw) skipped; ``per``
// consecutive items share an entry.  The band kernel's item is (entry,
// feature slab), slab fastest (per = the slab count), one slab of ksteps =
// W/KT steps.  The fused kernel's item is the entry (per = 1) or (entry,
// 32-row tile of out^T) (per = the tile count), and it walks all ``slabs``
// of the features in order, ksteps steps each.  The producer and the
// consumers walk the same sequence.
struct Items {
  int item, nitems, per, ksteps, nsteps, step, num_sw;
  bool walk;  // the item walks every slab (fused) or is one slab (band)
  const int32_t* sw;

  __device__ Items(int nitems_, int per_, int ksteps_, int slabs, bool walk_, const int32_t* sw_,
                   int num_sw_)
      : item(blockIdx.x), nitems(nitems_), per(per_), ksteps(ksteps_), nsteps(ksteps_ * slabs),
        step(0), num_sw(num_sw_), walk(walk_), sw(sw_) {
    skip();
  }
  __device__ void skip() {
    while (item < nitems && sw != nullptr && sw[item / per] >= num_sw) item += gridDim.x;
  }
  __device__ bool valid() const { return item < nitems; }
  __device__ int entry() const { return item / per; }
  __device__ int sub() const { return item % per; }
  __device__ int d0(int dt_slab) const { return (walk ? step / ksteps : item % per) * dt_slab; }
  __device__ int k0() const { return step % ksteps * KT; }
  __device__ bool slab_end() const { return step % ksteps == ksteps - 1; }
  __device__ bool last_step() const { return step == nsteps - 1; }
  __device__ void next() {
    if (++step == nsteps) {
      step = 0;
      item += gridDim.x;
      skip();
    }
  }
};

// Bytes of W^T staged as [dt][wsm] fp32 (the fused kernel's SLAB and ONE).
__host__ __device__ constexpr int wt_bytes(int wsm, int dt) { return wsm * dt * 4; }

// Bytes of an A_t row as the packed block stores it: bh/2 at pack 2, else bh
// (pack 8 stages one byte row a logical row).
__host__ __device__ constexpr int a_row_bytes(int bh, int pack) { return pack == 2 ? bh / 2 : bh; }

// Shared memory of one block, from the first 1024-aligned address of the
// dynamic window (SWIZZLE_ATOM bytes are reserved for that): ``stages`` ring
// stages, each the A_t slab as rb/CW boxes [KT][CW] bytes (rb =
// a_row_bytes) and the X^T slab as
// KT/XW boxes [DT][XW] of TX (XW = 128 bytes of TX), all as the tensor
// copies land them; in the scaled mode, each stage's KT column scales (fp32,
// SCALE_BYTES a stage, outside the stages so that these keep the swizzle
// atom's alignment); then each consumer warp's sums, [COLS columns][stride]
// fp32, stride DT + 1 (the fused kernel's whole-entry form: dt + 1; the
// pad word makes both the by-feature updates and the by-column stores
// conflict-free); then the fused kernel's staged W^T (wt_bytes); then
// BAR_BYTES of mbarriers.
template <typename TX, int DT>
struct Layout {
  static constexpr int XW = 128 / (int)sizeof(TX);
  static constexpr int ACC_STRIDE = DT + 1;
  static constexpr int SCALE_BYTES = KT * (int)sizeof(float);
  static __host__ __device__ int stage_bytes(int rb) {
    return KT * rb + KT * DT * (int)sizeof(TX);
  }
  static __host__ __device__ int acc_bytes(int bh, int stride = ACC_STRIDE) {
    return bh * stride * (int)sizeof(float);
  }
  static __host__ __device__ size_t smem(int bh, int rb, int stages, int stride = ACC_STRIDE,
                                         int wsm = 0, int dt = 0, bool scaled = false) {
    return SWIZZLE_ATOM + (size_t)stages * (stage_bytes(rb) + (scaled ? SCALE_BYTES : 0)) +
           acc_bytes(bh, stride) + wt_bytes(wsm, dt) + BAR_BYTES;
  }
};

// v rounded to T and widened back: the reference's agg.astype(wt.dtype)
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// Four consecutive values of W^T (16 bytes of fp32, 8 of bf16), widened.
struct F4 {
  float v[4];
};
__device__ __forceinline__ F4 ldw4(const float* p) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  return F4{{q.x, q.y, q.z, q.w}};
}
__device__ __forceinline__ F4 ldw4(const __nv_bfloat16* p) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  return F4{{a.x, a.y, b.x, b.y}};
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The fused kernel's forms (tband_kernel's FUSE): the band product alone;
// out^T's 32-row tile kept in registers across the feature slabs, each
// slab's W^T product added at its end (SLAB); the whole entry's aggregate
// kept in shared memory and multiplied at the entry's end (WHOLE); or, for
// one slab of features and ht <= 32, the tile summed and stored at the
// slab's end, so that no register of it stays live across the band's loop
// (ONE).
constexpr int BAND = 0, SLAB = 1, WHOLE = 2, ONE = 3;
constexpr int HT_TILE = 32;  // out^T rows a consumer warp keeps in registers

// o[j][c] += sum_d W^T[h_j, d_lo + d] * round_as(agg[2cp + c][d]) for d in
// [0, dn), in increasing d, one fmaf chain an element: a consumer warp's
// share of the update, its columns' aggregate read from its sums ``acc``
// ([COLS][stride], column a_off = d_lo's feature).  Lane (cp, hg) owns
// columns 2cp and 2cp + 1 of the warp's COLS and rows h_j = h0 + hg*HR + j of
// out^T (HR = COLS/2: a warp covers HT_TILE rows); rows at or past ht add
// nothing.  W^T comes from shared memory where the block staged it (``wts``:
// [dt][hpad] fp32, rows past ht zero; HR/4 loads of four rows a feature),
// else from [ht, dt] ``wt`` through L1 (four features a load a row).
template <typename TX, int COLS>
__device__ __forceinline__ void wt_product(const float* acc, int stride, int a_off, int d_lo,
                                           int dn, const TX* __restrict__ wt, const float* wts,
                                           int hpad, int dt, int ht, int h0, int lane,
                                           float (&o)[COLS / 2][2]) {
  constexpr int HR = COLS / 2;
  const int cp = lane % (COLS / 2), hg = lane / (COLS / 2);
  const float* a0 = acc + 2 * cp * stride + a_off;
  const float* a1 = a0 + stride;
  const int hb = h0 + hg * HR;
  for (int d = 0; d < dn; d += 4) {
    float x0[4], x1[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x0[q] = round_as(a0[d + q], wt);
      x1[q] = round_as(a1[d + q], wt);
    }
    if (wts != nullptr) {
      const float* wd = wts + (long long)(d_lo + d) * hpad + hb;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j4 = 0; j4 < HR; j4 += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(wd + q * hpad + j4);
          const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            o[j4 + j][0] = fmaf(wv[j], x0[q], o[j4 + j][0]);
            o[j4 + j][1] = fmaf(wv[j], x1[q], o[j4 + j][1]);
          }
        }
      }
    } else {
      const TX* wrow = wt + (long long)hb * dt + d_lo + d;
#pragma unroll
      for (int j = 0; j < HR; ++j) {
        if (hb + j < ht) {
          const F4 w4 = ldw4(wrow + (long long)j * dt);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            o[j][0] = fmaf(w4.v[q], x0[q], o[j][0]);
            o[j][1] = fmaf(w4.v[q], x1[q], o[j][1]);
          }
        }
      }
    }
  }
}

// Stores a warp's o (wt_product's ownership) into out^T's rows [h0, h0 +
// HT_TILE) below ht, at the warp's columns from ``cols`` (a pointer to
// column COLS*warp of out^T's row 0).
template <typename TO, int COLS>
__device__ __forceinline__ void store_tile(TO* cols, long long out_cols, int ht, int h0, int lane,
                                           const float (&o)[COLS / 2][2]) {
  constexpr int HR = COLS / 2;
  const int cp = lane % (COLS / 2), hb = h0 + lane / (COLS / 2) * HR;
#pragma unroll
  for (int j = 0; j < HR; ++j)
    if (hb + j < ht) store2(cols + (long long)(hb + j) * out_cols + 2 * cp, o[j][0], o[j][1]);
}

// Two consecutive values of W^T, widened (a warp-uniform address: one
// broadcast load).
__device__ __forceinline__ float2 ldw2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldw2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

// A_t's tensor maps (tband_kernel's ``amaps``): boxes of KT, KT/2, KT/4 and
// KT/8 rows at pack 8; packs 1 and 2 take the one map of KT rows, so their
// parameter block holds no unused maps.
template <int PACK>
struct AMaps {
  static constexpr int N = PACK == 8 ? 4 : 1;
  CUtensorMap m[N];
};

// The consumer warps' barrier (the producer warp takes no part).
__device__ __forceinline__ void consumer_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

// WHOLE's update of one entry, once every consumer warp's sums of all dt
// features are in ``sums`` (column c of the block at c * stride): out^T =
// W^T round_as(agg^T), split by rows of out^T so that each row of W^T is
// read by one warp.  Warp ``warp`` of ``nwarps`` takes the 8-row tiles
// warp, warp + nwarps, ...; per 128 columns lane l keeps 8 rows x 4 columns
// (l + 32 i) in registers and walks d in increasing order, two features at
// a time (W^T's two values one broadcast load, the sums one conflict-free
// load a column).  ``cols``: out^T's row 0 at the block's first column.
template <typename TX, typename TO>
__device__ __forceinline__ void whole_product(const float* sums, int stride, int bh, int dt,
                                              int ht, const TX* __restrict__ wt, TO* cols,
                                              long long out_cols, int warp, int nwarps,
                                              int lane) {
  for (int h0 = 8 * warp; h0 < ht; h0 += 8 * nwarps) {
    const TX* wrow = wt + (long long)h0 * dt;
    for (int cb = 0; cb < bh; cb += 128) {
      float o[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
      const float* a_c = sums + (cb + lane) * stride;
      const int ncol = min(4, (bh - cb) / 32);
      for (int d = 0; d < dt; d += 2) {
        float2 wv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) wv[j] = ldw2(wrow + (long long)j * dt + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i < ncol) {
            const float x0 = round_as(a_c[32 * i * stride + d], wt);
            const float x1 = round_as(a_c[32 * i * stride + d + 1], wt);
#pragma unroll
            for (int j = 0; j < 8; ++j) o[j][i] = fmaf(wv[j].y, x1, fmaf(wv[j].x, x0, o[j][i]));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < ncol) store(cols + (long long)(h0 + j) * out_cols + cb + lane + 32 * i, o[j][i]);
    }
  }
}

// Grid: persistent, a few blocks an SM (launch_config, fused_config).
// Block: bh/COLS consumer warps and a producer warp, whose first lane
// produces.  Consumer warp w owns output columns [COLS w, COLS w + COLS)
// (COLS 16 up to bh 256, twice the warps to share a stage's uneven rows;
// else 32): for A_t reads lane l < COLS stands for column COLS w + l, for
// X^T reads and sums lane l stands for feature row d0 + l.
// ``amaps``: A_t as PACK stores it, [Sb*W rows, bh] int8 (PACK 1), [Sb*W,
// bh/2] (2) or [Sb*W/8, bh] (8) bytes, boxes of cw bytes a row (swizzled
// as wide, none at 16) and KT rows (m[0]; pack 8 also KT/2, KT/4 and KT/8:
// m[1..3]); ``xmap``: X^T as [dt rows, M] of TX, box [DT][XW], 128-byte
// swizzle.  ``w`` and ``bh`` are the logical block's.
// Direct mode only: ``miss8`` (n8 ids, runs of eight superwindows) and
// ``miss1`` (n1 ids) name the superwindows no entry owns.  Their blocks are
// zero items, (superwindow, feature slab) pairs the consumers of block b
// write first (items b, b + gridDim.x, ...), while the producer fills the
// ring: each warp stores zeros over rows of [DT][bh], 16 bytes a lane.  They
// take no copy and no stage.
// FUSE != BAND (tband_fused_direct; direct mode, no zero items): ``out`` is
// agg^T, and ``wt`` [ht, dt] and ``wout`` (out^T [ht, out_cols]) the
// update's.  Items as the Items note says: per = htiles (SLAB) or 1
// (WHOLE).  SLAB: after each slab a warp stores its agg^T (tile 0 only),
// adds the slab's share of its out^T tile h0 = 32 * tile (wt_product) into
// registers, and stores the tile after the last slab.  WHOLE: the sums of
// slab d0 land at column d0 of a stride of dt + 1, and after the last slab
// the warp runs wt_product over all dt for each 32-row tile of out^T.
// SCALED (FUSE == BAND only): ``scale`` fp32 [scale_n] over X^T's lanes and
// the output's, ``ssw`` [sb] each entry's superwindow (sw in direct mode),
// as the scaled mode's note says.
template <typename TX, typename TO, int DT, int COLS, int FUSE, int PACK, bool SCALED>
__global__ void __launch_bounds__(MAX_BH + 32, (FUSE == SLAB || FUSE == ONE) && COLS == 16 ? 2 : 1)
tband_kernel(const __grid_constant__ AMaps<PACK> amaps, const __grid_constant__ CUtensorMap xmap,
             const int32_t* __restrict__ starts, const int32_t* __restrict__ sw,
             const int32_t* __restrict__ miss8, int n8, const int32_t* __restrict__ miss1,
             int n1, TO* __restrict__ out, int sb, int w, int bh, int cw, int nchunk,
             long long out_cols, int num_sw, int stages, const TX* __restrict__ wt,
             TO* __restrict__ wout, int ht, int htiles, int wsm, const float* __restrict__ scale,
             const int32_t* __restrict__ ssw, long long scale_n) {
  static_assert(!SCALED || FUSE == BAND, "only the band form has a scaled mode");
  using L = Layout<TX, DT>;
  constexpr int XW = L::XW;
  extern __shared__ __align__(16) unsigned char tband_smem[];
  unsigned char* ring =
      tband_smem + ((SWIZZLE_ATOM - smem_addr(tband_smem) % SWIZZLE_ATOM) % SWIZZLE_ATOM);
  const int rb = a_row_bytes(bh, PACK);
  const int stage_bytes = L::stage_bytes(rb);
  const int dt = nchunk * DT;
  const int stride = FUSE == WHOLE ? dt + 1 : L::ACC_STRIDE;
  // SCALED: each stage's X^T column scales, [stages][KT] fp32
  float* xscales = reinterpret_cast<float*>(ring + stages * stage_bytes);
  float* sums = xscales + (SCALED ? stages * KT : 0);
  // SLAB, ONE: W^T staged as [dt][wsm] fp32 (wsm = 32 * htiles), or none
  float* wts = wsm ? sums + bh * stride : nullptr;
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(sums) +
                                               L::acc_bytes(bh, stride) + wt_bytes(wsm, dt));
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
  if (FUSE != BAND && wts != nullptr)
    for (int e = threadIdx.x; e < wsm * dt; e += blockDim.x) {
      const int h = e / dt, d = e % dt;
      wts[d * wsm + h] = h < ht ? to_f32(wt[e]) : 0.f;
    }
  __syncthreads();  // the only block-wide barrier: the mbarriers (and W^T) exist

  const int ksteps = w / KT;
  const int per = FUSE == BAND ? nchunk : htiles;
  auto items = [&]() {
    return Items(sb * per, per, ksteps, FUSE == BAND ? 1 : nchunk, FUSE != BAND, sw, num_sw);
  };
  if (warp == nwarps) {
    // ---- producer: one lane issues every copy ----
    if (lane != 0) return;
    Items it = items();
    for (int t = 0; it.valid(); ++t) {
      const int slot = t % stages;
      // step t reuses the stage of step t - stages
      if (t >= stages) bar_wait(&empty[slot], (t / stages - 1) & 1);
      fence_proxy_async();
      unsigned char* a_dst = ring + slot * stage_bytes;
      unsigned char* x_dst = a_dst + KT * rb;
      const int i = it.entry(), k0 = it.k0(), x0 = starts[i] + k0;
      bar_arrive_expect(&full[slot], stage_bytes + (SCALED ? L::SCALE_BYTES : 0));
      if constexpr (SCALED)
        bulk_load(xscales + slot * KT, scale + x0, L::SCALE_BYTES, &full[slot]);
      if constexpr (PACK == 8) {
        // logical row k0 + j: byte row (k0 + j) % G of plane (k0 + j) / G; each
        // run of byte rows up to a plane's end lands at stage rows j onward
        const int G = w / 8;
        for (int j = 0; j < KT;) {
          int r = (k0 + j) % G;
          for (int len = min(KT - j, G - r); len > 0;) {
            const int q = len >= KT ? 0 : len >= KT / 2 ? 1 : len >= KT / 4 ? 2 : 3;
            for (int c = 0; c < rb; c += cw)
              tensor_load(a_dst + KT * c + j * cw, &amaps.m[q], c, i * G + r, &full[slot]);
            j += KT >> q, r += KT >> q, len -= KT >> q;
          }
        }
      } else {
        for (int c = 0; c < rb; c += cw)
          tensor_load(a_dst + KT * c, &amaps.m[0], c, i * w + k0, &full[slot]);
      }
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
  Items it = items();
  const int amask = cw / 16 - 1;  // 0 for 16-byte boxes: no swizzle
  // Column c's byte in each stage row: c, or (pack 2) c - bh/2 for the high
  // nibbles' half; byte b lies in box b / cw (at KT * cw bytes a box), at
  // column b % cw.  At packs 1 and 8 the warp's columns lie in one box
  // (``wbox``) at bytes c0 + j; at pack 2 each 16-column chunk h of the row
  // masks lies mbox[h] bytes past it, at bytes mcol[h] + j, and lane l's
  // column lbox bytes past it, at byte lcol.
  auto a_byte = [&](int c) { return PACK == 2 && c >= bh / 2 ? c - bh / 2 : c; };
  const int wbox = warp * COLS / cw * KT * cw, c0 = warp * COLS % cw;
  int mbox[COLS / 16], mcol[COLS / 16];
  unsigned mkeep[COLS / 16];  // the bits of a chunk's bytes that hold its columns
#pragma unroll
  for (int h = 0; h < COLS / 16; ++h) {
    const int c = warp * COLS + 16 * h, b = a_byte(c);
    mbox[h] = PACK == 2 ? b / cw * KT * cw - wbox : 0;
    mcol[h] = PACK == 2 ? b % cw : c0 + 16 * h;
    mkeep[h] = PACK != 2 ? 0xffffffffu : c < bh / 2 ? 0x0f0f0f0fu : 0xf0f0f0f0u;
  }
  const int lb = a_byte(warp * COLS + (lane < COLS ? lane : 0));
  const int lbox = lb / cw * KT * cw - wbox, lcol = PACK == 2 ? lb % cw : lb - warp * COLS + c0;
  const int lshift = PACK == 2 && warp * COLS + lane >= bh / 2 ? 4 : 0;
  // pack 8: the plane of logical row k is k / G = __umulhi(k, gdiv), exact
  // for k < W (G = W/8 >= 8: the product's error stays below 1/G)
  const unsigned gdiv = PACK == 8 ? 0xffffffffu / (unsigned)(w / 8) + 1u : 0u;
  const int xrow = lane * 128;  // feature row ``lane`` in an X^T box, before the swizzle
  float* acc = sums + warp * COLS * stride;  // [column][feature]
  for (int c = 0; c < COLS; ++c)
    for (int d = lane; d < stride - 1; d += 32) acc[c * stride + d] = 0.f;
  float o[COLS / 2][2] = {};  // SLAB: this warp's share of the out^T tile
  for (int t = 0; it.valid(); ++t) {
    const int slot = t % stages;
    bar_wait(&full[slot], (t / stages) & 1);
    const unsigned char* a_s = ring + slot * stage_bytes + wbox;  // this warp's box
    const unsigned char* x_s = ring + slot * stage_bytes + KT * rb;
    // the slab's sums: columns [0, DT) of acc, or [d0, d0 + DT) (WHOLE)
    float* acc_s = acc + (FUSE == WHOLE ? it.d0(DT) : 0);
    // pack 8: the planes of logical rows k0 + lane and k0 + lane + 32
    const unsigned k0 = it.k0();
    const int plane_lo = PACK == 8 ? __umulhi(k0 + lane, gdiv) : 0;
    const int plane_hi = PACK == 8 ? __umulhi(k0 + lane + 32, gdiv) : 0;
    // rows of this stage in which any of the warp's columns is non-zero
    unsigned any_lo = 0u, any_hi = 0u;
#pragma unroll
    for (int h = 0; h < COLS / 16; ++h) {
      const uint4 p = lds128(a_s + mbox[h] + swz(lane * cw + mcol[h], amask));
      const uint4 r = lds128(a_s + mbox[h] + swz((lane + 32) * cw + mcol[h], amask));
      const unsigned keep_lo = PACK == 8 ? 0x01010101u << plane_lo : mkeep[h];
      const unsigned keep_hi = PACK == 8 ? 0x01010101u << plane_hi : mkeep[h];
      any_lo |= (p.x | p.y | p.z | p.w) & keep_lo;
      any_hi |= (r.x | r.y | r.z | r.w) & keep_hi;
    }
    const unsigned lo = __ballot_sync(0xffffffffu, any_lo != 0u);
    const unsigned hi = __ballot_sync(0xffffffffu, any_hi != 0u);
    unsigned long long rows = lo | (unsigned long long)hi << 32;
    // column COLS w + lane's value in row k (its byte, nibble or bit), and
    // feature row ``lane``'s x of it
    // (Pack 1 predicates the load on lane < COLS; packs 2 and 8 load in
    // every lane, those past COLS their warp's first column, and select:
    // the predicated form compiles to a branch around their longer
    // extraction, which made the row loop slower on the card, as the select
    // did pack 1's.)
    auto byte_of = [&](int k) {
      if constexpr (PACK == 1) {
        return lane < COLS ? (int)static_cast<int8_t>(a_s[swz(k * cw + lcol, amask)]) : 0;
      } else {
        const int b = a_s[lbox + swz(k * cw + lcol, amask)];
        const int v = PACK == 2 ? (b >> lshift) & 15 : (b >> __umulhi(k0 + k, gdiv)) & 1;
        return lane < COLS ? v : 0;
      }
    };
    const float* xsc = xscales + slot * KT;  // SCALED: the stage's X^T column scales
    auto x_of = [&](int k) {
      if (lane >= DT) return 0.f;
      const float x = to_f32(*reinterpret_cast<const TX*>(
          x_s + k / XW * DT * 128 + swz(xrow + k % XW * (int)sizeof(TX), 7)));
      if constexpr (SCALED)
        return x * xsc[k];
      else
        return x;
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
            float* s_cd = acc_s + c * stride + lane;
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
    if (it.slab_end()) {
      // column COLS w + lane's sums, one feature row a store
      const int i = it.entry(), d0 = it.d0(DT);
      const long long col0 = (long long)(sw != nullptr ? sw[i] : i) * bh + warp * COLS;
      if (FUSE == BAND || it.sub() == 0) {
        TO* o_col = out + col0 + lane;
        if (lane < COLS) {
          float rs = 1.f;  // SCALED: the output lane's scale
          if constexpr (SCALED) {
            const long long r = (long long)ssw[i] * bh + warp * COLS + lane;
            rs = r < scale_n ? __ldg(scale + r) : 0.f;
          }
#pragma unroll 4
          for (int d = 0; d < DT; ++d) {
            const float v = acc_s[lane * stride + d];
            store(o_col + (long long)(d0 + d) * out_cols, SCALED ? v * rs : v);
            if (FUSE == BAND) acc_s[lane * stride + d] = 0.f;
          }
        }
      }
      if constexpr (FUSE == SLAB) {
        __syncwarp();
        const int h0 = it.sub() * HT_TILE;
        wt_product<TX, COLS>(acc, stride, 0, d0, DT, wt, wts, wsm, dt, ht, h0, lane, o);
        __syncwarp();
        if (lane < COLS)
          for (int d = 0; d < DT; ++d) acc[lane * stride + d] = 0.f;
        if (it.last_step()) {
          store_tile<TO, COLS>(wout + col0, out_cols, ht, h0, lane, o);
#pragma unroll
          for (int j = 0; j < COLS / 2; ++j) o[j][0] = o[j][1] = 0.f;
        }
      }
      if constexpr (FUSE == ONE) {
        __syncwarp();
        float o1[COLS / 2][2] = {};
        wt_product<TX, COLS>(acc, stride, 0, 0, DT, wt, wts, wsm, dt, ht, 0, lane, o1);
        store_tile<TO, COLS>(wout + col0, out_cols, ht, 0, lane, o1);
        __syncwarp();
        if (lane < COLS)
          for (int d = 0; d < DT; ++d) acc[lane * stride + d] = 0.f;
      }
      if constexpr (FUSE == WHOLE) {
        if (it.last_step()) {
          consumer_sync(nwarps * 32);  // every column's sums are in
          whole_product<TX, TO>(sums, stride, bh, dt, ht, wt,
                                wout + (long long)(sw != nullptr ? sw[i] : i) * bh, out_cols,
                                warp, nwarps, lane);
          consumer_sync(nwarps * 32);  // no warp reads them any more
          for (int c = 0; c < COLS; ++c)
            for (int d = lane; d < dt; d += 32) acc[c * stride + d] = 0.f;
        }
      }
      __syncwarp();
    }
    it.next();
  }
}

// Consumer columns a warp at band height bh (tband_kernel's COLS).
constexpr int cols_of(int bh) { return bh <= 256 ? 16 : 32; }

// Stages, shared memory and resident blocks an SM of the band form
// tband_kernel<TX, TO, DT, cols_of(bh), BAND, PACK, SCALED> at band height
// bh on the current device: as many stages (2..MAX_STAGES) as leave two
// blocks an SM in shared memory.  Kept per instantiation, band height and
// device, so a launch queries nothing.
struct Config {
  int dev = -1, stages = 0, blocks_per_sm = 0, sms = 0;
  size_t smem = 0;
};

template <typename TX, typename TO, int DT, int COLS, int PACK, bool SCALED>
cudaError_t launch_config(int bh, Config* cfg) {
  using L = Layout<TX, DT>;
  const int rb = a_row_bytes(bh, PACK);
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
  const long long fit = ((long long)per_sm / 2 - reserved - (long long)L::smem(bh, rb, 0)) /
                        (L::stage_bytes(rb) + (SCALED ? L::SCALE_BYTES : 0));
  const int stages = (int)(fit < 2 ? 2 : fit > MAX_STAGES ? MAX_STAGES : fit);
  const size_t smem = L::smem(bh, rb, stages, L::ACC_STRIDE, 0, 0, SCALED);
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  auto kernel = tband_kernel<TX, TO, DT, COLS, BAND, PACK, SCALED>;
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

// One launch's operands: A_t (PACK's encoding) and its logical shape [sb,
// w, bh], X^T [dt, m], the output's columns, the superwindows; the scaled
// mode's scale [scale_n] and each entry's superwindow ssw (scale null: the
// unscaled kernel).
struct Operands {
  const void *starts, *sw, *at, *xt;
  void* out;
  int sb, w, bh, dt, pack;
  long long m, out_cols;
  int num_sw;
  const float* scale;
  const int32_t* ssw;
  long long scale_n;
};

// The superwindows a direct launch zeroes (tband_kernel's zero items).
struct Missing {
  const int32_t *ids8, *ids1;
  int n8, n1;
};

// The fused launch's arguments beyond the band kernel's (FUSE != BAND):
// W^T, out^T, its rows, the out^T tiles an entry is dealt in (SLAB) and the
// ring stages, sized on the host (kernels/tband.py:fused_launch); and where
// the launch reports the resident blocks an SM it was sized for (or null).
struct Fused {
  const void* wt;
  void* wout;
  int ht, htiles, stages, wsm;
  int* blocks_out;
};

// Resident blocks an SM of the fused kernel tband_kernel<TX, TO, DT, COLS,
// FUSE, PACK> with ``smem`` bytes of dynamic shared memory on the current
// device, and the device's SMs; the kernel's shared-memory cap is raised to
// the device's opt-in most on first use.
template <typename TX, typename TO, int DT, int COLS, int FUSE, int PACK>
cudaError_t fused_blocks(int bh, size_t smem, int* blocks, int* sms) {
  static int opted[16] = {};
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (smem > (size_t)optin || dev >= 16) return cudaErrorInvalidValue;
  auto kernel = tband_kernel<TX, TO, DT, COLS, FUSE, PACK, false>;
  if (!opted[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return e;
    opted[dev] = 1;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, bh / COLS * 32 + 32, smem);
  if (e != cudaSuccess) return e;
  return *blocks < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// Dynamic shared memory of the fused kernel in form ``fuse`` with ``stages``
// ring stages (kernels/tband.py:fused_launch mirrors it).
template <typename TX, int DT>
size_t fused_smem(int fuse, int bh, int pack, int dt, int stages, int wsm) {
  return Layout<TX, DT>::smem(bh, a_row_bytes(bh, pack), stages,
                              fuse == WHOLE ? dt + 1 : DT + 1, wsm, dt);
}

template <typename TX, typename TO, int DT, int COLS, int FUSE, int PACK, bool SCALED>
cudaError_t launch_cols(const Operands& o, Missing miss, Fused f, cudaStream_t stream) {
  const int sb = o.sb, w = o.w, bh = o.bh, dt = o.dt;
  int stages = 0, blocks = 0, sms = 0;
  size_t smem = 0;
  cudaError_t e;
  if constexpr (FUSE == BAND) {
    Config c;
    e = launch_config<TX, TO, DT, COLS, PACK, SCALED>(bh, &c);
    stages = c.stages, blocks = c.blocks_per_sm, sms = c.sms, smem = c.smem;
  } else {
    stages = f.stages;
    smem = fused_smem<TX, DT>(FUSE, bh, PACK, dt, stages, f.wsm);
    e = fused_blocks<TX, TO, DT, COLS, FUSE, PACK>(bh, smem, &blocks, &sms);
    if (e == cudaSuccess && f.blocks_out != nullptr) *f.blocks_out = blocks;
  }
  if (e != cudaSuccess) return e;
  // A_t's boxes: the widest of 128, 64, 32 or 16 bytes that divides a stored
  // row, with the swizzle of its width (none at 16)
  const int rb = a_row_bytes(bh, PACK);
  const int cw = rb % 128 == 0 ? 128 : rb % 64 == 0 ? 64 : rb % 32 == 0 ? 32 : 16;
  const CUtensorMapSwizzle aswz = cw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : cw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                  : cw == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                             : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUtensorMapDataType xtype =
      sizeof(TX) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  AMaps<PACK> amaps = {};  // no entry (only zero items): no copy reads them
  CUtensorMap xmap = {};
  const long long a_rows = (long long)sb * (PACK == 8 ? w / 8 : w);
  if (sb > 0) {
    bool ok = encode_2d(&xmap, xtype, (int)sizeof(TX), o.xt, dt, o.m, DT, Layout<TX, DT>::XW,
                        CU_TENSOR_MAP_SWIZZLE_128B);
    for (int q = 0; q < AMaps<PACK>::N; ++q)
      ok = ok && encode_2d(&amaps.m[q], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, o.at, a_rows, rb,
                           KT >> q, cw, aswz);
    if (!ok) return cudaErrorInvalidValue;
  }
  const int nchunk = dt / DT;
  const long long items = FUSE == BAND ? ((long long)sb + 8LL * miss.n8 + miss.n1) * nchunk
                                       : (long long)sb * (FUSE == SLAB ? f.htiles : 1);
  const long long slots = (long long)blocks * sms;
  tband_kernel<TX, TO, DT, COLS, FUSE, PACK, SCALED>
      <<<(unsigned)(items < slots ? items : slots), bh / COLS * 32 + 32, smem, stream>>>(
          amaps, xmap, static_cast<const int32_t*>(o.starts), static_cast<const int32_t*>(o.sw),
          miss.ids8, miss.n8, miss.ids1, miss.n1, static_cast<TO*>(o.out), sb, w, bh, cw, nchunk,
          o.out_cols, o.num_sw, stages, static_cast<const TX*>(f.wt), static_cast<TO*>(f.wout),
          f.ht, f.htiles, f.wsm, o.scale, o.ssw, o.scale_n);
  return cudaGetLastError();
}

template <typename TX, typename TO, int DT, int FUSE, int PACK, bool SCALED>
cudaError_t launch_pack(const Operands& o, Missing miss, Fused f, cudaStream_t stream) {
  if (cols_of(o.bh) == 16)
    return launch_cols<TX, TO, DT, 16, FUSE, PACK, SCALED>(o, miss, f, stream);
  return launch_cols<TX, TO, DT, 32, FUSE, PACK, SCALED>(o, miss, f, stream);
}

template <typename TX, typename TO, int DT, int FUSE, bool SCALED>
cudaError_t launch(const Operands& o, Missing miss, Fused f, cudaStream_t stream) {
  if (o.pack == 2) return launch_pack<TX, TO, DT, FUSE, 2, SCALED>(o, miss, f, stream);
  if (o.pack == 8) return launch_pack<TX, TO, DT, FUSE, 8, SCALED>(o, miss, f, stream);
  return launch_pack<TX, TO, DT, FUSE, 1, SCALED>(o, miss, f, stream);
}

template <typename TX, typename TO, int DT, int PACK, bool SCALED>
cudaError_t config_cols(int bh, Config* c) {
  return cols_of(bh) == 16 ? launch_config<TX, TO, DT, 16, PACK, SCALED>(bh, c)
                           : launch_config<TX, TO, DT, 32, PACK, SCALED>(bh, c);
}

template <typename TX, typename TO, int DT, bool SCALED>
cudaError_t config_of(int bh, int pack, Config* c) {
  return pack == 2   ? config_cols<TX, TO, DT, 2, SCALED>(bh, c)
         : pack == 8 ? config_cols<TX, TO, DT, 8, SCALED>(bh, c)
                     : config_cols<TX, TO, DT, 1, SCALED>(bh, c);
}

// The fused forms and the band form unscaled, or the band form's scaled
// mode where the operands carry a scale (only it is instantiated SCALED).
template <typename TX, typename TO, int DT>
cudaError_t launch_fuse(int fuse, const Operands& o, Missing miss, Fused f, cudaStream_t stream) {
  if (fuse == ONE) return launch<TX, TO, DT, ONE, false>(o, miss, f, stream);
  if (fuse == SLAB) return launch<TX, TO, DT, SLAB, false>(o, miss, f, stream);
  if (fuse == WHOLE) return launch<TX, TO, DT, WHOLE, false>(o, miss, f, stream);
  if (o.scale != nullptr) return launch<TX, TO, DT, BAND, true>(o, miss, f, stream);
  return launch<TX, TO, DT, BAND, false>(o, miss, f, stream);
}

template <typename TX, typename TO>
cudaError_t dispatch_dt(int fuse, const Operands& o, Missing miss, Fused f, cudaStream_t stream) {
  if (o.dt % 32 == 0) return launch_fuse<TX, TO, 32>(fuse, o, miss, f, stream);
  return launch_fuse<TX, TO, 16>(fuse, o, miss, f, stream);
}

// The band or fused launch for the (X, out) type pair: fp32 -> fp32,
// bf16 -> bf16 or bf16 -> fp32.
cudaError_t launch_types(int fuse, const Operands& o, Missing miss, Fused f, int x_bf16,
                         int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_bf16) {
    if (!out_f32) return cudaErrorInvalidValue;
    return dispatch_dt<float, float>(fuse, o, miss, f, s);
  }
  if (out_f32) return dispatch_dt<__nv_bfloat16, float>(fuse, o, miss, f, s);
  return dispatch_dt<__nv_bfloat16, __nv_bfloat16>(fuse, o, miss, f, s);
}

// The checks both entries make: the shapes the kernel takes, and the
// 16-byte alignment its bulk copies need (A_t rows then are, as bh % 32 == 0,
// and X^T's pieces, as st % 128 == 0, checked at upload).
bool shapes_ok(int w, int bh, int dt, int pack) {
  return dt > 0 && dt % 16 == 0 && w > 0 && w % KT == 0 && bh > 0 && bh % 32 == 0 &&
         bh <= MAX_BH && (pack == 1 || pack == 2 || pack == 8);
}
bool aligned(const void* at, const void* xt, long long m, int x_bf16) {
  return (uintptr_t)at % 16 == 0 && (uintptr_t)xt % 16 == 0 && m * (x_bf16 ? 2 : 4) % 16 == 0;
}

// hcspmm_tband_config's types and mode.
template <bool SCALED>
cudaError_t config_types(int bh, int dt, int pack, int x_bf16, int out_f32, Config* c) {
  if (!x_bf16)
    return dt % 32 ? config_of<float, float, 16, SCALED>(bh, pack, c)
                   : config_of<float, float, 32, SCALED>(bh, pack, c);
  if (out_f32)
    return dt % 32 ? config_of<__nv_bfloat16, float, 16, SCALED>(bh, pack, c)
                   : config_of<__nv_bfloat16, float, 32, SCALED>(bh, pack, c);
  return dt % 32 ? config_of<__nv_bfloat16, __nv_bfloat16, 16, SCALED>(bh, pack, c)
                 : config_of<__nv_bfloat16, __nv_bfloat16, 32, SCALED>(bh, pack, c);
}

}  // namespace

// starts, sw: int32 [sb] (sw may be null: bucket mode); at: the [sb, w, bh]
// 0/1 blocks as ``pack`` stores them (1: int8 [sb, w, bh]; 2: uint8 [sb, w,
// bh/2], nibbles; 8: uint8 [sb, w/8, bh], bits); xt: [dt, m] fp32 (x_bf16 ==
// 0) or bf16; out: [dt, out_cols], fp32 when out_f32 != 0, else the type of
// xt.  Direct mode also zeroes the blocks of the missing superwindows:
// columns [8*bh*miss8[i], +8*bh) and [bh*miss1[i], +bh) of every row (miss8:
// int32 [n8], miss1: int32 [n1]; null when empty).  scale (may be null: the
// unscaled kernel): fp32 [scale_n], a diagonal D over xt's lanes and the
// superwindows' output lanes; ssw: int32 [sb], each entry's superwindow
// (sw in direct mode); entry i's block is then (X^T D)[:, st[i] : st[i] + w]
// @ A_t[i], its column c times scale[ssw[i] * bh + c] (0 past scale_n).  Returns a
// cudaError_t (0 = launched).  The caller guarantees st + w <= m for every
// entry, that every output block it reads is written by exactly one entry or
// missing id, that the ids lie inside out, and, with scale, that scale_n
// covers xt's m lanes.
extern "C" int hcspmm_tband_spmm(const void* starts, const void* sw, const void* at,
                                 const void* xt, void* out, int sb, int w, int bh, int dt,
                                 long long m, long long out_cols, int num_sw, const void* miss8,
                                 int n8, const void* miss1, int n1, int pack, int x_bf16,
                                 int out_f32, const void* scale, const void* ssw,
                                 long long scale_n, void* stream) {
  if (sb <= 0 && n8 <= 0 && n1 <= 0) return 0;
  if (sb < 0 || n8 < 0 || n1 < 0 || !shapes_ok(w, bh, dt, pack) ||
      ((n8 || n1) && sw == nullptr) ||
      (scale != nullptr && (ssw == nullptr || scale_n < m || (uintptr_t)scale % 16)))
    return (int)cudaErrorInvalidValue;
  // the zero items store 16 bytes a lane
  if (!aligned(at, xt, m, x_bf16) || (uintptr_t)out % 16) return (int)cudaErrorInvalidValue;
  const Missing miss{static_cast<const int32_t*>(miss8), static_cast<const int32_t*>(miss1), n8,
                     n1};
  return launch_types(BAND, Operands{starts, sw, at, xt, out, sb, w, bh, dt, pack, m, out_cols,
                                     num_sw, static_cast<const float*>(scale),
                                     static_cast<const int32_t*>(ssw), scale_n},
                      miss, Fused{nullptr, nullptr, 0, 1, 0, 0, nullptr}, x_bf16, out_f32, stream);
}

// The band kernel's launch configuration at band height bh, feature dim dt,
// A_t encoding ``pack``, the given types and its scaled mode (scaled != 0)
// or not on the current device: ring stages, dynamic shared memory bytes and
// resident blocks an SM.  Returns a cudaError_t.
extern "C" int hcspmm_tband_config(int bh, int dt, int pack, int x_bf16, int out_f32, int scaled,
                                   int* stages, long long* smem, int* blocks_per_sm) {
  if (!shapes_ok(KT, bh, dt, pack) || (!x_bf16 && !out_f32)) return (int)cudaErrorInvalidValue;
  Config c;
  const cudaError_t e = scaled ? config_types<true>(bh, dt, pack, x_bf16, out_f32, &c)
                               : config_types<false>(bh, dt, pack, x_bf16, out_f32, &c);
  *stages = c.stages;
  *smem = (long long)c.smem;
  *blocks_per_sm = c.blocks_per_sm;
  return (int)e;
}

// starts, sw: int32 [sb]; at: as hcspmm_tband_spmm's, in encoding ``pack``;
// xt: [dt, m] fp32 or bf16; wt: [ht, dt] in xt's type; agg: [dt, out_cols]
// and out: [ht, out_cols], fp32 when out_f32 != 0, else xt's type.  Entries
// with sw >= num_sw write nothing.  dt and ht are multiples of 16.  ``fuse``
// (SLAB 1, WHOLE 2 or ONE 3), ``htiles`` (SLAB: ceil(ht / 32); else 1) and
// ``stages`` come from the host's sizing (kernels/tband.py:fused_launch).  The
// alignment and the bounds are hcspmm_tband_spmm's.  ``blocks_per_sm`` (may be
// null) gets the resident blocks an SM the card's occupancy gave the launch,
// which sized its grid by them.  Returns a cudaError_t.
extern "C" int hcspmm_tband_fused(const void* starts, const void* sw, const void* at,
                                  const void* xt, const void* wt, void* agg, void* out, int sb,
                                  int w, int bh, int dt, int ht, long long m, long long out_cols,
                                  int num_sw, int fuse, int htiles, int stages, int wsm, int pack,
                                  int x_bf16, int out_f32, int* blocks_per_sm, void* stream) {
  if (sb <= 0) return 0;
  if (sw == nullptr || !shapes_ok(w, bh, dt, pack) || ht <= 0 || ht % 16 || stages < 2 ||
      stages > MAX_STAGES ||
      (fuse == SLAB ? htiles != (ht + HT_TILE - 1) / HT_TILE
                    : (fuse != WHOLE && fuse != ONE) || htiles != 1) ||
      (fuse == ONE && (ht > HT_TILE || (dt != 16 && dt != 32))) ||
      (wsm != 0 && (fuse == WHOLE || wsm != HT_TILE * htiles)))
    return (int)cudaErrorInvalidValue;
  if (!aligned(at, xt, m, x_bf16) || (uintptr_t)wt % 16 || out_cols % 2)
    return (int)cudaErrorInvalidValue;
  return launch_types(fuse, Operands{starts, sw, at, xt, agg, sb, w, bh, dt, pack, m, out_cols,
                                     num_sw, nullptr, nullptr, 0},
                      Missing{nullptr, nullptr, 0, 0},
                      Fused{wt, out, ht, htiles, stages, wsm, blocks_per_sm}, x_bf16, out_f32,
                      stream);
}
