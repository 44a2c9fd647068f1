"""TPU execution plan for hybrid SpMM.

The reference dispatches both populations inside one CUDA kernel with a
per-block branch on ``hybrid_type[bid]`` (hybrid_all_kernel.cu:960).  XLA
has no cheap per-grid-step divergence, so the TPU design partitions the
window space at preprocessing time into statically-shaped populations
(SURVEY.md §7 "hard parts" #1/#2):

- **Dense (MXU) path, width-bucketed.**  A dense window's unique neighbour
  columns (at most ``bucket_widths[-1]``) are padded to the smallest
  bucket width Kb; the window becomes one binary block-row
  ``A_w [window_h, Kb]`` (int8; the analog of the reference's 16x8 WMMA
  ``sparse_A`` blocks, .cu:1053-1079, fused across its MAX_BLK loop) plus
  the column ids (the analog of ``sparse_AToX_index``).  At run time each
  bucket is one fused gather + batched matmul — **no scatter/segment-sum
  anywhere**; the reduction over column blocks folds into the dot's
  contraction.  Profiling on v5e showed XLA's scatter at ~41 GB/s was the
  single largest cost of a tile+segment-sum design; buckets eliminate it.

- **Banded (MXU block-band) path** — a TPU-native population with no
  reference equivalent: superwindows of ``band_h`` consecutive rows whose
  column extent fits a band-width bucket Bb become one dense int8 block
  ``A_band [band_h, Bb]`` against a *contiguous* X slice
  ``[start, start+Bb)``.  One sequential DMA replaces every per-row
  gather; this is the explicit-VMEM analog of the L2 locality the GPU
  reference gets for free (its DD numbers imply ~5.3 TB/s effective —
  pure cache reuse).  Selected by a measured cost model
  (config.gather_ns_per_row / stream_gbps) against the gather paths.

- **Sparse (VPU) path** — windows that are empty, LOI-classified
  memory-bound, or wider than the largest bucket keep CSR semantics:
  gather one X row per edge and a sorted segment-sum into output rows
  (the equivalent of the warp-per-row CUDA-core loop, .cu:964-1036).

- **Merge** — one row-gather assembles ``[N, D]`` output from
  ``concat(bucket outputs..., sparse rows, zero row)`` via a precomputed
  permutation; empty windows map to the zero row.  O(N*D), no scatter.

All arrays are static-shaped per graph, so downstream jits compile once
per (graph, dim).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.format.windows import WindowAnalysis, analyze_windows
from hcspmm_tpu_torch.utils import profiling


def _pad_to(x: np.ndarray, size: int, fill) -> np.ndarray:
    if len(x) >= size:
        return x
    pad = np.full((size - len(x),) + x.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([x, pad])


def _store_a(a: np.ndarray, a_dtype: str) -> np.ndarray:
    """Dense int8 blocks ``a`` in the device encoding ``a_dtype``."""
    if a_dtype == "int4":
        from hcspmm_tpu_torch.format.streams import pack_a_int4
        return pack_a_int4(a)
    return a


def _ragged_arange(lens: np.ndarray) -> np.ndarray:
    """Vectorized ``concat([arange(l) for l in lens])``."""
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.zeros(len(lens), dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, lens)


def _ragged_gather(values: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Vectorized ``concat([values[s:s+l] for s, l in zip(starts, lens)])``."""
    lens = np.asarray(lens, dtype=np.int64)
    idx = np.repeat(np.asarray(starts, dtype=np.int64), lens) + _ragged_arange(lens)
    return values[idx]


@dataclasses.dataclass(frozen=True)
class PlanCaps:
    """Minimum array extents, so per-shard plans of one graph stack into a
    single uniform-shaped ``shard_map`` program (see parallel.partition)."""

    bucket_windows: Tuple[int, ...] = ()   # per-bucket min window counts
    ell_rows: Tuple[int, ...] = ()         # per-ELL-bucket min row counts
    band_supers: Tuple[int, ...] = ()      # per-band-bucket min superwindows
    num_sparse_rows: int = 0
    num_sparse_edges: int = 0
    num_spill_rows: int = 0                # band+spill population (>=0 forces
    num_spill_edges: int = 0               # the arrays to exist when 0 spill)


@dataclasses.dataclass
class ExecutionPlan:
    """Static device-side description of one hybrid SpMM.

    Column index convention: ``num_cols`` is a valid *dummy* index — SpMM
    implementations append one zero row to X, so padded gathers read zeros.
    """

    num_nodes: int              # rows of this operand (= global N when square)
    num_cols: int               # column space; num_cols is the dummy index
    window_h: int

    # ---- dense (MXU) path: one entry per width bucket ----
    bucket_widths: Tuple[int, ...]       # Kb per bucket (ascending)
    bucket_cols: List[np.ndarray]        # int32 [Wb, Kb], padded with num_cols
    bucket_a: List[np.ndarray]           # int8  [Wb, window_h, Kb], binary
    bucket_window_ids: List[np.ndarray]  # int64 [Wb_real] global window ids

    # ---- sparse (VPU) path: degree-bucketed ELL rows ----
    ell_widths: Tuple[int, ...]          # De per bucket (ascending)
    ell_cols: List[np.ndarray]           # int32 [Rb, De], padded with num_cols
    ell_row_ids: List[np.ndarray]        # int64 [Rb_real] global row ids

    # ---- residual scatter path (rows wider than ell_widths[-1]) ----
    num_sparse_rows: int         # Rs (>= 1; padded)
    num_sparse_edges: int        # Es (>= 1; padded)
    sparse_edge_col: np.ndarray  # int32 [Es], padded with num_cols
    sparse_edge_seg: np.ndarray  # int32 [Es] -> sparse-row position (padding -> Rs)
    sparse_rows: np.ndarray      # int32 [Rs] global row ids

    # ---- merge ----
    out_perm: np.ndarray         # int32 [N] -> row in concat(buckets..., sparse, zero)

    # ---- band+spill population (config.band_spill='auto') ----
    # Edges of band-selected superwindows that fall OUTSIDE the placed
    # band window: aggregated by a sorted segment-sum over spill rows and
    # scatter-ADDED onto the (band) output — the additive residual that
    # lets the band path carry power-law/community graphs (hub and
    # inter-community edges spill; the local mass streams).  Row padding
    # uses INT32_MAX so `.at[rows].add(..., mode='drop')` discards it.
    num_spill_rows: int = 0      # Rp capacity (0 = population absent)
    num_spill_edges: int = 0     # Ep capacity
    spill_rows: Optional[np.ndarray] = None      # int32 [Rp] global row ids
    spill_edge_col: Optional[np.ndarray] = None  # int32 [Ep], pad num_cols
    spill_edge_seg: Optional[np.ndarray] = None  # int32 [Ep] -> pos (pad Rp)
    # (round-5 prune: the 'colstream' column-streamed gather layout and
    # its cs_* arrays were deleted — hardware showed the MERGE, not the
    # gather, was the spill wall, and no config selected it; measurement
    # record in docs/ROADMAP.md rounds 2-3.)
    # dst-streamed spill merge (config.spill_impl='dstream',
    # kernels/dstream.py): dst-sorted chunks, Pallas one-hot segment
    # merge aliased into the padded output.  Pallas plans only; the take
    # arrays stay as fallback for sliced-output call sites.
    ds_gcols: Optional[np.ndarray] = None  # int32 [C*128] take indices
    ds_local: Optional[np.ndarray] = None  # int32 [C, 128], pad 128
    ds_blk: Optional[np.ndarray] = None    # int32 [C/G] dst block per step
    ds_lt: Optional[np.ndarray] = None     # int32 [C] tile within block
    ds_group: int = 0                      # G (0 = population absent)
    ds_rows: int = 0                       # padded row space the blocks index
    ds_meta: Optional[dict] = None         # column-range blocking slice
    #   table (kernels/dstream.py build_dstream_ranges): static host
    #   metadata, NOT a device array
    ds_ucols: Optional[np.ndarray] = None  # int32 [U] sorted unique spill
    #   columns: when present, the spill gather is TWO-LEVEL — one sorted
    #   take builds a compact [U, dp] table, and ds_gcols index THAT
    #   (remapped at build).  Kills the big-table gather wall + chunk-
    #   padding cost on low-density spills (YS-class: 170k edges over a
    #   437 MB table measured ~29 ns/edge; compact table is ~33 MB)
    ds_kind: str = "tile"                  # 'tile' = dstream (tile-pure
    #   chunks); 'block' = bstream (block-wide chunks, low-density fix)
    ds_gather_f32: bool = False            # cast bf16 X to f32 before the
    #   spill gather (f32 rows gather ~45% faster; config.ds_gather_f32)
    # lane-oriented spill merge for transposed-band plans
    # (kernels/tspill.py): block-wide chunks consumed in the [dt, M]
    # layout — no full-array relayout passes (the round-3 wrapper's
    # three [M, dt] transposes measured ~2.2 ms extra at YS@1.0,
    # tools/profile_parts.py)
    ds_tlocal: Optional[np.ndarray] = None  # int32 [ceil(C/8)*8, bw]
    #   dst lane within the chunk's G*128-lane block (sentinel G*128
    #   drops); LANE-vector rows — the old [C, bw, 1] sublane layout
    #   tiled to 128x memory and a padded-tile DMA per merge chunk
    ds_lblk: Optional[np.ndarray] = None    # int32 [C] lane-block per chunk
    ds_lgroup: int = 0                      # lane merge group (own, larger
    #   G than the row layout's: [dt, G*128] blocks are dt/128 the bytes)
    ds_laneg: Optional[np.ndarray] = None   # int32 [C*128] lane-gather
    #   ids: original columns (direct take from xt), or compact slots
    #   when ts_lo/ts_rel are present (mxgather two-level)
    ts_lo: Optional[np.ndarray] = None      # int32 [C2] mxgather slab bases
    ts_rel: Optional[np.ndarray] = None     # int32 [C2, 1, K] in-slab offsets
    ts_span: int = 0                        # mxgather slab width (lanes)
    # round-5 segmented second level (the gather-wall fix): per-edge lane
    # takes run ~2.2 ns from tables under the ~dozens-MB wall but ~13 ns
    # above it REGARDLESS of access locality (tools/probe_loctake.py /
    # probe_wall.py, artifacts/probe_loctake_r5.log).  When the T1
    # compact table exceeds the wall, destination-segment-local tables
    # (T2) are built from T1 via small static PIECE slices — every
    # gather in the chain then hits a sub-wall table.
    ts2_segs: Optional[list] = None  # static meta per dst segment:
    #   {'chunk_lo','chunk_hi' (merge-chunk range), 't2_w' (segment
    #   table width), 'pieces': [(p_lo, p_w, r_off, r_cnt), ...]
    #   (seg-major view), 'parts': [(piece_idx, off, cnt), ...]
    #   (slices of the piece-major take results reassembling the
    #   segment table)}
    ts2_pieces: Optional[list] = None  # piece-major build schedule:
    #   [(p_lo, p_w, rank_start, rank_cnt), ...] — one take per T1
    #   piece (T1 cycles the gather cache exactly once)
    ts2_ranks: Optional[np.ndarray] = None  # int32 [U2] piece-relative
    #   T1 slot of each segment-table column (duplicated across
    #   segments), PIECE-MAJOR order (matches ts2_pieces)
    # round-5 hub split: the hot (hub-column) spill edges run as their
    # own chunk stream against a cache-resident hub table; only the
    # cold remainder pays the T2 warming (see config.spill_hub_mb)
    hub_lo: Optional[np.ndarray] = None     # int32 [Ch] hub mxgather slabs
    hub_rel: Optional[np.ndarray] = None    # int32 [Ch, 1, K] offsets
    ds_h_tlocal: Optional[np.ndarray] = None  # int32 [ceil(C/8)*8, bw]
    ds_h_lblk: Optional[np.ndarray] = None    # int32 [Ch'] block per chunk
    ds_h_laneg: Optional[np.ndarray] = None   # int32 [Ch'*bw] hub slots
    ds_hgroup: int = 0                        # hot-stream merge group

    # ---- banded (MXU block-band) path: one entry per band-width bucket ----
    band_h: int = 16                          # superwindow height (rows)
    band_widths: Tuple[int, ...] = ()         # Bb per bucket (ascending)
    band_starts: List[np.ndarray] = dataclasses.field(default_factory=list)
    #   int32 [Sb] sublane-aligned X row offsets of each superwindow band
    band_edges: List[np.ndarray] = dataclasses.field(default_factory=list)
    #   int32 [E_s, 3] (super pos, row in super, band-local col) — the
    #   compact form; dense A blocks are built from it on demand (host) or
    #   on device (ops.spmm scatters them once at preprocess, uploading
    #   ~8 bytes/nnz instead of band_h*Bb bytes/superwindow)
    band_sw_ids: List[np.ndarray] = dataclasses.field(default_factory=list)
    #   int64 [Sb_real] global superwindow ids
    band_missing_sw: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int32))
    #   int32 [miss] supers in NO band bucket (partial cover): the padded
    #   SpMM zeroes their output blocks before the spill add
    # (round-5 prune: the 'ring' fetch-once X band kernel and its
    # band_ring schedules were deleted — measured 766-776 us vs wide's
    # 510-522 at DD/dim96 because the A convert+dot wall sits under the
    # bytes it saved; record in docs/ROADMAP.md round 3.)
    band_full_cover: bool = False  # every superwindow band-assigned ->
    #   direct-write kernels produce the output in place, no merge pass
    # (round-5 prune: the band_fold narrow-dim folded layout was deleted
    #   — its [bh, W] @ [W, 32] dots filled 32/128 MXU output lanes and
    #   measured 1.7x slower than unfolded at dim 32; the transposed band
    #   (band_impl='tband') replaced it as the narrow-dim fast path.
    #   A blocks keep their natural [Sb, bh, Bb] layout (see
    #   kernels.block_spmm._band_body_deep)
    tband: bool = False  # transposed band (config.band_impl='tband',
    #   kernels/tband.py): device arrays carry band{s}_at [Sb, W, bh]
    #   (possibly packed) instead of band{s}_a; starts are 128-aligned;
    #   the padded activation layout is X^T [dt, M]
    tband_pack: int = 1  # A_t device encoding: 1 int8 / 2 nibble / 8 bit
    a_dtype: str = "int8"  # band{s}_a / tp_a device encoding (config.a_dtype;
    #   'int8' on tband plans, which carry no band{s}_a): band_a_stored
    shard_uniform: bool = False  # proxy plan standing in for N capacity-
    #   padded shard plans under one shard_map trace: kernel dispatch may
    #   consult only capacity shapes (never per-shard real counts), and
    #   direct-write kernels must always allocate the trash block
    xp_rows: int = 0            # SpMM impls pad X to >= this many rows
    band_num_sw: int = 0        # superwindow grid size (>= ceil(n/band_h);
    #   tiny pallas graphs bump it so M = band_num_sw*band_h covers the
    #   128-column minimum band width — trailing supers are empty)

    # ---- tiled band (band_impl='tiled'): flat (super, X-tile) pairs ----
    # Canonical 128-row X tiles + a ring cache: each tile is DMA'd once
    # per sweep (the wide kernel re-fetches the ~50-75% band overlap of
    # consecutive superwindows) and A skips tiles outside each
    # superwindow's extent (variable width, no bucket padding).
    tiled: bool = False
    tile_w: int = 128
    tile_slots: int = 16
    pair_ptr: Optional[np.ndarray] = None    # int64 [num_sw+1]
    pair_tile: Optional[np.ndarray] = None   # int32 [P] canonical tile id
    pair_super: Optional[np.ndarray] = None  # int32 [P] owning superwindow
    pair_fetch: Optional[np.ndarray] = None  # int32 [P] 1 = DMA tile here
    pair_late: Optional[np.ndarray] = None   # int32 [P] 1 = can't prefetch
    pair_first: Optional[np.ndarray] = None  # int32 [P] first pair of super
    pair_last: Optional[np.ndarray] = None   # int32 [P] last pair of super
    tile_edges: Optional[np.ndarray] = None  # int32 [E, 3] (pair, row, col)

    def tiled_a_dense(self) -> np.ndarray:
        """Dense int8 A tiles [P, band_h, tile_w] for the tiled kernel."""
        p = len(self.pair_tile)
        a = np.zeros((p, self.band_h, self.tile_w), dtype=np.int8)
        e = self.tile_edges
        if len(e):
            a[e[:, 0], e[:, 1], e[:, 2]] = 1
        return a

    def tiled_a_stored(self) -> np.ndarray:
        """``tiled_a_dense()`` as the device holds it: int8 [P, band_h,
        tile_w] at ``a_dtype='int8'``, uint8 int4 nibbles [P, band_h,
        tile_w/2] at 'int4' (``streams.pack_a_int4``)."""
        return _store_a(self.tiled_a_dense(), self.a_dtype)

    # ---- stats (host-only; for roofline/logging) ----
    nnz: int = 0
    dense_nnz: int = 0
    sparse_nnz: int = 0
    band_nnz: int = 0
    spill_nnz: int = 0
    dense_gather_rows: int = 0   # sum Wb * Kb (inc. padding)
    unique_gather_rows: int = 0  # sum unique cols over dense windows

    @property
    def has_spill(self) -> bool:
        """True when the additive spill population exists (impls must add
        it onto the band/merge output; fused one-launch kernels bail)."""
        return self.num_spill_edges > 0

    @property
    def num_dense_windows(self) -> int:
        return sum(len(w) for w in self.bucket_window_ids)

    @property
    def num_band_supers(self) -> int:
        return sum(len(s) for s in self.band_sw_ids)

    @property
    def padded_rows(self) -> int:
        """Row count M of the padded activation layout ([M, dp] with
        128-multiple dp): the superwindow grid rounded up.  When
        ``band_padded_ok`` the SpMM maps [M, dp] -> [M, dp] with no
        pad/slice passes (rows >= num_nodes stay exactly zero)."""
        if not self.band_widths:
            return self.num_nodes
        return max(self.band_num_sw,
                   -(-self.num_nodes // self.band_h)) * self.band_h

    @property
    def band_padded_ok(self) -> bool:
        """True when every band slice fits inside ``padded_rows`` (starts
        were clamped at build time) so the padded fast path applies."""
        if not (self.band_widths and self.band_full_cover
                and self.num_cols == self.num_nodes):
            return False
        m = self.padded_rows
        for s, bbw in enumerate(self.band_widths):
            st = self.band_starts[s][: len(self.band_sw_ids[s])]
            if len(st) and int(st.max()) + bbw > m:
                return False
            if len(self.band_starts[s]) > len(self.band_sw_ids[s]) and bbw > m:
                return False  # capacity-padded dummy DMA from row 0
        return True

    def band_a_dense(self, s: int) -> np.ndarray:
        """Dense int8 band blocks [Sb, band_h, Bb] for bucket ``s``."""
        sb = self.band_starts[s].shape[0]
        bb = int(self.band_widths[s])
        a = np.zeros((sb, self.band_h, bb), dtype=np.int8)
        e = self.band_edges[s]
        if len(e):
            a[e[:, 0], e[:, 1], e[:, 2]] = 1
        return a

    def band_a_stored(self, s: int) -> np.ndarray:
        """``band_a_dense(s)`` as the device holds it: int8 [Sb, band_h, Bb]
        at ``a_dtype='int8'``, uint8 int4 nibbles [Sb, band_h, Bb/2] at
        'int4' (``streams.pack_a_int4``: column 2j in the low nibble of byte
        j, 2j + 1 in the high one)."""
        return _store_a(self.band_a_dense(s), self.a_dtype)

    def band_at_dense(self, s: int) -> np.ndarray:
        """TRANSPOSED dense int8 band blocks [Sb, Bb, band_h] for bucket
        ``s`` (plan.tband layout: contraction axis first, output rows on
        lanes — kernels/tband.py)."""
        sb = self.band_starts[s].shape[0]
        bb = int(self.band_widths[s])
        a = np.zeros((sb, bb, self.band_h), dtype=np.int8)
        e = self.band_edges[s]
        if len(e):
            a[e[:, 0], e[:, 2], e[:, 1]] = 1
        return a

    def band_at_stored(self, s: int) -> np.ndarray:
        """``band_at_dense(s)`` in the plan's ``tband_pack`` encoding, as the
        device holds it: int8 [Sb, Bb, band_h] (pack 1), uint8 nibbles [Sb,
        Bb, band_h/2] (2) or bits [Sb, Bb/8, band_h] (8).  An empty bucket
        stays int8."""
        at = self.band_at_dense(s)
        if self.tband_pack == 2 and at.size:
            from hcspmm_tpu_torch.format.streams import pack_a_nibble
            at = pack_a_nibble(at)
        elif self.tband_pack == 8 and at.size:
            from hcspmm_tpu_torch.format.streams import pack_a_bits
            at = pack_a_bits(at)
        return at

    @property
    def band_capacities(self) -> Tuple[int, ...]:
        return tuple(s.shape[0] for s in self.band_starts)

    @property
    def bucket_capacities(self) -> Tuple[int, ...]:
        return tuple(c.shape[0] for c in self.bucket_cols)

    @property
    def ell_capacities(self) -> Tuple[int, ...]:
        return tuple(c.shape[0] for c in self.ell_cols)

    def device_arrays(self, dense_band: bool = True):
        """The pytree of arrays an SpMM implementation needs on device.
        ``dense_band=False`` omits the dense band A blocks (callers that
        scatter them on device from ``band_edges`` skip the host densify
        entirely — ops.spmm.HybridSpMM)."""
        d = {
            "sparse_edge_col": self.sparse_edge_col,
            "sparse_edge_seg": self.sparse_edge_seg,
            "out_perm": self.out_perm,
        }
        if self.has_spill:
            d["spill_rows"] = self.spill_rows
            d["spill_edge_col"] = self.spill_edge_col
            d["spill_edge_seg"] = self.spill_edge_seg
            if self.ds_blk is not None:
                d["ds_gcols"] = self.ds_gcols
                d["ds_local"] = self.ds_local
                d["ds_blk"] = self.ds_blk
                d["ds_lt"] = self.ds_lt
                if self.ds_ucols is not None:
                    d["ds_ucols"] = self.ds_ucols
                if self.ds_tlocal is not None:
                    d["ds_tlocal"] = self.ds_tlocal
                    d["ds_lblk"] = self.ds_lblk
                    d["ds_laneg"] = self.ds_laneg
                    if self.ts_lo is not None:
                        d["ts_lo"] = self.ts_lo
                        d["ts_rel"] = self.ts_rel
                    if self.ts2_ranks is not None:
                        d["ts2_ranks"] = self.ts2_ranks
                    if self.hub_lo is not None:
                        d["hub_lo"] = self.hub_lo
                        d["hub_rel"] = self.hub_rel
                        d["ds_h_tlocal"] = self.ds_h_tlocal
                        d["ds_h_lblk"] = self.ds_h_lblk
                        d["ds_h_laneg"] = self.ds_h_laneg
        for b in range(len(self.bucket_widths)):
            d[f"b{b}_cols"] = self.bucket_cols[b]
            d[f"b{b}_a"] = self.bucket_a[b]
        for e in range(len(self.ell_widths)):
            d[f"e{e}_cols"] = self.ell_cols[e]
        if self.tiled:
            # scalar arrays padded by the kernel's lookahead depth so
            # prefetch reads past the last pair stay in bounds (padded
            # entries: repeat-last tile/super, zero flags -> no-ops)
            from hcspmm_tpu_torch.config import TILED_SCALAR_PAD as pad

            def _lap(a, repeat_last: bool):
                fill = a[-1] if repeat_last and len(a) else 0
                return np.concatenate(
                    [a, np.full(pad, fill, dtype=a.dtype)]
                )

            d["tp_tile"] = _lap(self.pair_tile, True)
            d["tp_super"] = _lap(self.pair_super, True)
            d["tp_fetch"] = _lap(self.pair_fetch, False)
            d["tp_late"] = _lap(self.pair_late, False)
            d["tp_first"] = _lap(self.pair_first, False)
            d["tp_last"] = _lap(self.pair_last, False)
            if dense_band:
                d["tp_a"] = self.tiled_a_dense()
        if len(self.band_widths) and self.num_cols == self.num_nodes:
            # square plans only: the padded partial-cover path's zeroing
            # list.  Shard (rectangular) plans never run padded, and its
            # per-shard length is non-uniform, which would break the
            # shard-uniform array stacking (parallel.partition).
            # Aligned full runs of 8 consecutive missing supers split
            # into an 8-wide list: the zero-fill kernel writes them as
            # single [.., 8*bh] blocks, cutting its grid-step count ~8x
            # on cluster-ordered graphs whose uncovered regions are
            # contiguous (YS: 2023 steps measured ~516 us).
            mm = np.sort(self.band_missing_sw.astype(np.int64))
            num_sw = self.padded_rows // self.band_h if self.band_h else 0
            if len(mm) and num_sw % 8 == 0:  # 8-wide blocks must tile M
                cnt = np.bincount(mm // 8)
                full8 = np.where(cnt == 8)[0]
                in8 = np.isin(mm // 8, full8)
                d["band_missing_sw8"] = full8.astype(np.int32)
                d["band_missing_sw"] = mm[~in8].astype(np.int32)
            else:
                d["band_missing_sw8"] = np.zeros(0, dtype=np.int32)
                d["band_missing_sw"] = self.band_missing_sw
        for s in range(len(self.band_widths)):
            d[f"band{s}_start"] = self.band_starts[s]
            if self.tband:
                if dense_band:
                    d[f"band{s}_at"] = self.band_at_stored(s)
            elif dense_band and not self.tiled:
                d[f"band{s}_a"] = self.band_a_dense(s)
            # pad to capacity for uniform shard stacking / grouped grid
            # steps; padded entries point at the direct-write buffer's
            # trash block (index num_superwindows, see kernels.block_spmm)
            num_sw = max(self.band_num_sw,
                         -(-self.num_nodes // self.band_h))
            d[f"band{s}_sw"] = _pad_to(
                self.band_sw_ids[s].astype(np.int32),
                self.band_starts[s].shape[0], num_sw,
            )
        return d


# Key base for per-superwindow sorted column keys (sw * _BIG + col):
# larger than any column id, so windows [start, start+w) never cross a
# superwindow boundary in searchsorted space.  Divisible by 16 so the
# 16-aligned group quantization (keys >> 4) below stays exact.
_BIG = np.int64(1) << 33


def _seg_of_positions(boundaries, total):
    """``seg_of[p]`` = index of the segment (given sorted start positions
    ``boundaries``, boundaries[0] == 0) containing position ``p``.

    Boundary-mark bincount+cumsum, NOT searchsorted: per-element binary
    search over 5.5M positions measured ~6 s on this rig vs ~40 ms for
    the cumsum form (see windows.analyze_windows note)."""
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    marks = np.bincount(boundaries[1:], minlength=total)[:total]
    return np.cumsum(marks)


def _robust_widths(keys, e_start, e_end, ne, qs):
    """Per-nonempty-superwindow minimal window width covering ceil(q*E_s)
    edges, for each coverage quantile q in ``qs``.

    ``keys``: int64 sorted ``sw*_BIG + col`` edge keys (grouped by super,
    columns ascending within).  Returns int64 [len(qs), n_ne]."""
    total = len(keys)
    cols = keys % _BIG
    ar = np.arange(total, dtype=np.int64)
    starts_ne = e_start[ne]
    ends_ne = e_end[ne]
    cnt_s = ends_ne - starts_ne
    seg_of = _seg_of_positions(starts_ne, total)
    out = np.empty((len(qs), len(starts_ne)), dtype=np.int64)
    for qi, q in enumerate(qs):
        k = np.maximum(np.ceil(q * cnt_s).astype(np.int64), 1)
        idx2 = ar + k[seg_of] - 1
        valid = idx2 < ends_ne[seg_of]
        w = np.where(
            valid,
            cols[np.minimum(idx2, total - 1)] - cols + 1,
            np.int64(1) << 40,
        )
        out[qi] = np.minimum.reduceat(w, starts_ne)
    return out


def _place_band_windows(keys, starts_ne, w, align=16):
    """Best ``align``-aligned window of width ``w`` per nonempty superwindow:
    the placement that covers the most edges (candidates = the aligned
    start at-or-below each edge column).  Returns (covered edge count
    [n_ne], chosen start column [n_ne]).

    Works on (sw, col//16) GROUPS rather than edges: keys are sorted, 16
    divides _BIG, so ``keys >> 4`` is sorted and group-constant; every
    candidate window start is a group's aligned column, its covered-edge
    count a difference of group-prefix sums.  One searchsorted over [G]
    groups replaces two over [E] edges (~100x fewer probes at TT scale).
    """
    total = len(keys)
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    sh = int(align).bit_length() - 1     # log2(align); align | _BIG
    qk = keys >> sh                      # sw*(_BIG//align) + col//align
    flags = np.empty(total, dtype=bool)
    flags[0] = True
    np.not_equal(qk[1:], qk[:-1], out=flags[1:])
    gstart = np.flatnonzero(flags)       # [G] edge position of group start
    qku = qk[gstart]                     # [G] sorted group keys
    g = len(gstart)
    cum = np.append(gstart, total)       # [G+1] prefix edge counts
    hi_g = np.searchsorted(qku, qku + (w >> sh))
    cnt_g = cum[hi_g] - gstart           # edges covered from this group on
    # super boundaries in group space (supers = high bits of qku)
    sup_g = qku >> (33 - sh)             # _BIG >> sh == 1 << (33 - sh)
    sflags = np.empty(g, dtype=bool)
    sflags[0] = True
    np.not_equal(sup_g[1:], sup_g[:-1], out=sflags[1:])
    gb = np.flatnonzero(sflags)          # [n_ne] group index of super start
    cov = np.maximum.reduceat(cnt_g, gb)
    seg_of_g = np.cumsum(sflags) - 1
    best = np.where(cnt_g == cov[seg_of_g], np.arange(g), g)
    bi = np.minimum.reduceat(best, gb)
    start = (qku[bi] & ((np.int64(1) << (33 - sh)) - 1)) << sh
    return cov, start


def _build_tiled_pairs(num_sw, bh, min_col, max_col, nonempty,
                       column_index, wa, sw_of_edge, slots):
    """Flat (superwindow, canonical-128-row-X-tile) pair stream + the
    statically simulated ring-cache fetch schedule for the tiled band
    kernel (kernels.block_spmm.band_tiled_spmm).

    Schedule invariants (the kernel prefetches pair q's tile LA_X steps
    early): a prefetch may not overwrite a slot read by any pair in
    [q-LA_X, q) — such fetches are marked ``late`` and issued at q
    itself.  Every fetched tile is waited exactly once (at its fetch
    pair); non-fetch pairs read resident slots."""
    TW = 128
    LA_X = 2
    t0 = np.where(nonempty, min_col // TW, 0).astype(np.int64)
    t1 = np.where(nonempty, max_col // TW + 1, 0).astype(np.int64)
    cnt = np.maximum(t1 - t0, 0)
    # every superwindow owns >= 1 pair so its output block is written;
    # empty ones get a dummy zero-A pair reusing the previous tile
    cnt_eff = np.maximum(cnt, 1)
    pair_ptr = np.zeros(num_sw + 1, dtype=np.int64)
    np.cumsum(cnt_eff, out=pair_ptr[1:])
    p_total = int(pair_ptr[-1])
    pair_tile = np.zeros(p_total, dtype=np.int64)
    pair_super = np.repeat(np.arange(num_sw, dtype=np.int64), cnt_eff)
    real = cnt > 0
    rs = np.where(real)[0]
    if len(rs):
        pos = np.repeat(pair_ptr[:-1][rs], cnt[rs]) + _ragged_arange(cnt[rs])
        val = np.repeat(t0[rs], cnt[rs]) + _ragged_arange(cnt[rs])
        pair_tile[pos] = val
    for p in pair_ptr[:-1][~real]:  # dummies, ascending order
        pair_tile[p] = pair_tile[p - 1] if p > 0 else 0
    pair_first = np.zeros(p_total, dtype=np.int32)
    pair_last = np.zeros(p_total, dtype=np.int32)
    pair_first[pair_ptr[:-1]] = 1
    pair_last[pair_ptr[1:] - 1] = 1
    # ring-cache simulation
    slot_of = pair_tile % slots
    resident = np.full(slots, -1, dtype=np.int64)
    fetch = np.zeros(p_total, dtype=np.int32)
    for p in range(p_total):
        if resident[slot_of[p]] != pair_tile[p]:
            fetch[p] = 1
            resident[slot_of[p]] = pair_tile[p]
    late = np.zeros(p_total, dtype=np.int32)
    for q in np.where(fetch)[0]:
        for r in range(max(q - LA_X, 0), q):
            if slot_of[r] == slot_of[q] and pair_tile[r] != pair_tile[q]:
                late[q] = 1
                break
    # compact A: (pair, row-in-super, tile-local col) per edge
    e_sw = sw_of_edge
    e_tile = column_index // TW
    pair_of_e = pair_ptr[e_sw] + (e_tile - t0[e_sw])
    tile_edges = np.empty((len(pair_of_e), 3), dtype=np.int32)
    tile_edges[:, 0] = pair_of_e
    tile_edges[:, 1] = wa.edge_to_row.astype(np.int64) % bh
    tile_edges[:, 2] = column_index % TW
    return dict(
        tiled=True,
        tile_w=TW,
        tile_slots=slots,
        pair_ptr=pair_ptr,
        pair_tile=pair_tile.astype(np.int32),
        pair_super=pair_super.astype(np.int32),
        pair_fetch=fetch,
        pair_late=late,
        pair_first=pair_first,
        pair_last=pair_last,
        tile_edges=tile_edges,
    )


def _mx_k(config, n_req: int, mp: int) -> int:
    """mxgather cols-per-chunk: double the base k on dense request
    populations (requests per span window > base k), where chunk count
    is k-limited and the strided slab DMA descriptors dominate
    (tools/sweep_mx.py: TT-like best at (2048, 256))."""
    k = int(config.ts_k)
    if mp and n_req * config.ts_span / mp > 2 * k:
        return 2 * k
    return k


def _build_ts2_segments(cols2d: np.ndarray, uc_all: np.ndarray,
                        slot_all: np.ndarray, t1_slots: int,
                        cap_slots: int, piece_slots: int):
    """Destination-segment table layout for the two-level lane gather
    (the round-5 gather-wall fix; see ExecutionPlan.ts2_segs).

    cols2d: int [C, bw] ORIGINAL column ids per merge-chunk slot (pads
    repeat a real col of the same chunk); uc_all/slot_all: sorted global
    unique cols and their T1 slot positions; cap_slots: max unique cols
    per destination segment (the T2 sub-wall cap); piece_slots: T1
    static-slice width for the T2 build takes.

    Greedy: grow each segment chunk-by-chunk (exponential probe + bisect
    on the unique-col count) until the cap.  Returns (segs static meta,
    ranks int32 [U2] piece-relative, laneg int32 [C*bw]
    segment-relative positions).  Every take in the resulting chain —
    T1 piece -> segment table -> per-edge — sees a table under the wall.
    """
    c, bw = cols2d.shape
    segs = []
    ranks_parts: list = []
    r_total = 0
    laneg = np.empty(c * bw, np.int32)
    c0 = 0
    while c0 < c:
        step = 64
        u = None
        cand = c0
        while cand < c:
            cand = min(c0 + step, c)
            u = np.unique(cols2d[c0:cand])
            if len(u) > cap_slots or cand == c:
                break
            step *= 2
        if u is not None and len(u) > cap_slots and cand > c0 + 1:
            lo_b, hi_b = c0 + 1, cand - 1
            while lo_b < hi_b:  # last end with count <= cap
                mid = (lo_b + hi_b + 1) // 2
                if len(np.unique(cols2d[c0:mid])) <= cap_slots:
                    lo_b = mid
                else:
                    hi_b = mid - 1
            c1 = lo_b
            u = np.unique(cols2d[c0:c1])
        else:
            c1 = cand
        su = slot_all[np.searchsorted(uc_all, u)].astype(np.int64)
        pieces = []
        k0 = 0
        while k0 < len(su):
            p_lo = (int(su[k0]) // piece_slots) * piece_slots
            p_w = min(piece_slots, t1_slots - p_lo)
            k1 = int(np.searchsorted(su, p_lo + p_w))
            pieces.append((p_lo, p_w, r_total + k0, k1 - k0))
            k0 = k1
        ranks_parts.append(su)
        r_total += len(su)
        sl = cols2d[c0:c1].reshape(-1)
        laneg[c0 * bw: c1 * bw] = np.searchsorted(u, sl).astype(np.int32)
        segs.append(dict(chunk_lo=int(c0), chunk_hi=int(c1),
                         t2_w=int(len(u)), pieces=pieces))
        c0 = c1
    ranks = np.concatenate(ranks_parts) if ranks_parts else \
        np.zeros(0, np.int64)
    for s in segs:
        for (p_lo, _p_w, r0, cnt) in s["pieces"]:
            ranks[r0:r0 + cnt] -= p_lo
    # ---- piece-major reorder (round-5 cache-cycling fix) ----
    # The gather 'cache' is ~16-24 MB and warms only via gather misses
    # (~68 us/MB; tools/probe_workset.py eight16/x4acc/touch rows), so a
    # segment-major build would cycle every T1 piece through it once PER
    # SEGMENT.  Reordering the build piece-major cycles T1 exactly once:
    # one take per piece over all segments' ranks, then the segment
    # tables reassemble from static slices of the piece results (pure
    # copies at stream bandwidth).
    piece_map: dict = {}
    for si, s in enumerate(segs):
        for (p_lo, p_w, r0, cnt) in s["pieces"]:
            piece_map.setdefault((p_lo, p_w), []).append((si, r0, cnt))
    pieces_pm = []
    ranks_pm_parts = []
    seg_parts: list = [[] for _ in segs]
    off = 0
    for pi, (p_lo, p_w) in enumerate(sorted(piece_map)):
        start = off
        innoff = 0
        for (si, r0, cnt) in piece_map[(p_lo, p_w)]:
            ranks_pm_parts.append(ranks[r0:r0 + cnt])
            seg_parts[si].append((pi, innoff, cnt))
            innoff += cnt
            off += cnt
        pieces_pm.append((int(p_lo), int(p_w), int(start), int(innoff)))
    ranks_pm = (np.concatenate(ranks_pm_parts) if ranks_pm_parts
                else np.zeros(0, np.int64))
    for si, s in enumerate(segs):
        s["parts"] = seg_parts[si]
    return (segs, pieces_pm, ranks_pm.astype(np.int32), laneg)


@profiling.spanned("format.plan")
def build_plan(
    row_pointers: np.ndarray,
    column_index: np.ndarray,
    num_nodes: int,
    config: PlanConfig = PlanConfig(),
    analysis: Optional[WindowAnalysis] = None,
    num_cols: Optional[int] = None,
    caps: PlanCaps = PlanCaps(),
) -> ExecutionPlan:
    """``num_nodes`` counts rows; ``num_cols`` (default: square) sets the
    column space for a rectangular row-block shard of the adjacency.  With
    tracing on (``utils.profiling``) the build is a ``format.plan`` span in
    phases: ``.windows`` (window analysis), ``.band`` (band widths and
    placement, the tiled pairs), ``.spill`` (the spill population and its
    row streams), ``.lanes`` (the tband lane streams, hub and T1/T2
    tables), ``.rows`` (routing, dense buckets, ELL, residual) and
    ``.merge`` (the merge permutation)."""
    num_cols = num_nodes if num_cols is None else num_cols
    a_dtype = getattr(config, "a_dtype", "int8")
    if a_dtype not in ("int8", "int4"):
        raise ValueError(f"a_dtype must be 'int8' or 'int4', got {a_dtype!r}")
    profiling.phase("format.plan.windows")
    wa = analysis or analyze_windows(
        row_pointers,
        column_index,
        num_nodes,
        window_h=config.window_h,
        loi_mode=config.loi_mode,
        loi_coeffs=config.loi,
        num_cols=num_cols,
    )
    wh = config.window_h
    widths = tuple(config.bucket_widths)
    n, c = num_nodes, num_cols
    # keep ci int32: every consumer either upcasts through an int64
    # partner (key math, window-start subtraction) or wants int32 anyway
    # (native passes, plan arrays) — the int64 detour copied 8 B/edge
    # three extra times at DD scale
    column_index = np.ascontiguousarray(column_index)
    if column_index.dtype != np.int32:
        column_index = column_index.astype(np.int32)
    nnz = int(len(wa.edge_to_row))

    rp64 = np.asarray(row_pointers, dtype=np.int64)
    degrees = np.diff(rp64)

    profiling.phase("format.plan.band")
    # -------------------- banded superwindows --------------------
    # Decide, per band_h-row superwindow, whether its whole column extent
    # streams as one contiguous block (see module docstring).  Selected
    # superwindows own all their windows/rows; the remaining populations
    # are carved from what is left.
    auto_width = (
        config.band_mode != "never" and isinstance(config.band_widths, str)
    )
    if config.band_mode == "never":
        band_widths = ()
    elif auto_width:
        band_widths = (256,)  # placeholder; resolved from extents below
    else:
        band_widths = tuple(config.band_widths)
    bh = config.band_h
    if band_widths and bh % wh != 0:
        raise ValueError("band_h must be a multiple of window_h")
    if config.impl == "pallas" and band_widths:
        # Mosaic requires the int8 A-block lane dim (= band width) to be
        # a multiple of the 128-lane tile on real TPUs (verified: width
        # 64 fails compilation; CPU interpret mode accepts anything) —
        # round configured widths up
        band_widths = tuple(sorted({
            max(128, -(-int(w) // 128) * 128) for w in band_widths
        }))
    if any(int(w) % 16 for w in band_widths):
        # band starts (incl. the padded-layout clamp num_sw*band_h - W)
        # must stay 16-aligned: the kernels assert that to Mosaic via
        # pl.multiple_of on the dynamic HBM slice
        raise ValueError("band widths must be multiples of 16")
    al = 16  # band-start alignment in original columns
    tband = bool(band_widths) and config.band_impl == "tband"
    if tband:
        # transposed band (kernels/tband.py): X^T lane slices need
        # 128-aligned starts; A_t blocks are [W, bh] with bh on lanes
        if config.impl != "pallas":
            raise ValueError("band_impl='tband' requires impl='pallas'")
        if num_cols != num_nodes:
            raise ValueError("band_impl='tband' requires square plans")
        if bh % 128:
            raise ValueError("band_impl='tband' requires band_h % 128 == 0")
        if int(getattr(config, "tband_pack", 1)) not in (1, 2, 8):
            raise ValueError("tband_pack must be 1, 2 or 8")
        al = 128
    num_sw = (n + bh - 1) // bh if band_widths else 0
    if band_widths and config.impl == "pallas":
        # Pallas band widths have a 128-column floor (lane tile); the
        # padded row space M = num_sw*band_h must cover the widest band
        # (starts clamp into [0, M-W]).  Graphs smaller than 128 rows
        # get trailing EMPTY superwindows (zero A blocks -> the direct
        # write stores zeros there), keeping the padded invariant.
        num_sw = max(num_sw, -(-128 // bh))
        # Round the super count to a multiple of 16 so M divides every
        # power-of-two block size up to 16*bh: the lane-merge group
        # (kernels/tspill.py) and the 8-wide zero-fill batches both need
        # M % span == 0 (Pallas blocked specs).  YH's 12259 supers made
        # pick_group collapse to span 256 — 12.3k mostly-padding chunks,
        # 42 ns/spill-edge (tools/profile_tspill_stages.py).  Trailing
        # supers are in no bucket -> zero-filled like any missing super;
        # the row/lane padding costs <= 15*bh rows of zeros.
        num_sw = -(-num_sw // 16) * 16
    band_starts: List[np.ndarray] = []
    band_edges: List[np.ndarray] = []
    band_sw_ids: List[np.ndarray] = []
    band_window_mask = np.zeros(wa.num_windows, dtype=bool)
    xp_rows = c + 1
    band_nnz = 0
    spill_fields: dict = {}
    spill_mode = False  # set inside the band block when band_spill='auto'
    band_missing = np.zeros(0, dtype=np.int32)
    dense_routed_w = None  # set by spill-mode three-way routing
    caps_s = caps.band_supers or (0,) * len(band_widths)
    if len(caps_s) != len(band_widths):
        raise ValueError("caps.band_supers length must match band_widths")
    if band_widths:
        # even zero-real (capacity-padded) buckets DMA a dummy band from
        # row 0, so X must always cover the widest bucket (auto mode
        # defers this until widths resolve from extents — the 256
        # placeholder would inflate xp_rows on tiny graphs)
        if not auto_width:
            xp_rows = max(xp_rows, int(band_widths[-1]))
        sw_row0 = np.minimum(np.arange(num_sw, dtype=np.int64) * bh, n)
        sw_row1 = np.minimum(sw_row0 + bh, n)
        e_start = rp64[sw_row0]
        e_end = rp64[sw_row1]
        nonempty = e_end > e_start
        min_col = np.full(num_sw, 0, dtype=np.int64)
        max_col = np.full(num_sw, -1, dtype=np.int64)
        ne = np.where(nonempty)[0]
        if len(ne):
            min_col[ne] = np.minimum.reduceat(column_index, e_start[ne])
            max_col[ne] = np.maximum.reduceat(column_index, e_start[ne])
        start = (min_col // al) * al  # sublane-aligned band start
        extent = max_col - start + 1
        # edge -> superwindow via boundary marks (integer division over E
        # elements measured seconds on this rig; see _seg_of_positions)
        nnz_e = len(wa.edge_to_row)
        sw_of_edge = _seg_of_positions(
            rp64[np.minimum(
                np.arange(num_sw, dtype=np.int64) * bh, n)], nnz_e)
        E_sw = e_end - e_start

        # gather-path cost per superwindow (one padded ELL slot per edge
        # on the XLA take path) — shared by both selection modes below
        ell_w = np.asarray(config.ell_widths, dtype=np.int64)
        slot = np.where(
            degrees > 0,
            ell_w[np.minimum(np.searchsorted(ell_w, degrees), len(ell_w) - 1)],
            0,
        )
        slot = np.where(degrees > ell_w[-1], degrees, slot)
        slots_sw = np.add.reduceat(
            np.concatenate([slot, [0]]), sw_row0
        ) * (sw_row1 > sw_row0)
        # X-stream lane count for the band cost model: the transposed
        # band streams X^T slabs of dt (~32) sublanes, not the padded
        # 128-lane rows — pricing tband's X at 128 lanes overpriced wide
        # candidates 4x and kept TT/GH at W=1024 while the (round-5,
        # much cheaper) spill path no longer justified narrow windows
        dnom = 32.0 if tband else 128.0
        xbytes = 2.0 if config.compute_dtype == "bfloat16" else 4.0
        # per-gathered-row cost: row bytes over the measured random-gather
        # bandwidth (XLA take path).  The old fixed 7 ns default made a
        # 2048-wide band block "cheaper" than gathering 100 edges, so
        # power-law plans claimed every superwindow at ~1% coverage and
        # streamed GBs of A for nothing (round-2 fix).
        if config.gather_ns_per_row is not None:
            g_ns = config.gather_ns_per_row * 1e-9
        elif tband:
            # measured round-5 effective marginal spill cost on the lane
            # chain (segmented gather 2.2-4 + cache warming amortized +
            # merge slot ~0.7 + chunk share ~1): TT 11.2 / GH 10.7 /
            # RD 12.2 / AZ 4.3 ns per edge AVERAGE, marginal ~7
            g_ns = 7e-9
        else:
            g_ns = dnom * xbytes / (config.take_gbps * 1e9)
        sparse_cost = slots_sw * g_ns
        bw_s = config.stream_gbps * 1e9
        if config.impl == "pallas":
            r_up = lambda v: max(128, -(-int(v) // 128) * 128)
        else:
            r_up = lambda v: max(16, -(-int(v) // 16) * 16)

        spill_mode = config.band_spill == "auto" and len(ne) > 0
        if spill_mode:
            # ---- robust selection (band+spill): per superwindow, PLACE a
            # bucket-width window where it covers the most edges; edges
            # outside the window spill to the additive segment-sum
            # population.  This is what lets the streamed band path carry
            # power-law / community graphs (hub and inter-community edges
            # spill, the local mass streams) instead of the all-or-nothing
            # full-extent selection of band_spill='never'.
            # Native fast path: the per-edge quantile/placement passes
            # run in OpenMP C++ (native/preprocess.cpp hcspmm_band_*);
            # the keys-sort NumPy path stays as the portable fallback
            # and the test oracle (tests/test_format.py).
            from hcspmm_tpu_torch.format import windows as _w
            _nat = _w._native_lib() is not None
            keys_unsorted = keys = None
            if not _nat:
                keys_unsorted = sw_of_edge * _BIG + column_index
                keys = np.sort(keys_unsorted)
            starts_ne = e_start[ne]
            E_ne = E_sw[ne]
            if auto_width:
                if caps.band_supers:
                    raise ValueError(
                        "band_widths='auto' cannot satisfy PlanCaps "
                        "(shard-uniform plans need explicit widths)")
                # VMEM cap: see the band_spill='never' branch below.  Also
                # capped at the padded row space M = num_sw*band_h: spill-
                # mode starts clamp into [0, M-W] (negative for W > M), and
                # the folded/padded fast path needs every slice inside M.
                W_CAP = min(2048, max(128 if config.impl == "pallas" else 16,
                                      (num_sw * bh)
                                      // (128 if config.impl == "pallas"
                                          else 16)
                                      * (128 if config.impl == "pallas"
                                         else 16)))
                qs = tuple(sorted({0.5, 0.75, 0.9,
                                   float(config.band_coverage), 1.0}))
                if _nat:
                    rw = _w.native_band_robust(
                        rp64, column_index, n, bh, qs)[3][:, ne]
                else:
                    rw = _robust_widths(keys, e_start, e_end, ne, qs)
                qcov = rw[qs.index(float(config.band_coverage))]
                cands = set()
                for row in (qcov, rw[-1]):
                    for pct in (50, 60, 70, 80, 90, 95, 99, 100):
                        v = r_up(np.percentile(row, pct))
                        if v <= W_CAP:
                            cands.add(v)
                # hub-heavy graphs have extent distributions whose every
                # percentile exceeds W_CAP, leaving only the widest
                # candidate — but the placed-window coverage curve is
                # concave, so NARROW windows + spill often win there
                # (round-3 hardware: RD resolves 2048 from percentiles
                # alone while the width sweep measured W=512 1.2x
                # faster).  Always consider a fixed ladder too.
                for v in (128, 256, 384, 512, 640, 768, 1024, 1536, 2048):
                    if v <= W_CAP and v == r_up(v):
                        cands.add(v)
                if not cands:
                    cands.add(r_up(min(int(np.median(qcov)), W_CAP)))
                # total modeled cost per candidate width; coverage comes
                # from the quantile table (step interpolation — exact
                # placement runs once for the winner, below)
                qs_arr = np.asarray(qs)
                cand_list = sorted(cands)
                cost_w = {}
                unc_w_tot = {}
                # band-block compute wall: the int8->bf16 convert + MXU
                # dot cost ~2.1 ps per A ELEMENT on v5e (measured: DD's
                # 214M-element band runs ~450 us compute-bound,
                # docs/ROADMAP.md) — wide low-occupancy bands hit this
                # before the byte stream
                a_elem_s = float(getattr(config, "a_elem_ps", 2.1)) * 1e-12
                for wc in cand_list:
                    nq = (rw <= wc).sum(axis=0)
                    lo = np.maximum(nq - 1, 0)
                    frac = np.where(nq > 0, qs_arr[lo], 0.0)
                    # linear interpolation toward the next quantile step:
                    # the step function is a coverage LOWER bound, which
                    # over-charged narrow candidates with phantom spill
                    # (round-3: RD resolved W=2048 while hardware said
                    # W=512, artifacts/round3_hw.jsonl width sweeps)
                    hi = np.minimum(nq, len(qs_arr) - 1)
                    w_lo = np.where(nq > 0,
                                    rw[lo, np.arange(rw.shape[1])], 0.0)
                    w_hi = rw[hi, np.arange(rw.shape[1])]
                    t = np.clip((wc - w_lo) / np.maximum(w_hi - w_lo, 1.0),
                                0.0, 1.0)
                    frac = frac + (qs_arr[hi] - np.where(nq > 0, qs_arr[lo],
                                                         0.0)) * t
                    frac = np.minimum(frac, 1.0)
                    cov = frac * E_ne
                    band_s = np.maximum(
                        (bh * wc + wc * dnom * xbytes) / bw_s,
                        bh * wc * a_elem_s)
                    cost_w[wc] = band_s + (E_ne - cov) * g_ns
                    unc_w_tot[wc] = float((E_ne - cov).sum())
                # A nonzero spill population costs a FIXED dispatch tax on
                # top of the per-edge model: the take + merge chain's own
                # launches and (for dstream) destination-block R/W floors.
                # Round-2 hardware: routing 0.1% of DD's edges to spill
                # cost +35-107 us vs the zero-spill shape (dd_default 643
                # vs dd_w640 608; dstream delta in kernels/dstream.py) —
                # the regression VERDICT r2 flagged.  Charging it here
                # collapses near-zero-spill plans to the zero-spill
                # direct-write shape (the 100th-percentile candidate).
                spill_fixed = float(getattr(config, "spill_fixed_s", 80e-6))

                def _tot_single(wc):
                    per = np.minimum(cost_w[wc], sparse_cost[ne])
                    # dropped supers (gather cheaper than the band block)
                    # also ride the spill population in spill mode
                    has_spill = (unc_w_tot[wc] > 0
                                 or bool((cost_w[wc]
                                          > sparse_cost[ne]).any()))
                    return float(per.sum()) + (spill_fixed if has_spill
                                               else 0.0)

                best = None
                for wc in cand_list:
                    tot = _tot_single(wc)
                    if best is None or tot < best[0]:
                        best = (tot, (wc,))
                # 2-width ladders: a narrow bucket can band the loose-
                # extent supers a single wide bucket would drop to the
                # gather path (e.g. RD stand-in: 1482/4746 supers dropped
                # at the single 2048).  A second bucket costs a second
                # kernel launch + block-scatter merge that the byte model
                # does not see — round-1 hardware measured a modeled-16%-
                # cheaper split LOSING (606 vs 548 us at DD scale), so the
                # pair must beat the best single by a wide margin (15%)
                # plus the fixed launch cost.
                split_penalty_s = 60e-6
                best_single = best[0]
                for i, w_lo in enumerate(cand_list):
                    for w_hi in cand_list[i + 1:]:
                        pair = np.minimum(cost_w[w_lo], cost_w[w_hi])
                        has_spill = (
                            min(unc_w_tot[w_lo], unc_w_tot[w_hi]) > 0
                            or bool((pair > sparse_cost[ne]).any()))
                        tot = (float(np.minimum(pair, sparse_cost[ne]).sum())
                               + split_penalty_s
                               + (spill_fixed if has_spill else 0.0))
                        if tot < min(best[0], 0.85 * best_single):
                            best = (tot, (w_lo, w_hi))
                band_widths = best[1]
                if len(band_widths) == 1:
                    # EXACT-placement refinement (round 4): the quantile
                    # coverage interpolation is a width-resolution
                    # heuristic whose error compounds at coarse start
                    # alignment (tband al=128) — measured: cluster-
                    # reordered DD resolved W=512 with 180k REAL spill
                    # edges (1.5 ms) while W=768 places zero-spill
                    # (~250 us).  Re-price the top candidates (and the
                    # +128 neighbor of the best) with exact placements —
                    # one native multi-width pass, O(E * ncand).
                    ranked = sorted(cand_list, key=_tot_single)[:4]
                    w0 = int(band_widths[0])
                    exact_c = tuple(sorted({
                        *(int(v) for v in ranked), w0,
                        *( (w0 + 128,) if w0 + 128 <= W_CAP else () ),
                    }))
                    if _nat:
                        cov_x = _w.native_band_place(
                            rp64, column_index, n, bh, al, exact_c
                        )[0][:, ne]
                    else:
                        cov_x = np.zeros((len(exact_c), len(ne)),
                                         dtype=np.int64)
                        for b2, wb2 in enumerate(exact_c):
                            cov_x[b2], _ = _place_band_windows(
                                keys, starts_ne, int(wb2), align=al)
                    # Density-aware spill rate: the streamed merge's
                    # chunk fill collapses when spill edges scatter
                    # thinly over the destination tiles (YS-class:
                    # 170k edges over a 1.7M-row space measured
                    # ~29 ns/edge vs ~5 at powerlaw density — the
                    # gathers are mostly chunk padding).  Anchored
                    # hyperbola: + ~250/ept ns (ept = edges per
                    # 128-row tile); reproduces 29 ns at ept 12.7 and
                    # ~the base rate past ept ~60.
                    m_tiles = max(num_sw * bh / 128.0, 1.0)
                    tots = []
                    for b2, wb2 in enumerate(exact_c):
                        unc_v = E_ne - cov_x[b2]
                        unc2 = float(unc_v.sum())
                        ept = max(unc2 / m_tiles, 0.5)
                        g_eff = g_ns + min(250.0 / ept, 120.0) * 1e-9
                        band_s2 = max(
                            (bh * wb2 + wb2 * dnom * xbytes) / bw_s,
                            bh * wb2 * a_elem_s)
                        per2 = np.minimum(band_s2 + unc_v * g_eff,
                                          sparse_cost[ne])
                        dropped2 = bool((band_s2 + unc_v * g_eff
                                         > sparse_cost[ne]).any())
                        tots.append(float(per2.sum())
                                    + (spill_fixed if (unc2 > 0 or dropped2)
                                       else 0.0))
                    band_widths = (exact_c[int(np.argmin(tots))],)
                caps_s = (0,) * len(band_widths)
                xp_rows = max(xp_rows, int(band_widths[-1]))
            # exact placement per ladder width; per-super bucket choice
            # minimizes modeled cost (band bytes + spill gather)
            nb = len(band_widths)
            if _nat:
                covf, stf, _ = _w.native_band_place(
                    rp64, column_index, n, bh, al, band_widths)
                cov_b, st_b = covf[:, ne], stf[:, ne]
            else:
                cov_b = np.zeros((nb, len(ne)), dtype=np.int64)
                st_b = np.zeros((nb, len(ne)), dtype=np.int64)
                for b, wb in enumerate(band_widths):
                    cov_b[b], st_b[b] = _place_band_windows(
                        keys, starts_ne, int(wb), align=al)
            widths_arr = np.asarray(band_widths, dtype=np.float64)
            band_cost_b = (
                (bh * widths_arr[:, None]
                 + widths_arr[:, None] * dnom * xbytes) / bw_s
                + (E_ne[None, :] - cov_b) * g_ns
            )
            best_b = np.argmin(band_cost_b, axis=0)
            ar_ne = np.arange(len(ne))

            # ---- population routing: the LOI selector generalized to the
            # TPU population set (reference: the two-way CUDA/TC dispatch,
            # hybrid_all_kernel.cu:261-262 + .cu:960).  Two passes with
            # costs in seconds from the measured constants (streamed
            # bytes at stream_gbps, gathered rows at take_gbps):
            #
            # 1. per WINDOW: a TC-suitable window routes to the MXU
            #    dense-bucket population iff its bucket cost (gather
            #    K_pad unique rows + stream the A block) beats leaving
            #    its *uncovered* edges (w.r.t. the super's placed band
            #    window) to the spill gather.  Windows already inside
            #    the band window stay banded for free.
            # 2. per SUPERWINDOW: with bucket windows carved out, the
            #    band window is RE-PLACED on the remaining edges and
            #    kept iff streaming it beats gathering those edges.
            w_of_w = (np.arange(wa.num_windows, dtype=np.int64) * wh) // bh
            kmax_r = widths[-1]
            tc_w = (
                (wa.hybrid_type == 1)
                & (wa.edge_counts > 0)
                & (wa.unique_counts <= kmax_r)
            )
            kpad_w = np.asarray(widths + (kmax_r,))[
                np.minimum(np.searchsorted(np.asarray(widths),
                                           wa.unique_counts), len(widths))
            ]
            win_bucket_cost = wh * kpad_w / bw_s + kpad_w * g_ns
            # per-window uncovered-edge count under the all-edges placed
            # window of its super
            st_all = np.zeros(num_sw, dtype=np.int64)
            st_all[ne] = st_b[best_b, ar_ne]
            bbw_all = np.asarray(band_widths)[best_b]
            bbw_sw = np.zeros(num_sw, dtype=np.int64)
            bbw_sw[ne] = bbw_all
            lc_all = column_index - st_all[sw_of_edge]
            out_win_e = (lc_all < 0) | (lc_all >= bbw_sw[sw_of_edge])
            uncov_w = np.bincount(
                wa.edge_to_window[out_win_e], minlength=wa.num_windows)
            dense_routed_w = tc_w & (win_bucket_cost < uncov_w * g_ns)
            if config.band_mode == "always":
                dense_routed_w &= False
            if tband:
                # the transposed band path (kernels/tband.py) applies
                # band + spill ONLY — it has no dense-bucket application
                # in the [dt, M] layout, so dense-routing a window here
                # would silently DROP its edges (PT+rcm built such a
                # plan and lost 9.5k of 162k edges; caught round 5)
                dense_routed_w &= False
            # Layout-aware routing (round 2): ANY dense-routed window (or
            # dropped super, below) breaks full band cover, which forfeits
            # the closed padded layout — the rows layout re-pads/slices
            # every application, ~2 extra [M, dp] passes of glue.  Full-
            # cover-breaking routing must beat that fixed cost COLLECTIVELY,
            # not just its own marginal gather cost.
            glue_s = (getattr(config, "glue_passes", 2.0)
                      * (num_sw * bh) * dnom * xbytes / bw_s)
            if dense_routed_w.any():
                save_dense = float(
                    (uncov_w[dense_routed_w] * g_ns
                     - win_bucket_cost[dense_routed_w]).sum())
                if save_dense < glue_s:
                    dense_routed_w &= False

            # pass 2: re-place band on non-bucket edges, per-super on/off
            tc_e = dense_routed_w[wa.edge_to_window]
            cov_rest = np.zeros(num_sw, dtype=np.int64)
            st_rest = np.zeros(num_sw, dtype=np.int64)
            best_rest = np.zeros(num_sw, dtype=np.int64)
            if not tc_e.any():
                # nothing dense-routed: the rest set IS the full edge set
                # — reuse pass 1's placement instead of recomputing
                rest_cnt = E_sw.copy()
                ne_rest = ne
                covr_b, str_b = cov_b, st_b
            elif _nat:
                covr_f, str_f, rest_cnt = _w.native_band_place(
                    rp64, column_index, n, bh, al, band_widths,
                    mask=~tc_e, num_sw=num_sw)
                ne_rest = np.where(rest_cnt > 0)[0]
                covr_b = covr_f[:, ne_rest]
                str_b = str_f[:, ne_rest]
            else:
                rest_cnt = np.bincount(
                    sw_of_edge[~tc_e], minlength=num_sw).astype(np.int64)
                keys_rest = np.sort(keys_unsorted[~tc_e])
                rest_pos = np.zeros(num_sw + 1, dtype=np.int64)
                np.cumsum(rest_cnt, out=rest_pos[1:])
                ne_rest = np.where(rest_cnt > 0)[0]
                covr_b = np.zeros((nb, len(ne_rest)), dtype=np.int64)
                str_b = np.zeros((nb, len(ne_rest)), dtype=np.int64)
                for b, wb in enumerate(band_widths):
                    covr_b[b], str_b[b] = _place_band_windows(
                        keys_rest, rest_pos[:-1][ne_rest], int(wb),
                        align=al)
            if len(ne_rest):
                band_cost_rb = (
                    (bh * widths_arr[:, None]
                     + widths_arr[:, None] * dnom * xbytes) / bw_s
                    + (rest_cnt[ne_rest][None, :] - covr_b) * g_ns
                )
                br = np.argmin(band_cost_rb, axis=0)
                arr_r = np.arange(len(ne_rest))
                cov_rest[ne_rest] = covr_b[br, arr_r]
                st_rest[ne_rest] = str_b[br, arr_r]
                best_rest[ne_rest] = br

            S_rest = (bh * widths_arr[best_rest]
                      + widths_arr[best_rest] * dnom * xbytes) / bw_s
            if config.band_mode == "always":
                band_on = np.zeros(num_sw, dtype=bool)
                band_on[ne] = cov_b[best_b, ar_ne] > 0
            else:
                # band on iff streaming the block beats raw-gathering the
                # edges it covers (a dropped super's edges ride the spill
                # population — one sorted take per edge — and its output
                # block zeroes; spmm_pallas_padded handles partial cover,
                # so no layout-glue term here, unlike dense routing above)
                band_on = (rest_cnt > 0) & (S_rest < cov_rest * g_ns)
            band_sel = band_on
            bucket_sw = best_rest
            start = st_rest
            if config.band_mode == "always":
                bucket_sw = np.zeros(num_sw, dtype=np.int64)
                bucket_sw[ne] = best_b
                start = st_all
        elif auto_width:
            # Resolve band width from the measured extent distribution:
            # a single bucket at round128(max extent) keeps the one-call
            # direct-write fast path whenever the distribution is tight;
            # a long tail gets a p95 bucket + max bucket instead of
            # padding every superwindow to the outlier width.
            if caps.band_supers:
                raise ValueError(
                    "band_widths='auto' cannot satisfy PlanCaps "
                    "(shard-uniform plans need explicit widths)")
            ne_ext = extent[nonempty]
            if len(ne_ext):
                r128 = lambda v: max(128, -(-int(v) // 128) * 128)
                # VMEM cap: the deep pipeline holds L A-blocks + L X
                # bands in scratch (kernels.block_spmm); beyond ~2048
                # that blows the 16 MB VMEM budget (observed: a long-
                # tail graph resolved W=19200 and OOM'd on hardware).
                # Wider superwindows simply don't fit a bucket and route
                # to the gather paths, as the pre-auto ladder did.
                W_CAP = 2048
                ne_ext = ne_ext[ne_ext <= W_CAP]
                if not len(ne_ext):
                    ne_ext = np.array([W_CAP], dtype=np.int64)
                w_max = r128(ne_ext.max())
                # Two-bucket split only when it cuts band bytes >=25%
                # (A + X band both scale with width): the multi-bucket
                # full-cover path costs one direct write + a block
                # scatter + a second kernel's pipeline fill, measured
                # worth ~70 us at DD scale (606 vs 535 us for a 16%
                # byte cut — split loses).  Candidate lower widths from
                # extent percentiles.
                best = (len(ne_ext) * w_max, (w_max,))
                for pct in (50, 60, 70, 80, 90, 95):
                    w_lo = r128(np.percentile(ne_ext, pct))
                    if w_lo >= w_max:
                        continue
                    n_lo = int((ne_ext <= w_lo).sum())
                    bytes_2 = n_lo * w_lo + (len(ne_ext) - n_lo) * w_max
                    if bytes_2 < best[0]:
                        best = (bytes_2, tuple(sorted({w_lo, w_max})))
                single_bytes = len(ne_ext) * w_max
                band_widths = (
                    best[1] if best[0] <= 0.75 * single_bytes else (w_max,)
                )
            caps_s = (0,) * len(band_widths)
            xp_rows = max(xp_rows, int(band_widths[-1]))
        if not spill_mode:
            bucket_sw = np.searchsorted(np.asarray(band_widths), extent)
            fits = nonempty & (bucket_sw < len(band_widths))

            if config.band_mode == "always":
                band_sel = fits
            else:
                # measured cost model: band streams H*Bb int8 of A plus
                # one Bb-row f32-container band of X; the alternative
                # gathers one padded ELL slot per edge (XLA take path).
                bb_arr = np.asarray(band_widths + (band_widths[-1],))[
                    np.minimum(bucket_sw, len(band_widths))
                ]
                band_cost = (bh * bb_arr + bb_arr * dnom * xbytes) / bw_s
                band_sel = fits & (band_cost < sparse_cost)

        # Full coverage: when every nonempty superwindow is band-selected,
        # sweep the empty ones into the smallest bucket (zero A blocks) so
        # the whole output is produced by direct-write band kernels and the
        # merge permutation pass disappears (kernels.block_spmm).  Dense-
        # routed windows inside banded supers break direct write (their
        # rows' outputs come from the bucket region via out_perm).
        no_dense_routed = dense_routed_w is None or not dense_routed_w.any()
        if (bool(band_sel[nonempty].all()) and bool(nonempty.any())
                and no_dense_routed):
            band_sel = band_sel | ~nonempty
        band_full_cover = (bool(band_sel.all()) and len(band_sel) > 0
                           and no_dense_routed)

        # Collapse a *configured* ladder to a single width bucket when the
        # extra A padding is cheap (auto widths already chose the optimal
        # split from the extent distribution — never collapse those).
        # Multi-bucket full cover costs one direct write + a small block
        # scatter (kernels.block_spmm), so this is a mild preference for
        # the one-kernel shape, not the old 2x aliasing-chain penalty.
        if band_full_cover and not auto_width and not spill_mode:
            sel = np.where(band_sel)[0]
            used = np.unique(bucket_sw[sel])
            if len(used) > 1:
                bmax = int(used.max())
                widths_arr = np.asarray(band_widths)
                bytes_multi = int(
                    (widths_arr[bucket_sw[sel]] * bh).sum()
                )
                bytes_single = int(widths_arr[bmax]) * bh * len(sel)
                if bytes_single <= 1.5 * bytes_multi:
                    bucket_sw[sel] = bmax

        # Clamp band starts so every band slice stays inside the padded
        # row space M = num_sw*band_h.  Validity: a start may sit anywhere
        # in [max_col+1-Bb, min_col] (16-aligned); since max_col < n <= M,
        # M-Bb is always a valid lower position whenever M >= Bb.  With
        # clamped starts the SpMM closes over the padded layout
        # [M, dp] -> [M, dp] with ZERO pad/slice passes per application
        # (see kernels.block_spmm.spmm_pallas_padded).
        # (square plans only: a rectangular row-block shard's columns span
        # the *global* space, where max_col may exceed the local M)
        m_rows = num_sw * bh
        bbw_of = np.asarray(band_widths + (band_widths[-1],))[
            np.minimum(bucket_sw, len(band_widths))
        ]
        can_clamp = band_sel & (m_rows >= bbw_of) & (n == c)
        clamp_bound = (m_rows - bbw_of) // al * al
        start = np.where(can_clamp, np.minimum(start, clamp_bound), start)

        # in-window mask: spill mode carves each banded super's A block
        # from the placed window only; everything else spills (computed
        # AFTER clamping so the clamp never invalidates an A entry).
        # Edges of dense-routed (bucket) windows belong to the bucket
        # population: never in band A, never spilled.
        if spill_mode:
            lc_e = column_index - start[sw_of_edge]
            in_win_e = (lc_e >= 0) & (lc_e < bbw_of[sw_of_edge])
            bandwin_e = (band_sel[sw_of_edge]
                         & ~dense_routed_w[wa.edge_to_window])
            in_win_e &= bandwin_e
            # NON-banded supers' edges also ride the spill population
            # (round 2): one sorted segment-sum + scatter-add instead of
            # the ELL per-row-DMA / residual paths, and — decisive — the
            # padded layout stays closed under PARTIAL band cover (their
            # output blocks zero + spill adds; see
            # kernels.block_spmm.spmm_pallas_padded).
            nonband_e = (~band_sel[sw_of_edge]
                         & ~dense_routed_w[wa.edge_to_window])
            spill_mask_e = (bandwin_e & ~in_win_e) | nonband_e
        else:
            in_win_e = np.ones(len(column_index), dtype=bool)
            spill_mask_e = np.zeros(len(column_index), dtype=bool)

        sw_pos = np.full(num_sw, -1, dtype=np.int64)
        for s, bbw in enumerate(band_widths):
            sws = np.where(band_sel & (bucket_sw == s))[0].astype(np.int64)
            # zero-capacity when empty (impls skip the kernel launch);
            # caps force a min capacity for uniform shard stacking
            # (capacity-padded entries carry the trash sw_id, see
            # device_arrays)
            sb = max(len(sws), caps_s[s])
            starts_arr = np.zeros(sb, dtype=np.int32)
            edges = np.zeros((0, 3), dtype=np.int32)
            if len(sws):
                sw_pos[sws] = np.arange(len(sws))
                starts_arr[: len(sws)] = start[sws].astype(np.int32)
                xp_rows = max(xp_rows, int((start[sws] + bbw).max()))
                # compact A: (super pos, local row, band-local col) per edge
                sel_e = (band_sel[sw_of_edge]
                         & (bucket_sw[sw_of_edge] == s) & in_win_e)
                e_sw = sw_of_edge[sel_e]
                # preallocated column writes: np.stack measured 0.88 s
                # for the same 1.7M x 3 result
                edges = np.empty((len(e_sw), 3), dtype=np.int32)
                edges[:, 0] = sw_pos[e_sw]
                edges[:, 1] = wa.edge_to_row[sel_e].astype(np.int64) % bh
                edges[:, 2] = column_index[sel_e] - start[e_sw]
                band_nnz += int(sel_e.sum())
            band_starts.append(starts_arr)
            band_edges.append(edges)
            band_sw_ids.append(sws)
        # supers in no bucket (partial cover): the padded SpMM zeroes
        # their blocks (their edges are in the spill population)
        band_missing = np.where(~band_sel)[0].astype(np.int32)
        w_of = (np.arange(wa.num_windows, dtype=np.int64) * wh) // bh
        band_window_mask = band_sel[w_of]
        if dense_routed_w is not None:
            band_window_mask &= ~dense_routed_w

        profiling.phase("format.plan.spill")
        # ---- spill population (sorted by row: CSR edge order) ----
        spill_nnz = int(spill_mask_e.sum())
        if spill_nnz or caps.num_spill_rows or caps.num_spill_edges:
            sp_rows_e = wa.edge_to_row[spill_mask_e].astype(np.int64)
            sp_cols_e = column_index[spill_mask_e].astype(np.int32)
            if len(sp_rows_e):
                flags = np.empty(len(sp_rows_e), dtype=bool)
                flags[0] = True
                np.not_equal(sp_rows_e[1:], sp_rows_e[:-1], out=flags[1:])
                sp_rows_u = sp_rows_e[flags]
                sp_seg = (np.cumsum(flags) - 1).astype(np.int32)
            else:
                sp_rows_u = np.zeros(0, dtype=np.int64)
                sp_seg = np.zeros(0, dtype=np.int32)
            rp_cap = max(len(sp_rows_u), caps.num_spill_rows, 1)
            ep_cap = max(len(sp_cols_e), caps.num_spill_edges, 1)
            spill_fields = dict(
                num_spill_rows=rp_cap,
                num_spill_edges=ep_cap,
                spill_nnz=spill_nnz,
                # INT32_MAX row padding: always out of bounds, so the
                # scatter-add's mode='drop' discards it
                spill_rows=_pad_to(sp_rows_u.astype(np.int32), rp_cap,
                                   np.iinfo(np.int32).max),
                spill_edge_col=_pad_to(sp_cols_e, ep_cap, c),
                spill_edge_seg=_pad_to(sp_seg, ep_cap, rp_cap),
            )
            # dstream pays ~2x64 KB of destination-block R/W per touched
            # 128-row tile; with few edges per touched tile the take
            # path's per-edge cost is cheaper (measured: DD's 1865
            # scattered spill edges cost +107 us under dstream while
            # powerlaw's 440 edges/tile run 2.8x faster)
            # ---- streamed-merge layout choice (tile vs block vs take) ----
            # Exact chunk counts are host-computable, so the choice is a
            # measured-constant cost model, not a threshold: gathered
            # rows = chunks*128 (the padding gathers are real HBM reads,
            # round-3 campaign), one one-hot dot per chunk ([128,128] for
            # tile-pure chunks, [G*128,128] for block-wide), plus the
            # grid-step floor and the per-touched-block R/W.
            ds_kind = "tile"
            ds_dense_enough = False
            compact_ok = False
            if spill_nnz and config.spill_impl == "dstream" \
                    and (num_sw * bh) % 128 == 0:
                from hcspmm_tpu_torch.format.streams import pick_group as _pg

                _g = _pg(num_sw * bh)
                tiles_cnt = np.bincount(sp_rows_e >> 7)
                tiles_cnt = tiles_cnt[tiles_cnt > 0]
                blk_cnt = np.bincount(sp_rows_e // (_g * 128))
                blk_cnt = blk_cnt[blk_cnt > 0]
                chunks_t = int((-(-tiles_cnt // 128)).sum())
                chunks_b = int((-(-blk_cnt // 128)).sum())
                # constants refit on the round-3 continuation A/Bs
                # (artifacts/round3_hw.jsonl ab_kind, post pad-self-fetch
                # fix): gather ~4 ns/row from tables under the
                # ds_table_mb page-locality wall, ~8 ns above it
                # (take_vs_table probe: 3.9 @ 102 MB vs 8.6 @ 1.2 GB);
                # the refit reproduces every measured ordering — block
                # wins DD/YS/RD/TT, tile wins powerlaw (high fill +
                # small table), take never wins above the tiny-spill
                # floor (YS measured take +1.4 ms over block at only
                # 45k edges: the XLA segsum+scatter chain carries a
                # ~1.2 ms fixed cost)
                el_b = 2 if config.compute_dtype == "bfloat16" else 4
                _tbl_mb = num_sw * bh * 128 * el_b / 1e6
                # unique-column compaction (round 4): when the activation
                # table exceeds the page-locality wall but the spill's
                # UNIQUE columns fit a compact table, one sorted take
                # builds [U, dp] and every chunk gather (incl. padding)
                # runs at the small-table rate.
                compact_fixed = 0.0
                if config.ds_table_mb > 0 and _tbl_mb > config.ds_table_mb:
                    _u_cols = int(len(np.unique(sp_cols_e)))
                    _uc_mb = _u_cols * 128 * el_b / 1e6
                    compact_ok = (_uc_mb <= config.ds_table_mb
                                  and _uc_mb < 0.5 * _tbl_mb)
                    if compact_ok:
                        compact_fixed = _u_cols * 8e-9
                g_s = (4e-9 if (compact_ok
                                or _tbl_mb <= config.ds_table_mb)
                       else 8e-9)
                floor_s = 0.15e-6
                blk_rw = 2 * _g * 128 * dnom * xbytes / bw_s
                # tile-pure chunks in the blocked-gather regime split
                # every tile's edges across column ranges: measured
                # ~1.3x more padding gathers (TT tile 30.1 vs block
                # 24.2 ms).  Charge it iff the range blocking below will
                # actually block — same n_rng and density gate (ADVICE
                # r3: the old form hardcoded 2 ranges and omitted the
                # ds_table_mb > 0 blocking-enabled check).  g_s stays on
                # pure table size: with blocking disabled the layout
                # still gathers unsliced from the big table, so the slow
                # rate is the physically right price there.
                tiles_u = max(len(tiles_cnt), 1)
                n_rng_m = 1
                if (not compact_ok and config.ds_table_mb > 0
                        and spill_nnz >= config.ds_blocked_min_edges
                        and _tbl_mb > config.ds_table_mb):
                    n_rng_m = int(-(-_tbl_mb // config.ds_table_mb))
                    if spill_nnz / (n_rng_m * tiles_u) < 128:
                        n_rng_m = 1
                chunks_t_eff = (int(chunks_t * 1.3) if n_rng_m > 1
                                else chunks_t)
                # per-chunk step constants refit round 5 on measured
                # tile/block/take triples (artifacts/ab_kind_r5.jsonl:
                # GH@1.0 wide tile 56.8 / block 39.3 / take 49.3 ms, AZ
                # tile 4.96 / block 6.67 / take 19.1, PT wash; plus DD
                # tile 1.36 < block 1.56 and RD/TT/YS block wins, r3/r4).
                # The old dot_s*G term priced a block chunk's one-hot dot
                # as G tile dots (224 ns at G=8) and flipped GH block ->
                # tile (28.6 -> 56.7 ms regression, VERDICT r4 #2); the
                # measured reality is a near-flat per-chunk step cost —
                # the kind choice is carried by CHUNK COUNTS (gather
                # fill), not MXU work.
                # per-chunk: a ~200 ns step floor, plus the one-hot
                # build (~18 ns per 128x128 tile of it — the block form
                # builds G tiles); per-destination-region accumulator
                # R/W at stream bandwidth ([128, dp] per touched tile
                # for tile-pure, [G*128, dp] per block for block-wide).
                tile_step_s = 200e-9
                block_step_s = 200e-9 + _g * 18e-9
                tile_rw = 2 * 128 * dnom * xbytes / bw_s
                cost_tile = (chunks_t_eff * 128 * g_s
                             + chunks_t * tile_step_s
                             + (-(-chunks_t // _g)) * floor_s
                             + tiles_u * tile_rw + compact_fixed)
                cost_block = (chunks_b * 128 * g_s
                              + chunks_b * block_step_s
                              + len(blk_cnt) * blk_rw + compact_fixed) \
                    if _g > 1 else np.inf
                # take path: exact-count gather + XLA segsum + scatter
                # (measured 7.5 + 13.7 ns/row, artifacts/round2_hw.jsonl)
                # + the chain's measured fixed cost (YS ab_kind)
                cost_take = spill_nnz * 25e-9 + 1.2e-3 \
                    if spill_nnz > 4096 else 0.0
                # tiny spill: take's fixed chain beats any kernel launch
                # (spill_fixed_s covers the shape choice upstream)
                best_k = min((cost_tile, "tile"), (cost_block, "block"),
                             (cost_take, "take"))
                ds_kind = best_k[1]
                if config.ds_kind != "auto":
                    ds_kind = config.ds_kind
                ds_dense_enough = ds_kind != "take"
                # transposed-band plans merge spill in the LANE
                # orientation (kernels/tspill.py tbstream): that path
                # consumes block-wide chunks and has no relayout passes,
                # so it beats 'take' (which would pay three [M, dt]
                # transposes in the wrapper) at any size — force the
                # block build.
                if tband and config.spill_lane != "off":
                    ds_kind = "block"
                    ds_dense_enough = True
            if (config.spill_impl == "dstream" and ds_dense_enough
                    and config.impl == "pallas" and band_widths
                    and (num_sw * bh) % 128 == 0
                    and not (caps.num_spill_rows or caps.num_spill_edges)):
                # dst-streamed Pallas merge layout (kernels/dstream.py);
                # shard-uniform (caps) plans keep 'take' (chunk counts
                # are not shard-uniform).  Edges are CSR order = dst-
                # sorted already.
                from hcspmm_tpu_torch.format.streams import (build_dstream,
                                                        build_dstream_ranges)

                mp = num_sw * bh
                # column-range blocking (see config.ds_table_mb): the
                # activation table estimate assumes the padded dp=128
                # lane floor at the plan's compute dtype
                el_b = 2 if config.compute_dtype == "bfloat16" else 4
                tbl_mb = mp * 128 * el_b / 1e6
                n_rng = 1
                if (not compact_ok and config.ds_table_mb > 0
                        and spill_nnz >= config.ds_blocked_min_edges
                        and tbl_mb > config.ds_table_mb):
                    n_rng = int(-(-tbl_mb // config.ds_table_mb))
                    # blocking splits every destination tile's edges
                    # across ranges, so chunk fill (and the padding
                    # gathers) scale with per-RANGE density: measured
                    # 2.5x LOSS at 15 edges/(range*tile) on the RD
                    # stand-in (artifacts/round3_hw.jsonl) — require
                    # the same density gate per range (tiles_u is the
                    # chooser's touched-tile count, same quantity)
                    tiles_t = tiles_u
                    if spill_nnz / (n_rng * tiles_t) < 128:
                        # measured crossover: below ~128 edges per
                        # (range, tile) the split's padding gathers
                        # outweigh the small-table rate (round-3 A/B)
                        n_rng = 1
                if ds_kind == "block":
                    from hcspmm_tpu_torch.format.streams import build_bstream

                    ds_g, ds_l, ds_b, ds_grp = build_bstream(
                        sp_rows_e, sp_cols_e, mp, pad_col=c)
                    ds_t, ds_m = np.zeros(0, dtype=np.int32), None
                elif n_rng > 1:
                    ds_g, ds_l, ds_b, ds_t, ds_grp, ds_m = (
                        build_dstream_ranges(sp_rows_e, sp_cols_e, mp,
                                             pad_col=c, num_ranges=n_rng,
                                             range_rows=-(-mp // (128 * n_rng))
                                             * 128))
                else:
                    ds_g, ds_l, ds_b, ds_t, ds_grp = build_dstream(
                        sp_rows_e, sp_cols_e, mp, pad_col=c)
                    ds_m = None
                # f32-cast gather only pays when the table is big
                # enough to sit in the slow-gather regime (bf16 from an
                # 86 MB table measured 2-2.6 ns/row — casting there COST
                # 2.3x end-to-end on powerlaw, artifacts round-3) and the
                # spill is large enough to repay the cast stream
                # lane-oriented merge arrays for transposed-band plans
                # (kernels/tspill.py) — capture the ORIGINAL column ids
                # before any row-path compact remap below
                lane_fields = {}
                if (tband and config.spill_lane != "off"
                        and ds_kind == "block"):
                    profiling.phase("format.plan.lanes")
                    # lane chunks get their OWN (larger) group: [dt,
                    # G*128] destination blocks are dt/128 the bytes of
                    # the row layout's [G*128, 128], so a 4x group
                    # quarters the block-boundary chunk breaks that
                    # dominate diffuse spills (YH: ~3k single-chunk
                    # blocks at G=8 measured ~42 ns/edge)
                    from hcspmm_tpu_torch.format.streams import (
                        build_bstream as _bb, pick_group as _pgl)

                    # host cost model over candidate (group, chunk
                    # width) pairs: per chunk a ~400 ns fixed step
                    # (gathered/local streams, dot, grid) + the
                    # [bw, span] one-hot build (~0.0011 ns per element,
                    # VPU-bound: span 4096 measured ~550 ns at bw=128,
                    # 256 ~35 ns), per visited block a [dt, span] R/W
                    # pair (dt=32 estimate), plus the padding slots'
                    # repeat-page gathers (~2 ns each — wider chunks cut
                    # the fixed cost but inflate padding at low
                    # edges-per-block fill).  Dense spills want small
                    # spans (one-hot cost per full chunk), diffuse ones
                    # large (block-break chunks dominate) — YH picks
                    # (16, 128), RD (8, 256), TT (4, 512).
                    def _lane_cost_rows(rows_l, e_cnt):
                        def cost(gb):
                            g, bwm = gb
                            span_l = g * 128
                            bw_l = bwm * 128
                            bc = np.bincount(rows_l // span_l)
                            bc = bc[bc > 0]
                            chunks_l = int((-(-bc // bw_l)).sum())
                            oh_ns = 0.0011 * bw_l * span_l
                            rw_ns = 2 * 32 * span_l * 2 / 819e9 * 1e9
                            pad_ns = (chunks_l * bw_l - e_cnt) * 2.0
                            return (chunks_l * (400.0 + oh_ns)
                                    + len(bc) * rw_ns + pad_ns)
                        return cost

                    cand_g = [(g, b) for g in (4, 8, 16, 32)
                              if mp % (g * 128) == 0
                              for b in (1, 2, 4, 8)]

                    def _build_lane_stream(rows_l, cols_l):
                        """(g, bw) choice + block-wide chunking for one
                        edge stream; returns (gcols int64, local int32
                        [lpad, bw], blk, group)."""
                        grp, bwm = (min(cand_g, key=_lane_cost_rows(
                            rows_l, len(rows_l))) if cand_g
                            else (_pgl(mp, max_group=32), 1))
                        g_, l_, b_, grp = _bb(
                            rows_l, cols_l, mp, pad_col=c, group=grp,
                            chunk_edges=bwm * 128)
                        return g_.astype(np.int64), l_.astype(np.int32), \
                            b_, grp

                    # ---- hub split (round 5): the spill gather cache is
                    # ~16-24 MB and warms only via misses, so the
                    # duplicated segment tables (T2 below) pay ~68 us/MB
                    # per pass.  When the top hub columns cover enough of
                    # the spill edges (config.spill_hub_min_cov) at
                    # enough reuse, they run as their OWN chunk stream
                    # against a cache-resident hub table (hot for its
                    # whole pass); only the cold remainder pays T2.
                    lane_tbl_mb = mp * 32 * el_b / 1e6
                    t1_would = (config.ts_table_mb > 0
                                and lane_tbl_mb > config.ts_table_mb
                                and mp >= config.ts_span)
                    cap_slots_cfg = int(config.ts2_table_mb * 1e6
                                        / (32 * el_b))
                    sp_rows_l, sp_cols_l = sp_rows_e, sp_cols_e
                    hub_cols = None
                    if (t1_would and config.ts2_table_mb > 0
                            and config.spill_hub_mb > 0):
                        k_hub = int(config.spill_hub_mb * 1e6
                                    / (32 * el_b))
                        cnt = np.bincount(sp_cols_e)
                        u_all = int((cnt > 0).sum())
                        reuse = len(sp_cols_e) / max(u_all, 1)
                        if (u_all > 3 * cap_slots_cfg and k_hub < u_all
                                and reuse
                                >= config.spill_hub_min_reuse):
                            top = np.argsort(cnt)[::-1][:k_hub]
                            cov = float(cnt[top].sum()) / len(sp_cols_e)
                            if cov >= config.spill_hub_min_cov:
                                hub_cols = np.sort(
                                    top[cnt[top] > 0]).astype(np.int64)
                                hot = np.isin(sp_cols_e, hub_cols)
                                hg, hl, hb, hgrp = _build_lane_stream(
                                    sp_rows_e[hot], sp_cols_e[hot])
                                from hcspmm_tpu_torch.format.streams import \
                                    build_mx_chunks as _bmx
                                h_lo, h_rel, h_slot = _bmx(
                                    hub_cols, config.ts_span,
                                    _mx_k(config, len(hub_cols), mp),
                                    mp)
                                # pad slots repeat a real hub col ->
                                # always found by searchsorted
                                hgi = h_slot[np.searchsorted(hub_cols,
                                                             hg)]
                                lane_fields.update(
                                    hub_lo=h_lo, hub_rel=h_rel,
                                    ds_h_tlocal=hl, ds_h_lblk=hb,
                                    ds_h_laneg=hgi.astype(np.int32),
                                    ds_hgroup=hgrp)
                                sp_rows_l = sp_rows_e[~hot]
                                sp_cols_l = sp_cols_e[~hot]

                    lg_g, lg_l, lg_b, lg_grp = _build_lane_stream(
                        sp_rows_l, sp_cols_l)
                    cl = len(lg_b)  # real chunk count (lg_l is 8-padded)
                    lane_fields["ds_tlocal"] = lg_l
                    lane_fields["ds_lblk"] = lg_b
                    lane_fields["ds_lgroup"] = lg_grp
                    g_lane = lg_g
                    # past the lane-table wall a compact table is built
                    # by mxgather and every per-edge gather hits it at
                    # the small-table rate; cold-stream edges only when
                    # the hub split is active
                    if t1_would:
                        from hcspmm_tpu_torch.format.streams import \
                            build_mx_chunks

                        uc_l = np.unique(g_lane)
                        ts_lo, ts_rel, ts_slot = build_mx_chunks(
                            uc_l, config.ts_span,
                            _mx_k(config, len(uc_l), mp), mp)
                        lane_fields.update(ts_lo=ts_lo, ts_rel=ts_rel,
                                           ts_span=config.ts_span)
                        # round-5 segmented second level: when T1 itself
                        # exceeds the hard gather wall, per-edge takes
                        # from it run ~13 ns regardless of locality
                        # (probe_loctake_r5) — build destination-segment
                        # tables so every take hits a sub-wall table
                        t1_slots = len(ts_lo) * ts_rel.shape[2]
                        cap_slots = cap_slots_cfg
                        bw_l = lg_l.shape[1]
                        if (config.ts2_table_mb > 0
                                and t1_slots > cap_slots):
                            segs2, pieces2, ranks2, laneg2 = \
                                _build_ts2_segments(
                                    g_lane.reshape(cl, bw_l), uc_l,
                                    ts_slot, t1_slots, cap_slots,
                                    cap_slots)
                            lane_fields.update(ts2_segs=segs2,
                                               ts2_pieces=pieces2,
                                               ts2_ranks=ranks2)
                            g_lane = laneg2
                        else:
                            g_lane = ts_slot[
                                np.searchsorted(uc_l, g_lane)]
                    lane_fields["ds_laneg"] = g_lane.astype(np.int32)
                    profiling.phase("format.plan.spill")
                ds_uc = None
                if compact_ok:
                    # two-level gather: remap chunk gather indices into
                    # the compact unique-column table (sorted take builds
                    # it at runtime); pad entries carry col == c, which
                    # searchsorted maps to U — clipped to the last
                    # compact row, dropped by the local-id sentinel
                    ds_uc = np.unique(sp_cols_e).astype(np.int32)
                    ds_g = np.searchsorted(ds_uc, ds_g).astype(np.int32)
                # gf32 decision uses the table the gathers actually hit
                eff_tbl_mb = (len(ds_uc) * 128 * el_b / 1e6
                              if ds_uc is not None else tbl_mb)
                gf32_auto = (config.compute_dtype == "bfloat16"
                             and spill_nnz >= config.ds_gather_f32_min_edges
                             and eff_tbl_mb
                             >= config.ds_gather_f32_min_table_mb)
                spill_fields.update(
                    ds_gcols=ds_g, ds_local=ds_l, ds_blk=ds_b, ds_lt=ds_t,
                    ds_group=ds_grp, ds_rows=mp, ds_meta=ds_m,
                    ds_kind=ds_kind, ds_ucols=ds_uc,
                    ds_gather_f32=(gf32_auto
                                   if config.ds_gather_f32 == "auto"
                                   else bool(config.ds_gather_f32)),
                    **lane_fields)

    profiling.phase("format.plan.band")
    # -------------------- tiled band pair stream --------------------
    tiled_fields = {}
    if (
        band_widths
        and config.band_impl == "tiled"
        and config.impl == "pallas"  # the XLA fallback consumes band*_a
        and band_full_cover
        and not spill_fields  # tiled pairs span full extents themselves
        and n == c
        and bh % 128 == 0
    ):
        tiled_fields = _build_tiled_pairs(
            num_sw, bh, min_col, max_col, nonempty, column_index,
            wa, sw_of_edge, int(config.band_tile_slots),
        )

    profiling.phase("format.plan.rows")
    kmax = widths[-1]
    if dense_routed_w is not None:
        # spill-mode three-way routing already decided per window
        dense_mask_w = dense_routed_w
    else:
        dense_mask_w = (
            (wa.hybrid_type == 1)
            & (wa.edge_counts > 0)
            & (wa.unique_counts <= kmax)
            & ~band_window_mask
        )
        # single-path collapse (round 5, VERDICT r4 #9): a minority path
        # carrying a sliver of the nnz still pays its kernel family's
        # fixed dispatch/VMEM costs — measured end-to-end, routing DD's
        # calibrated ~2% sparse remainder dense beat the mixture by 2.7%
        # (artifacts/loi_calibration_r4.log).  When the calibrated
        # selector leaves a path under 3% of routable nnz, reroute it
        # (capacity caps still force the sparse path for over-wide
        # windows).
        if config.loi_mode == "calibrated":
            routable = (wa.edge_counts > 0) & ~band_window_mask
            e_d = int(wa.edge_counts[dense_mask_w].sum())
            e_r = int(wa.edge_counts[routable].sum())
            fits = routable & (wa.unique_counts <= kmax)
            if e_r and e_d < 0.03 * e_r:
                dense_mask_w &= False          # all-sparse cheaper
            elif e_r and (e_r - e_d) < 0.03 * e_r:
                dense_mask_w = fits            # all-dense (capacity-capped)
    sparse_mask_w = ~dense_mask_w & (wa.edge_counts > 0) & ~band_window_mask
    if spill_mode:
        # spill-mode routing is total: banded supers' out-of-window edges
        # and ALL non-banded supers' (non-dense) edges are already in the
        # spill population — nothing remains for the ELL/residual paths
        sparse_mask_w &= False

    # -------------------- dense buckets --------------------
    # bucket index per dense window: smallest Kb >= unique_count
    bucket_of = np.searchsorted(np.asarray(widths), wa.unique_counts)
    bucket_cols: List[np.ndarray] = []
    bucket_a: List[np.ndarray] = []
    bucket_window_ids: List[np.ndarray] = []
    bucket_pos_of_window = np.full(wa.num_windows, -1, dtype=np.int64)
    bucket_idx_of_window = np.full(wa.num_windows, -1, dtype=np.int64)
    caps_b = caps.bucket_windows or (0,) * len(widths)
    if len(caps_b) != len(widths):
        raise ValueError("caps.bucket_windows length must match bucket_widths")

    dense_gather_rows = 0
    unique_gather_rows = 0
    for b, kb in enumerate(widths):
        wids = np.where(dense_mask_w & (bucket_of == b))[0].astype(np.int64)
        # capacity to a kernel-group multiple so dense_bucket_spmm never
        # pads in-trace (a traced concat copies the whole A array/call)
        wb = max(len(wids), caps_b[b])
        if wb:
            from hcspmm_tpu_torch.config import DENSE_GROUP
            wb = -(-wb // DENSE_GROUP) * DENSE_GROUP
        cols = np.full((wb, kb), c, dtype=np.int32)
        a = np.zeros((wb, wh, kb), dtype=np.int8)
        if len(wids):
            bucket_idx_of_window[wids] = b
            bucket_pos_of_window[wids] = np.arange(len(wids))
            # scatter each window's sorted unique cols into its row
            u_start = wa.unique_ptr[wids]
            u_cnt = wa.unique_counts[wids].astype(np.int64)
            flat_rows = np.repeat(np.arange(len(wids)), u_cnt)
            flat_off = _ragged_arange(u_cnt)
            flat_vals = _ragged_gather(wa.unique_cols, u_start, u_cnt)
            cols[flat_rows, flat_off] = flat_vals
            # fill A from edges of this bucket's windows
            sel = dense_mask_w[wa.edge_to_window] & (bucket_of[wa.edge_to_window] == b)
            e_w = wa.edge_to_window[sel].astype(np.int64)
            a.reshape(-1)[
                bucket_pos_of_window[e_w] * (wh * kb)
                + (wa.edge_to_row[sel].astype(np.int64) % wh) * kb
                + wa.edge_to_column[sel].astype(np.int64)
            ] = 1
            unique_gather_rows += int(u_cnt.sum())
        bucket_cols.append(cols)
        bucket_a.append(a)
        bucket_window_ids.append(wids)
        dense_gather_rows += wb * kb

    # -------------------- sparse path: ELL degree buckets --------------------
    # Rows of sparse windows with degree > 0, bucketed by degree; rows wider
    # than the last ELL width go to the residual scatter path.
    ell_widths = tuple(config.ell_widths)
    sparse_row_mask = np.zeros(n, dtype=bool)
    sparse_window_ids = np.where(sparse_mask_w)[0].astype(np.int64)
    if len(sparse_window_ids):
        rows_all = (
            sparse_window_ids[:, None] * wh + np.arange(wh)[None, :]
        ).reshape(-1)
        rows_all = rows_all[rows_all < n]
        sparse_row_mask[rows_all] = True
    sparse_row_mask &= degrees > 0

    ell_bucket_of = np.searchsorted(np.asarray(ell_widths), degrees)
    caps_e = caps.ell_rows or (0,) * len(ell_widths)
    if len(caps_e) != len(ell_widths):
        raise ValueError("caps.ell_rows length must match ell_widths")

    ell_cols: List[np.ndarray] = []
    ell_row_ids: List[np.ndarray] = []
    for e, de in enumerate(ell_widths):
        rows_e = np.where(sparse_row_mask & (ell_bucket_of == e))[0].astype(np.int64)
        rb = max(len(rows_e), caps_e[e])
        if rb:
            from hcspmm_tpu_torch.config import ell_rows_per_step
            r_step = min(ell_rows_per_step(de), rb)
            rb = -(-rb // r_step) * r_step
        cols = np.full((rb, de), c, dtype=np.int32)
        if len(rows_e):
            degs = degrees[rows_e]
            flat_r = np.repeat(np.arange(len(rows_e)), degs)
            flat_o = _ragged_arange(degs)
            flat_v = _ragged_gather(column_index, rp64[rows_e], degs).astype(np.int32)
            cols[flat_r, flat_o] = flat_v
        ell_cols.append(cols)
        ell_row_ids.append(rows_e)
        dense_gather_rows += rb * de

    # -------------------- residual scatter path --------------------
    resid_mask = sparse_row_mask & (ell_bucket_of >= len(ell_widths))
    srows = np.where(resid_mask)[0].astype(np.int64)
    rs_real = len(srows)
    rpos = np.full(n + 1, -1, dtype=np.int64)
    if rs_real:
        rpos[srows] = np.arange(rs_real)

    for_resid = resid_mask[wa.edge_to_row]
    s_cols = column_index[for_resid].astype(np.int32)
    s_segs = rpos[wa.edge_to_row[for_resid].astype(np.int64)].astype(np.int32)

    rs = max(rs_real, 1, caps.num_sparse_rows)
    es = max(len(s_cols), 1, caps.num_sparse_edges)
    sparse_rows = _pad_to(srows.astype(np.int32), rs, 0)
    sparse_edge_col = _pad_to(s_cols, es, c)
    sparse_edge_seg = _pad_to(s_segs, es, rs)

    profiling.phase("format.plan.merge")
    # -------------------- merge permutation --------------------
    # concat layout: [band buckets Sb*band_h rows each][dense buckets
    # Wb*wh rows each][ELL buckets Rb rows each][residual Rs rows][1 zero
    # row]
    off = 0
    band_row_offsets = []
    for s in range(len(band_widths)):
        band_row_offsets.append(off)
        off += band_starts[s].shape[0] * bh
    bucket_row_offsets = []
    for b in range(len(widths)):
        bucket_row_offsets.append(off)
        off += bucket_cols[b].shape[0] * wh
    ell_row_offsets = []
    for e in range(len(ell_widths)):
        ell_row_offsets.append(off)
        off += ell_cols[e].shape[0]
    sparse_off = off
    zero_at = sparse_off + rs
    out_perm = np.full(n, zero_at, dtype=np.int64)
    for s in range(len(band_widths)):
        sws = band_sw_ids[s]
        if not len(sws):
            continue
        real = (sws[:, None] * bh + np.arange(bh)[None, :]).reshape(-1)
        dpos = band_row_offsets[s] + np.arange(len(sws) * bh)
        in_range = real < n
        out_perm[real[in_range]] = dpos[in_range]
    for b in range(len(widths)):
        wids = bucket_window_ids[b]
        if not len(wids):
            continue
        real = (wids[:, None] * wh + np.arange(wh)[None, :]).reshape(-1)
        dpos = bucket_row_offsets[b] + np.arange(len(wids) * wh)
        in_range = real < n
        out_perm[real[in_range]] = dpos[in_range]
    for e in range(len(ell_widths)):
        rows_e = ell_row_ids[e]
        if len(rows_e):
            out_perm[rows_e] = ell_row_offsets[e] + np.arange(len(rows_e))
    if rs_real:
        out_perm[srows] = sparse_off + np.arange(rs_real)

    dense_nnz = int(wa.edge_counts[dense_mask_w].sum())
    sparse_real = nnz - dense_nnz - band_nnz \
        - spill_fields.get("spill_nnz", 0)
    if tband and (dense_nnz > 0 or sparse_real > 0):
        # kernels/tband.py applies band + spill only; any dense/ELL/
        # residual population on a tband plan would be silently dropped
        # (its edges never reach the output).  The auto routing above
        # never creates one; reachable only via band_spill='never' with
        # non-banded windows — tell the user instead of losing edges.
        raise ValueError(
            "band_impl='tband' plans carry band+spill populations only "
            f"(got dense_nnz={dense_nnz}, sparse_nnz={sparse_real}); "
            "use band_spill='auto' or band_impl='wide'")
    plan = ExecutionPlan(
        num_nodes=n,
        num_cols=c,
        window_h=wh,
        band_h=bh,
        band_widths=band_widths,
        band_starts=band_starts,
        band_edges=band_edges,
        band_sw_ids=band_sw_ids,
        band_missing_sw=band_missing,
        band_full_cover=band_full_cover if band_widths else False,
        tband=tband,
        tband_pack=int(getattr(config, "tband_pack", 1)) if tband else 1,
        a_dtype="int8" if tband else a_dtype,
        band_num_sw=num_sw if band_widths else 0,
        xp_rows=xp_rows,
        **tiled_fields,
        **spill_fields,
        band_nnz=band_nnz,
        bucket_widths=widths,
        bucket_cols=bucket_cols,
        bucket_a=bucket_a,
        bucket_window_ids=bucket_window_ids,
        ell_widths=ell_widths,
        ell_cols=ell_cols,
        ell_row_ids=ell_row_ids,
        num_sparse_rows=rs,
        num_sparse_edges=es,
        sparse_edge_col=sparse_edge_col,
        sparse_edge_seg=sparse_edge_seg,
        sparse_rows=sparse_rows,
        out_perm=out_perm.astype(np.int32),
        nnz=nnz,
        dense_nnz=dense_nnz,
        sparse_nnz=(nnz - dense_nnz - band_nnz
                    - spill_fields.get("spill_nnz", 0)),
        dense_gather_rows=dense_gather_rows,
        unique_gather_rows=unique_gather_rows,
    )
    return plan


def transpose_csr(
    row_pointers: np.ndarray, column_index: np.ndarray, num_nodes: int
) -> Tuple[np.ndarray, np.ndarray]:
    """CSR of A^T, for the safe (non-symmetric) backward mode the reference
    lacks (it always reuses untransposed A, GNN_model.py:49-57)."""
    import scipy.sparse as sp

    a = sp.csr_matrix(
        (np.ones(len(column_index), dtype=np.int8), column_index, row_pointers),
        shape=(num_nodes, num_nodes),
    )
    at = a.T.tocsr()
    at.sum_duplicates()
    return at.indptr.astype(np.int32), at.indices.astype(np.int32)
