"""Global configuration for hcspmm_tpu_torch (carried from hcspmm_tpu.config).

The cost-model constants below were measured on a TPU v5e and are kept
unchanged so that this package builds exactly the plans the JAX package
builds (tests/test_torch_plan.py holds the two equal).  They are not a
model of the H100.

The reference hard-codes its tiling in hybrid_kernel/config.h:4-6
(BLK_H=16, BLK_W=8, WARP_SIZE=32) and mirrors it in config.py:1-3, plus
kernel-tuning macros (WPB=3, MAX_BLK=3, S_SIZE=62) in
hybrid_all_kernel.cu:21-26.  Here everything lives in one dataclass; the
reference values are the defaults where they are semantic (window height,
column-block width), while TPU-specific knobs (tile_k buckets, group size,
dtype policy) are chosen for the MXU/VPU instead of WMMA/warps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# Semantic constants shared with the reference format (config.h:4-6).
BLK_H = 16  # row-window height (rows per window)
BLK_W = 8   # column-block width used for block_partition counting

# Scalar-prefetch padding for the tiled band kernel: format.plan pads the
# tp_* arrays by this many entries so the kernel's lookahead reads (A ring
# lookahead + X prefetch) never index past the last pair.  Must be >= the
# largest lookahead in kernels.block_spmm (_TILED_LA_A, _TILED_LA_X).
TILED_SCALAR_PAD = 8

# Grid-step grouping of the dense/ELL bucket kernels (kernels.block_spmm);
# format.plan pads bucket capacities to these multiples so the kernels
# never pad in-trace (a traced concat copies the whole A array per call).
DENSE_GROUP = 8


def ell_rows_per_step(de: int) -> int:
    """Rows per ELL kernel grid step for degree bucket width ``de``."""
    return max(8, 2048 // de)


@dataclasses.dataclass(frozen=True)
class LOICoefficients:
    """Logistic selector coefficients.

    The reference's *intended* model (commented-out line,
    hybrid_all_kernel.cu:261; report §IV-C):

        sparse if  size > max_cols
               or  w_cols*size + w_density*density + bias > 0

    where ``size`` is the number of unique neighbour columns in the window
    (the reference's deduplicated count) and ``density`` is
    nnz / (num_blocks * BLK_H * BLK_W), i.e. occupancy of the allocated
    column blocks.  Positive score => memory-bound => sparse (gather) path;
    otherwise the dense (MXU block) path.

    GPU-fitted coefficients are meaningless on TPU; `format.loi.calibrate`
    refits them from measured timings (report §IV-C procedure).
    """

    w_cols: float = 0.19854024
    w_density: float = -6.578043
    bias: float = -3.14922857
    max_cols: int = 32


# Coefficients refit on the v5e via tools/calibrate_loi.py (2026-08-16,
# bf16, pallas paths): the MXU width-bucket path wins almost everywhere —
# the crossover to the gather path only appears for wide low-density
# windows, the inverse of the GPU's CUDA-core-favoring selector.
# Used by loi_mode='calibrated' unless PlanConfig.loi overrides.
LOI_TPU_V5E = LOICoefficients(
    w_cols=0.103309, w_density=-20.144110, bias=-4.329597, max_cols=256,
)


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """Configuration of the TPU execution plan (format.plan)."""

    window_h: int = BLK_H
    # Unique-column width buckets for dense (MXU) windows.  A dense window
    # with U unique neighbour columns is padded to the smallest bucket
    # width >= U and becomes one binary [window_h, Kb] block-row — the
    # analog of the reference's MAX_BLK 8-wide WMMA blocks
    # (hybrid_all_kernel.cu:258-260) fused across the block loop and sized
    # for the MXU.  Windows wider than the last bucket go to the sparse
    # path (the reference similarly caps at MAX_BLK*8 columns).
    bucket_widths: Sequence[int] = (32, 64, 96, 128, 192, 256)
    # Degree buckets for the sparse (gather + row-sum) path: a sparse-window
    # row of degree d is padded to the smallest ELL width >= d and computed
    # as a scatter-free gather + axis-sum (the warp-per-row CSR loop of
    # hybrid_all_kernel.cu:964-1036, vectorized).  Rows wider than the last
    # width fall back to a residual sorted segment-sum.
    ell_widths: Sequence[int] = (4, 8, 16, 32, 64, 128, 256)
    # ---- banded (MXU block-band) path: TPU-native third population ----
    # Rows are grouped into superwindows of band_h consecutive rows; a
    # superwindow whose neighbour-column extent fits a band width bucket
    # streams its X band with ONE contiguous DMA and computes
    # out = A_band[band_h, Bb] @ band[Bb, D] on the MXU.  This is the TPU
    # analog of the GPU reference's implicit L2 locality (its 5.3 TB/s
    # effective bandwidth on DD comes from cached X rows): after
    # LOA/RCM reordering most superwindows have small extent.  No
    # per-row gather at all; cost is nnz-independent (H*Bb int8 A stream
    # + one band fetch).  Empty tuple disables the path.
    band_h: int = 256
    # 'auto' resolves the width bucket(s) from the measured per-superwindow
    # extent distribution at plan build (round128(max extent) single bucket
    # when tight — keeps the one-call direct-write fast path; p95+max
    # buckets on long tails).  An explicit tuple pins the ladder (required
    # for shard-uniform distributed plans).
    band_widths: "Sequence[int] | str" = "auto"
    # 'auto' uses the cost model below; 'always' takes every superwindow
    # whose extent fits a bucket; 'never' disables the banded path.
    band_mode: str = "auto"
    # Band kernel flavor: 'wide' = one fixed-width A block + one X band
    # DMA per superwindow; 'tiled' = per-superwindow variable tile count
    # over canonical 128-row X tiles with a ring cache (each X tile is
    # fetched ONCE per sweep instead of once per overlapping band, and A
    # skips tiles outside the superwindow's extent).  'tiled' requires
    # band_h % 128 == 0 and square plans; others fall back to 'wide'.
    # 'tband' = TRANSPOSED band (kernels/tband.py): activations carried
    # as X^T [dim, M] and each superwindow computes
    # Y^T[:, R:R+bh] = X^T[:, S:S+W] @ A_t[W, bh] — the dim<=64 fast
    # path (the reference's `..._hybrid_32/64` analog): 4x fewer MACs at
    # dim 32, X/out streams dim/128 of the padded layout (measured
    # 306-394 us vs wide 522-702 at DD/dim32, tools/ab_tband.py).
    # Square pallas plans only; the padded layout becomes [dt, M].
    band_impl: str = "wide"
    # Device A_t encoding for 'tband': 1 = int8 (1 B/element), 2 = nibble
    # (output-lane groups 0-127/128-255 share a byte; in-kernel unpack =
    # two constant shifts + one tile-aligned concat), 8 = 1-bit along the
    # contraction axis (8 shift+mask passes — measured unpack-compute-
    # bound at DD, kept for re-testing).  Nibble halves the A stream,
    # the dominant band-path bytes at low occupancy.
    tband_pack: int = 1
    # X-tile ring slots for band_impl='tiled' (VMEM: slots * 128 * dp * 2B)
    band_tile_slots: int = 16
    # ---- band+spill: robust band windows on non-bandable graphs ----
    # 'auto': a superwindow whose full column extent exceeds the band
    # width gets the width-window *placed* where it covers the most
    # edges; the uncovered edges SPILL to a segment-sum gather population
    # added onto the band output.  This is what makes the band path carry
    # power-law / community graphs (hub and inter-community edges spill,
    # the local mass streams) instead of all-or-nothing extent selection.
    # 'never' restores strict full-extent selection (round-1 behavior).
    band_spill: str = "auto"
    # Spill gather implementation: 'take' = XLA row gather + sorted
    # segment-sum (production round 1);
    # 'dstream' (round-2 default) = XLA take gather + dst-streamed Pallas
    # one-hot merge aliased into the padded output (kernels/dstream.py).
    # (A 'colstream' column-streamed MXU gather existed rounds 1-4 and
    # was pruned: measured slower than take in every configuration.)
    # Hardware decided (artifacts/round2_hw.jsonl): the XLA MERGE, not
    # the gather, was the spill wall (segsum 7.5 + scatter 13.7 ns/row vs
    # take 3.9); dstream replaces the merge.  Measured end-to-end numbers
    # live in artifacts/ (round-3 campaign) — no claims here.
    # Pallas band plans only (shard/caps plans and sliced-output call
    # sites fall back to 'take', which is always built alongside).
    spill_impl: str = "dstream"
    # Streamed-merge layout: 'auto' picks tile-pure chunks, block-wide
    # chunks, or the take+segsum path from exact host-side chunk counts
    # and measured per-row/dot/step constants (format.plan); 'tile' /
    # 'block' / 'take' force a layout (tests, ablations).
    ds_kind: str = "auto"
    # Column-range blocking of the dstream gather (kernels/dstream.py
    # build_dstream_ranges): when the activation table exceeds this many
    # MB, spill edges are partitioned by column range and each range
    # gathers from a materialized contiguous X slice.  Probe (v5e,
    # artifacts/round3_hw.jsonl): XLA random row-gather degrades with
    # table footprint (3.9 ns/row @ 102 MB -> 8.6 @ 1.23 GB); slicing
    # restores the small-table rate at the cost of one sequential X
    # stream + extra merge passes.  0 disables blocking.
    ds_table_mb: float = 192.0
    # Minimum spill edges for blocking to engage (the slice streams cost
    # ~X bytes once; below this the per-edge win cannot repay it).
    ds_blocked_min_edges: int = 100_000
    # Spill gather dtype: 'auto' casts a bf16 activation table to f32
    # before the take when the spill population is large enough to repay
    # the cast stream (probe: bf16 rows gather 5.8 ns vs f32 4.0 —
    # sub-word relayout; artifacts/round3_hw.jsonl take_parallel).
    # True/False force it.
    ds_gather_f32: "bool | str" = "auto"
    ds_gather_f32_min_edges: int = 400_000
    ds_gather_f32_min_table_mb: float = 192.0
    # Lane-oriented spill merge for transposed-band plans
    # (kernels/tspill.py): 'auto' builds block-wide chunks consumed in
    # the [dt, M] layout (no relayout passes — the round-3 wrapper's
    # three [M, dt] transposes measured ~2.2 ms extra at YS@1.0);
    # 'off' keeps the legacy transpose-and-reuse-row-merge wrapper.
    spill_lane: str = "auto"
    # Past this many MB (dim-32 transposed-table estimate), the lane
    # gather goes two-level: kernels/tspill.mxgather_lanes builds a
    # compact unique-column table by pipelined slab DMA + one-hot MXU
    # dots, and per-edge gathers hit it at the small-table rate
    # (probe: [32, 1.75M] = 112 MB direct lane take ~15 ns/col vs
    # ~1.9 ns from a compact table; tools/probe_tspill.py).
    ts_table_mb: float = 48.0
    ts_span: int = 2048   # mxgather slab width (lanes; round-5 sweep:
    #   the kernel is strided-DMA-bound — dt descriptors per slab — so
    #   fewer, wider chunks win: YH-like 3.39 -> 2.46 ns/ucol at 2048,
    #   TT-like best at (2048, k=256); tools/sweep_mx.py)
    ts_k: int = 128       # mxgather cols per chunk (the plan doubles it
    #   on dense request populations — see format.plan _mx_k)
    # Round-5 segmented second level: when the mxgather T1 table itself
    # exceeds the hard lane-gather wall (measured ~2.2 ns/idx below
    # ~17 MB vs ~13.3 ns above ~67 MB irrespective of access locality —
    # tools/probe_loctake.py, artifacts/probe_loctake_r5.log),
    # destination-segment tables (T2, duplicated unique cols) are built
    # from static T1 pieces of at most this size, and every gather in
    # the chain hits a sub-wall table.  0 disables.
    ts2_table_mb: float = 16.0
    # Round-5 hub split: when the spill's unique columns far exceed the
    # gather cache AND the top hub columns cover enough edges, the hot
    # edges run as their OWN chunk stream gathering from a
    # cache-resident hub table (built once, stays hot for its whole
    # pass), and only the cold remainder pays the duplicated
    # segment-table (T2) warming.  Measured coverage at a 16 MB hub:
    # GH 68% / RD 53% / TT 42% of spill edges.  0 disables.
    spill_hub_mb: float = 16.0
    spill_hub_min_cov: float = 0.30
    # ...and only when spill columns are genuinely reused: measured at a
    # 16 MB hub, GH (reuse 2.9) ran 24.2 -> 17.0 ms and TT (3.3)
    # 98 -> 82.5, but RD (reuse 1.98, cov 0.53) REGRESSED 34 -> 37 —
    # low-reuse hubs save too little T2 warming to repay the hub build
    # and the extra chunk fragmentation.
    spill_hub_min_reuse: float = 2.5
    # Band-block compute wall: int8->bf16 convert + MXU dot seconds per
    # A ELEMENT (v5e measured: DD's 214M-element band ~450 us compute-
    # bound, docs/ROADMAP.md) — prices wide low-occupancy bands.
    a_elem_ps: float = 2.1
    # Fixed cost (seconds) of HAVING a spill population at all: the
    # take+merge chain's dispatch/launch floor on top of the per-edge
    # model.  Round-2 hardware measured +35-107 us at DD scale for a
    # 1,865-edge (0.1%) spill vs the zero-spill direct-write shape; the
    # auto-width cost model charges this so near-zero-spill plans
    # collapse to the zero-spill shape (VERDICT r2 weak #2).  120 us =
    # the upper end of the measured delta (643 - 535 us, dd_default vs
    # round-1): the round-3 interpolated coverage model otherwise
    # re-picked the regressed W=512+spill shape on DD.
    spill_fixed_s: float = 120e-6
    # Target edge-coverage quantile when resolving band widths from the
    # per-superwindow *robust* extent (minimal window covering this
    # fraction of the super's edges) instead of the full extent.
    band_coverage: float = 0.95
    # Device dtype of the binary band blocks: 'int8' or 'int4'.  A-bytes
    # (N x band width) dominate band-path HBM traffic on low-degree
    # graphs; int4 halves them (values are {0,1}, so 4 bits are plenty).
    a_dtype: str = "int8"
    # (round-5 prune: the band_fold narrow-dim folded layout was deleted
    # — measured 1.7x slower than unfolded at dim 32 [32/128 MXU output
    # lanes]; band_impl='tband' is the narrow-dim fast path.  Record in
    # docs/ROADMAP.md round 3 / artifacts/round3_hw.jsonl.)
    # Cost-model constants for the band-vs-gather decision, measured on
    # v5e.  Gathered rows (ELL slots / spill edges) go through the random
    # row-gather path whose measured effective bandwidth is take_gbps
    # (XLA take ~27 GB/s round-1; re-probed by tools/probe_gather.py), so
    # per-row cost = row bytes / take_gbps.  Streamed band/A bytes run at
    # stream_gbps.  gather_ns_per_row=None derives the per-row cost from
    # take_gbps and the compute dtype; a number pins it (ablations).
    gather_ns_per_row: Optional[float] = None
    take_gbps: float = 27.0
    stream_gbps: float = 900.0  # measured ~970 GB/s effective on v5e
    # Breaking full band cover (dropping a super / dense-routing a window)
    # forfeits the closed padded layout: the rows layout re-pads/slices
    # every application — charged as this many extra [M, dp] streaming
    # passes, paid COLLECTIVELY by the cover-breaking routing decisions.
    # 0 restores pure marginal-cost routing (tests/ablations).
    glue_passes: float = 2.0
    # LOI mode: 'intended' | 'degenerate' | 'calibrated' | 'all_dense'
    # | 'all_sparse'.  'degenerate' reproduces the reference's live line
    # (hybrid_all_kernel.cu:262, missing `> 0`) for bit-parity experiments.
    loi_mode: str = "intended"
    # None = unset (the ONLY sentinel): 'calibrated' mode then picks the
    # hardware-refit LOI_TPU_V5E, other modes the reference GPU values.
    # An explicit LOICoefficients(...) — including the GPU defaults — is
    # honored verbatim (format.windows.analyze_windows).
    loi: Optional[LOICoefficients] = None
    # Compute dtype for gathered features / block matmuls.  fp32 matches the
    # reference's CUDA-core path; bf16 halves gather bandwidth (the TPU
    # bottleneck) at TF32-class tolerance (report Table VII ran half/bf16).
    compute_dtype: str = "float32"
    # Kernel implementation: 'pallas' (hand-written kernels from
    # hcspmm_tpu_torch.kernels — the production path; every measured win lives
    # here) or 'xla' (gather + einsum + segment_sum under jit — the
    # fallback/oracle path, kept for non-TPU backends and A/B tests).
    impl: str = "pallas"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirrors the reference CLI flag surface (HC-SpMM_main.py:18-27)."""

    dataset: str = "example"
    dim: int = 96
    num_layers: int = 6
    hidden: int = 32
    classes: int = 22
    epochs: int = 200
    model: str = "gcn"  # 'gcn' | 'gin'
    single_kernel: bool = False
    lr: float = 0.01
    seed: int = 0
    dropout: float = 0.5
    # Reference aggregation is an unweighted neighbour sum (binary adjacency,
    # degrees computed then dropped — dataset.py:106-107).  normalize=True is
    # the extension flag for symmetric-normalized GCN aggregation.
    normalize: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Multi-chip layout (net-new vs the single-GPU reference)."""

    axis_name: str = "x"
    num_shards: int = 1
    # 'allgather' replicates X per step; 'halo' exchanges only the remote
    # rows each shard's windows actually reference.
    halo_mode: str = "allgather"


@dataclasses.dataclass(frozen=True)
class HCSpMMConfig:
    plan: PlanConfig = dataclasses.field(default_factory=PlanConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def degree_clamp(x: int) -> int:
    """Reference config.py:5-9 `func`: clamp degree to >= 1."""
    return x if x > 0 else 1
