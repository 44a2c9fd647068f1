"""Row-block partitioning of the adjacency over a device mesh.

Net-new vs the single-GPU reference (SURVEY.md §2.3): A is split into
contiguous row blocks of whole windows; each device owns the matching row
block of X, Y and Z.  Local windows may reference any global column, so
each device needs remote X rows ("halo"):

- ``allgather`` mode: replicate X per step (one ``all_gather`` over ICI);
  simple, bandwidth N*D per device — the baseline.
- ``halo`` mode: at preprocessing, compute per (owner, requester) shard
  pair exactly which rows are needed; at run time exchange only those via
  ``ppermute`` rounds.  Plan column indices are pre-remapped into each
  shard's ``concat(X_local, halo_buffer, zero)`` space, so the compute
  kernels are oblivious to distribution.

All per-shard arrays are padded to uniform shapes (PlanCaps) and stacked
with a leading shard axis, so one ``shard_map`` program serves every
device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.format.plan import ExecutionPlan, PlanCaps, build_plan


def pad_rows(x: np.ndarray, n_padded: int):
    """Pad node-dim arrays (features/labels) with zeros up to n_padded."""
    if x.shape[0] == n_padded:
        return x
    pad_shape = (n_padded - x.shape[0],) + x.shape[1:]
    return np.concatenate([x, np.zeros(pad_shape, dtype=x.dtype)])


@dataclasses.dataclass
class ShardedPlan:
    num_shards: int
    num_nodes: int          # true N
    n_padded: int           # N rounded up to shards * rows_per_shard
    rows_per_shard: int
    window_h: int
    num_buckets: int        # dense width buckets (uniform across shards)
    num_ell: int            # ELL degree buckets (uniform across shards)
    num_band: int           # band-width buckets (allgather mode only)
    band_h: int
    xp_rows: int            # uniform X padding target across shards
    num_sparse_rows: int    # uniform per-shard count
    mode: str               # 'allgather' | 'halo'

    # stacked per-shard plan arrays, each with leading dim [S, ...]
    stacked: Dict[str, np.ndarray]

    # halo-mode only
    halo_pair: int = 0                      # H: rows exchanged per shard pair
    send_idx: Optional[np.ndarray] = None   # int32 [S, S-1, H] local rows owner
                                            # sends in round r (to shard i+r+1)
    far_pair: int = 0   # band_halo only: out-of-strip rows gathered per
    #                     shard pair (index-halo feeding the spill
    #                     population); 0 = pure boundary-strip exchange
    plans: Optional[List[ExecutionPlan]] = None  # host-side, for stats
    impl: str = "xla"   # shard-local compute: 'xla' | 'pallas'
    num_spill_rows: int = 0  # uniform band+spill capacity (0 = absent)

    @property
    def nnz(self) -> int:
        return sum(p.nnz for p in self.plans) if self.plans else 0


def _slice_csr(rp: np.ndarray, ci: np.ndarray, lo: int, hi: int, rows: int):
    """CSR of rows [lo, hi) re-based to start at 0, padded to `rows` rows."""
    local_rp = (rp[lo: hi + 1] - rp[lo]).astype(np.int64)
    local_ci = ci[rp[lo]: rp[hi]].astype(np.int32)
    if len(local_rp) - 1 < rows:
        local_rp = np.concatenate(
            [local_rp, np.full(rows - (len(local_rp) - 1), local_rp[-1], np.int64)]
        )
    return local_rp, local_ci


def build_sharded_plan(
    row_pointers: np.ndarray,
    column_index: np.ndarray,
    num_nodes: int,
    num_shards: int,
    config: PlanConfig = PlanConfig(),
    mode: str = "allgather",
) -> ShardedPlan:
    rp = np.asarray(row_pointers, dtype=np.int64)
    ci = np.asarray(column_index, dtype=np.int32)
    # The banded path needs a contiguous local X view: valid under
    # allgather (global space) and band_halo (boundary strips), but the
    # index-gather halo breaks contiguity, so 'halo' plans carve bands out.
    if mode == "halo":
        config = dataclasses.replace(config, band_mode="never")
    if isinstance(config.band_widths, str):
        # auto widths would resolve differently per shard and break the
        # uniform stacking caps; pin the ladder for sharded plans
        config = dataclasses.replace(config,
                                     band_widths=(256, 512, 1024, 2048))
    if config.band_impl != "wide":
        # tiled pair streams are per-shard-shaped (and square-gated);
        # sharded plans always use the wide band arrays
        config = dataclasses.replace(config, band_impl="wide")
    wh = config.window_h
    chunk = wh * num_shards
    n_padded = ((num_nodes + chunk - 1) // chunk) * chunk
    rows_per = n_padded // num_shards

    # Pass 1: per-shard plans (column space = padded global for allgather).
    # window analyses are cached across the probe and caps passes — the
    # per-shard analysis is the dominant plan-build cost and is
    # independent of caps (keyed by remap identity, since halo remapping
    # rewrites the column ids the analysis sorts)
    _analysis_cache: Dict = {}

    def shard_plans(num_cols_fn, remap_fn=None, caps=PlanCaps()):
        from hcspmm_tpu_torch.format.windows import analyze_windows

        plans = []
        for s in range(num_shards):
            lo = min(s * rows_per, num_nodes)
            hi = min((s + 1) * rows_per, num_nodes)
            lrp, lci = _slice_csr(rp, ci, lo, hi, rows_per)
            if remap_fn is not None:
                lci = remap_fn(s, lci)
            key = (id(remap_fn), s)
            wa = _analysis_cache.get(key)
            if wa is None:
                wa = analyze_windows(
                    lrp, lci, rows_per, window_h=config.window_h,
                    loi_mode=config.loi_mode, loi_coeffs=config.loi,
                    num_cols=num_cols_fn(s),
                )
                _analysis_cache[key] = wa
            plans.append(
                build_plan(lrp, lci, rows_per, config, analysis=wa,
                           num_cols=num_cols_fn(s), caps=caps)
            )
        return plans

    def caps_of(probe):
        nb = len(probe[0].bucket_widths)
        ne = len(probe[0].ell_widths)
        ns = len(probe[0].band_widths)
        return PlanCaps(
            bucket_windows=tuple(
                max(p.bucket_capacities[b] for p in probe) for b in range(nb)
            ),
            ell_rows=tuple(
                max(p.ell_capacities[e] for p in probe) for e in range(ne)
            ),
            band_supers=tuple(
                max(p.band_capacities[s] for p in probe) for s in range(ns)
            ),
            num_sparse_rows=max(p.num_sparse_rows for p in probe),
            num_sparse_edges=max(p.num_sparse_edges for p in probe),
            # band+spill: any shard spilling forces the arrays (at the
            # max capacity) on EVERY shard, so stacking stays uniform and
            # no shard's spill edges are silently dropped
            num_spill_rows=max(p.num_spill_rows for p in probe),
            num_spill_edges=max(p.num_spill_edges for p in probe),
        )

    far_pair = 0
    if mode == "allgather":
        probe = shard_plans(lambda s: n_padded)
        plans = shard_plans(lambda s: n_padded, caps=caps_of(probe))
        send_idx, halo_pair = None, 0
    elif mode == "band_halo":
        # Fixed-size contiguous halo: after band-friendly (RCM/LOA/pack)
        # ordering, a shard's rows only reference columns within +-Hb of
        # its own range, so the exchange is ONE boundary strip of Hb rows
        # per neighbour direction (two ppermutes of [Hb, D] over ICI) and
        # the local X view [prev strip | own | next strip] stays
        # CONTIGUOUS -- the banded MXU path runs unchanged on shards.
        hb = int(max(config.band_widths)) if config.band_widths else 0
        if hb <= 0:
            raise ValueError("band_halo requires band_widths")
        if config.impl == "pallas":
            # derive the strip from the same rounding rule build_plan
            # applies to pallas band widths (lane-128 minimum), so the
            # halo always covers the widest bucket the plans can resolve
            hb = max(128, -(-hb // 128) * 128)
        if hb > rows_per:
            raise ValueError(
                f"band_halo strip ({hb}) exceeds rows per shard "
                f"({rows_per}); use fewer shards, smaller band_widths, or "
                "mode='allgather'"
            )
        halo_pair = hb
        # Out-of-strip references (hub edges, inter-community edges on
        # power-law graphs) degrade to an index-gather halo feeding the
        # plan's band+spill population instead of failing the mode: the
        # extra rows are appended after the strips, so the banded view
        # stays contiguous and the MXU path runs unchanged.  With
        # band_spill='never' the strict contract (raise) is kept.
        far_need: List[List[np.ndarray]] = []
        for i in range(num_shards):
            lo = min(i * rows_per, num_nodes)
            hi = min((i + 1) * rows_per, num_nodes)
            cols = np.unique(ci[rp[lo]: rp[hi]].astype(np.int64))
            far = cols[(cols < i * rows_per - hb)
                       | (cols >= (i + 1) * rows_per + hb)]
            if len(far) and config.band_spill == "never":
                raise ValueError(
                    f"shard {i} references columns outside its +-{hb}"
                    " halo window; reorder the graph (rcm/pack/cluster),"
                    " enable band_spill='auto', or use"
                    " mode='halo'/'allgather'"
                )
            owners = far // rows_per
            far_need.append([
                np.sort(far[owners == j]) for j in range(num_shards)
            ])
        far_pair = max(
            (len(far_need[i][j]) for i in range(num_shards)
             for j in range(num_shards) if j != i),
            default=0,
        )
        if far_pair:
            send_idx = np.zeros((num_shards, num_shards - 1, far_pair),
                                np.int32)
            for j in range(num_shards):
                for r in range(num_shards - 1):
                    i = (j + r + 1) % num_shards
                    rows = far_need[i][j] - j * rows_per
                    send_idx[j, r, : len(rows)] = rows
        else:
            send_idx = None

        strip_cols = rows_per + 2 * hb

        def remap_band(i: int, lci: np.ndarray) -> np.ndarray:
            lut_base = lci.astype(np.int64) - (i * rows_per - hb)
            if far_pair:
                # out-of-strip columns -> their slot in the gathered halo
                # region [strip_cols, strip_cols + (S-1)*far_pair)
                lut = np.full(n_padded, -1, np.int64)
                for j in range(num_shards):
                    if j == i or not len(far_need[i][j]):
                        continue
                    rcv_round = (i - j) % num_shards  # in 1..S-1
                    base = strip_cols + (rcv_round - 1) * far_pair
                    lut[far_need[i][j]] = base + np.arange(
                        len(far_need[i][j]))
                mapped = lut[lci.astype(np.int64)]
                lut_base = np.where(mapped >= 0, mapped, lut_base)
            return lut_base.astype(np.int32)

        local_cols = strip_cols + (num_shards - 1) * far_pair
        probe = shard_plans(lambda s: local_cols, remap_band)
        plans = shard_plans(lambda s: local_cols, remap_band, caps_of(probe))
    elif mode == "halo":
        # Needed remote rows per (requester i, owner j != i).
        need: List[List[np.ndarray]] = []
        for i in range(num_shards):
            lo = min(i * rows_per, num_nodes)
            hi = min((i + 1) * rows_per, num_nodes)
            cols = np.unique(ci[rp[lo]: rp[hi]].astype(np.int64))
            owners = cols // rows_per
            need.append([
                np.sort(cols[owners == j]) for j in range(num_shards)
            ])
        halo_pair = max(
            (len(need[i][j]) for i in range(num_shards)
             for j in range(num_shards) if j != i),
            default=0,
        )
        halo_pair = max(halo_pair, 1)

        # send_idx[j, r] = local rows shard j sends in round r to shard
        # (j + r + 1) % S; padding repeats local row 0.
        send_idx = np.zeros((num_shards, num_shards - 1, halo_pair), np.int32)
        for j in range(num_shards):
            for r in range(num_shards - 1):
                i = (j + r + 1) % num_shards
                rows = need[i][j] - j * rows_per
                send_idx[j, r, : len(rows)] = rows

        # Column remap per requester shard i:
        #   local col  g (owner i)  -> g - i*rows_per
        #   remote col g (owner j)  -> rows_per + (r-1)*H + pos(g in need[i][j])
        #     where r = (i - j) mod S is the receive round of owner j.
        #   dummy -> rows_per + (S-1)*H
        def remap(i: int, lci: np.ndarray) -> np.ndarray:
            lut = np.full(n_padded, rows_per + (num_shards - 1) * halo_pair,
                          dtype=np.int64)
            mine = np.arange(i * rows_per, (i + 1) * rows_per)
            lut[mine] = np.arange(rows_per)
            for j in range(num_shards):
                if j == i:
                    continue
                rcv_round = (i - j) % num_shards  # in 1..S-1
                base = rows_per + (rcv_round - 1) * halo_pair
                lut[need[i][j]] = base + np.arange(len(need[i][j]))
            return lut[lci.astype(np.int64)].astype(np.int32)

        local_cols = rows_per + (num_shards - 1) * halo_pair
        probe = shard_plans(lambda s: local_cols, remap)
        plans = shard_plans(lambda s: local_cols, remap, caps_of(probe))
    else:
        raise ValueError(f"unknown halo mode: {mode}")

    stacked = {
        k: np.stack([p.device_arrays()[k] for p in plans])
        for k in plans[0].device_arrays()
    }
    return ShardedPlan(
        num_shards=num_shards,
        num_nodes=num_nodes,
        n_padded=n_padded,
        rows_per_shard=rows_per,
        window_h=wh,
        num_buckets=len(plans[0].bucket_widths),
        num_ell=len(plans[0].ell_widths),
        num_band=len(plans[0].band_widths),
        band_h=plans[0].band_h,
        xp_rows=max(p.xp_rows for p in plans),
        num_sparse_rows=plans[0].num_sparse_rows,
        num_spill_rows=(plans[0].num_spill_rows
                        if plans[0].has_spill else 0),
        mode=mode,
        stacked=stacked,
        halo_pair=halo_pair if mode in ("halo", "band_halo") else 0,
        send_idx=send_idx if mode in ("halo", "band_halo") else None,
        far_pair=far_pair if mode == "band_halo" else 0,
        plans=plans,
        impl=config.impl,
    )
