"""Hybrid SpMM on one H100: the wide padded layout [M, dp] and the row
layout [N, d].

Port of hcspmm_tpu/kernels/block_spmm.py.  In the wide padded layout,
activations are row-major ``[M, dp]`` (M = plan.padded_rows, dp the
feature dim rounded up to 128; rows past num_nodes and columns past the
feature dim are zero), and superwindow i computes

    out[R : R+bh] = A[i] [bh, Bb] @ xp[st : st+Bb]

with A the plan's 0/1 block and st a 16-aligned start clamped into M at
plan build.  A is stored as the plan's ``a_dtype`` says
(``plan.band_a_stored``, ``plan.tiled_a_stored``): int8 [.., Bb], or, at
'int4', uint8 nibbles [.., Bb/2] (column 2j in the low nibble of byte j,
2j + 1 in the high one); the kernels read either as stored (template
``PACK`` 1 or 2), and the plain versions expand nibbles first
(``expand_a``).  The layout is closed under chaining: a GNN layer's dense
update is ``xp @ pad(W)`` and the next SpMM reads its output unchanged.

The band product is the CUDA kernel ``csrc/block_spmm.cu``;
``band_bucket_spmm_direct`` (direct write), ``band_bucket_spmm`` (fp32,
bucket order) and ``band_bucket_spmm_grouped`` (G superwindows a thread
block, identity order) are its wrappers and ``band_direct_dispatch`` the
reference's bucket-keyed entry.  The same source holds the tiled band
(``band_tiled_spmm``: a plan's flat (superwindow, 128-row X tile) pairs,
``plan.tiled``) and the fused aggregate and update
(``band_fused_spmm_direct``: agg = A X and out = agg W in one launch, the
kernel-fusion mode that ``plan.prefer_fused_kernel`` turns on).  Beside them
sit the plain PyTorch versions (gather + fp32 einsum) that the tests and
chip_smoke.py hold the kernels against.  A wrapper takes the plain version
only for tensors on the CPU; for a CUDA tensor it launches the kernel or
raises.

``spmm_wide_padded`` is one SpMM (the reference's ``spmm_pallas_padded``):
the main bucket's direct write, the other buckets' blocks scattered over
theirs, the missing superwindows zeroed (``tspill.zero_row_blocks``), and
the spill population added by ``apply_spill`` (``dstream.dstream_spill``,
or the take path); a tiled plan is one ``band_tiled_spmm``.
``spmm_fused_wide_padded`` and ``spmm_fused_rows`` are the fused layer
products in the wide padded and the row layout (None where the plan has no
single full-cover bucket, as the reference's ``spmm_fused_pallas_padded``
and ``spmm_fused_pallas``).  ``spmm_padded_supported`` is the reference's test of
which plans have that path; ``check_plan`` raises for any other plan.

``spmm_rows`` is one SpMM in the row layout [N, d] -> [N, d] (the
reference's ``spmm_pallas``, HC-SpMM's own hybrid): band buckets through
the band kernel, then every dense window in one launch for each eight
dense buckets (``dense_rows``, the reference's tensor-core population;
``dense_bucket_spmm`` is one bucket's) and every ELL row, residual hub row and empty row in another
(``ell_rows``, the reference's CUDA-core warp-per-row loop and its
segment-sum; ``ell_bucket_spmm`` and ``ell_residual_spmm`` run one bucket
or the residual alone), each writing its rows of the result at their node
ids from tables built and checked at upload (``row_tables``); spill is
added by the take path.  The two kernels are ``csrc/rows.cu``;
``rows_check`` raises for the plans the row layout does not run here.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from hcspmm_tpu_torch.config import TILED_SCALAR_PAD
from hcspmm_tpu_torch.kernels import dstream, tspill
from hcspmm_tpu_torch.kernels._build import load_library
from hcspmm_tpu_torch.utils import profiling

#: Launches of the band kernel of csrc/block_spmm.cu (every mode), counted
#: where a wrapper launches it (never by the plain versions).  chip_smoke.py
#: zeroes it before a run of the main path and reads it after.
launches = 0

#: Launches of the other kernels of csrc/block_spmm.cu, and of the band
#: kernel's direct, bucket and grouped modes (also counted in ``launches``).
kernel_launches = {"band_bucket_spmm_direct": 0, "band_bucket_spmm": 0,
                   "band_bucket_spmm_grouped": 0, "band_fused_spmm_direct": 0,
                   "band_tiled_spmm": 0}

#: The fused kernel's launches by (dp, hp), counted with
#: ``kernel_launches["band_fused_spmm_direct"]``.
fused_shapes = collections.Counter()

#: The latest fused launch: ``fused_launch``'s sizing and ``resident``, the
#: blocks an SM the card's occupancy gave it (its grid's size).
last_fused_launch = {}

TILE_W = 128  # X rows of one tiled pair (csrc/block_spmm.cu TILE)

#: Launches of the two kernels of csrc/rows.cu, counted where a wrapper
#: launches one (``ell_residual``: launches of the ELL kernel that carried
#: residual rows, alone or riding a plan's ELL launch).
row_launches = {"dense_bucket_spmm": 0, "ell_bucket_spmm": 0, "ell_residual": 0}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("block_spmm")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hcspmm_band_spmm.argtypes = [vp] * 6 + [i32] * 14 + [vp, vp, ctypes.c_longlong, vp]
    lib.hcspmm_tiled_spmm.argtypes = [vp] * 5 + [i32] * 6 + [vp]
    lib.hcspmm_band_fused.argtypes = [vp] * 8 + [i32] * 13 + [ctypes.POINTER(i32), vp]
    lib.hcspmm_band_device.argtypes = [ctypes.POINTER(i32)] * 4
    for fn in (lib.hcspmm_band_spmm, lib.hcspmm_tiled_spmm, lib.hcspmm_band_fused,
               lib.hcspmm_band_device):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _rows_lib() -> ctypes.CDLL:
    return bind_rows(load_library("rows"))


def bind_rows(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of csrc/rows.cu, with its functions' ctypes types set."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    vpp, i32p = ctypes.POINTER(vp), ctypes.POINTER(i32)
    lib.hcspmm_dense_rows.argtypes = [vpp, vpp, vpp, i32p, i32p, i32, i32, vp, i64, i32, i32, vp,
                                      i64, vp]
    lib.hcspmm_ell_rows.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp, i64, i32, i32, vp, i64, vp]
    for fn in (lib.hcspmm_dense_rows, lib.hcspmm_ell_rows):
        fn.restype = ctypes.c_int
    return lib


# The band kernel's ring (csrc/block_spmm.cu band_kernel): rows of A a
# stage holds, its stages, the shared memory beside the ring
# (BAND_FIXED_SMEM: alignment slack, the mbarriers and the stages' item
# headers) and the blocks an SM the ring is sized for.
_BAND_ROWS = 32
_BAND_STAGES = (2, 8)
_BAND_FIXED_SMEM = 128 + 3 * 8 * 8
_BAND_BLOCKS_PER_SM = 3
# The fused kernel (csrc/block_spmm.cu band_fused_kernel): a unit's output
# rows (FR), the contraction rows of a staged slab (FK) and the out columns
# of a pass (FC) of its update, whose slabs (two of agg^T [FK, FR] and two
# of W [FK, FC], fp32) sit beside its A tile, and the shared memory beside
# both (alignment slack, the tile's mbarrier and the next unit's id).  One
# block an SM: its update keeps an 8 x 16 register tile a thread.
_FUSED_ROWS, _FUSED_SLAB, _FUSED_COLS = 128, 8, 256
_FUSED_SLAB_SMEM = 2 * _FUSED_SLAB * (_FUSED_ROWS + _FUSED_COLS) * 4
_FUSED_FIXED_SMEM = 128 + 64


def _boxes(rb, aligned):
    """(tma, box_w, nbox): how a row of A of ``rb`` bytes is staged."""
    if rb % 16 == 0 and aligned:
        box_w = next(w for w in (256, 128, 64, 32, 16) if rb % w == 0)
        if rb // box_w > 8:
            box_w = 256
        return True, box_w, -(-rb // box_w)
    return False, -(-rb // 16) * 16, 1


def a_pack(a) -> int:
    """How a band block or A tile tensor is stored: 1 for int8 [.., Bb], 2
    for int4 nibbles, uint8 [.., Bb/2]; raises for anything else."""
    if a.dim() != 3 or a.dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"a must be int8 [Sb, bh, Bb] or int4 nibbles uint8 [Sb, bh, Bb/2], "
                         f"got {a.dtype} {tuple(a.shape)}")
    return 1 if a.dtype == torch.int8 else 2


def expand_a(a):
    """The int8 blocks [.., Bb] that ``a`` stores: ``a`` itself at int8,
    each nibble of uint8 [.., Bb/2] sign-extended at int4 (column 2j from
    the low nibble of byte j, 2j + 1 from the high one)."""
    if a.dtype != torch.uint8:
        return a
    nib = torch.stack([a & 15, a >> 4], dim=-1).reshape(a.shape[:-1] + (2 * a.shape[-1],))
    return ((nib.to(torch.int16) ^ 8) - 8).to(torch.int8)


def band_launch(rb: int, per_sm: int, reserved: int, optin: int, aligned: bool = True) -> dict:
    """The band kernel's ring for rows of A of ``rb`` bytes as stored (the
    band width Bb at int8, Bb / 2 at int4) on a device with ``per_sm`` bytes
    of shared memory an SM, ``reserved`` of them taken per block and at most
    ``optin`` for one block (an H100: 233472, 1024, 232448).

    A stage holds ``rows`` rows of A (32, halved until two stages fit in one
    block) as ``nbox`` boxes of ``box_w`` bytes.  With ``tma`` (a row a
    16-byte multiple and A 16-byte ``aligned``) a tensor copy fills each
    box: the widest of 256, 128, 64, 32, 16 bytes that divides the row, or
    256 with the last box reaching past it (zero-filled) where that would
    take more than eight boxes.  Otherwise 4-byte cp.async copies stage each
    row whole, padded to 16 bytes.  ``stages`` (2-8) is as many as leave
    three blocks an SM; ``smem`` is the block's dynamic shared memory."""
    tma, box_w, nbox = _boxes(rb, aligned)
    row_bytes = box_w * nbox
    rows = _BAND_ROWS
    while rows > 1 and _BAND_FIXED_SMEM + 2 * rows * row_bytes > optin:
        rows //= 2
    stage = rows * row_bytes
    fit = (per_sm // _BAND_BLOCKS_PER_SM - reserved - _BAND_FIXED_SMEM) // stage
    stages = min(max(fit, _BAND_STAGES[0]), _BAND_STAGES[1])
    smem = _BAND_FIXED_SMEM + stages * stage
    if smem > optin:
        raise ValueError(f"rows of {rb} bytes: two ring stages of one row take {smem} bytes of "
                         f"shared memory, more than a block's {optin}")
    return dict(tma=tma, box_w=box_w, nbox=nbox, rows=rows, stages=stages, smem=smem)


def fused_launch(rb: int, dp: int, hp: int, per_sm: int, reserved: int, optin: int,
                 aligned: bool = True) -> dict:
    """The fused kernel's launch for rows of A of ``rb`` bytes as stored,
    dp and hp, on a device as ``band_launch`` takes it.  A row of A is
    staged as band_launch stages
    it (``tma``, ``box_w``, ``nbox``); the A tile holds ``arows`` rows (the
    unit's 128, halved until the tile and the update's slabs fit one block);
    ``smem`` is the block's dynamic shared memory, ``blocks_per_sm`` one.
    Also ``unit_rows`` (output rows of a unit of work), ``w_slab`` (rows of
    agg^T and W staged at once), ``tile_cols`` (out columns of a pass: 256,
    or 128 where hp <= 128),
    ``passes`` (ceil(hp / tile_cols)) and ``ng`` (128-column groups of a band
    pass over dp).  Raises ValueError for a dp that is no multiple of 128,
    hp < 1, or rows of A so wide that not even one fits beside the
    slabs."""
    if dp <= 0 or dp % 128 or hp <= 0:
        raise ValueError(f"dp={dp}, hp={hp}: dp a positive multiple of 128, hp positive")
    tma, box_w, nbox = _boxes(rb, aligned)
    fixed = _FUSED_FIXED_SMEM + _FUSED_SLAB_SMEM
    arows = _FUSED_ROWS
    while arows > 1 and fixed + arows * box_w * nbox > optin:
        arows //= 2
    smem = fixed + arows * box_w * nbox
    if smem > optin:
        raise ValueError(f"rows of {rb} bytes: one row of A beside the update's slabs takes {smem} "
                         f"bytes of shared memory, more than a block's {optin}")
    groups = dp // 128
    cols = 128 if hp <= 128 else _FUSED_COLS
    return dict(tma=tma, box_w=box_w, nbox=nbox, arows=arows, smem=smem,
                unit_rows=_FUSED_ROWS, w_slab=_FUSED_SLAB, tile_cols=cols,
                passes=-(-hp // cols),
                ng=next(g for g in (4, 3, 2, 1) if groups % g == 0), blocks_per_sm=1)


@functools.lru_cache(maxsize=None)
def band_device(index: int) -> tuple:
    """(SMs, shared memory an SM, reserved a block, a block's opt-in most)
    of CUDA device ``index``, as the band kernel's launch reads them."""
    vals = [ctypes.c_int() for _ in range(4)]
    with torch.cuda.device(index):
        rc = _lib().hcspmm_band_device(*(ctypes.byref(v) for v in vals))
    _raise_on(rc, "band_kernel")
    return tuple(v.value for v in vals)


def lane_pad(d: int) -> int:
    """Feature dim padded to the wide layout's 128 columns."""
    return max(128, -(-d // 128) * 128)


def spmm_padded_supported(plan) -> bool:
    """The reference's ``spmm_padded_supported`` (hcspmm_tpu/kernels/
    block_spmm.py:768): True when the closed padded layout can run
    ``plan`` — every superwindow owned by one band bucket, or a partial
    cover whose uncovered edges all ride the spill population (no dense,
    ELL or residual rows) — with every band slice inside M.  Other plans
    run in the row layout."""
    if getattr(plan, "tiled", False):
        return True
    if plan.band_padded_ok:
        num_sw = plan.padded_rows // plan.band_h
        if sum(len(s) for s in plan.band_sw_ids) == num_sw:
            return True
    if not (plan.band_widths and plan.num_cols == plan.num_nodes
            and plan.dense_nnz == 0 and plan.sparse_nnz == 0):
        return False
    m = plan.padded_rows
    for s, w in enumerate(plan.band_widths):
        st = plan.band_starts[s][: len(plan.band_sw_ids[s])]
        if len(st) and int(st.max()) + w > m:
            return False
        if len(plan.band_starts[s]) > len(plan.band_sw_ids[s]) and w > m:
            return False
    return True


def rows_check(plan) -> None:
    """Raise NotImplementedError for the non-tband plans this package does
    not run: shard-uniform proxy plans (the reference's stand-in for every
    shard under one SPMD trace; here each rank runs its own shard's plan,
    ``parallel.dist_spmm``).  Every other plan runs in the row layout
    (``spmm_rows``), rectangular shard plans included, and, where
    ``spmm_padded_supported``, also in the wide padded layout (tiled plans
    through ``band_tiled_spmm``), with its band blocks at either
    ``a_dtype``."""
    if getattr(plan, "shard_uniform", False):
        raise NotImplementedError(
            "shard-uniform proxy plans: each rank runs its own shard's plan "
            "(hcspmm_tpu_torch.parallel.dist_spmm)")


def check_plan(plan) -> None:
    """Raise NotImplementedError unless ``plan`` runs on the wide padded
    layout with no edge dropped: a square plan with band buckets and
    band and spill populations only, every superwindow either covered by
    one band entry or listed as missing (its block is zeroed and its edges
    spill), and band slices inside the padded layout.  These are the plans
    the reference's ``spmm_padded_supported`` admits here (a cover it
    would accept with blocks that no entry owns raises).  A tiled plan
    (spill-free by construction) runs its pairs instead."""
    rows_check(plan)
    if getattr(plan, "tiled", False):
        if plan.has_spill or plan.tile_w != TILE_W or plan.padded_rows % TILE_W:
            raise NotImplementedError(
                f"a tiled plan with spill ({plan.spill_nnz} edges), tile width "
                f"{plan.tile_w} or {plan.padded_rows} rows: the tiled band takes "
                f"spill-free pairs of {TILE_W}-row tiles")
        return
    if plan.dense_nnz or plan.sparse_nnz:
        raise NotImplementedError(
            "the dense and sparse row-merge populations (dense_nnz="
            f"{plan.dense_nnz}, sparse_nnz={plan.sparse_nnz}) and their "
            "out_perm merge run in the row layout (spmm_rows)")
    if not plan.band_widths:
        raise NotImplementedError(
            "the wide padded layout needs band buckets; this plan runs in "
            "the row layout (spmm_rows)")
    m = plan.padded_rows
    num_sw = m // plan.band_h
    covered = sum(len(s) for s in plan.band_sw_ids)
    missing = len(plan.band_missing_sw)
    if covered + missing != num_sw:
        raise NotImplementedError(
            f"band entries cover {covered} and {missing} are missing of "
            f"{num_sw} superwindows: a plan whose blocks do not all have "
            "one owner would leave output unset")
    if not spmm_padded_supported(plan):
        raise NotImplementedError(
            f"band slices leave the padded layout of {m} rows: this plan runs "
            "in the row layout (spmm_rows)")


def check_band_arrays(starts: np.ndarray, sw_ids: np.ndarray, w: int, m: int,
                      num_sw: int, pack: int = 1) -> None:
    """Host check of one bucket's entries before upload: the kernel reads
    xp[st : st+Bb] unchecked, so every slice (capacity padding included:
    bucket mode computes it) must lie inside [0, M); a row of A stored
    ``pack`` columns to a byte must be whole 4-byte words."""
    st = np.asarray(starts, dtype=np.int64)
    sw = np.asarray(sw_ids, dtype=np.int64)
    if w % (4 * pack):
        raise ValueError(f"band width {w} is not a multiple of {4 * pack}")
    if len(st) and ((st % 16).any() or st.min() < 0 or st.max() + w > m):
        raise ValueError(f"band starts must be 16-aligned with st + {w} <= {m}")
    if len(sw) != len(st) or (len(sw) and (sw.min() < 0 or sw.max() > num_sw)):
        raise ValueError(f"superwindow ids must lie in [0, {num_sw}]")


# ---------------------------------------------------------------------------
# plain PyTorch versions (tests, CPU tensors, and the kernel's check)
# ---------------------------------------------------------------------------


def block_row_scale(scale, sw_ids, bh):
    """fp32 [Sb, bh]: the scale of each row of each entry's superwindow,
    ``scale[sw[i] * bh + r]``, 0 past the scale (capacity padding)."""
    rows = sw_ids.long()[:, None] * bh + torch.arange(bh, device=scale.device)
    inside = rows < scale.shape[0]
    return torch.where(inside, scale[rows.clamp(max=scale.shape[0] - 1)], 0.0)


def band_bucket_spmm_plain(starts, a, xp, scale=None, sw_ids=None):
    """fp32 [Sb, bh, dp]: block i = A[i] @ xp[st[i] : st[i]+Bb] (``a`` as
    stored, int8 or int4 nibbles: ``expand_a``).  With ``scale`` (fp32 [M]
    over xp's rows): block i = D_i A[i] D xp slice, the slice's rows times
    their scales and each row of the block times ``block_row_scale``'s
    (the rows of superwindow ``sw_ids[i]``)."""
    a = expand_a(a)
    bb = a.shape[2]
    rows = starts.long()[:, None] + torch.arange(bb, device=xp.device)
    xs = xp[rows].float()
    if scale is not None:
        xs = xs * scale[rows][..., None]
    part = torch.einsum("sbk,skd->sbd", a.float(), xs)
    if scale is not None:
        part = part * block_row_scale(scale, sw_ids, a.shape[1])[..., None]
    return part


def band_bucket_spmm_direct_plain(sw_ids, starts, a, xp, num_sw, out_dtype, scale=None):
    """[num_sw, bh, dp] ``out_dtype``: block sw[i] = A[i] @ xp slice (with
    ``scale``, as ``band_bucket_spmm_plain`` scales it); entries with sw ==
    num_sw are dropped, unowned blocks stay unset."""
    part = band_bucket_spmm_plain(starts, a, xp, scale, sw_ids)
    out = torch.empty((num_sw,) + part.shape[1:], dtype=out_dtype, device=xp.device)
    keep = sw_ids < num_sw
    out[sw_ids[keep].long()] = part[keep].to(out_dtype)
    return out


def band_bucket_spmm_grouped_plain(starts, a, xp, num_sw, out_dtype, group=4):
    """[min(Sb, num_sw), bh, dp] ``out_dtype``: block i = A[i] @ xp slice in
    identity order (``group`` changes no value)."""
    return band_bucket_spmm_plain(starts, a, xp)[:num_sw].to(out_dtype)


def band_fused_spmm_direct_plain(sw_ids, starts, a, xp, w, num_sw, out_dtype):
    """(agg [num_sw, bh, dp], out [num_sw, bh, hp]) ``out_dtype``: agg = A[i]
    @ xp slice in fp32, out = agg rounded to w's dtype @ w in fp32; blocks
    as ``band_bucket_spmm_direct_plain``."""
    part = band_bucket_spmm_plain(starts, a, xp)
    prod = torch.matmul(part.to(w.dtype).float(), w.float())
    keep = sw_ids < num_sw
    idx = sw_ids[keep].long()
    agg = torch.empty((num_sw,) + part.shape[1:], dtype=out_dtype, device=xp.device)
    out = torch.empty((num_sw,) + prod.shape[1:], dtype=out_dtype, device=xp.device)
    agg[idx] = part[keep].to(out_dtype)
    out[idx] = prod[keep].to(out_dtype)
    return agg, out


def band_tiled_spmm_plain(arrs, xp, plan, out_dtype):
    """[M // bh, bh, dp] ``out_dtype``: each pair's ``tp_a[p] @ xp tile`` in
    fp32, summed per superwindow by ``index_add_`` in pair order."""
    ptr = arrs["tp_ptr"].long()
    num_sw = ptr.shape[0] - 1
    pairs = int(ptr[-1])
    tile, a = arrs["tp_tile"][:pairs].long(), expand_a(arrs["tp_a"])
    owner = torch.repeat_interleave(torch.arange(num_sw, device=xp.device), ptr[1:] - ptr[:-1])
    rows = tile[:, None] * TILE_W + torch.arange(TILE_W, device=xp.device)
    part = torch.einsum("pbk,pkd->pbd", a.float(), xp[rows].float())
    out = torch.zeros((num_sw, plan.band_h, xp.shape[1]), dtype=torch.float32,
                      device=xp.device)
    return out.index_add_(0, owner, part).to(out_dtype)


def _gather_rows(xp, idx):
    """fp32 rows ``xp[idx]``; an index outside [0, R) gives a zero row (the
    reference's zero row for pad columns)."""
    r = xp.shape[0]
    idx = idx.long()
    ok = (idx >= 0) & (idx < r)
    if r == 0:
        return torch.zeros(idx.shape + xp.shape[1:], dtype=torch.float32, device=xp.device)
    rows = xp.index_select(0, idx.clamp(0, r - 1).reshape(-1)).float()
    rows = rows.reshape(idx.shape + xp.shape[1:])
    return torch.where(ok[..., None], rows, torch.zeros((), device=xp.device))


def _into(out, res):
    if out is None:
        return res
    out.copy_(res)
    return out


def dense_bucket_spmm_plain(cols, a, xp, out=None):
    """fp32 [Wb, wh, D]: ``out[w] = a[w] @ xp[cols[w]]`` (index_select, then
    an fp32 einsum)."""
    return _into(out, torch.einsum("wrk,wkd->wrd", a.float(), _gather_rows(xp, cols)))


def ell_bucket_spmm_plain(cols, xp, out=None):
    """fp32 [Rb, D]: ``out[r] = sum_k xp[cols[r, k]]`` (index_select, then an
    fp32 sum)."""
    return _into(out, _gather_rows(xp, cols).sum(1))


def ell_residual_spmm_plain(ptr, cols, xp, out=None):
    """fp32 [Rs, D]: ``out[r] = sum of xp[cols[e]]`` over ``ptr[r] <= e <
    ptr[r+1]`` (``index_add_`` by row)."""
    rows = ptr.shape[0] - 1
    lens = (ptr[1:] - ptr[:-1]).long()
    seg = torch.repeat_interleave(torch.arange(rows, device=xp.device), lens)
    lo = int(ptr[0]) if rows else 0
    edges = cols[lo: lo + seg.shape[0]]
    res = torch.zeros((rows,) + xp.shape[1:], dtype=torch.float32, device=xp.device)
    return _into(out, res.index_add_(0, seg, _gather_rows(xp, edges)))


def dense_rows_plain(arrs, plan, xp, out):
    """Every real dense window of ``plan`` (``b{b}_wid``) into ``out`` [N, D]
    fp32: window w's row r at node ``w * window_h + r``, rows past N
    dropped (``dense_bucket_spmm_plain``, then ``index_copy_``)."""
    wh, n = plan.window_h, out.shape[0]
    for b in range(len(plan.bucket_widths)):
        wid = arrs[f"b{b}_wid"].long()
        w = wid.shape[0]
        if not w:
            continue
        res = dense_bucket_spmm_plain(arrs[f"b{b}_cols"][:w], arrs[f"b{b}_a"][:w], xp)
        node = (wid[:, None] * wh + torch.arange(wh, device=xp.device)).reshape(-1)
        keep = node < n
        out.index_copy_(0, node[keep], res.reshape(-1, xp.shape[1])[keep])
    return out


def ell_rows_plain(node, ptr, cols, xp, out):
    """Row i of the table (``ell_residual_spmm_plain``'s sum over
    ``cols[ptr[i]:ptr[i+1]]``) into ``out`` [N, D] fp32 at node ``node[i]``."""
    return out.index_copy_(0, node.long(), ell_residual_spmm_plain(ptr, cols, xp))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda_args(starts, sw_ids, a, xp):
    dev = xp.device
    if dev.type != "cuda":
        raise ValueError(f"xp lies on {dev}: the band kernel takes CUDA or CPU tensors")
    named = {"starts": starts, "a": a, "xp": xp}
    if sw_ids is not None:
        named["sw_ids"] = sw_ids
    for name, t in named.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    if xp.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"xp dtype {xp.dtype}: float32 or bfloat16 only")
    pack = a_pack(a)
    sb, bh, bb = a.shape[0], a.shape[1], a.shape[2] * pack
    m, dp = xp.shape
    for name, t in (("starts", starts), ("sw_ids", sw_ids)):
        if t is not None and (t.dtype != torch.int32 or tuple(t.shape) != (sb,)):
            raise ValueError(f"{name} must be int32 [{sb}]")
    if dp % 128 or bb % (4 * pack) or bb > m:
        raise ValueError(f"unsupported shape: dp={dp} Bb={bb} bh={bh} M={m}")
    return pack


def _check_scale(scale, ssw, m, dev, sb):
    """``scale`` fp32 [m] (the band's rows, or the tband kernel's lanes) and
    ``ssw`` int32 [Sb] on ``dev``, contiguous (the band kernels read them
    unchecked)."""
    if (scale.device != dev or not scale.is_contiguous() or scale.dtype != torch.float32
            or tuple(scale.shape) != (m,)):
        raise ValueError(f"scale must be contiguous float32 [{m}] on {dev}")
    if (ssw is None or ssw.device != dev or not ssw.is_contiguous()
            or ssw.dtype != torch.int32 or tuple(ssw.shape) != (sb,)):
        raise ValueError(f"a scaled launch needs each entry's superwindow: int32 [{sb}] on "
                         f"{dev}")


def _launch(starts, sw_ids, a, xp, out, num_sw, pack, group=1, scale=None, ssw=None):
    global launches
    sb, bh, bb = a.shape[0], a.shape[1], a.shape[2] * pack
    if scale is not None:
        _check_scale(scale, ssw, xp.shape[0], xp.device, sb)
    with torch.cuda.device(xp.device):
        ring = band_launch(a.shape[2], *band_device(xp.device.index)[1:],
                           aligned=a.data_ptr() % 16 == 0)
        counter = torch.zeros(1, dtype=torch.int32, device=xp.device)  # the blocks' work counter
        rc = _lib().hcspmm_band_spmm(
            starts.data_ptr(), None if sw_ids is None else sw_ids.data_ptr(), a.data_ptr(),
            xp.data_ptr(), out.data_ptr(), counter.data_ptr(), sb, bh, bb, xp.shape[1], num_sw,
            group, ring["rows"], ring["box_w"], ring["nbox"], ring["stages"], int(ring["tma"]),
            pack, int(xp.dtype == torch.bfloat16), int(out.dtype == torch.float32),
            None if scale is None else scale.data_ptr(), None if scale is None else ssw.data_ptr(),
            0 if scale is None else scale.shape[0], torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "band_kernel")
    launches += 1


def _raise_on(rc, kernel):
    if rc != 0:
        raise RuntimeError(f"csrc/block_spmm.cu {kernel} launch failed: cudaError {rc}")


def band_bucket_spmm_direct(sw_ids, starts, a, xp, num_sw, out_dtype, scale=None):
    """Row-layout band SpMM, direct write: entry i computes superwindow
    ``sw_ids[i]``'s output rows (port of the Pallas kernel at
    hcspmm_tpu/kernels/block_spmm.py:424).

    starts, sw_ids: int32 [Sb]; a: int8 [Sb, bh, Bb], or int4 nibbles uint8
    [Sb, bh, Bb/2] (``a_pack``); xp: [M, dp] float32 or bfloat16.  Returns
    [num_sw, bh, dp] in ``out_dtype`` (xp's dtype or float32).  Entries with
    ``sw_id == num_sw`` write nothing, and blocks no entry owns are left
    unset: callers zero or overwrite them.  ``scale`` (fp32 [M], a diagonal
    D over xp's rows and the output's): the block is D A D xp, the kernel
    scaling X's rows in its sums and each output row at its store."""
    if xp.device.type == "cpu":
        return band_bucket_spmm_direct_plain(sw_ids, starts, a, xp, num_sw, out_dtype, scale)
    pack = _check_cuda_args(starts, sw_ids, a, xp)
    if out_dtype not in (xp.dtype, torch.float32):
        raise ValueError(f"out_dtype {out_dtype}: xp's dtype or float32")
    out = torch.empty((num_sw, a.shape[1], xp.shape[1]), dtype=out_dtype, device=xp.device)
    _launch(starts, sw_ids, a, xp, out, num_sw, pack, scale=scale, ssw=sw_ids)
    kernel_launches["band_bucket_spmm_direct"] += 1
    return out


def band_bucket_spmm(starts, a, xp, scale=None, sw_ids=None):
    """Bucket-order form for secondary buckets (port of
    hcspmm_tpu/kernels/block_spmm.py:290): fp32 [Sb, bh, dp], block i from
    entry i; the caller scatters the blocks.  ``scale`` as
    ``band_bucket_spmm_direct``'s, with ``sw_ids`` (int32 [Sb]) naming the
    superwindow whose rows' scales block i takes."""
    if xp.device.type == "cpu":
        return band_bucket_spmm_plain(starts, a, xp, scale, sw_ids)
    pack = _check_cuda_args(starts, None, a, xp)
    out = torch.empty((a.shape[0], a.shape[1], xp.shape[1]), dtype=torch.float32,
                      device=xp.device)
    _launch(starts, None, a, xp, out, a.shape[0], pack, scale=scale, ssw=sw_ids)
    kernel_launches["band_bucket_spmm"] += 1
    return out


def grouped_size(sb: int, group: int) -> int:
    """The reference's group after halving until it divides Sb (capacity
    is plan-padded to a multiple of 4)."""
    while group > 1 and sb % group:
        group //= 2
    return group


def band_bucket_spmm_grouped(starts, a, xp, num_sw, out_dtype, group: int = 4):
    """Full-cover single-bucket band SpMM with ``group`` superwindows a
    thread block, in identity superwindow order (port of the Pallas kernel at
    hcspmm_tpu/kernels/block_spmm.py:379, an experiment the reference keeps
    for A/B runs against the direct kernel; the band kernel's grouped mode).

    Returns [min(Sb, num_sw), bh, dp] in ``out_dtype``: block i = A[i] @
    xp[st[i] : st[i]+Bb]; entries past num_sw (capacity padding) write
    nothing."""
    group = grouped_size(a.shape[0], group)
    if xp.device.type == "cpu":
        return band_bucket_spmm_grouped_plain(starts, a, xp, num_sw, out_dtype, group)
    pack = _check_cuda_args(starts, None, a, xp)
    if out_dtype not in (xp.dtype, torch.float32):
        raise ValueError(f"out_dtype {out_dtype}: xp's dtype or float32")
    out = torch.empty((min(a.shape[0], num_sw), a.shape[1], xp.shape[1]), dtype=out_dtype,
                      device=xp.device)
    _launch(starts, None, a, xp, out, num_sw, pack, group)
    kernel_launches["band_bucket_spmm_grouped"] += 1
    return out


def band_direct_dispatch(arrs, s, xp, num_sw, out_dtype, scale=None):
    """Direct-write band call for bucket ``s`` of the uploaded plan arrays
    (the reference's ``band_direct_dispatch``, block_spmm.py:325)."""
    return band_bucket_spmm_direct(arrs[f"band{s}_sw"], arrs[f"band{s}_start"],
                                   arrs[f"band{s}_a"], xp, num_sw, out_dtype, scale)


def band_fused_spmm_direct(sw_ids, starts, a, xp, w, num_sw, out_dtype):
    """Fused aggregate and update, direct write (port of the Pallas kernel at
    hcspmm_tpu/kernels/block_spmm.py:630): entry i computes superwindow
    ``sw_ids[i]``'s ``agg = A[i] @ xp[st : st+Bb]`` (fp32 sums) and ``out =
    agg.astype(w.dtype) @ w`` (fp32 sums) in one launch.

    w: [dp, hp] in xp's dtype (the forward form W or the backward form
    W^T).  Returns (agg [num_sw, bh, dp], out [num_sw, bh, hp]) in
    ``out_dtype`` (xp's dtype or float32); entries with ``sw_id == num_sw``
    write nothing and unowned blocks stay unset.  Every dp runs: the band
    kernel's fused form (``fused_launch``) writes a unit's aggregate rows,
    then reads them back from L2 in slabs for the update."""
    if xp.device.type == "cpu":
        return band_fused_spmm_direct_plain(sw_ids, starts, a, xp, w, num_sw, out_dtype)
    pack = _check_cuda_args(starts, sw_ids, a, xp)
    dp = xp.shape[1]
    if (w.device != xp.device or not w.is_contiguous() or w.dtype != xp.dtype
            or w.dim() != 2 or w.shape[0] != dp):
        raise ValueError(f"w must be contiguous {xp.dtype} [{dp}, hp] on {xp.device}")
    if out_dtype not in (xp.dtype, torch.float32):
        raise ValueError(f"out_dtype {out_dtype}: xp's dtype or float32")
    sb, bh, bb = a.shape[0], a.shape[1], a.shape[2] * pack
    hp = w.shape[1]
    agg = torch.empty((num_sw, bh, dp), dtype=out_dtype, device=xp.device)
    out = torch.empty((num_sw, bh, hp), dtype=out_dtype, device=xp.device)
    resident = ctypes.c_int()
    with torch.cuda.device(xp.device):
        cfg = fused_launch(a.shape[2], dp, hp, *band_device(xp.device.index)[1:],
                           aligned=a.data_ptr() % 16 == 0)
        counter = torch.zeros(1, dtype=torch.int32, device=xp.device)  # the blocks' work counter
        rc = _lib().hcspmm_band_fused(
            starts.data_ptr(), sw_ids.data_ptr(), a.data_ptr(), xp.data_ptr(), w.data_ptr(),
            agg.data_ptr(), out.data_ptr(), counter.data_ptr(), sb, bh, bb, dp, hp, num_sw,
            cfg["arows"], cfg["box_w"], cfg["nbox"], int(cfg["tma"]), pack,
            int(xp.dtype == torch.bfloat16), int(out_dtype == torch.float32),
            ctypes.byref(resident), torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "band_fused_kernel")
    last_fused_launch.clear()
    last_fused_launch.update(cfg, resident=resident.value)
    kernel_launches["band_fused_spmm_direct"] += 1
    fused_shapes[(dp, hp)] += 1
    return agg, out


def band_fused_dispatch(arrs, s, xp, wp, num_sw, out_dtype):
    """Fused direct-write band call for bucket ``s`` (the reference's
    ``band_fused_dispatch``, block_spmm.py:607)."""
    return band_fused_spmm_direct(arrs[f"band{s}_sw"], arrs[f"band{s}_start"],
                                  arrs[f"band{s}_a"], xp, wp, num_sw, out_dtype)


def band_tiled_spmm(arrs, xp, plan, out_dtype):
    """Tiled band SpMM over the padded layout: xp [M, dp] -> [M // bh, bh,
    dp] in ``out_dtype`` (port of the Pallas kernel at
    hcspmm_tpu/kernels/block_spmm.py:561).  Superwindow s sums its run of
    pairs ``tp_ptr[s] <= p < tp_ptr[s+1]``: ``tp_a[p] [bh, 128] @
    xp[tp_tile[p]*128 : +128]`` in fp32, and writes its block once; an empty
    superwindow's one pair has a zero A tile.  ``tp_a`` is int8 [P, bh,
    128], or int4 nibbles uint8 [P, bh, 64] (``a_pack``).  The ring-cache schedule
    (``tp_fetch``/``tp_late``) changes no value and is only checked on the
    host (``check_tiled_arrays``)."""
    if xp.device.type == "cpu":
        return band_tiled_spmm_plain(arrs, xp, plan, out_dtype)
    ptr, tile, a = arrs["tp_ptr"], arrs["tp_tile"], arrs["tp_a"]
    m, dp = xp.shape
    num_sw = ptr.shape[0] - 1
    if xp.dtype not in (torch.float32, torch.bfloat16) or not xp.is_contiguous():
        raise ValueError(f"xp must be contiguous float32 or bfloat16, got {xp.dtype}")
    for name, t in (("tp_ptr", ptr), ("tp_tile", tile), ("tp_a", a)):
        if t.device != xp.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {xp.device}")
    pack = a_pack(a)
    if (a.shape[1:] != (plan.band_h, TILE_W // pack) or ptr.dtype != torch.int32
            or tile.dtype != torch.int32):
        raise ValueError(f"tp_a must be int8 [P, {plan.band_h}, {TILE_W}] or uint8 nibbles "
                         f"[P, {plan.band_h}, {TILE_W // 2}], tp_ptr and tp_tile int32")
    if dp % 128 or m != num_sw * plan.band_h:
        raise ValueError(f"xp [{m}, {dp}]: dp a multiple of 128, M = {num_sw} x "
                         f"{plan.band_h}")
    if out_dtype not in (xp.dtype, torch.float32):
        raise ValueError(f"out_dtype {out_dtype}: xp's dtype or float32")
    out = torch.empty((num_sw, plan.band_h, dp), dtype=out_dtype, device=xp.device)
    with torch.cuda.device(xp.device):
        rc = _lib().hcspmm_tiled_spmm(
            ptr.data_ptr(), tile.data_ptr(), a.data_ptr(), xp.data_ptr(), out.data_ptr(),
            num_sw, plan.band_h, dp, pack, int(xp.dtype == torch.bfloat16),
            int(out_dtype == torch.float32), torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "tiled_kernel")
    kernel_launches["band_tiled_spmm"] += 1
    return out


_MAX_BUCKETS = 8  # csrc/rows.cu dense: buckets of one launch's table
_ELL_SHORT = 16  # rows of at most this many entries: a group of lanes each
_ELL_SPLIT = 64  # rows of at least this many entries: a block of warps each

#: Arrays of ``check_row_arrays`` that stay on the host: the row table's
#: class counts, read by the ELL launch without a device sync.
HOST_KEYS = ("rows_meta",)


def _row_args(xp, out, shape, named):
    """Check the row kernels' arguments on the card; returns ``out`` (a new
    fp32 tensor when None)."""
    dev = xp.device
    if dev.type != "cuda":
        raise ValueError(f"xp lies on {dev}: the row kernels take CUDA or CPU tensors")
    if xp.dtype not in (torch.float32, torch.bfloat16) or xp.dim() != 2:
        raise ValueError(f"xp must be float32 or bfloat16 [R, D], got {xp.dtype} "
                         f"{tuple(xp.shape)}")
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    named = dict(named, xp=xp, out=out)
    for name, t in named.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
        if name not in ("xp", "out", "a") and t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32")
    if out.dtype != torch.float32 or tuple(out.shape) != tuple(shape):
        raise ValueError(f"out must be float32 {tuple(shape)}")
    return out


def _run_rows(names, fn, *args):
    """Launch on the current stream; counts one launch for each of ``names``."""
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csrc/rows.cu {names[0]} launch failed: cudaError {rc}")
    for name in names:
        row_launches[name] += 1


def window_masks(a: np.ndarray) -> np.ndarray:
    """int32 [W, wh, ceil(Kb / 32)]: bit k % 32 of word k // 32 of row r is
    ``a[w, r, k] != 0`` (the dense kernel's row masks, built at upload)."""
    w, wh, kb = a.shape
    nw = -(-kb // 32)
    words = np.zeros((w, wh, 4 * nw), np.uint8)
    words[..., : -(-kb // 8)] = np.packbits(np.asarray(a) != 0, axis=-1, bitorder="little")
    return words.view("<u4").view(np.int32)


def _dense_launch(buckets, wh, xp, out, limit):
    """One launch of the dense kernel over ``buckets`` [(cols, masks, wid or
    None, windows)], in that order."""
    nb = len(buckets)
    if nb > _MAX_BUCKETS:
        raise ValueError(f"{nb} dense buckets: csrc/rows.cu takes at most {_MAX_BUCKETS} a launch")
    vp, i32 = ctypes.c_void_p * nb, ctypes.c_int * nb
    with torch.cuda.device(xp.device):
        _run_rows(("dense_bucket_spmm",), _rows_lib().hcspmm_dense_rows,
                  vp(*[c.data_ptr() for c, _, _, _ in buckets]),
                  vp(*[m.data_ptr() for _, m, _, _ in buckets]),
                  vp(*[None if w is None else w.data_ptr() for _, _, w, _ in buckets]),
                  i32(*[c.shape[1] for c, _, _, _ in buckets]),
                  i32(*[n for _, _, _, n in buckets]), nb, wh, xp.data_ptr(), xp.shape[0],
                  xp.shape[1], int(xp.dtype == torch.bfloat16), out.data_ptr(), limit)
    return out


def dense_bucket_spmm(cols, a, xp, out=None):
    """``out[w] = a[w] @ xp[cols[w]]`` for one width bucket (port of the
    Pallas kernel at hcspmm_tpu/kernels/block_spmm.py:101).

    cols: int32 [Wb, Kb] neighbour rows (pad columns point at a zero row
    of xp or past its end: an index outside [0, R) adds nothing); a: int8
    0/1 [Wb, wh, Kb]; xp: [R, D] float32 or bfloat16.  Returns fp32
    [Wb, wh, D], written into ``out`` when given.  On the card: the dense
    kernel with a one-bucket table, its row masks built from ``a`` on the
    host (``window_masks``)."""
    if xp.device.type == "cpu":
        return dense_bucket_spmm_plain(cols, a, xp, out)
    wb, kb = cols.shape
    if a.dtype != torch.int8 or a.dim() != 3 or (a.shape[0], a.shape[2]) != (wb, kb):
        raise ValueError(f"a must be int8 [{wb}, wh, {kb}]")
    wh, d = a.shape[1], xp.shape[1]
    out = _row_args(xp, out, (wb, wh, d), dict(cols=cols, a=a))
    if wb and d:
        masks = torch.from_numpy(window_masks(a.cpu().numpy())).to(xp.device)
        _dense_launch([(cols, masks, None, wb)], wh, xp, out, wb * wh)
    return out


def dense_launch_groups(arrs, plan) -> list:
    """The buckets of each launch of ``dense_rows``: the plan's non-empty
    dense buckets, the widest first, in groups of at most ``_MAX_BUCKETS``
    (the table a launch takes by value; the buckets write disjoint rows, so
    the split changes no sum)."""
    buckets = sorted((b for b in range(len(plan.bucket_widths))
                      if arrs[f"b{b}_wid"].shape[0]), key=lambda b: -plan.bucket_widths[b])
    return [buckets[i:i + _MAX_BUCKETS] for i in range(0, len(buckets), _MAX_BUCKETS)]


def dense_rows(arrs, plan, xp, out):
    """Every real dense window of ``plan`` into ``out`` [N, D] fp32, window
    w's row r at node ``w * window_h + r`` (rows past N write nothing), in
    one launch over all buckets, the widest first, or one launch for each
    group of ``dense_launch_groups`` where there are more than
    ``_MAX_BUCKETS``.  ``arrs`` holds the upload's ``b{b}_cols``, ``b{b}_m``
    (row masks), ``b{b}_wid`` (window ids) and, for the plain version,
    ``b{b}_a``."""
    if xp.device.type == "cpu":
        return dense_rows_plain(arrs, plan, xp, out)
    _row_args(xp, out, (plan.num_nodes, xp.shape[1]), {})  # the tables: checked at upload
    if xp.shape[1]:
        for group in dense_launch_groups(arrs, plan):
            _dense_launch([(arrs[f"b{b}_cols"], arrs[f"b{b}_m"], arrs[f"b{b}_wid"],
                            arrs[f"b{b}_wid"].shape[0]) for b in group], plan.window_h, xp, out,
                          plan.num_nodes)
    return out


def _ell_launch(names, node, ptr, cols, de, classes, xp, out, limit):
    """One launch of the ELL kernel over a row table whose rows are hubs,
    middle and short rows in ``classes`` counts, in that order."""
    n_hub, n_mid, n_short = classes
    rows = n_hub + n_mid + n_short
    if not rows or not xp.shape[1]:
        return out
    with torch.cuda.device(xp.device):
        _run_rows(names, _rows_lib().hcspmm_ell_rows,
                  None if node is None else node.data_ptr(),
                  None if ptr is None else ptr.data_ptr(), cols.data_ptr(), de, rows, n_hub,
                  n_mid, xp.data_ptr(), xp.shape[0], xp.shape[1],
                  int(xp.dtype == torch.bfloat16), out.data_ptr(), limit)
    return out


def ell_bucket_spmm(cols, xp, out=None):
    """``out[r] = sum_k xp[cols[r, k]]`` for one ELL degree bucket (port of
    the Pallas kernel at hcspmm_tpu/kernels/block_spmm.py:161).

    cols: int32 [Rb, De] (pad entries point at a zero row or past the
    table); xp: [R, D] float32 or bfloat16.  Returns fp32 [Rb, D]."""
    if xp.device.type == "cpu":
        return ell_bucket_spmm_plain(cols, xp, out)
    rb, de = cols.shape
    out = _row_args(xp, out, (rb, xp.shape[1]), dict(cols=cols))
    classes = ((rb, 0, 0) if de >= _ELL_SPLIT else (0, rb, 0) if de > _ELL_SHORT
               else (0, 0, rb))
    return _ell_launch(("ell_bucket_spmm",), None, None, cols, de, classes, xp, out, rb)


def ell_residual_spmm(ptr, cols, xp, out=None):
    """The residual rows (degree above every ELL width; the reference's
    segment-sum, block_spmm.py:1020-1029): ``out[r] = sum of xp[cols[e]]``
    for ``ptr[r] <= e < ptr[r+1]``, in edge order, by the ELL kernel (a
    block of warps a row).

    ptr: int32 [Rs + 1] nondecreasing, inside cols; cols: int32 [Es].
    Returns fp32 [Rs, D]."""
    if xp.device.type == "cpu":
        return ell_residual_spmm_plain(ptr, cols, xp, out)
    rows = ptr.shape[0] - 1
    out = _row_args(xp, out, (rows, xp.shape[1]), dict(ptr=ptr, cols=cols))
    return _ell_launch(("ell_residual",), None, ptr, cols, 0, (rows, 0, 0), xp, out, rows)


def ell_rows(arrs, xp, out):
    """The plan's row table (``rw_node``, ``rw_ptr``, ``rw_cols``: the ELL
    rows and the residual rows without their pad entries, then the nodes of
    no population as empty rows) into ``out`` [N, D] fp32 at each row's
    node, in one launch; the residual rows ride it (counted in
    ``row_launches["ell_residual"]``)."""
    node, ptr, cols = arrs["rw_node"], arrs["rw_ptr"], arrs["rw_cols"]
    if xp.device.type == "cpu":
        return ell_rows_plain(node, ptr, cols, xp, out)
    n_hub, n_mid, n_short, n_res = arrs["rows_meta"].tolist()
    _row_args(xp, out, (out.shape[0], xp.shape[1]), {})  # the table: checked at upload
    names = ("ell_bucket_spmm", "ell_residual") if n_res else ("ell_bucket_spmm",)
    return _ell_launch(names, node, ptr, cols, 0, (n_hub, n_mid, n_short), xp, out,
                       out.shape[0])


# ---------------------------------------------------------------------------
# full SpMM over the wide padded layout (+ glue for [N, d] callers)
# ---------------------------------------------------------------------------


def _spill_seg(arrs, xsrc, plan, scale=None):
    """fp32 [Rs, D]: each spill row's sum of its spilled edges' rows of
    ``xsrc`` (clip mode; port of hcspmm_tpu/kernels/block_spmm.py:729),
    each row times its ``scale`` where one is given (fp32 over xsrc's
    rows)."""
    cols = arrs["spill_edge_col"].clamp(max=xsrc.shape[0] - 1)
    xe = xsrc.index_select(0, cols).float()
    if scale is not None:
        xe = xe.mul_(scale.index_select(0, cols)[:, None])
    seg = torch.zeros((plan.num_spill_rows + 1, xsrc.shape[1]), dtype=torch.float32,
                      device=xsrc.device)
    seg.index_add_(0, arrs["spill_edge_seg"], xe)
    return seg[: plan.num_spill_rows]


def _spill_rows(arrs, plan, m):
    """The spill rows inside the first ``m`` rows (real rows come first,
    checked on upload; the padding rows are dropped)."""
    return arrs["spill_rows"][: int(np.count_nonzero(plan.spill_rows < m))]


def _spill_take(out, arrs, xsrc, plan, scale=None):
    """The take path (port of hcspmm_tpu/kernels/block_spmm.py:729-765):
    gather each spilled edge's row of ``xsrc`` (clip mode), segment-sum by
    spill row in fp32, and add each row's sum onto ``out``.  ``scale`` (fp32
    [M] over xsrc's and out's rows): the gathered rows times their scales,
    each sum times its row's; arrays of the spill's size, never [M, D]."""
    rows = _spill_rows(arrs, plan, out.shape[0])
    seg = _spill_seg(arrs, xsrc, plan, scale)[: rows.shape[0]]
    if scale is not None:
        seg = seg.mul_(scale.index_select(0, rows)[:, None])
    return out.index_add_(0, rows, seg.to(out.dtype))


def apply_spill(out, arrs, xsrc, plan, scale=None):
    """Add the spill population onto ``out`` [M, d] in place (port of
    hcspmm_tpu/kernels/block_spmm.py:745): the row merge when the plan
    carries its streams and ``out`` is the full padded row space, else
    the take path.  ``scale`` (fp32 [M]): the spill of D A D xsrc, onto an
    ``out`` that holds the scaled band part."""
    if not (plan.has_spill and "spill_rows" in arrs):
        return out
    profiling.count("spmm.spill_edges", plan.spill_nnz)
    with profiling.span("spmm.spill.rows"):
        if ("ds_blk" in arrs and out.shape[0] == plan.ds_rows
                and out.shape[1] == xsrc.shape[1]):
            return dstream.dstream_spill(arrs, xsrc, out, plan, scale)
        return _spill_take(out, arrs, xsrc, plan, scale)


def _spill_take_rows(out, arrs, xsrc, plan):
    """The row layout's spill: the take path onto ``out`` [N, d], spanned
    and counted as ``apply_spill`` is."""
    if not (plan.has_spill and "spill_rows" in arrs):
        return out
    profiling.count("spmm.spill_edges", plan.spill_nnz)
    with profiling.span("spmm.spill.rows"):
        return _spill_take(out, arrs, xsrc, plan)


def spmm_wide_padded(arrs, xp, plan, compute_dtype):
    """SpMM over the wide padded layout: xp [M, dp] -> [M, dp] (port of
    hcspmm_tpu/kernels/block_spmm.py:803 on wide plans).  The most
    populated bucket writes the whole buffer directly; each other bucket's
    blocks are scattered over the blocks it owns (unset by the direct
    write); the missing superwindows' blocks are zeroed (aligned runs of
    eight first); the spill population is added last.  With no band entry
    at all the buffer starts as zeros.  A tiled plan is one
    ``band_tiled_spmm`` (it never spills).

    ``arrs["row_scale"]``, where present (fp32 [M], a diagonal D with 1 on
    the pad rows; not on tiled plans), computes D A D xp: the band kernel
    and the row merge (or the take path) apply D as they sum, with no pass
    over [M, dp] of their own; counted in ``spmm.scale_folded``.  D is an
    operand that travels in a copy of the static plan arrays
    (``ops.spmm.WideLayout`` builds that copy once), because this 4-argument
    signature is the one ``benchmark/tests/test_bench_faults.py`` patches;
    any plan dict that carries ``row_scale`` is therefore a scaled SpMM.
    It belongs in an explicit argument once that test can follow."""
    check_plan(plan)
    xp = xp.to(compute_dtype).contiguous()
    m, dp = xp.shape
    if m != plan.padded_rows:
        raise ValueError(f"xp has {m} rows, the plan's layout {plan.padded_rows}")
    scale = arrs.get("row_scale")
    if scale is not None:
        if getattr(plan, "tiled", False):
            raise ValueError("the tiled band takes no scale: scale its input and output")
        profiling.count("spmm.scale_folded")
    if getattr(plan, "tiled", False):
        with profiling.span("spmm.band"):
            return band_tiled_spmm(arrs, xp, plan, xp.dtype).view(m, dp)
    bh = plan.band_h
    num_sw = m // bh
    nonempty = [i for i in range(len(plan.band_widths))
                if arrs[f"band{i}_start"].shape[0] > 0]
    with profiling.span("spmm.band"):
        if not nonempty:
            buf = torch.zeros((m, dp), dtype=xp.dtype, device=xp.device)
        else:
            s_main = max(nonempty, key=lambda i: len(plan.band_sw_ids[i]))
            b3 = band_direct_dispatch(arrs, s_main, xp, num_sw, xp.dtype, scale)
            for i in nonempty:
                if i == s_main:
                    continue
                part = band_bucket_spmm(arrs[f"band{i}_start"], arrs[f"band{i}_a"], xp, scale,
                                        arrs[f"band{i}_sw"])
                real = len(plan.band_sw_ids[i])  # capacity padding trails the real entries
                b3.index_copy_(0, arrs[f"band{i}_sw"][:real].long(), part[:real].to(b3.dtype))
            buf = b3.view(m, dp)
            for key, w in (("band_missing_sw8", 8 * bh), ("band_missing_sw", bh)):
                if key in arrs:
                    buf = tspill.zero_row_blocks(buf, arrs[key], w)
    return apply_spill(buf, arrs, xp, plan, scale)


def single_full_bucket(arrs, plan, num_sw):
    """The one non-empty band bucket when it owns all ``num_sw``
    superwindows, else None (the fused kernel's condition)."""
    nonempty = [s for s in range(len(plan.band_widths))
                if arrs[f"band{s}_start"].shape[0] > 0]
    if len(nonempty) != 1 or len(plan.band_sw_ids[nonempty[0]]) != num_sw:
        return None
    return nonempty[0]


def _fuse_spill(agg_r, out_r, arrs, xsrc, w, plan):
    """The band+spill correction of a fused call (the reference's, in XLA):
    each spill row's sum ``seg`` of ``xsrc`` rows is added to agg and ``seg
    @ w`` (fp32) to out, on the spill rows only."""
    if plan.has_spill and "spill_rows" in arrs:
        rows = _spill_rows(arrs, plan, agg_r.shape[0])
        seg = _spill_seg(arrs, xsrc, plan)[: rows.shape[0]]
        agg_r.index_add_(0, rows, seg.to(agg_r.dtype))
        out_r.index_add_(0, rows, torch.matmul(seg, w.float()).to(out_r.dtype))
    return out_r, agg_r


def spmm_fused_wide_padded(arrs, xp, wp, plan):
    """Fused ``(out = agg @ wp, agg = A @ xp)`` in the closed wide padded
    layout (port of hcspmm_tpu/kernels/block_spmm.py:867): xp [M, dp], wp
    [dp, hp] in xp's dtype; returns ([M, hp], [M, dp]) in xp's dtype, with
    the spill correction on the spill rows.  None, for the caller to
    compose, unless the plan is a wide (not tiled, not tband) plan whose one
    band bucket owns every superwindow."""
    if (getattr(plan, "tiled", False) or not plan.band_padded_ok
            or getattr(plan, "tband", False)):
        return None
    m, dp = xp.shape
    num_sw = plan.padded_rows // plan.band_h
    s = single_full_bucket(arrs, plan, num_sw)
    if s is None:
        return None
    xp = xp.contiguous()
    agg, out = band_fused_dispatch(arrs, s, xp, wp.to(xp.dtype).contiguous(), num_sw, xp.dtype)
    return _fuse_spill(agg.view(m, dp), out.view(m, wp.shape[1]), arrs, xp, wp, plan)


def spmm_fused_rows(arrs, x, w, plan, compute_dtype):
    """Fused ``((A @ x) @ w, A @ x)`` in the row layout, x [N, d], w [d, h]
    -> ([N, h], [N, d]) in x's dtype (port of
    hcspmm_tpu/kernels/block_spmm.py:677): x padded to the band table
    (``xp_rows`` and 128 columns) in the compute dtype, w's rows padded to
    match, one fused launch, the slices, and the spill correction.  None
    unless the plan is a full-cover wide plan whose one band bucket owns
    every superwindow."""
    n, d = x.shape
    if (not plan.band_full_cover or getattr(plan, "tiled", False)
            or getattr(plan, "tband", False)):
        return None
    num_sw = max(plan.band_num_sw, -(-n // plan.band_h))
    s = single_full_bucket(arrs, plan, num_sw)
    if s is None:
        return None
    xb = _band_table(x.to(compute_dtype), plan)
    wp = torch.zeros((xb.shape[1], w.shape[1]), dtype=compute_dtype, device=w.device)
    wp[:d] = w
    od = x.dtype if x.dtype in (compute_dtype, torch.float32) else torch.float32
    agg, out = band_fused_dispatch(arrs, s, xb, wp, num_sw, od)
    out_r = out.view(-1, w.shape[1])[:n]
    agg_r = agg.view(-1, xb.shape[1])[:n, :d].contiguous()
    out_r, agg_r = _fuse_spill(agg_r, out_r, arrs, xb[:, :d], w, plan)
    return out_r.to(x.dtype), agg_r.to(x.dtype)


# ---------------------------------------------------------------------------
# full SpMM in the row layout [N, d] (HC-SpMM's hybrid)
# ---------------------------------------------------------------------------


def band_table_rows(plan) -> int:
    """Rows of the row layout's band table: X's ``num_cols`` rows (the
    column space, wider than the N output rows on a shard plan), its zero
    row, and zero rows up to the plan's ``xp_rows`` and the padded layout's
    M, so that every band slice (capacity padding included) lies inside it."""
    return max(plan.xp_rows, plan.num_cols + 1, plan.padded_rows)


def _band_table(xr, plan):
    """[band_table_rows, 128-multiple] copy of ``xr`` (all its rows) for the
    band kernel."""
    r, d = xr.shape
    xb = torch.zeros((band_table_rows(plan), lane_pad(d)), dtype=xr.dtype, device=xr.device)
    xb[:r, :d] = xr
    return xb


def row_population_rows(plan) -> int:
    """Rows of the row populations laid end to end, capacity padding
    included (band buckets, dense windows, ELL rows, residual rows, in that
    order): ``out_perm`` indexes them, and its zero row follows them."""
    return (sum(int(s.shape[0]) * plan.band_h for s in plan.band_starts)
            + sum(int(c.shape[0]) * plan.window_h for c in plan.bucket_cols)
            + sum(int(c.shape[0]) for c in plan.ell_cols) + plan.num_sparse_rows)


def band_covers_all(plan) -> bool:
    """Whether ``spmm_rows`` takes the full-cover path: the plan's band
    buckets own every superwindow of its N rows."""
    if not (plan.band_widths and plan.band_full_cover):
        return False
    num_sw = max(plan.band_num_sw, -(-plan.num_nodes // plan.band_h))
    return (any(s.shape[0] for s in plan.band_starts)
            and sum(len(v) for v in plan.band_sw_ids) == num_sw)


def spmm_rows(arrs, x, plan, compute_dtype):
    """SpMM in the row layout: x [C, d] -> [N, d] in x's dtype, C the plan's
    ``num_cols`` (N on a square plan; on a shard plan the rank's column
    space, its rows and their halo) and N its ``num_nodes`` (port of
    hcspmm_tpu/kernels/block_spmm.py:897 ``spmm_pallas`` on non-tband
    plans, which also takes its row counts from the plan, never from x).

    Full band cover: the most populated band bucket writes every
    superwindow's block directly, the other buckets' blocks are scattered
    over theirs, and the spill is added onto the [N, d] slice.  Otherwise
    each population writes its rows of the fp32 [N, d] result (``torch.empty``)
    at their node ids: the band buckets' rows by ``index_copy_``, the dense
    windows in one launch for each eight buckets (``dense_rows``), the ELL
    and residual rows and the zero rows of the nodes no population owns in another (``ell_rows``);
    the upload checked that these owners partition [0, N).  The spill
    population is added by the take path, and the fp32 sums are rounded
    once to x's dtype.  The row kernels read ``x`` in the compute dtype
    with no padding (pad columns point past it); only the band kernel gets
    a 128-column table.  A tiled plan runs its padded core on x padded to
    [M, 128-multiple] and sliced back."""
    rows_check(plan)
    n, d = plan.num_nodes, x.shape[1]
    if x.shape[0] != plan.num_cols:
        raise ValueError(f"x has {x.shape[0]} rows, the plan's column space {plan.num_cols}")
    if getattr(plan, "tiled", False):
        xp = torch.zeros((plan.padded_rows, lane_pad(d)), dtype=compute_dtype, device=x.device)
        xp[:n, :d] = x
        return spmm_wide_padded(arrs, xp, plan, compute_dtype)[:n, :d].to(x.dtype)
    xr = x.to(compute_dtype).contiguous()
    if band_covers_all(plan):
        num_sw = max(plan.band_num_sw, -(-n // plan.band_h))
        # buckets with real entries: a shard plan's capacity padding (sw_id
        # == num_sw) may fill a bucket that owns no superwindow of its own
        nonempty = [s for s in range(len(plan.band_widths)) if len(plan.band_sw_ids[s])]
        with profiling.span("spmm.band"):
            xb = _band_table(xr, plan)
            od = x.dtype if x.dtype in (xr.dtype, torch.float32) else torch.float32
            s_main = max(nonempty, key=lambda s: len(plan.band_sw_ids[s]))
            b3 = band_direct_dispatch(arrs, s_main, xb, num_sw, od)
            for s in nonempty:
                if s != s_main:
                    part = band_bucket_spmm(arrs[f"band{s}_start"], arrs[f"band{s}_a"], xb)
                    real = len(plan.band_sw_ids[s])
                    b3.index_copy_(0, arrs[f"band{s}_sw"][:real].long(), part[:real].to(od))
            out = b3.view(-1, xb.shape[1])[:n, :d].contiguous()
        return _spill_take_rows(out, arrs, xr, plan).to(x.dtype)

    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    banded = [s for s in range(len(plan.band_widths)) if arrs[f"band{s}_rq"].shape[0]]
    with profiling.span("spmm.band"):
        xb = _band_table(xr, plan) if banded else None
        for s in banded:
            part = band_bucket_spmm(arrs[f"band{s}_start"], arrs[f"band{s}_a"], xb)
            out.index_copy_(0, arrs[f"band{s}_rnode"],
                            part.view(-1, xb.shape[1]).index_select(0, arrs[f"band{s}_rq"])[:, :d])
    dense_rows(arrs, plan, xr, out)
    ell_rows(arrs, xr, out)
    return _spill_take_rows(out, arrs, xr, plan).to(x.dtype)


def sparse_seg_ptr(seg, rs: int) -> np.ndarray:
    """int32 [rs + 1] row starts of the residual edges, whose rows ``seg``
    are sorted (padding edges carry row ``rs`` and fall past the last
    start)."""
    seg = np.asarray(seg, dtype=np.int64)
    if len(seg) and ((np.diff(seg) < 0).any() or seg.min() < 0 or seg.max() > rs):
        raise ValueError(f"sparse_edge_seg must be sorted in [0, {rs}]")
    return np.searchsorted(seg, np.arange(rs + 1), side="left").astype(np.int32)


def check_row_arrays(host: dict, plan) -> dict:
    """Host check of the row populations' index arrays before upload (the
    row kernels and the merge read them unchecked); returns the residual's
    row starts (``sparse_seg_ptr``) to upload beside them and, for a plan
    that ``spmm_rows`` runs population by population, ``row_tables``."""
    c = plan.num_cols
    for key in [f"b{b}_cols" for b in range(len(plan.bucket_widths))] + [
            f"e{e}_cols" for e in range(len(plan.ell_widths))] + ["sparse_edge_col"]:
        v = np.asarray(host[key])
        if v.size and (v.min() < 0 or v.max() > c):
            raise ValueError(f"{key} must lie in [0, {c}] ({c}: the zero row)")
    for b, kb in enumerate(plan.bucket_widths):
        cols, a = host[f"b{b}_cols"], host[f"b{b}_a"]
        if cols.shape[1:] != (kb,) or a.shape != (cols.shape[0], plan.window_h, kb):
            raise ValueError(f"b{b}_cols and b{b}_a must be [Wb, {kb}] and "
                             f"[Wb, {plan.window_h}, {kb}]")
    perm = np.asarray(host["out_perm"])
    total = row_population_rows(plan)
    if len(perm) != plan.num_nodes or (perm.size and (perm.min() < 0 or perm.max() > total)):
        raise ValueError(f"out_perm must hold {plan.num_nodes} rows in [0, {total}]")
    extra = {"sparse_seg_ptr": sparse_seg_ptr(host["sparse_edge_seg"], plan.num_sparse_rows)}
    if not (getattr(plan, "tband", False) or getattr(plan, "tiled", False)
            or band_covers_all(plan)):
        extra.update(row_tables(host, plan))
    return extra


def row_tables(host: dict, plan) -> dict:
    """The tables by which ``spmm_rows`` writes each population's rows at
    their node ids, built from the plan's owners of each row and checked
    against ``out_perm``: every node is owned exactly once, by one
    population row (band and dense rows below N, ELL rows, residual rows
    with edges) or, where ``out_perm`` points at the zero row, by none.
    Raises otherwise.

    Returns ``band{s}_rq`` / ``band{s}_rnode`` (int64: the band part's kept
    rows and their nodes), ``b{b}_wid`` (int32 window ids of the real
    windows) and ``b{b}_m`` (their row masks, ``window_masks``), and the row
    table of the ELL kernel: ``rw_node``, ``rw_ptr`` and ``rw_cols`` (int32;
    each ELL and residual row's real entries, without the pad entries at
    ``num_cols``, then the zero rows with none), sorted stably into hub rows
    (at least ``_ELL_SPLIT`` entries), middle rows and short rows (at most
    ``_ELL_SHORT``), with ``rows_meta`` = (hubs, middle, short, residual
    rows)."""
    n, c, wh, bh = plan.num_nodes, plan.num_cols, plan.window_h, plan.band_h
    owner = np.full(n, -1, np.int64)
    out = {}

    def claim(nodes, pos, what):
        if nodes.size and (nodes.min() < 0 or nodes.max() >= n):
            raise ValueError(f"{what} names a node outside [0, {n})")
        if np.unique(nodes).size != nodes.size or (owner[nodes] >= 0).any():
            raise ValueError(f"{what} claims a node that another row already owns")
        owner[nodes] = pos

    def block_rows(ids, h, off, what):
        ids = np.asarray(ids, np.int64)
        q = np.arange(ids.size * h)
        node = ids[q // h] * h + q % h if ids.size else q
        keep = node < n
        claim(node[keep], off + q[keep], what)
        return q[keep], node[keep]

    off = 0
    for s in range(len(plan.band_widths)):
        out[f"band{s}_rq"], out[f"band{s}_rnode"] = block_rows(plan.band_sw_ids[s], bh, off,
                                                               f"band{s}_sw")
        off += plan.band_starts[s].shape[0] * bh
    for b in range(len(plan.bucket_widths)):
        wids = np.asarray(plan.bucket_window_ids[b], np.int64)
        block_rows(wids, wh, off, f"bucket {b}'s windows")
        out[f"b{b}_wid"] = wids.astype(np.int32)
        out[f"b{b}_m"] = window_masks(host[f"b{b}_a"][: wids.size])
        off += host[f"b{b}_cols"].shape[0] * wh
    nodes, lens, flats = [], [], []  # the row table's rows, in population order
    for e in range(len(plan.ell_widths)):
        rows = np.asarray(plan.ell_row_ids[e], np.int64)
        claim(rows, off + np.arange(rows.size), f"ELL bucket {e}'s rows")
        cols = np.asarray(host[f"e{e}_cols"])[: rows.size]
        real = cols != c
        nodes.append(rows)
        lens.append(real.sum(1))
        flats.append(cols[real])
        off += host[f"e{e}_cols"].shape[0]
    rs = plan.num_sparse_rows
    seg, ecol = np.asarray(host["sparse_edge_seg"]), np.asarray(host["sparse_edge_col"])
    rr = np.flatnonzero(np.bincount(seg[seg < rs], minlength=rs))  # residual rows with edges
    nodes.append(np.asarray(plan.sparse_rows, np.int64)[rr])
    claim(nodes[-1], off + rr, "the residual rows")
    sel = (seg < rs) & (ecol != c)
    lens.append(np.bincount(seg[sel], minlength=rs)[rr])
    flats.append(ecol[sel])
    zero = np.flatnonzero(owner < 0)
    bad = np.flatnonzero(np.where(owner >= 0, owner, row_population_rows(plan))
                         != np.asarray(host["out_perm"]))
    if bad.size:
        v = int(bad[0])
        who = f"owned by row {owner[v]}" if owner[v] >= 0 else "owned by none"
        raise ValueError(f"out_perm disagrees with the populations' owners at node {v} ({who})")
    nodes.append(zero)
    lens.append(np.zeros(zero.size, np.int64))
    node, ln = np.concatenate(nodes), np.concatenate(lens).astype(np.int64)
    flat = np.concatenate(flats)
    if flat.size > np.iinfo(np.int32).max:
        raise ValueError(f"{flat.size} row entries: the row table takes at most 2^31 - 1")
    order = np.argsort(np.where(ln >= _ELL_SPLIT, 0, np.where(ln > _ELL_SHORT, 1, 2)),
                       kind="stable")
    start = np.cumsum(ln) - ln
    ptr = np.concatenate([[0], np.cumsum(ln[order])])
    take = np.repeat(start[order] - ptr[:-1], ln[order]) + np.arange(ptr[-1])
    n_hub = int(np.count_nonzero(ln >= _ELL_SPLIT))
    n_short = int(np.count_nonzero(ln <= _ELL_SHORT))
    out.update(rw_node=node[order].astype(np.int32), rw_ptr=ptr.astype(np.int32),
               rw_cols=flat[take].astype(np.int32),
               rows_meta=np.array([n_hub, node.size - n_hub - n_short, n_short, rr.size]))
    return out


def check_tiled_arrays(host: dict, plan) -> dict:
    """Host check of a tiled plan's pair stream before upload (the tiled
    kernel reads it unchecked): every superwindow owns a non-empty run of
    consecutive pairs (``pair_ptr``), marked first and last where the runs
    start and end and owned by it in ``tp_super``; every tile lies inside the
    padded layout; the fetch schedule is 0/1; each scalar array carries the
    plan's lookahead padding.  Returns the runs as int32 ``tp_ptr``."""
    num_sw = plan.padded_rows // plan.band_h
    ptr = np.asarray(plan.pair_ptr, dtype=np.int64)
    pairs = len(plan.pair_tile)
    if (ptr.shape != (num_sw + 1,) or ptr[0] != 0 or ptr[-1] != pairs
            or (np.diff(ptr) < 1).any() or pairs > np.iinfo(np.int32).max):
        raise ValueError(f"pair_ptr must hold {num_sw} non-empty runs of {pairs} pairs")
    keys = ("tp_tile", "tp_super", "tp_fetch", "tp_late", "tp_first", "tp_last")
    v = {k: np.asarray(host[k]) for k in keys}
    if any(a.shape != (pairs + TILED_SCALAR_PAD,) for a in v.values()):
        raise ValueError(f"tp_* must hold {pairs} pairs + {TILED_SCALAR_PAD} pad entries")
    v = {k: a[:pairs] for k, a in v.items()}
    tiles = plan.padded_rows // TILE_W
    if pairs and (v["tp_tile"].min() < 0 or v["tp_tile"].max() >= tiles):
        raise ValueError(f"tile ids must lie in [0, {tiles})")
    first, last = np.zeros(pairs, np.int64), np.zeros(pairs, np.int64)
    first[ptr[:-1]] = 1
    last[ptr[1:] - 1] = 1
    if (not np.array_equal(v["tp_super"], np.repeat(np.arange(num_sw), np.diff(ptr)))
            or not np.array_equal(v["tp_first"], first)
            or not np.array_equal(v["tp_last"], last)
            or not np.isin(v["tp_fetch"], (0, 1)).all()
            or not np.isin(v["tp_late"], (0, 1)).all()):
        raise ValueError("tp_super, tp_first, tp_last must follow pair_ptr and "
                         "tp_fetch, tp_late be 0/1")
    return {"tp_ptr": ptr.astype(np.int32)}
