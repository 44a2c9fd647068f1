"""Transposed-band SpMM: the narrow-dim (dim <= 64) path, on one H100.

Port of hcspmm_tpu/kernels/tband.py.  Activations are carried as
X^T [dt, M] (dt = feature dim padded to 16, M = plan.padded_rows) and
superwindow i computes

    Y^T[:, R:R+bh] = X^T[:, S:S+W] @ A_t[W, bh]

with A_t the plan's 0/1 block, transposed on the host and stored as the
plan's ``tband_pack`` says: int8 [Sb, W, bh] (1), nibbles [Sb, W, bh/2] (2)
or bits [Sb, W/8, bh] (8), uint8 (``expand_at`` gives the int8 block back).
The kernels read every encoding as it is stored.  The layout is closed under
chaining, and the dense update (X W)^T = W^T X^T keeps a training step
transposed end to end (ops.spmm wires that).

The band product is the CUDA kernel ``csrc/tband.cu``; the functions
``tband_spmm_direct`` and ``tband_spmm_bucket`` are its wrappers.  The same
source holds the fused aggregate and update, ``tband_fused_direct``
(agg^T = X^T A_t and out^T = W^T agg^T in one launch: the kernel-fusion mode
that ``plan.prefer_fused_kernel`` turns on; ``spmm_tband_fused_padded`` is
its layer-level entry).  Beside them sit the plain PyTorch versions (gather
+ fp32 einsum) that the tests and chip_smoke.py hold the kernels against.  A wrapper takes the plain
version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises.

The direct launch also zeroes the missing superwindows' blocks (the
reference's ``zero_lane_blocks``, folded in), and the spill chain then adds
the edges the band does not hold (``_tband_apply_spill``:
kernels/tspill.py, or the legacy path through the row layout's merge in
kernels/block_spmm.py and kernels/dstream.py).  Normalised (the plan
arrays' ``row_scale``), every one of them applies D^-1/2 as it reads and
stores: the band kernel's scaled mode, the chain's scaled forms.
``check_plan`` admits the plans the reference's ``spmm_padded_supported``
admits on this layout; the rest raise instead of losing edges.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from hcspmm_tpu_torch.kernels import block_spmm, tspill
from hcspmm_tpu_torch.kernels._build import load_library
from hcspmm_tpu_torch.utils import profiling

#: Launches of the band kernel of csrc/tband.cu (both modes), counted
#: where a wrapper launches it (never by the plain versions).  chip_smoke.py
#: zeroes it before a run of the main path and reads it after.
launches = 0

#: Launches of the fused kernel of csrc/tband.cu, of the band kernel's
#: bucket mode, and of its direct mode with missing superwindows to zero
#: (``zero_lane_blocks``, folded into the launch); the last two are also
#: counted in ``launches``.
kernel_launches = {"tband_spmm_bucket": 0, "tband_fused_direct": 0, "zero_lane_blocks": 0}

#: Launches of csrc/tband.cu's tband_kernel (band and fused forms) by the
#: A_t encoding they read (``tband_pack``: 1, 2 or 8).
pack_launches = collections.Counter()

#: The fused kernel's launches by (dt, ht), counted with
#: ``kernel_launches["tband_fused_direct"]``.
fused_shapes = collections.Counter()

#: The latest fused launch: ``fused_launch``'s sizing and ``resident``, the
#: blocks an SM the card's occupancy gave it (its grid's size).
last_fused_launch = {}

_MAX_BH = 512  # threads per block in csrc/tband.cu: one per output column
_KT = 64       # csrc/tband.cu KT: the contraction width must divide by it


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """csrc/tband.cu, built and bound."""
    lib = load_library("tband")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hcspmm_tband_spmm.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                      i64, i64, i32, vp, i32, vp, i32, i32, i32, i32, vp, vp,
                                      i64, vp]
    lib.hcspmm_tband_spmm.restype = ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.hcspmm_tband_fused.argtypes = [vp] * 7 + [i32] * 5 + [i64, i64] + [i32] * 8 + [ip, vp]
    lib.hcspmm_tband_fused.restype = ctypes.c_int
    lib.hcspmm_tband_config.argtypes = [i32] * 6 + [ip, ctypes.POINTER(i64), ip]
    lib.hcspmm_tband_config.restype = ctypes.c_int
    return lib


def launch_config(bh: int, dt: int, x_dtype, out_dtype, pack: int = 1,
                  scaled: bool = False) -> dict:
    """The band kernel's launch configuration on the current CUDA device at
    band height ``bh``, feature dim ``dt`` and A_t encoding ``pack`` (whose
    ring stage holds bh/2 bytes a row at pack 2, else bh), in its scaled
    mode where ``scaled``: its ring ``stages``, dynamic shared memory bytes
    (``smem``) and resident ``blocks_per_sm``."""
    stages, blocks, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    rc = _lib().hcspmm_tband_config(bh, dt, pack, int(x_dtype == torch.bfloat16),
                                    int(out_dtype == torch.float32), int(scaled),
                                    ctypes.byref(stages), ctypes.byref(smem),
                                    ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"csrc/tband.cu launch configuration failed: cudaError {rc}")
    return dict(stages=stages.value, smem=smem.value, blocks_per_sm=blocks.value)


# The fused kernel's forms (csrc/tband.cu tband_kernel's FUSE), the out^T
# rows a warp keeps in registers (HT_TILE), and the shared memory beside the
# ring and the sums: the swizzle atom's alignment slack and the mbarriers.
FUSE_SLAB, FUSE_WHOLE, FUSE_ONE = 1, 2, 3
_HT_TILE = 32
_FIXED_SMEM = 1024 + 128
_MAX_STAGES = 6


def fused_launch(bh: int, dt: int, ht: int, x_elt: int, per_sm: int, reserved: int,
                 optin: int, pack: int = 1) -> dict:
    """The fused kernel's form and ring at band height ``bh``, feature dim
    ``dt``, out^T rows ``ht``, X's element bytes ``x_elt`` and A_t encoding
    ``pack`` on a device with ``per_sm`` bytes of shared memory an SM,
    ``reserved`` of them taken per block and at most ``optin`` for one block
    (an H100: 233472, 1024, 232448).

    A stage holds the 64-row A_t slab as stored ([64, bh/2] bytes at pack
    2, else [64, bh]) and X^T's slab [DT, 64] (DT = 32 where dt allows, else
    16).  The ``form``:

    - FUSE_SLAB keeps each warp's sums of one slab ([bh][DT + 1] fp32) and
      out^T tiles of 32 rows in registers: the form wherever ht <= 32, and
      the fallback, in ``htiles`` passes over the band, where neither other
      form fits; FUSE_ONE is its case of one slab (dt = DT), whose tile lives
      only at the slab's end.  Both stage W^T in shared memory (``wsm`` = 32
      * htiles rows of it, fp32) where it fits beside two blocks an SM, else
      read it through L1 (``wsm`` 0).
    - FUSE_WHOLE keeps the entry's whole aggregate ([bh][dt + 1] fp32) and
      multiplies it at the entry's end, its warps splitting out^T by rows:
      the form for ht > 32 where two stages of it fit one block, one block
      an SM.

    ``stages`` (2-6) is as many as leave ``blocks_per_sm`` blocks an SM (the
    register forms: two where two stages allow, else one); ``smem`` is the
    block's dynamic shared memory.  Raises ValueError where not even two
    stages fit one block."""
    if dt <= 0 or dt % 16 or ht <= 0 or ht % 16 or bh <= 0 or bh % 32 or bh > _MAX_BH:
        raise ValueError(f"dt={dt}, ht={ht}, bh={bh}: dt and ht multiples of 16, bh a "
                         f"multiple of 32 up to {_MAX_BH}")
    slab = 32 if dt % 32 == 0 else 16
    stage = _KT * a_row_bytes(bh, pack) + _KT * slab * x_elt

    def sized(stride, extra=0, blocks_options=(2, 1)):
        fixed = _FIXED_SMEM + bh * stride * 4 + extra
        rooms = {2: per_sm // 2 - reserved, 1: min(optin, per_sm - reserved)}
        for blocks in blocks_options:
            fit = (rooms[blocks] - fixed) // stage
            if fit >= 2:
                stages = min(fit, _MAX_STAGES)
                return dict(stages=stages, smem=fixed + stages * stage, blocks_per_sm=blocks)
        return None

    # one block an SM: its 17 warps' registers leave no room for a second
    whole = sized(dt + 1, blocks_options=(1,)) if ht > _HT_TILE else None
    if whole is not None:
        return dict(form=FUSE_WHOLE, htiles=1, slab=slab, wsm=0, **whole)
    htiles = -(-ht // _HT_TILE)
    form = FUSE_ONE if dt == slab and ht <= _HT_TILE else FUSE_SLAB
    wsm = _HT_TILE * htiles
    cfg = sized(slab + 1, wsm * dt * 4, (2,))  # W^T in shared memory, two blocks an SM
    if cfg is None:
        wsm, cfg = 0, sized(slab + 1)
    if cfg is None:
        raise ValueError(f"bh={bh}: two ring stages of {stage} bytes and the sums take more "
                         f"shared memory than a block's {optin}")
    return dict(form=form, htiles=htiles, slab=slab, wsm=wsm, **cfg)


def a_row_bytes(bh: int, pack: int) -> int:
    """Bytes of a stored A_t row at band height ``bh``: bh/2 at pack 2,
    else bh (csrc/tband.cu a_row_bytes)."""
    return bh // 2 if pack == 2 else bh


def logical_wh(at, pack: int) -> tuple:
    """(W, bh) of the 0/1 blocks that ``at`` stores in encoding ``pack``
    (the reference's _logical_wh, hcspmm_tpu/kernels/tband.py:171)."""
    _, ws, bhs = at.shape
    if pack == 2:
        return ws, bhs * 2
    if pack == 8:
        return ws * 8, bhs
    return ws, bhs


def expand_at(at, pack: int):
    """The int8 0/1 blocks [Sb, W, bh] that ``at`` stores in encoding
    ``pack`` (the reference's _expand_a, hcspmm_tpu/kernels/tband.py:84):
    pack 1 is the block itself; pack 2, uint8 [Sb, W, bh/2], holds column j
    in the low nibble of byte j and column j + bh/2 in its high nibble; pack
    8, uint8 [Sb, W/8, bh], holds row g*(W/8) + r in bit g of byte row r."""
    if pack == 1:
        return at
    if pack == 2:
        return torch.cat([at & 15, at >> 4], dim=2).to(torch.int8)
    if pack == 8:
        return torch.cat([(at >> g) & 1 for g in range(8)], dim=1).to(torch.int8)
    raise ValueError(f"pack={pack}: 1, 2 or 8")


def check_plan(plan) -> None:
    """Raise NotImplementedError unless ``plan`` runs here with no edge
    dropped: a square tband plan (A_t in any of the three encodings),
    band and spill populations only, every superwindow either covered by
    one band entry or listed as missing (its block is zeroed and its edges
    spill), band slices inside the padded layout, and a spill population
    (if any) on the lane path, the legacy row merge or the take path.  These
    are the plans the reference's ``spmm_padded_supported`` admits on this
    layout."""
    if not getattr(plan, "tband", False):
        raise NotImplementedError(
            "not a band_impl='tband' plan: the wide padded layout or the row "
            "layout runs it (kernels/block_spmm.py)")
    if plan.dense_nnz or plan.sparse_nnz:
        raise NotImplementedError(
            "tband plans carry band and spill populations only "
            f"(dense_nnz={plan.dense_nnz}, sparse_nnz={plan.sparse_nnz})")
    if not plan.band_widths or plan.num_cols != plan.num_nodes:
        raise NotImplementedError(
            "the transposed padded layout needs a square plan with band "
            "buckets; shard plans build band_impl='wide' and run in the row "
            "layout (parallel.dist_spmm)")
    m = plan.padded_rows
    num_sw = m // plan.band_h
    covered = sum(len(s) for s in plan.band_sw_ids)
    missing = len(plan.band_missing_sw)
    if covered + missing != num_sw:
        raise NotImplementedError(
            f"band entries cover {covered} and {missing} are missing of "
            f"{num_sw} superwindows: a plan whose blocks do not all have "
            "one owner would leave output unset")
    for s, w in enumerate(plan.band_widths):
        st = plan.band_starts[s][: len(plan.band_sw_ids[s])]
        if (len(st) and int(st.max()) + w > m) or (
                len(plan.band_starts[s]) > len(st) and w > m):
            raise NotImplementedError(
                f"bucket {s}: band slices of width {w} leave the padded "
                f"layout of {m} lanes")
    if plan.band_h > _MAX_BH or plan.band_h % 32:
        raise NotImplementedError(
            f"band_h={plan.band_h}: csrc/tband.cu takes a multiple of 32 "
            f"up to {_MAX_BH}")


def check_band_arrays(starts: np.ndarray, sw_ids: np.ndarray, w: int, m: int,
                      num_sw: int) -> None:
    """Host check of one bucket's entries before upload: the kernel reads
    X^T[:, st : st+W] unchecked, so every slice must lie inside [0, M)."""
    st = np.asarray(starts, dtype=np.int64)
    sw = np.asarray(sw_ids, dtype=np.int64)
    if w % _KT:
        raise ValueError(f"band width {w} is not a multiple of {_KT}")
    if len(st) and ((st % 128).any() or st.min() < 0 or st.max() + w > m):
        raise ValueError(f"band starts must be 128-aligned with st + {w} <= {m}")
    if len(sw) != len(st) or (len(sw) and (sw.min() < 0 or sw.max() > num_sw)):
        raise ValueError(f"superwindow ids must lie in [0, {num_sw}]")


# ---------------------------------------------------------------------------
# plain PyTorch versions (tests, CPU tensors, and the kernel's check)
# ---------------------------------------------------------------------------


def tband_spmm_bucket_plain(starts, at, xt, pack=1, scale=None, sw_ids=None):
    """fp32 [dt, Sb*bh]: block i = X^T[:, st[i] : st[i]+W] @ A_t[i], A_t
    expanded from encoding ``pack`` first (``expand_at``).  With ``scale``
    (fp32 [M] over xt's lanes): the slice's columns times their scales, and
    column c of block i times ``scale[sw_ids[i] * bh + c]``
    (``block_spmm.block_row_scale``: 0 past the scale)."""
    at = expand_at(at, pack)
    sb, w, bh = at.shape
    cols = starts.long()[:, None] + torch.arange(w, device=xt.device)
    xg = xt[:, cols].float()                               # [dt, Sb, W]
    if scale is not None:
        xg = xg * scale[cols]
    out = torch.einsum("dsw,swb->dsb", xg, at.float())     # [dt, Sb, bh]
    if scale is not None:
        out = out * block_spmm.block_row_scale(scale, sw_ids, bh)
    return out.reshape(xt.shape[0], sb * bh)


def tband_spmm_direct_plain(sw_ids, starts, at, xt, num_sw, out_dtype, missing8=None,
                            missing=None, pack=1, scale=None):
    """[dt, num_sw*bh] ``out_dtype``: block sw[i] = X^T slice @ A_t[i] (A_t
    in encoding ``pack``; with ``scale``, as ``tband_spmm_bucket_plain``
    scales it); entries with sw == num_sw are dropped; the blocks
    of ``missing8`` (runs of eight superwindows) and ``missing`` are zeroed
    (``tspill.zero_lane_blocks_plain``); other unowned blocks stay unset."""
    sb = at.shape[0]
    bh = logical_wh(at, pack)[1]
    dt = xt.shape[0]
    part = tband_spmm_bucket_plain(starts, at, xt, pack, scale, sw_ids).view(dt, sb, bh)
    out = torch.empty((dt, num_sw * bh), dtype=out_dtype, device=xt.device)
    keep = sw_ids < num_sw
    out.view(dt, num_sw, bh)[:, sw_ids[keep].long()] = part[:, keep].to(out_dtype)
    for ids, w in ((missing8, 8 * bh), (missing, bh)):
        if ids is not None and ids.shape[0]:
            tspill.zero_lane_blocks_plain(out, ids, w)
    return out


def tband_fused_direct_plain(sw_ids, starts, at, xt, wt, num_sw, out_dtype, pack=1):
    """(agg^T [dt, num_sw*bh], out^T [ht, num_sw*bh]) ``out_dtype``: agg^T as
    ``tband_spmm_direct_plain``, out^T = wt @ agg^T rounded to wt's dtype,
    in fp32."""
    sb = at.shape[0]
    bh = logical_wh(at, pack)[1]
    part = tband_spmm_bucket_plain(starts, at, xt, pack)
    prod = torch.matmul(wt.float(), part.to(wt.dtype).float())
    keep = sw_ids < num_sw
    idx = sw_ids[keep].long()
    outs = []
    for v in (part, prod):
        o = torch.empty((v.shape[0], num_sw * bh), dtype=out_dtype, device=xt.device)
        o.view(v.shape[0], num_sw, bh)[:, idx] = v.view(v.shape[0], sb, bh)[:, keep].to(out_dtype)
        outs.append(o)
    return tuple(outs)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda_args(starts, sw_ids, at, xt, pack):
    """Raise unless the kernel takes these arguments; returns the logical
    (W, bh) of ``at``, stored in encoding ``pack``."""
    dev = xt.device
    if dev.type != "cuda":
        raise ValueError(f"xt lies on {dev}: the band kernel takes CUDA or "
                         "CPU tensors")
    named = {"starts": starts, "at": at, "xt": xt}
    if sw_ids is not None:
        named["sw_ids"] = sw_ids
    for name, t in named.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    if xt.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"xt dtype {xt.dtype}: float32 or bfloat16 only")
    want = torch.int8 if pack == 1 else torch.uint8
    if pack not in (1, 2, 8) or at.dtype != want or at.dim() != 3:
        raise ValueError(f"pack={pack}: at must be 3-D {want} (pack 1, 2 or 8: see expand_at)")
    sb = at.shape[0]
    w, bh = logical_wh(at, pack)
    dt, m = xt.shape
    for name, t in (("starts", starts), ("sw_ids", sw_ids)):
        if t is not None and (t.dtype != torch.int32 or tuple(t.shape) != (sb,)):
            raise ValueError(f"{name} must be int32 [{sb}]")
    if dt % 16 or w % _KT or w > m or bh % 32 or bh > _MAX_BH:
        raise ValueError(f"unsupported shape: dt={dt} W={w} bh={bh} M={m}")
    return w, bh


def _launch(starts, sw_ids, at, xt, out, num_sw, w, bh, pack, missing8=None, missing=None,
            scale=None, ssw=None):
    global launches
    sb = at.shape[0]
    dt, m = xt.shape
    if (at.data_ptr() % 16 or xt.data_ptr() % 16 or m * xt.element_size() % 16
            or (scale is not None and scale.data_ptr() % 16)):
        raise ValueError("the band kernel's bulk copies need at, xt and scale 16-byte aligned "
                         f"and xt's rows a multiple of 16 bytes (M={m})")
    ids = [v if v is not None and v.shape[0] else None for v in (missing8, missing)]
    for name, v in zip(("missing8", "missing"), ids):
        if v is not None and (v.device != xt.device or v.dtype != torch.int32
                              or not v.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 on {xt.device}")
    if scale is not None:
        block_spmm._check_scale(scale, ssw, m, xt.device, sb)
    with torch.cuda.device(xt.device):
        rc = _lib().hcspmm_tband_spmm(
            starts.data_ptr(), None if sw_ids is None else sw_ids.data_ptr(),
            at.data_ptr(), xt.data_ptr(), out.data_ptr(), sb, w, bh, dt, m,
            out.shape[1], num_sw, *[x for v in ids for x in (
                None if v is None else v.data_ptr(), 0 if v is None else v.shape[0])],
            pack, int(xt.dtype == torch.bfloat16), int(out.dtype == torch.float32),
            None if scale is None else scale.data_ptr(),
            None if scale is None else ssw.data_ptr(), 0 if scale is None else m,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csrc/tband.cu launch failed: cudaError {rc}")
    launches += 1
    pack_launches[pack] += 1
    if any(v is not None for v in ids):
        kernel_launches["zero_lane_blocks"] += 1


def tband_spmm_direct(sw_ids, starts, at, xt, num_sw, out_dtype, missing8=None,
                      missing=None, pack=1, scale=None):
    """Transposed-band SpMM, direct write: entry i computes superwindow
    ``sw_ids[i]``'s output columns (port of the Pallas kernel at
    hcspmm_tpu/kernels/tband.py:189), and the blocks of the missing
    superwindows are zeroed in the same launch (the reference's
    ``zero_lane_blocks`` after it, hcspmm_tpu/kernels/tspill.py:55).

    starts, sw_ids: int32 [Sb]; at: the 0/1 blocks [Sb, W, bh] in encoding
    ``pack`` (int8 at 1; uint8 [Sb, W, bh/2] at 2, [Sb, W/8, bh] at 8: see
    ``expand_at``); xt: [dt, M] float32
    or bfloat16; missing8, missing: int32 ids of aligned runs of eight
    superwindows and of single ones (a plan's ``band_missing_sw8`` and
    ``band_missing_sw``, checked at upload), or None.  Returns [dt,
    num_sw*bh] in ``out_dtype`` (xt's dtype or float32).  Entries with
    ``sw_id == num_sw`` write nothing, and blocks neither an entry nor a
    missing id names are left unset: callers guarantee full cover.
    ``scale`` (fp32 [M], a diagonal D over xt's lanes and the output's):
    the product of X^T D, each output lane times its scale (the kernel's
    scaled mode: X^T's values scaled as they are read, the sums at their
    store); the missing blocks stay zero."""
    if xt.device.type == "cpu":
        return tband_spmm_direct_plain(sw_ids, starts, at, xt, num_sw, out_dtype, missing8,
                                       missing, pack, scale)
    w, bh = _check_cuda_args(starts, sw_ids, at, xt, pack)
    if out_dtype not in (xt.dtype, torch.float32):
        raise ValueError(f"out_dtype {out_dtype}: xt's dtype or float32")
    out = torch.empty((xt.shape[0], num_sw * bh), dtype=out_dtype, device=xt.device)
    _launch(starts, sw_ids, at, xt, out, num_sw, w, bh, pack, missing8, missing, scale, sw_ids)
    return out


def tband_spmm_bucket(starts, at, xt, pack=1, scale=None, sw_ids=None):
    """Bucket-order form for secondary buckets (port of
    hcspmm_tpu/kernels/tband.py:228): fp32 [dt, Sb*bh], block i from entry
    i; the caller scatters the blocks.  ``at`` as ``tband_spmm_direct``'s.
    ``scale`` as ``tband_spmm_direct``'s, with ``sw_ids`` (int32 [Sb])
    naming the superwindow whose lanes' scales block i takes (0 past M: the
    capacity padding)."""
    if xt.device.type == "cpu":
        return tband_spmm_bucket_plain(starts, at, xt, pack, scale, sw_ids)
    w, bh = _check_cuda_args(starts, None, at, xt, pack)
    out = torch.empty((xt.shape[0], at.shape[0] * bh), dtype=torch.float32, device=xt.device)
    _launch(starts, None, at, xt, out, 0, w, bh, pack, scale=scale, ssw=sw_ids)
    kernel_launches["tband_spmm_bucket"] += 1
    return out


def tband_fused_direct(sw_ids, starts, at, xt, wt, num_sw, out_dtype, pack=1):
    """Fused transposed aggregate and update, direct write (port of the
    Pallas kernel at hcspmm_tpu/kernels/tband.py:277): entry i computes
    superwindow ``sw_ids[i]``'s ``agg^T = X^T[:, st:st+W] @ A_t[i]`` (fp32
    sums) and ``out^T = wt @ agg^T.astype(wt.dtype)`` (fp32 sums).

    ``at`` as ``tband_spmm_direct``'s, in encoding ``pack``; wt: [ht, dt] in
    xt's dtype (ht a multiple of 16).  Returns (agg^T
    [dt, num_sw*bh], out^T [ht, num_sw*bh]) in ``out_dtype`` (xt's dtype or
    float32); entries with ``sw_id == num_sw`` write nothing and unowned
    blocks stay unset.  Every dt and ht runs, in the form ``fused_launch``
    picks: the band kernel's ring walks the entry's feature slabs in order
    and each warp adds its columns' share of the update."""
    if xt.device.type == "cpu":
        return tband_fused_direct_plain(sw_ids, starts, at, xt, wt, num_sw, out_dtype, pack)
    w, bh = _check_cuda_args(starts, sw_ids, at, xt, pack)
    dt, m = xt.shape
    sb = at.shape[0]
    if (wt.device != xt.device or not wt.is_contiguous() or wt.dtype != xt.dtype
            or wt.dim() != 2 or wt.shape[1] != dt or wt.shape[0] % 16):
        raise ValueError(f"wt must be contiguous {xt.dtype} [ht, {dt}], ht a multiple of 16")
    if out_dtype not in (xt.dtype, torch.float32):
        raise ValueError(f"out_dtype {out_dtype}: xt's dtype or float32")
    ht = wt.shape[0]
    if at.data_ptr() % 16 or xt.data_ptr() % 16 or m * xt.element_size() % 16:
        raise ValueError("the fused kernel's bulk copies need at and xt 16-byte aligned and "
                         f"xt's rows a multiple of 16 bytes (M={m})")
    if wt.data_ptr() % 16:  # its vector loads: a fresh (aligned) copy of a view's storage
        wt = wt.clone()
    agg = torch.empty((dt, num_sw * bh), dtype=out_dtype, device=xt.device)
    out = torch.empty((ht, num_sw * bh), dtype=out_dtype, device=xt.device)
    resident = ctypes.c_int()
    with torch.cuda.device(xt.device):
        cfg = fused_launch(bh, dt, ht, xt.element_size(),
                           *block_spmm.band_device(xt.device.index)[1:], pack)
        rc = _lib().hcspmm_tband_fused(
            starts.data_ptr(), sw_ids.data_ptr(), at.data_ptr(), xt.data_ptr(), wt.data_ptr(),
            agg.data_ptr(), out.data_ptr(), sb, w, bh, dt, ht, m, num_sw * bh, num_sw,
            cfg["form"], cfg["htiles"], cfg["stages"], cfg["wsm"], pack,
            int(xt.dtype == torch.bfloat16),
            int(out_dtype == torch.float32), ctypes.byref(resident),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csrc/tband.cu fused tband_kernel launch failed: cudaError {rc}")
    last_fused_launch.clear()
    last_fused_launch.update(cfg, resident=resident.value)
    kernel_launches["tband_fused_direct"] += 1
    pack_launches[pack] += 1
    fused_shapes[(dt, ht)] += 1
    return agg, out


# ---------------------------------------------------------------------------
# full transposed SpMM over the [dt, M] layout (+ glue for [N, d] callers)
# ---------------------------------------------------------------------------


# Spill population size above which the legacy row-layout spill path pads
# its [M, dt] operands to 128 columns, unless the padded table would exceed
# the size limit below (the reference's constants, measured on a TPU;
# hcspmm_tpu/kernels/tband.py:339-340).
_SPILL_WIDE_MIN_EDGES = 100_000
_SPILL_WIDE_MAX_TABLE_MB = 256.0


def _row_spill(buf, arrs, xt, plan, scale=None):
    """The legacy spill path (``spill_lane='off'``, or ``spill_impl=
    'take'``; hcspmm_tpu/kernels/tband.py:391-406): both operands go to the
    row layout [M, dt] (padded to 128 columns for large spills), the row
    layout's ``apply_spill`` adds the population (the row merge when the
    plan carries its streams, else the take path; ``scale``, over the M
    lanes that are its rows, in their scaled forms), and the result comes
    back transposed."""
    dt, m = buf.shape
    tbl_mb = m * 128 * xt.element_size() / 1e6
    wide = (plan.spill_nnz >= _SPILL_WIDE_MIN_EDGES and dt < 128
            and tbl_mb <= _SPILL_WIDE_MAX_TABLE_MB)
    pad = (0, 128 - dt) if wide else (0, 0)
    with profiling.span("spmm.spill.rows"):  # the relayouts too
        out_u = F.pad(buf.T, pad).contiguous()
        x_u = F.pad(xt.T, pad).contiguous()
        out_u = block_spmm.apply_spill(out_u, arrs, x_u, plan, scale)
        return out_u[:, :dt].T.contiguous()


def _tband_apply_spill(buf, arrs, xt, plan, scale=None):
    """Add the spill population onto ``buf`` (port of
    hcspmm_tpu/kernels/tband.py:343).  Lane path (``ds_tlocal`` present, in
    place): the hub stream first (mxgather hub table, then the merge
    gathering from it through ``ds_h_laneg``), then the cold stream, merged
    straight from the mxgather T1 table (``ts_lo``) or from xt itself
    through ``ds_lsrc``, the per-slot column composed at upload from the T2
    tables or the plan's one take (``tspill.check_spill_arrays``): no
    gathered copy is made.  Otherwise the legacy row-layout path.

    ``scale`` (fp32 [M]): the spill of D A D xt onto a ``buf`` that holds
    the scaled band part: the gathers scale each value by its source lane's
    scale, the merges add each lane's sum times its own (and, merging from
    xt itself, scale each slot by its column's); the legacy path takes the
    row layout's scaled forms."""
    if not (plan.has_spill and "spill_rows" in arrs):
        return buf
    if "ds_tlocal" not in arrs:
        return _row_spill(buf, arrs, xt, plan, scale)
    profiling.count("spmm.spill_edges", plan.spill_nnz)
    if "hub_lo" in arrs:
        with profiling.span("spmm.spill.hub"):
            h = tspill.mxgather_lanes(xt, arrs["hub_lo"], arrs["hub_rel"], span=plan.ts_span,
                                      scale=scale)
            buf = tspill.tbstream_merge(h, arrs["ds_h_tlocal"], arrs["ds_h_lblk"], buf,
                                        group=plan.ds_hgroup, gidx=arrs["ds_h_laneg"],
                                        segs=tspill.segments_of(arrs, "ds_h_lseg"),
                                        rscale=scale)
    with profiling.span("spmm.spill.cold"):
        cscale = None
        if "ts_lo" in arrs:
            src = tspill.mxgather_lanes(xt, arrs["ts_lo"], arrs["ts_rel"], span=plan.ts_span,
                                        scale=scale)
        else:
            src, cscale = xt, scale
        return tspill.tbstream_merge(src, arrs["ds_tlocal"], arrs["ds_lblk"], buf,
                                     group=plan.ds_lgroup, gidx=arrs["ds_lsrc"],
                                     segs=tspill.segments_of(arrs, "ds_lseg"), rscale=scale,
                                     cscale=cscale)


def spmm_tband_padded(arrs, xt, plan, compute_dtype):
    """SpMM over the transposed padded layout: xt [dt, M] -> [dt, M]
    (M = plan.padded_rows).  The most populated bucket writes the whole
    buffer directly and, in the same launch, zeroes the missing
    superwindows' blocks; each other bucket's blocks are scattered over the
    blocks it owns (unset by the direct write); the spill population is
    added last.  With no band
    entry at all the buffer starts as zeros.

    ``arrs["row_scale"]``, where present (fp32 [M], a diagonal D with 1 on
    the pad lanes), computes D A D xt: the band kernel's scaled mode and the
    spill chain's scaled forms apply D as they read and store, with no pass
    over [dt, M] of their own; counted in ``spmm.scale_folded``.  As in
    ``block_spmm.spmm_wide_padded``, D travels in a copy of the static plan
    arrays (``ops.spmm.TbandLayout`` builds it once), because this
    4-argument signature is the one ``benchmark/tests/test_bench_faults.py``
    patches; any plan dict that carries ``row_scale`` is a scaled SpMM."""
    check_plan(plan)
    xt = xt.to(compute_dtype).contiguous()
    dt, m = xt.shape
    if m != plan.padded_rows:
        raise ValueError(f"xt has {m} lanes, the plan's layout {plan.padded_rows}")
    scale = arrs.get("row_scale")
    if scale is not None:
        profiling.count("spmm.scale_folded")
    bh = plan.band_h
    num_sw = m // bh
    nonempty = [i for i in range(len(plan.band_widths))
                if arrs[f"band{i}_start"].shape[0] > 0]
    with profiling.span("spmm.band"):
        if not nonempty:
            buf = torch.zeros((dt, m), dtype=xt.dtype, device=xt.device)
        else:
            s_main = max(nonempty, key=lambda i: len(plan.band_sw_ids[i]))
            # the uncovered superwindows (their edges ride the spill) are
            # zeroed by the same launch: aligned runs of eight, then the rest
            pack = plan.tband_pack
            buf = tband_spmm_direct(arrs[f"band{s_main}_sw"], arrs[f"band{s_main}_start"],
                                    arrs[f"band{s_main}_at"], xt, num_sw, xt.dtype,
                                    arrs.get("band_missing_sw8"), arrs.get("band_missing_sw"),
                                    pack, scale)
            b3 = buf.view(dt, num_sw, bh)
            for i in nonempty:
                if i == s_main:
                    continue
                part = tband_spmm_bucket(arrs[f"band{i}_start"], arrs[f"band{i}_at"], xt, pack,
                                         scale, arrs[f"band{i}_sw"])
                real = len(plan.band_sw_ids[i])  # capacity padding trails the real entries
                b3.index_copy_(1, arrs[f"band{i}_sw"][:real].long(),
                               part.view(dt, -1, bh)[:, :real].to(buf.dtype))
    return _tband_apply_spill(buf, arrs, xt, plan, scale)


def spmm_tband_fused_padded(arrs, xt, wt, plan):
    """Fused ``(out^T = wt (A X)^T, agg^T = (A X)^T)`` in the transposed
    padded layout (port of hcspmm_tpu/kernels/tband.py:483): xt [dt, M], wt
    [ht, dt] -> ([ht, M], [dt, M]) in xt's dtype.  None, for the caller to
    compose, where the plan spills or its one non-empty bucket does not own
    every superwindow, as the reference returns None."""
    if plan.has_spill:
        return None
    num_sw = plan.padded_rows // plan.band_h
    s = block_spmm.single_full_bucket(arrs, plan, num_sw)
    if s is None:
        return None
    xt = xt.contiguous()
    agg, out = tband_fused_direct(arrs[f"band{s}_sw"], arrs[f"band{s}_start"],
                                  arrs[f"band{s}_at"], xt, wt.to(xt.dtype).contiguous(),
                                  num_sw, xt.dtype, plan.tband_pack)
    return out, agg


def sublane_pad(d: int) -> int:
    """Feature dim padded to the transposed layout's 16-row granule."""
    return max(16, -(-d // 16) * 16)


def spmm_tband(arrs, x, plan, compute_dtype):
    """[N, d] -> [N, d] glue around the transposed padded core (one
    transpose in, one out; padded callers chain spmm_tband_padded)."""
    n, d = plan.num_nodes, x.shape[1]
    xt = torch.zeros((sublane_pad(d), plan.padded_rows), dtype=compute_dtype,
                     device=x.device)
    xt[:d, : x.shape[0]] = x.T.to(compute_dtype)
    out = spmm_tband_padded(arrs, xt, plan, compute_dtype)
    return out[:d, :n].T.to(x.dtype)
