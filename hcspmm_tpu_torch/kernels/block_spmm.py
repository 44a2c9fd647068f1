"""Band SpMM over the wide padded layout [M, dp], on one H100.

Port of the wide band path of hcspmm_tpu/kernels/block_spmm.py.
Activations are row-major ``[M, dp]`` (M = plan.padded_rows, dp the
feature dim rounded up to 128; rows past num_nodes and columns past the
feature dim are zero), and superwindow i computes

    out[R : R+bh] = A[i] [bh, Bb] @ xp[st : st+Bb]

with A the plan's int8 0/1 block and st a 16-aligned start clamped into M
at plan build.  The layout is closed under chaining: a GNN layer's dense
update is ``xp @ pad(W)`` and the next SpMM reads its output unchanged.

The band product is the CUDA kernel ``csrc/block_spmm.cu``;
``band_bucket_spmm_direct`` (direct write) and ``band_bucket_spmm``
(fp32, bucket order) are its wrappers and ``band_direct_dispatch`` the
reference's bucket-keyed entry.  Beside them sit the plain PyTorch
versions (gather + fp32 einsum) that the tests and chip_smoke.py hold the
kernel against.  A wrapper takes the plain version only for tensors on the
CPU; for a CUDA tensor it launches the kernel or raises.

``spmm_wide_padded`` is one SpMM (the reference's ``spmm_pallas_padded``):
the main bucket's direct write, the other buckets' blocks scattered over
theirs, the missing superwindows zeroed (``tspill.zero_row_blocks``), and
the spill population added by ``apply_spill`` (``dstream.dstream_spill``,
or the take path).  ``check_plan`` admits exactly the plans the
reference's ``spmm_padded_supported`` admits on this layout; the rest raise
instead of losing edges.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from hcspmm_tpu_torch.kernels import dstream, tspill
from hcspmm_tpu_torch.kernels._build import load_library

#: Launches of the CUDA kernel of csrc/block_spmm.cu, counted where a
#: wrapper launches it (never by the plain versions).  chip_smoke.py
#: zeroes it before a run of the main path and reads it after.
launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("block_spmm")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hcspmm_band_spmm.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.hcspmm_band_spmm.restype = ctypes.c_int
    return lib


def lane_pad(d: int) -> int:
    """Feature dim padded to the wide layout's 128 columns."""
    return max(128, -(-d // 128) * 128)


def check_plan(plan) -> None:
    """Raise NotImplementedError unless ``plan`` runs on the wide padded
    layout with no edge dropped: a square plan with band buckets and
    band and spill populations only, every superwindow either covered by
    one band entry or listed as missing (its block is zeroed and its edges
    spill), and band slices inside the padded layout.  These are the plans
    the reference's ``spmm_padded_supported`` admits here."""
    if getattr(plan, "tiled", False):
        raise NotImplementedError(
            "band_impl='tiled': the tiled band kernel (hcspmm_tpu/kernels/"
            "block_spmm.py:band_tiled_spmm) is ROADMAP A.11")
    if plan.dense_nnz or plan.sparse_nnz:
        raise NotImplementedError(
            "the dense and sparse row-merge populations (dense_nnz="
            f"{plan.dense_nnz}, sparse_nnz={plan.sparse_nnz}) and their "
            "out_perm merge are the row layout, ROADMAP A.7")
    if not plan.band_widths or plan.num_cols != plan.num_nodes:
        raise NotImplementedError(
            "the wide padded layout needs a square plan with band buckets; "
            "other plans run in the row layout (ROADMAP A.7) or are "
            "row-partitioned (A.10)")
    m = plan.padded_rows
    num_sw = m // plan.band_h
    covered = sum(len(s) for s in plan.band_sw_ids)
    missing = len(plan.band_missing_sw)
    if covered + missing != num_sw:
        raise NotImplementedError(
            f"band entries cover {covered} and {missing} are missing of "
            f"{num_sw} superwindows: a plan whose blocks do not all have "
            "one owner would leave output unset (ROADMAP A.7)")
    for s, w in enumerate(plan.band_widths):
        st = plan.band_starts[s][: len(plan.band_sw_ids[s])]
        if (len(st) and int(st.max()) + w > m) or (
                len(plan.band_starts[s]) > len(st) and w > m):
            raise NotImplementedError(
                f"bucket {s}: band slices of width {w} leave the padded "
                f"layout of {m} rows (ROADMAP A.7)")


def check_band_arrays(starts: np.ndarray, sw_ids: np.ndarray, w: int, m: int,
                      num_sw: int) -> None:
    """Host check of one bucket's entries before upload: the kernel reads
    xp[st : st+Bb] unchecked, so every slice (capacity padding included:
    bucket mode computes it) must lie inside [0, M)."""
    st = np.asarray(starts, dtype=np.int64)
    sw = np.asarray(sw_ids, dtype=np.int64)
    if w % 4:
        raise ValueError(f"band width {w} is not a multiple of 4")
    if len(st) and ((st % 16).any() or st.min() < 0 or st.max() + w > m):
        raise ValueError(f"band starts must be 16-aligned with st + {w} <= {m}")
    if len(sw) != len(st) or (len(sw) and (sw.min() < 0 or sw.max() > num_sw)):
        raise ValueError(f"superwindow ids must lie in [0, {num_sw}]")


# ---------------------------------------------------------------------------
# plain PyTorch versions (tests, CPU tensors, and the kernel's check)
# ---------------------------------------------------------------------------


def band_bucket_spmm_plain(starts, a, xp):
    """fp32 [Sb, bh, dp]: block i = A[i] @ xp[st[i] : st[i]+Bb]."""
    bb = a.shape[2]
    rows = starts.long()[:, None] + torch.arange(bb, device=xp.device)
    return torch.einsum("sbk,skd->sbd", a.float(), xp[rows].float())


def band_bucket_spmm_direct_plain(sw_ids, starts, a, xp, num_sw, out_dtype):
    """[num_sw, bh, dp] ``out_dtype``: block sw[i] = A[i] @ xp slice;
    entries with sw == num_sw are dropped, unowned blocks stay unset."""
    part = band_bucket_spmm_plain(starts, a, xp)
    out = torch.empty((num_sw,) + part.shape[1:], dtype=out_dtype, device=xp.device)
    keep = sw_ids < num_sw
    out[sw_ids[keep].long()] = part[keep].to(out_dtype)
    return out


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
    if a.dtype != torch.int8 or a.dim() != 3:
        raise ValueError("a must be int8 [Sb, bh, Bb]")
    sb, bh, bb = a.shape
    m, dp = xp.shape
    for name, t in (("starts", starts), ("sw_ids", sw_ids)):
        if t is not None and (t.dtype != torch.int32 or tuple(t.shape) != (sb,)):
            raise ValueError(f"{name} must be int32 [{sb}]")
    if dp % 128 or bb % 4 or bb > m:
        raise ValueError(f"unsupported shape: dp={dp} Bb={bb} bh={bh} M={m}")


def _launch(starts, sw_ids, a, xp, out, num_sw):
    global launches
    sb, bh, bb = a.shape
    with torch.cuda.device(xp.device):
        rc = _lib().hcspmm_band_spmm(
            starts.data_ptr(), None if sw_ids is None else sw_ids.data_ptr(), a.data_ptr(),
            xp.data_ptr(), out.data_ptr(), sb, bh, bb, xp.shape[1], num_sw,
            int(xp.dtype == torch.bfloat16), int(out.dtype == torch.float32),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csrc/block_spmm.cu launch failed: cudaError {rc}")
    launches += 1


def band_bucket_spmm_direct(sw_ids, starts, a, xp, num_sw, out_dtype):
    """Row-layout band SpMM, direct write: entry i computes superwindow
    ``sw_ids[i]``'s output rows (port of the Pallas kernel at
    hcspmm_tpu/kernels/block_spmm.py:424).

    starts, sw_ids: int32 [Sb]; a: int8 [Sb, bh, Bb]; xp: [M, dp] float32
    or bfloat16.  Returns [num_sw, bh, dp] in ``out_dtype`` (xp's dtype or
    float32).  Entries with ``sw_id == num_sw`` write nothing, and blocks no
    entry owns are left unset: callers zero or overwrite them."""
    if xp.device.type == "cpu":
        return band_bucket_spmm_direct_plain(sw_ids, starts, a, xp, num_sw, out_dtype)
    _check_cuda_args(starts, sw_ids, a, xp)
    if out_dtype not in (xp.dtype, torch.float32):
        raise ValueError(f"out_dtype {out_dtype}: xp's dtype or float32")
    out = torch.empty((num_sw, a.shape[1], xp.shape[1]), dtype=out_dtype, device=xp.device)
    _launch(starts, sw_ids, a, xp, out, num_sw)
    return out


def band_bucket_spmm(starts, a, xp):
    """Bucket-order form for secondary buckets (port of
    hcspmm_tpu/kernels/block_spmm.py:290): fp32 [Sb, bh, dp], block i from
    entry i; the caller scatters the blocks."""
    if xp.device.type == "cpu":
        return band_bucket_spmm_plain(starts, a, xp)
    _check_cuda_args(starts, None, a, xp)
    out = torch.empty((a.shape[0], a.shape[1], xp.shape[1]), dtype=torch.float32,
                      device=xp.device)
    _launch(starts, None, a, xp, out, 0)
    return out


def band_direct_dispatch(arrs, s, xp, num_sw, out_dtype):
    """Direct-write band call for bucket ``s`` of the uploaded plan arrays
    (the reference's ``band_direct_dispatch``, block_spmm.py:325)."""
    return band_bucket_spmm_direct(arrs[f"band{s}_sw"], arrs[f"band{s}_start"],
                                   arrs[f"band{s}_a"], xp, num_sw, out_dtype)


# ---------------------------------------------------------------------------
# full SpMM over the wide padded layout (+ glue for [N, d] callers)
# ---------------------------------------------------------------------------


def _spill_take(out, arrs, xsrc, plan):
    """The take path (port of hcspmm_tpu/kernels/block_spmm.py:729-765):
    gather each spilled edge's row of ``xsrc`` (clip mode), segment-sum by
    spill row in fp32, and add each row's sum onto ``out``; padded rows
    (real rows come first, checked on upload) are dropped."""
    m = out.shape[0]
    xe = xsrc.index_select(0, arrs["spill_edge_col"].clamp(max=xsrc.shape[0] - 1))
    seg = torch.zeros((plan.num_spill_rows + 1, xsrc.shape[1]), dtype=torch.float32,
                      device=xsrc.device)
    seg.index_add_(0, arrs["spill_edge_seg"], xe.float())
    real = int(np.count_nonzero(plan.spill_rows < m))
    return out.index_add_(0, arrs["spill_rows"][:real], seg[:real].to(out.dtype))


def apply_spill(out, arrs, xsrc, plan):
    """Add the spill population onto ``out`` [M, d] in place (port of
    hcspmm_tpu/kernels/block_spmm.py:745): the row merge when the plan
    carries its streams and ``out`` is the full padded row space, else
    the take path."""
    if not (plan.has_spill and "spill_rows" in arrs):
        return out
    if ("ds_blk" in arrs and out.shape[0] == plan.ds_rows
            and out.shape[1] == xsrc.shape[1]):
        return dstream.dstream_spill(arrs, xsrc, out, plan)
    return _spill_take(out, arrs, xsrc, plan)


def spmm_wide_padded(arrs, xp, plan, compute_dtype):
    """SpMM over the wide padded layout: xp [M, dp] -> [M, dp] (port of
    hcspmm_tpu/kernels/block_spmm.py:803 on wide plans).  The most
    populated bucket writes the whole buffer directly; each other bucket's
    blocks are scattered over the blocks it owns (unset by the direct
    write); the missing superwindows' blocks are zeroed (aligned runs of
    eight first); the spill population is added last.  With no band entry
    at all the buffer starts as zeros."""
    check_plan(plan)
    xp = xp.to(compute_dtype).contiguous()
    m, dp = xp.shape
    if m != plan.padded_rows:
        raise ValueError(f"xp has {m} rows, the plan's layout {plan.padded_rows}")
    bh = plan.band_h
    num_sw = m // bh
    nonempty = [i for i in range(len(plan.band_widths))
                if arrs[f"band{i}_start"].shape[0] > 0]
    if not nonempty:
        buf = torch.zeros((m, dp), dtype=xp.dtype, device=xp.device)
        return apply_spill(buf, arrs, xp, plan)
    s_main = max(nonempty, key=lambda i: len(plan.band_sw_ids[i]))
    b3 = band_direct_dispatch(arrs, s_main, xp, num_sw, xp.dtype)
    for i in nonempty:
        if i == s_main:
            continue
        part = band_bucket_spmm(arrs[f"band{i}_start"], arrs[f"band{i}_a"], xp)
        real = len(plan.band_sw_ids[i])  # capacity padding trails the real entries
        b3.index_copy_(0, arrs[f"band{i}_sw"][:real].long(), part[:real].to(b3.dtype))
    buf = b3.view(m, dp)
    for key, w in (("band_missing_sw8", 8 * bh), ("band_missing_sw", bh)):
        if key in arrs:
            buf = tspill.zero_row_blocks(buf, arrs[key], w)
    return apply_spill(buf, arrs, xp, plan)


def spmm_wide(arrs, x, plan, compute_dtype):
    """[N, d] -> [N, d] glue around the wide padded core (one pad in, one
    slice out, as the reference's tiled path does; padded callers chain
    ``spmm_wide_padded``).  The row layout's own populations and its
    out_perm merge are ROADMAP A.7."""
    n, d = plan.num_nodes, x.shape[1]
    xp = torch.zeros((plan.padded_rows, lane_pad(d)), dtype=compute_dtype, device=x.device)
    xp[: x.shape[0], :d] = x.to(compute_dtype)
    return spmm_wide_padded(arrs, xp, plan, compute_dtype)[:n, :d].to(x.dtype)
