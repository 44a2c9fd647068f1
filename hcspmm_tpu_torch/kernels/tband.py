"""Transposed-band SpMM: the narrow-dim (dim <= 64) path, on one H100.

Port of hcspmm_tpu/kernels/tband.py.  Activations are carried as
X^T [dt, M] (dt = feature dim padded to 16, M = plan.padded_rows) and
superwindow i computes

    Y^T[:, R:R+bh] = X^T[:, S:S+W] @ A_t[W, bh]

with A_t the plan's int8 0/1 block, transposed on the host.  The layout is
closed under chaining, and the dense update (X W)^T = W^T X^T keeps a
training step transposed end to end (ops.spmm wires that).

The band product is the CUDA kernel ``csrc/tband.cu``; the functions
``tband_spmm_direct`` and ``tband_spmm_bucket`` are its wrappers.  Beside
them sit the plain PyTorch versions (gather + fp32 einsum) that the tests
and chip_smoke.py hold the kernel against.  A wrapper takes the plain
version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises.

Only plans whose every superwindow block is written by exactly one band
entry run here (``check_plan``): missing superwindows, the spill chain and
packed A_t encodings are not ported yet, and such plans raise instead of
losing edges.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from hcspmm_tpu_torch.kernels._build import load_library

#: Launches of the CUDA kernel of csrc/tband.cu, counted where a wrapper
#: launches it (never by the plain versions).  chip_smoke.py zeroes it
#: before a run of the main path and reads it after.
launches = 0

_MAX_BH = 512  # threads per block in csrc/tband.cu: one per output column
_KT = 64       # csrc/tband.cu KT: the contraction width must divide by it


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("tband")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hcspmm_tband_spmm.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                      i64, i64, i32, i32, i32, vp]
    lib.hcspmm_tband_spmm.restype = ctypes.c_int
    return lib


def check_plan(plan) -> None:
    """Raise NotImplementedError unless ``plan`` runs here with no edge
    dropped: a tband plan, int8 A_t (``tband_pack == 1``), band entries
    covering every superwindow of the padded layout, and no spill, dense
    or sparse population."""
    if not getattr(plan, "tband", False):
        raise NotImplementedError(
            "hcspmm_tpu_torch runs band_impl='tband' plans only; the wide "
            "padded layout is ROADMAP A.6 and the row layout A.7")
    if plan.tband_pack != 1:
        raise NotImplementedError(
            f"tband_pack={plan.tband_pack}: the nibble and 1-bit A_t "
            "encodings are ROADMAP A.2")
    if plan.has_spill or plan.spill_nnz:
        raise NotImplementedError(
            f"plan spills {plan.spill_nnz} edges: the tband spill chain "
            "(zero_lane_blocks, mxgather_lanes, tbstream_merge) is ROADMAP A.3")
    if plan.dense_nnz or plan.sparse_nnz:
        raise NotImplementedError(
            "tband plans carry band and spill populations only "
            f"(dense_nnz={plan.dense_nnz}, sparse_nnz={plan.sparse_nnz})")
    num_sw = plan.padded_rows // plan.band_h
    covered = sum(len(s) for s in plan.band_sw_ids)
    if covered != num_sw:
        raise NotImplementedError(
            f"band entries cover {covered} of {num_sw} superwindows: "
            "missing superwindows and the spill chain that carries their "
            "edges are ROADMAP A.3")
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


def tband_spmm_bucket_plain(starts, at, xt):
    """fp32 [dt, Sb*bh]: block i = X^T[:, st[i] : st[i]+W] @ A_t[i]."""
    sb, w, bh = at.shape
    cols = starts.long()[:, None] + torch.arange(w, device=xt.device)
    xg = xt[:, cols].float()                               # [dt, Sb, W]
    out = torch.einsum("dsw,swb->dsb", xg, at.float())     # [dt, Sb, bh]
    return out.reshape(xt.shape[0], sb * bh)


def tband_spmm_direct_plain(sw_ids, starts, at, xt, num_sw, out_dtype):
    """[dt, num_sw*bh] ``out_dtype``: block sw[i] = X^T slice @ A_t[i];
    entries with sw == num_sw are dropped, unowned blocks stay unset."""
    sb, _, bh = at.shape
    dt = xt.shape[0]
    part = tband_spmm_bucket_plain(starts, at, xt).view(dt, sb, bh)
    out = torch.empty((dt, num_sw * bh), dtype=out_dtype, device=xt.device)
    keep = sw_ids < num_sw
    out.view(dt, num_sw, bh)[:, sw_ids[keep].long()] = part[:, keep].to(out_dtype)
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda_args(starts, sw_ids, at, xt):
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
    if at.dtype != torch.int8 or at.dim() != 3:
        raise ValueError("at must be int8 [Sb, W, bh]")
    sb, w, bh = at.shape
    dt, m = xt.shape
    for name, t in (("starts", starts), ("sw_ids", sw_ids)):
        if t is not None and (t.dtype != torch.int32 or tuple(t.shape) != (sb,)):
            raise ValueError(f"{name} must be int32 [{sb}]")
    if dt % 16 or w % _KT or w > m or bh % 32 or bh > _MAX_BH:
        raise ValueError(f"unsupported shape: dt={dt} W={w} bh={bh} M={m}")


def _launch(starts, sw_ids, at, xt, out, num_sw):
    global launches
    sb, w, bh = at.shape
    dt, m = xt.shape
    with torch.cuda.device(xt.device):
        rc = _lib().hcspmm_tband_spmm(
            starts.data_ptr(), None if sw_ids is None else sw_ids.data_ptr(),
            at.data_ptr(), xt.data_ptr(), out.data_ptr(), sb, w, bh, dt, m,
            out.shape[1], num_sw, int(xt.dtype == torch.bfloat16),
            int(out.dtype == torch.float32),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csrc/tband.cu launch failed: cudaError {rc}")
    launches += 1


def tband_spmm_direct(sw_ids, starts, at, xt, num_sw, out_dtype):
    """Transposed-band SpMM, direct write: entry i computes superwindow
    ``sw_ids[i]``'s output columns (port of the Pallas kernel at
    hcspmm_tpu/kernels/tband.py:189).

    starts, sw_ids: int32 [Sb]; at: int8 [Sb, W, bh]; xt: [dt, M] float32
    or bfloat16.  Returns [dt, num_sw*bh] in ``out_dtype`` (xt's dtype or
    float32).  Entries with ``sw_id == num_sw`` write nothing, and blocks
    no entry owns are left unset: callers guarantee full cover."""
    if xt.device.type == "cpu":
        return tband_spmm_direct_plain(sw_ids, starts, at, xt, num_sw, out_dtype)
    _check_cuda_args(starts, sw_ids, at, xt)
    if out_dtype not in (xt.dtype, torch.float32):
        raise ValueError(f"out_dtype {out_dtype}: xt's dtype or float32")
    out = torch.empty((xt.shape[0], num_sw * at.shape[2]), dtype=out_dtype,
                      device=xt.device)
    _launch(starts, sw_ids, at, xt, out, num_sw)
    return out


def tband_spmm_bucket(starts, at, xt):
    """Bucket-order form for secondary buckets (port of
    hcspmm_tpu/kernels/tband.py:228): fp32 [dt, Sb*bh], block i from entry
    i; the caller scatters the blocks."""
    if xt.device.type == "cpu":
        return tband_spmm_bucket_plain(starts, at, xt)
    _check_cuda_args(starts, None, at, xt)
    out = torch.empty((xt.shape[0], at.shape[0] * at.shape[2]),
                      dtype=torch.float32, device=xt.device)
    _launch(starts, None, at, xt, out, 0)
    return out


# ---------------------------------------------------------------------------
# full transposed SpMM over the [dt, M] layout (+ glue for [N, d] callers)
# ---------------------------------------------------------------------------


def spmm_tband_padded(arrs, xt, plan, compute_dtype):
    """SpMM over the transposed padded layout: xt [dt, M] -> [dt, M]
    (M = plan.padded_rows).  The most populated bucket writes the whole
    buffer directly; each other bucket's blocks are scattered over the
    blocks it owns (unset by the direct write)."""
    check_plan(plan)
    xt = xt.to(compute_dtype).contiguous()
    dt, m = xt.shape
    if m != plan.padded_rows:
        raise ValueError(f"xt has {m} lanes, the plan's layout {plan.padded_rows}")
    bh = plan.band_h
    num_sw = m // bh
    nonempty = [i for i in range(len(plan.band_widths))
                if arrs[f"band{i}_start"].shape[0] > 0]
    s_main = max(nonempty, key=lambda i: len(plan.band_sw_ids[i]))
    buf = tband_spmm_direct(arrs[f"band{s_main}_sw"], arrs[f"band{s_main}_start"],
                            arrs[f"band{s_main}_at"], xt, num_sw, xt.dtype)
    b3 = buf.view(dt, num_sw, bh)
    for i in nonempty:
        if i == s_main:
            continue
        part = tband_spmm_bucket(arrs[f"band{i}_start"], arrs[f"band{i}_at"], xt)
        real = len(plan.band_sw_ids[i])  # capacity padding trails the real entries
        b3.index_copy_(1, arrs[f"band{i}_sw"][:real].long(),
                       part.view(dt, -1, bh)[:, :real].to(buf.dtype))
    return buf


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
