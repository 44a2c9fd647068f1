"""Lane-oriented spill chain of the transposed-band layout, on one H100.

Port of hcspmm_tpu/kernels/tspill.py.  Activations are X^T [dt, M]; the
tband spill chain (kernels/tband.py ``_tband_apply_spill``) runs

    T     = mxgather_lanes(xt, lo, rel)                   # compact unique-column table
    buf   = tbstream_merge(T or xt, local, blk, buf, gidx=...)  # gather + scatter-add

and missing superwindows are zeroed before it by the band kernel's direct
launch (kernels/tband.py; ``zero_lane_blocks_plain`` is that fold's plain
version); ``zero_row_blocks`` is the wide layout's [M, dp] zero-fill.
The reference gathers a [dt, C*bw] copy of the per-edge columns first
(``take``, or ``segmented_gather`` through its T2 tables) and merges that;
here ``check_spill_arrays`` composes the per-slot column ``ds_lsrc`` on
the host at upload and the merge gathers through it.  The three kernels are
``csrc/tspill.cu``; each wrapper here launches its kernel for CUDA tensors
(or raises) and runs the plain PyTorch version beside it for CPU tensors,
and counts its launches in ``launches``.  ``segmented_gather`` (the
reference's T2 take, in torch index ops) is what ``ds_lsrc`` is held
against.  The normalised operator D A D X^T (``tband.spmm_tband_padded``
given ``row_scale``) runs the gather and the merge in their scaled forms
(``scale``; ``rscale`` and ``cscale``): no pass over [dt, M] of its own.

``check_spill_arrays`` checks every spill index array on the host before
upload and builds the merges' destination segment tables
(``segment_table``); the kernels read them unchecked.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from hcspmm_tpu_torch.kernels._build import load_library

#: Launches of each kernel of csrc/tspill.cu, counted where its wrapper
#: launches it (never by the plain versions).  chip_smoke.py zeroes them
#: before a run of the main path and reads them after.
launches = {"zero_row_blocks": 0, "mxgather_lanes": 0, "tbstream_merge": 0}

_MX_NB = 4     # the reference's chunks per grid step: the table's chunk
#                count is padded to a multiple of it
_LANE_LONG = 16  # csrc/tspill.cu merge: a segment of more slots gets a warp


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("tspill")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hcspmm_zero_row_blocks.argtypes = [vp, vp, i32, i64, i32, i32, vp]
    lib.hcspmm_mxgather_lanes.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i64, i32, vp,
                                          vp]
    lib.hcspmm_tbstream_merge.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, i64, i64,
                                          i32, i32, vp, vp, vp]
    for fn in (lib.hcspmm_zero_row_blocks, lib.hcspmm_mxgather_lanes,
               lib.hcspmm_tbstream_merge):
        fn.restype = ctypes.c_int
    return lib


def _run(name: str, fn, *args) -> None:
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csrc/tspill.cu {name} launch failed: cudaError {rc}")
    launches[name] += 1


def _check_cuda(ref: torch.Tensor, **named) -> None:
    """Every tensor on ref's CUDA device and contiguous; index tensors
    int32; float tensors fp32 or bf16."""
    dev = ref.device
    if dev.type != "cuda":
        raise ValueError(f"tensors lie on {dev}: the spill kernels take CUDA or CPU "
                         "tensors")
    for name, t in named.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
        if t.is_floating_point():
            if t.dtype not in (torch.float32, torch.bfloat16):
                raise ValueError(f"{name} dtype {t.dtype}: float32 or bfloat16 only")
        elif t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, not {t.dtype}")


def _check_scale(name: str, scale, n: int, dev) -> None:
    """A scale is None or contiguous fp32 [n] on ``dev`` (the kernels read
    it unchecked)."""
    if scale is not None and (scale.dtype != torch.float32 or not scale.is_contiguous()
                              or tuple(scale.shape) != (n,) or scale.device != dev):
        raise ValueError(f"{name} must be contiguous float32 [{n}] on {dev}")


def mx_width(chunks: int, k: int) -> int:
    """Lanes of an mxgather table: the chunk count padded to _MX_NB."""
    return -(-chunks // _MX_NB) * _MX_NB * k


#: The three arrays of a segment table, as ``{name}_{field}`` plan keys.
SEG_FIELDS = ("dst", "ptr", "long")


def segment_table(dest, long_min: int) -> tuple:
    """Destination segments of a merge stream.  ``dest``: int [E], each
    slot's destination (a row or lane of the output), -1 for a dropped pad
    slot.  A segment is a maximal run of consecutive slots with one
    destination.  Returns int32 (dst [S] (-1 for a run of pad slots), ptr
    [S+1] slot offsets, long [L] the segments of more than ``long_min``
    slots).  Raises ValueError if a destination has two segments: the
    kernels give each segment one owner, so two would race."""
    dest = np.asarray(dest, dtype=np.int64)
    e = len(dest)
    _need(e < np.iinfo(np.int32).max, f"{e} slots exceed int32 offsets")
    start = np.flatnonzero(np.concatenate([[True], dest[1:] != dest[:-1]])) if e else \
        np.zeros(0, np.int64)
    dst = dest[start]
    ptr = np.append(start, e)
    real = dst >= 0
    u, n = np.unique(dst[real], return_counts=True)
    _need(not (n > 1).any(), f"destination {u[n > 1][:1]} has two runs of slots: a "
          "merge stream must keep each destination's slots together")
    long = np.flatnonzero(real & (np.diff(ptr) > long_min))
    return dst.astype(np.int32), ptr.astype(np.int32), long.astype(np.int32)


def segment_arrays(name: str, table) -> dict:
    """``table`` (``segment_table``'s) as plan arrays ``{name}_dst`` etc."""
    return {f"{name}_{f}": v for f, v in zip(SEG_FIELDS, table)}


def segments_of(arrs: dict, name: str):
    """The segment table ``name`` of the uploaded plan arrays, or None."""
    if f"{name}_ptr" not in arrs:
        return None
    return tuple(arrs[f"{name}_{f}"] for f in SEG_FIELDS)


def lane_dest(local_t, blk, group: int) -> np.ndarray:
    """int64 [C*bw]: each slot's destination lane ``blk[c]*span + local``,
    -1 for a pad slot (local == span)."""
    span = group * 128
    blk = np.asarray(blk, dtype=np.int64)
    loc = np.asarray(local_t)[: len(blk)].astype(np.int64)
    return np.where(loc < span, blk[:, None] * span + loc, -1).reshape(-1)


def lane_segments(local_t, blk, group: int) -> tuple:
    """The lane merge's segment table of one stream (``segment_table``)."""
    return segment_table(lane_dest(local_t, blk, group), _LANE_LONG)


# ---------------------------------------------------------------------------
# plain PyTorch versions (tests, CPU tensors, and the kernels' check)
# ---------------------------------------------------------------------------


def zero_lane_blocks_plain(buf, ids, w: int):
    """In place: lanes [ids[i]*w, ids[i]*w + w) of buf [dt, M] set to 0
    (the reference's ``zero_lane_blocks``, hcspmm_tpu/kernels/tspill.py:55;
    on the card the band kernel's direct launch does it, kernels/tband.py)."""
    buf.view(buf.shape[0], -1, w).index_fill_(1, ids.long(), 0)
    return buf


def zero_row_blocks_plain(buf, ids, w: int):
    """In place: rows [ids[i]*w, ids[i]*w + w) of buf [M, dp] set to 0."""
    buf.view(-1, w, buf.shape[1]).index_fill_(0, ids.long(), 0)
    return buf


def mxgather_lanes_plain(xt, lo, rel, scale=None):
    """[dt, mx_width(C, k)]: column c*k+j = xt[:, lo[c]+rel[c,0,j]], zero
    where rel == -1 and in the tail chunks.  With ``scale`` (fp32 [M]): each
    value times its source lane's scale, rounded to xt's dtype."""
    c, k = rel.shape[0], rel.shape[2]
    r = rel.reshape(c, k).long()
    idx = (lo.long()[:, None] + r.clamp(min=0)).reshape(-1)
    vals = xt.index_select(1, idx)
    if scale is not None:
        vals = (vals * scale[idx]).to(xt.dtype)
    out = torch.zeros((xt.shape[0], mx_width(c, k)), dtype=xt.dtype, device=xt.device)
    out[:, : c * k] = torch.where((r >= 0).reshape(1, -1), vals, out[:, : c * k])
    return out


def tbstream_merge_plain(src, local_t, blk, buf, *, group: int, gidx=None, rscale=None,
                         cscale=None):
    """In place: buf[:, blk[c]*span + local_t[c, j]] += gathered[:, c*bw + j]
    for local_t < span = group*128, where gathered is ``src`` itself or,
    with ``gidx``, ``src.index_select(1, gidx)`` (the reference's take);
    fp32 sums over an fp32 copy of the touched blocks, written back once in
    buf's dtype.  With ``rscale`` (fp32 [M]): each lane's slots are summed
    from zero, each times ``cscale`` of its column of src where that is
    given, and the lane gets ``rscale[lane]`` times its sum."""
    dt, m = buf.shape
    span = group * 128
    bw = local_t.shape[1]
    c = blk.shape[0]
    if c == 0:
        return buf
    cols = (gidx[: c * bw].long() if gidx is not None
            else torch.arange(c * bw, device=src.device))
    gathered = src.index_select(1, cols)
    ublk, inv = torch.unique_consecutive(blk.long(), return_inverse=True)
    loc = local_t[:c].reshape(-1).long()
    keep = loc < span
    dest = (inv.repeat_interleave(bw) * span + loc)[keep]
    b3 = buf.view(dt, m // span, span)
    acc = b3[:, ublk].float().reshape(dt, -1)
    vals = gathered[:, keep].float()
    if rscale is None:
        acc.index_add_(1, dest, vals)
    else:
        if cscale is not None:
            vals = vals * cscale[cols[keep]]
        sums = torch.zeros_like(acc).index_add_(1, dest, vals)
        lanes = (ublk[:, None] * span + torch.arange(span, device=buf.device)).reshape(-1)
        acc.addcmul_(sums, rscale[lanes])
    b3[:, ublk] = acc.view(dt, -1, span).to(buf.dtype)
    return buf


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def zero_row_blocks(buf, ids, w: int):
    """Zero rows [ids[i]*w, ids[i]*w + w) of buf [M, dp] in place and
    return buf (port of hcspmm_tpu/kernels/tspill.py:84, the wide layout's
    twin of ``zero_lane_blocks``); ``w`` is ``bh`` or ``8*bh``.  An empty
    ``ids`` launches nothing."""
    if ids.shape[0] == 0:
        return buf
    if buf.device.type == "cpu":
        return zero_row_blocks_plain(buf, ids, w)
    _check_cuda(buf, buf=buf, ids=ids)
    m, dp = buf.shape
    if w <= 0 or m % w or (w * dp * buf.element_size()) % 16:
        raise ValueError(f"block height {w} must divide M={m} and fill 16-byte rows")
    with torch.cuda.device(buf.device):
        _run("zero_row_blocks", _lib().hcspmm_zero_row_blocks, buf.data_ptr(),
             ids.data_ptr(), ids.shape[0], dp, w, buf.element_size())
    return buf


def mxgather_lanes(xt, lo, rel, *, span: int, scale=None):
    """Compact table [dt, mx_width(C, k)] in xt's dtype: column c*k+j =
    xt[:, lo[c]+rel[c,0,j]], exact zeros where rel == -1 and in the tail
    chunks (port of hcspmm_tpu/kernels/tspill.py:280).  lo: int32 [C]
    128-aligned slab bases with lo + span <= M; rel: int32 [C, 1, k] in
    [-1, span), checked on the host (``check_spill_arrays``).  ``scale``
    (fp32 [M]): each value times its source lane's scale, rounded once to
    xt's dtype (the table of X^T D)."""
    if xt.device.type == "cpu":
        return mxgather_lanes_plain(xt, lo, rel, scale)
    _check_cuda(xt, xt=xt, lo=lo, rel=rel)
    _check_scale("scale", scale, xt.shape[1], xt.device)
    c, k = rel.shape[0], rel.shape[2]
    if tuple(lo.shape) != (c,) or rel.dim() != 3 or rel.shape[1] != 1:
        raise ValueError(f"lo must be [C] and rel [C, 1, k]: {tuple(lo.shape)}, "
                         f"{tuple(rel.shape)}")
    if span > xt.shape[1]:
        raise ValueError(f"span {span} exceeds M={xt.shape[1]}")
    dt, m = xt.shape
    out = torch.empty((dt, mx_width(c, k)), dtype=xt.dtype, device=xt.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(xt.device):
        _run("mxgather_lanes", _lib().hcspmm_mxgather_lanes, xt.data_ptr(), lo.data_ptr(),
             rel.data_ptr(), out.data_ptr(), c, out.shape[1] // k, k, dt, m,
             xt.element_size(), None if scale is None else scale.data_ptr())
    return out


def tbstream_merge(src, local_t, blk, buf, *, group: int, gidx=None, segs=None, rscale=None,
                   cscale=None):
    """``buf += scatter-add of src columns by destination lane``, in place;
    returns buf (port of hcspmm_tpu/kernels/tspill.py:151, with the take
    before it folded in).

    Slot j of chunk c adds ``src[:, gidx[c*bw + j]]`` (gidx: int32 [C*bw]
    columns of src), or ``src[:, c*bw + j]`` without gidx (src is then the
    gathered stream [dt, C*bw]), to lane ``blk[c]*span + local_t[c, j]``.
    local_t: int32 [ceil(C/8)*8, bw], each slot's lane within its
    ``group*128``-lane block (the sentinel ``group*128`` drops it); blk:
    int32 [C] nondecreasing block ids; src: [dt, W] in buf's dtype; buf:
    [dt, M].
    ``segs``: the stream's ``lane_segments`` as int32 tensors on buf's
    device (computed here, and gidx checked, when None).  Each lane is summed
    in fp32 and written once; the kernel's sums are deterministic.
    ``rscale`` (fp32 [M]): the scaled form, each lane's sum from zero times
    ``rscale[lane]`` added into buf; ``cscale`` (fp32 [W], only with rscale):
    each slot's value times its column's first (a merge straight from X^T,
    whose values no scaled gather has scaled)."""
    if cscale is not None and rscale is None:
        raise ValueError("a column scale comes with a row scale")
    if buf.device.type == "cpu":
        return tbstream_merge_plain(src, local_t, blk, buf, group=group, gidx=gidx,
                                    rscale=rscale, cscale=cscale)
    c, bw = blk.shape[0], local_t.shape[1]
    if segs is None:
        if gidx is not None:
            _check_in("gidx", gidx[: c * bw].cpu().numpy(), 0, src.shape[1])
        segs = tuple(torch.from_numpy(v).to(buf.device) for v in lane_segments(
            local_t.cpu().numpy(), blk.cpu().numpy(), group))
    named = dict(src=src, local_t=local_t, blk=blk, buf=buf, seg_dst=segs[0], seg_ptr=segs[1],
                 seg_long=segs[2])
    if gidx is not None:
        named["gidx"] = gidx
    _check_cuda(buf, **named)
    dt, m = buf.shape
    if src.dtype != buf.dtype:
        raise ValueError(f"src is {src.dtype}, buf {buf.dtype}")
    if (m % (group * 128) or local_t.shape[0] < c or src.dim() != 2 or src.shape[0] != dt
            or (gidx is None and src.shape[1] != c * bw)
            or (gidx is not None and gidx.shape[0] < c * bw)
            or segs[1].shape[0] != segs[0].shape[0] + 1):
        raise ValueError(f"unsupported shapes: src {tuple(src.shape)}, local "
                         f"{tuple(local_t.shape)}, blk [{c}], buf {tuple(buf.shape)}, "
                         f"group {group}")
    _check_scale("rscale", rscale, m, buf.device)
    _check_scale("cscale", cscale, src.shape[1], buf.device)
    with torch.cuda.device(buf.device):
        _run("tbstream_merge", _lib().hcspmm_tbstream_merge, src.data_ptr(),
             None if gidx is None else gidx.data_ptr(), segs[0].data_ptr(),
             segs[1].data_ptr(), segs[2].data_ptr(), buf.data_ptr(), segs[0].shape[0],
             segs[2].shape[0], _LANE_LONG, src.shape[1], m, dt,
             int(buf.dtype == torch.bfloat16),
             *[None if v is None else v.data_ptr() for v in (rscale, cscale)])
    return buf


def segmented_gather(t1, ranks, laneg, segs, pieces, bw: int):
    """Per-edge spill gather through destination-segment tables (port of
    hcspmm_tpu/kernels/tspill.py:200), in torch index ops.

    t1: [dt, T1w] mxgather table; ranks: int32 piece-relative T1 slots in
    piece-major order; laneg: int32 [C*bw] segment-relative positions;
    segs/pieces: the plan's static ``ts2_segs``/``ts2_pieces``.  Returns
    [dt, C*bw] in merge-chunk order.  Indices are checked on the host
    (``check_spill_arrays``), so no clamp is needed."""
    piece_res = [t1[:, p_lo: p_lo + p_w].index_select(1, ranks[r0: r0 + cnt])
                 for (p_lo, p_w, r0, cnt) in pieces]
    parts = []
    for s in segs:
        tparts = [piece_res[pi][:, off: off + cnt] for (pi, off, cnt) in s["parts"] if cnt]
        seg_tbl = tparts[0] if len(tparts) == 1 else torch.cat(tparts, dim=1)
        parts.append(seg_tbl.index_select(1, laneg[s["chunk_lo"] * bw: s["chunk_hi"] * bw]))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# host checks of a plan's spill arrays
# ---------------------------------------------------------------------------


def _need(ok, msg: str) -> None:
    if not ok:
        raise ValueError(msg)


def _check_in(name: str, a, lo: int, hi: int) -> None:
    a = np.asarray(a)
    _need(not a.size or (a.min() >= lo and a.max() < hi),
          f"{name} must lie in [{lo}, {hi})")


def _check_stream(host: dict, local: str, blk: str, group: int, m: int) -> None:
    """One merge stream: blocks nondecreasing and inside M, local lanes in
    [0, span] (span drops), the 8-row padded [ceil(C/8)*8, bw] layout."""
    span = group * 128
    _need(group > 0 and m % span == 0, f"merge group {group}: span must divide M={m}")
    b = np.asarray(host[blk], dtype=np.int64)
    lt = np.asarray(host[local])
    _need(lt.ndim == 2 and lt.shape[1] % 128 == 0
          and lt.shape[0] == -(-len(b) // 8) * 8,
          f"{local} must be [ceil(C/8)*8, bw], bw a multiple of 128: {lt.shape}")
    _need(not (np.diff(b) < 0).any(), f"{blk} must not decrease")
    _check_in(blk, b, 0, m // span)
    _check_in(local, lt, 0, span + 1)


def _check_mx(host: dict, lo: str, rel: str, span: int, m: int) -> int:
    """mxgather slabs inside M; returns the table's width."""
    lo_a = np.asarray(host[lo], dtype=np.int64)
    rel_a = np.asarray(host[rel])
    _need(0 < span <= m and rel_a.ndim == 3 and rel_a.shape[:2] == (len(lo_a), 1),
          f"{rel} must be [C, 1, k] for span {span} <= M={m}")
    _need(not (lo_a % 128).any(), f"{lo} must be 128-aligned")
    _check_in(lo, lo_a, 0, m - span + 1)
    _check_in(rel, rel_a, -1, span)
    return mx_width(len(lo_a), rel_a.shape[2])


def compose_lane_src(laneg, ranks, segs, pieces, bw: int) -> np.ndarray:
    """int32 [C*bw]: the T1 column each slot's value comes from through the
    plan's T2 tables, the column ``segmented_gather`` gathers for it: slot e
    of T2 segment s reads position q = laneg[e] of the segment's table, the
    concatenation of its parts (piece pi, offset off, count cnt), so part k
    with start[k] <= q < start[k] + cnt gives T1 column ``p_lo[pi] +
    ranks[r0[pi] + off + q - start[k]]``.  The indices are checked by the
    caller (``check_spill_arrays``)."""
    laneg = np.asarray(laneg, dtype=np.int64)
    ranks = np.asarray(ranks, dtype=np.int64)
    out = np.zeros(len(laneg), dtype=np.int64)
    for s in segs:
        parts = [(pi, off, cnt) for pi, off, cnt in s["parts"] if cnt]
        lo, hi = s["chunk_lo"] * bw, s["chunk_hi"] * bw
        if not parts or hi == lo:
            continue
        cnt = np.array([c for _, _, c in parts], dtype=np.int64)
        start = np.cumsum(cnt) - cnt
        k = np.searchsorted(start, laneg[lo:hi], side="right") - 1
        p_lo = np.array([pieces[pi][0] for pi, _, _ in parts], dtype=np.int64)
        first = np.array([pieces[pi][2] + off for pi, off, _ in parts], dtype=np.int64)
        out[lo:hi] = p_lo[k] + ranks[first[k] + laneg[lo:hi] - start[k]]
    return out.astype(np.int32)


def check_spill_arrays(host: dict, plan) -> dict:
    """Check the spill and missing-superwindow arrays of ``host`` (a
    plan's ``device_arrays``) for ``plan``; raise ValueError on anything
    a kernel or a take would read out of bounds.  Returns the extra arrays
    the port's merge needs: ``ds_lsrc``, each cold slot's column of the
    merge's source (T1, or X^T where the plan has no T1; composed through
    the T2 tables where it has them, else ``ds_laneg``), and the lane
    segment tables ``ds_lseg_*`` (cold stream) and ``ds_h_lseg_*`` (hub
    stream, which gathers through ``ds_h_laneg``)."""
    m = plan.padded_rows
    num_sw = m // plan.band_h
    if "band_missing_sw8" in host:
        _check_in("band_missing_sw8", host["band_missing_sw8"], 0, num_sw // 8)
    if "band_missing_sw" in host:
        _check_in("band_missing_sw", host["band_missing_sw"], 0, num_sw)
    extra = {}
    if not plan.has_spill:
        return extra
    if "ds_tlocal" not in host:  # the take path: clip-mode gather, dropped pads
        rows = np.asarray(host["spill_rows"], dtype=np.int64)
        real = rows < m
        _need(real[: int(real.sum())].all(),
              "spill_rows: the real rows must precede the padding")
        _check_in("spill_rows", rows[real], 0, m)
        _check_in("spill_edge_seg", host["spill_edge_seg"], 0, len(rows) + 1)
        return extra
    bw = host["ds_tlocal"].shape[1]
    _check_stream(host, "ds_tlocal", "ds_lblk", plan.ds_lgroup, m)
    extra.update(segment_arrays("ds_lseg", lane_segments(host["ds_tlocal"], host["ds_lblk"],
                                                         plan.ds_lgroup)))
    laneg = np.asarray(host["ds_laneg"])
    _need(laneg.shape == (len(host["ds_lblk"]) * bw,), "ds_laneg must be [C*bw]")
    if "hub_lo" in host:
        hub_w = _check_mx(host, "hub_lo", "hub_rel", plan.ts_span, m)
        _check_stream(host, "ds_h_tlocal", "ds_h_lblk", plan.ds_hgroup, m)
        extra.update(segment_arrays("ds_h_lseg", lane_segments(
            host["ds_h_tlocal"], host["ds_h_lblk"], plan.ds_hgroup)))
        h_laneg = np.asarray(host["ds_h_laneg"])
        _need(h_laneg.shape == (len(host["ds_h_lblk"]) * host["ds_h_tlocal"].shape[1],),
              "ds_h_laneg must be [C_hub*bw_hub]")
        _check_in("ds_h_laneg", h_laneg, 0, hub_w)
    src_w = _check_mx(host, "ts_lo", "ts_rel", plan.ts_span, m) if "ts_lo" in host else m
    if "ts2_ranks" in host and getattr(plan, "ts2_segs", None):
        ranks = np.asarray(host["ts2_ranks"])
        for p_lo, p_w, r0, cnt in plan.ts2_pieces:
            _need(0 <= p_lo and p_lo + p_w <= src_w and r0 + cnt <= len(ranks),
                  "ts2_pieces must slice T1 and ts2_ranks in bounds")
            _check_in("ts2_ranks", ranks[r0: r0 + cnt], 0, p_w)
        lo = 0
        for s in plan.ts2_segs:
            _need(s["chunk_lo"] == lo, "ts2_segs must tile the merge chunks in order")
            lo = s["chunk_hi"]
            for pi, off, cnt in s["parts"]:
                _need(0 <= off and off + cnt <= plan.ts2_pieces[pi][3],
                      "ts2_segs parts must slice their piece in bounds")
            _check_in("ds_laneg", laneg[s["chunk_lo"] * bw: s["chunk_hi"] * bw], 0,
                      sum(cnt for _, _, cnt in s["parts"]))
        _need(lo == len(host["ds_lblk"]), "ts2_segs must cover every merge chunk")
        lsrc = compose_lane_src(laneg, ranks, plan.ts2_segs, plan.ts2_pieces, bw)
    else:
        lsrc = laneg.astype(np.int32)
    _check_in("ds_lsrc", lsrc, 0, src_w)
    extra["ds_lsrc"] = lsrc
    return extra
