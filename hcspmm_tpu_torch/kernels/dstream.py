"""Row-layout spill merge of the wide padded layout [M, dp], on one H100.

Port of hcspmm_tpu/kernels/dstream.py.  The spill population (the edges
the band blocks do not hold) is sorted by destination row and cut into
chunks of 128 slots; the merge adds

    out[row(e)] += xsrc[gcols[e]]          (clip-mode gather)

for every slot e, in place.  Two encodings of the destination:

- block form (``bstream_merge``, plan ``ds_kind='block'``): each chunk
  goes to block ``blk[c]`` of ``G*128`` rows; ``local`` is the row within
  the block, sentinel ``G*128``;
- tile form (``dstream_merge``, ``ds_kind='tile'``): step ``s`` merges
  chunks ``s*G .. s*G+G-1`` into block ``blk[s]``, chunk ``c`` into its
  128-row tile ``lt[c]``; ``local`` is the row within the tile, sentinel
  128.

One CUDA kernel serves both (``csrc/dstream.cu``); each wrapper launches it
for CUDA tensors (or raises), runs the plain PyTorch version beside it for
CPU tensors, and counts its launches in ``launches``.  The kernel reads a
destination segment table (``row_segments``: each row's contiguous run of
slots) instead of local/blk/lt; the plain versions read those, so holding
the kernel against them checks the table too.  ``dstream_spill`` is the
reference's dispatch: the ``ds_ucols`` compact-table take, the kind, and
the loop over column ranges (``ds_meta``); its takes are torch glue.

``check_row_spill_arrays`` checks every index array the kernel reads on
the host before upload, and builds each launch's segment table
(``ds_seg_*``, or ``ds_seg{p}_*`` per column range).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from hcspmm_tpu_torch.kernels._build import load_library
from hcspmm_tpu_torch.kernels.tspill import (_check_in, _check_scale, _need, segment_arrays,
                                             segment_table, segments_of)

#: Launches of csrc/dstream.cu's merge through each wrapper, counted where
#: the wrapper launches it (never by the plain versions).  chip_smoke.py
#: zeroes them before a run of the main path and reads them after.
launches = {"bstream_merge": 0, "dstream_merge": 0}

_ROW_LONG = 32  # csrc/dstream.cu: a segment of more slots gets a thread block


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("dstream")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hcspmm_row_merge.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, i64, i32, i32,
                                     i32, i32, vp, vp, vp]
    lib.hcspmm_row_merge.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# plain PyTorch version (tests, CPU tensors, and the kernel's check)
# ---------------------------------------------------------------------------


def _merge_plain(gcols, local, chunk_base, sentinel, xsrc, out, span, cscale=None,
                 rscale=None):
    """In place: out[chunk_base[c] + local[e]] += xsrc[min(gcols[e], R-1)]
    for every slot e of chunk c = e // 128 with local < sentinel; fp32
    sums over an fp32 copy of the touched blocks, written back once in
    out's dtype.  With ``cscale`` and ``rscale`` (the scaled form): each
    row's slots are summed from zero, each times ``cscale`` of its xsrc
    row, and the row gets ``rscale[row]`` times its sum."""
    c = chunk_base.shape[0]
    if c == 0:
        return out
    m, dp = out.shape
    loc = local.reshape(-1)[: c * 128].long()
    keep = loc < sentinel
    dest = (chunk_base.repeat_interleave(128) + loc)[keep]
    cols = gcols[: c * 128].long().clamp(max=xsrc.shape[0] - 1)[keep]
    ublk, inv = torch.unique(dest // span, return_inverse=True)
    b3 = out.view(m // span, span, dp)
    acc = b3[ublk].float().reshape(-1, dp)
    vals = xsrc.index_select(0, cols).float()
    if rscale is None:
        acc.index_add_(0, inv * span + dest % span, vals)
    else:
        vals = vals * cscale[cols][:, None]
        sums = torch.zeros_like(acc).index_add_(0, inv * span + dest % span, vals)
        rows = (ublk[:, None] * span + torch.arange(span, device=out.device)).reshape(-1)
        acc.addcmul_(sums, rscale[rows][:, None])
    b3[ublk] = acc.view(-1, span, dp).to(out.dtype)
    return out


def bstream_merge_plain(gcols, local, blk, xsrc, out, *, group: int, cscale=None,
                        rscale=None):
    """Block form: chunk c goes to block blk[c] of group*128 rows."""
    span = group * 128
    return _merge_plain(gcols, local, blk.long() * span, span, xsrc, out, span, cscale, rscale)


def dstream_merge_plain(gcols, local, blk, lt, xsrc, out, *, group: int, cscale=None,
                        rscale=None):
    """Tile form: chunk c goes to tile lt[c] of block blk[c // group]."""
    span = group * 128
    base = blk.long().repeat_interleave(group)[: lt.shape[0]] * span + lt.long() * 128
    return _merge_plain(gcols, local, base, 128, xsrc, out, span, cscale, rscale)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def row_dest(local, blk, lt, group: int, chunks: int) -> np.ndarray:
    """int64 [chunks*128]: each slot's destination row, -1 for a sentinel
    slot.  Block form (``lt`` None): ``blk[c]*span + local``, sentinel
    span; tile form: ``blk[c // group]*span + lt[c]*128 + local``, sentinel
    128."""
    span = group * 128
    loc = np.asarray(local).reshape(-1)[: chunks * 128].astype(np.int64).reshape(chunks, 128)
    blk = np.asarray(blk, dtype=np.int64)
    if lt is None:
        keep, base = loc < span, blk[:chunks] * span
    else:
        keep = loc < 128
        base = blk[np.arange(chunks) // group] * span + np.asarray(lt, np.int64)[:chunks] * 128
    return np.where(keep, base[:, None] + loc, -1).reshape(-1)


def row_segments(local, blk, lt, group: int, chunks: int) -> tuple:
    """The row merge's segment table of one launch (``segment_table``)."""
    return segment_table(row_dest(local, blk, lt, group, chunks), _ROW_LONG)


def _launch(name, gcols, local, blk, lt, segs, xsrc, out, group, cscale=None, rscale=None):
    dev = out.device
    if dev.type != "cuda":
        raise ValueError(f"out lies on {dev}: the merge kernel takes CUDA or CPU tensors")
    m, dp = out.shape
    chunks = gcols.shape[0] // 128
    dests = chunks if lt is None else -(-chunks // group)  # blk entries the chunks read
    if (group <= 0 or m % (group * 128) or xsrc.dim() != 2
            or xsrc.shape[1] != dp or xsrc.shape[0] == 0 or local.numel() < chunks * 128
            or blk.shape[0] < dests or (lt is not None and lt.shape[0] < chunks)):
        raise ValueError(f"unsupported shapes: gcols [{gcols.shape[0]}], local "
                         f"{tuple(local.shape)}, xsrc {tuple(xsrc.shape)}, out {(m, dp)}, "
                         f"group {group}")
    if segs is None:
        segs = tuple(torch.from_numpy(v).to(dev) for v in row_segments(
            local.cpu().numpy(), blk.cpu().numpy(), None if lt is None else lt.cpu().numpy(),
            group, chunks))
    seg_row, seg_ptr, seg_long = segs
    named = {"gcols": gcols, "seg_row": seg_row, "seg_ptr": seg_ptr, "seg_long": seg_long,
             "xsrc": xsrc, "out": out}
    for key, t in named.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{key} must be contiguous on {dev}")
        if t.is_floating_point():
            if t.dtype not in (torch.float32, torch.bfloat16):
                raise ValueError(f"{key} dtype {t.dtype}: float32 or bfloat16 only")
        elif t.dtype != torch.int32:
            raise ValueError(f"{key} must be int32, not {t.dtype}")
    if seg_ptr.shape[0] != seg_row.shape[0] + 1:
        raise ValueError("seg_ptr must hold one more offset than seg_row")
    if (cscale is None) != (rscale is None):
        raise ValueError("the scaled form takes both cscale and rscale")
    _check_scale("cscale", cscale, xsrc.shape[0], dev)
    _check_scale("rscale", rscale, m, dev)
    vector = dp % 8 == 0 and xsrc.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    with torch.cuda.device(dev):
        rc = _lib().hcspmm_row_merge(
            gcols.data_ptr(), seg_row.data_ptr(), seg_ptr.data_ptr(), seg_long.data_ptr(),
            xsrc.data_ptr(), out.data_ptr(), seg_row.shape[0], seg_long.shape[0], _ROW_LONG,
            xsrc.shape[0], dp, int(xsrc.dtype == torch.bfloat16),
            int(out.dtype == torch.bfloat16), int(vector),
            None if cscale is None else cscale.data_ptr(),
            None if rscale is None else rscale.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csrc/dstream.cu {name} launch failed: cudaError {rc}")
    launches[name] += 1
    return out


def bstream_merge(gcols, local, blk, xsrc, out, *, group: int, segs=None, cscale=None,
                  rscale=None):
    """``out += scatter-add of xsrc[gcols] by destination row``, in place,
    block-wide chunks (port of hcspmm_tpu/kernels/dstream.py:253, its take
    included); returns out.

    gcols: int32 [C*128] rows of xsrc (clip mode: past the end reads the
    last row); local: int32 [ceil(C/8)*8, 128], each slot's row within its
    ``group*128``-row block, the sentinel ``group*128`` drops it; blk: int32
    [C] nondecreasing; xsrc: [R, dp]; out: [M, dp].  ``segs``: the stream's
    ``row_segments`` as int32 tensors on out's device (computed here when
    None).  Each touched row is summed in fp32 and written once in out's
    dtype; the kernel's sums are deterministic.  ``rscale`` (fp32 [M]) and
    ``cscale`` (fp32 [R]), both or neither: the scaled form, ``out[row] +=
    rscale[row] * sum of cscale[col] * xsrc[col]`` (csrc/dstream.cu)."""
    if out.device.type == "cpu":
        return bstream_merge_plain(gcols, local, blk, xsrc, out, group=group, cscale=cscale,
                                   rscale=rscale)
    return _launch("bstream_merge", gcols, local, blk, None, segs, xsrc, out, group, cscale,
                   rscale)


def dstream_merge(gcols, local, blk, lt, xsrc, out, *, group: int, segs=None, cscale=None,
                  rscale=None):
    """The tile-pure form of ``bstream_merge`` (port of
    hcspmm_tpu/kernels/dstream.py:408, its take included): step s merges
    chunks s*group .. s*group+group-1 into block blk[s], chunk c into tile
    lt[c]; local: int32 [ceil(S/8)*8, group*128], each slot's row within its
    tile, the sentinel 128 drops it.  ``segs``, ``cscale`` and ``rscale`` as
    ``bstream_merge``'s."""
    if out.device.type == "cpu":
        return dstream_merge_plain(gcols, local, blk, lt, xsrc, out, group=group, cscale=cscale,
                                   rscale=rscale)
    return _launch("dstream_merge", gcols, local, blk, lt, segs, xsrc, out, group, cscale,
                   rscale)


def dstream_spill(arrs, xsrc, out, plan, scale=None):
    """Add the spill population onto ``out`` [M, dp] in place through the
    row merge (port of hcspmm_tpu/kernels/dstream.py:469): the ``ds_ucols``
    compact-table take first when the plan has one, then the block form,
    the tile form, or the tile form once per column range, each range
    gathering from its slice ``xsrc[r0 : r0 + range_rows]`` (start clamped
    as the reference's dynamic_slice) and rounding to out's dtype.
    ``scale`` (fp32 [M] over xsrc's and out's rows): the merges' scaled
    form; the compact table's column scales are gathered with it ([U])."""
    cscale = scale
    if "ds_ucols" in arrs:
        xsrc = xsrc.index_select(0, arrs["ds_ucols"])
        if scale is not None:
            cscale = scale.index_select(0, arrs["ds_ucols"])
    g = plan.ds_group
    if getattr(plan, "ds_kind", "tile") == "block":
        return bstream_merge(arrs["ds_gcols"], arrs["ds_local"], arrs["ds_blk"], xsrc, out,
                             group=g, segs=segments_of(arrs, "ds_seg"), cscale=cscale,
                             rscale=scale)
    meta = getattr(plan, "ds_meta", None)
    if meta is None:
        return dstream_merge(arrs["ds_gcols"], arrs["ds_local"], arrs["ds_blk"],
                             arrs["ds_lt"], xsrc, out, group=g,
                             segs=segments_of(arrs, "ds_seg"), cscale=cscale, rscale=scale)
    rr = int(meta["range_rows"])
    for p, (s0, s1, c0, c1, l0, l1) in enumerate(_ranges(meta)):
        if s1 == s0:
            continue  # empty range: no slice, no kernel
        r0 = max(min(int(meta["r0"][p]), xsrc.shape[0] - rr), 0)
        out = dstream_merge(arrs["ds_gcols"][c0 * 128: c1 * 128], arrs["ds_local"][l0:l1],
                            arrs["ds_blk"][s0:s1], arrs["ds_lt"][c0:c1],
                            xsrc[r0: r0 + rr], out, group=g,
                            segs=segments_of(arrs, f"ds_seg{p}"),
                            cscale=None if scale is None else cscale[r0: r0 + rr], rscale=scale)
    return out


def _ranges(meta):
    """(steps, chunks, local rows) bounds of each column range."""
    st, ch, lr = meta["steps"], meta["chunks"], meta["lrows"]
    return [(int(st[p]), int(st[p + 1]), int(ch[p]), int(ch[p + 1]), int(lr[p]),
             int(lr[p + 1])) for p in range(min(len(meta["r0"]), len(st) - 1))]


# ---------------------------------------------------------------------------
# host checks of a wide plan's row merge arrays
# ---------------------------------------------------------------------------


def _check_tile_stream(local, blk, lt, group, m, name=""):
    """One tile-form stream: G chunks per step, the 8-row padded local
    layout, blocks nondecreasing inside M, tiles in [0, G), rows in
    [0, 128] (128 drops)."""
    s = len(blk)
    _need(len(lt) == s * group, f"ds_lt{name} must hold group={group} chunks per step")
    _need(local.ndim == 2 and local.shape == (-(-s // 8) * 8, group * 128),
          f"ds_local{name} must be [ceil(S/8)*8, G*128]: {local.shape}")
    _need(not (np.diff(blk) < 0).any(), f"ds_blk{name} must not decrease")
    _check_in(f"ds_blk{name}", blk, 0, m // (group * 128))
    _check_in(f"ds_lt{name}", lt, 0, group)
    _check_in(f"ds_local{name}", local, 0, 129)


def check_row_spill_arrays(host: dict, plan) -> dict:
    """Check the row merge arrays of ``host`` (a wide plan's
    ``device_arrays``) for ``plan``; raise ValueError on anything the
    kernel or a take would read out of bounds, or if a row has two
    segments in one launch.  Returns the segment tables the kernel reads
    (``row_segments``): ``ds_seg_*``, or ``ds_seg{p}_*`` for each non-empty
    column range ``p``."""
    if not (plan.has_spill and "ds_blk" in host):
        return {}
    m = plan.padded_rows
    g = plan.ds_group
    span = g * 128
    _need(g > 0 and m % span == 0 and plan.ds_rows == m,
          f"merge group {g}: the block of {span} rows must tile M={m} (ds_rows "
          f"{plan.ds_rows})")
    gcols = np.asarray(host["ds_gcols"])
    local = np.asarray(host["ds_local"])
    blk = np.asarray(host["ds_blk"], dtype=np.int64)
    lt = np.asarray(host["ds_lt"], dtype=np.int64)
    _need(len(gcols) % 128 == 0, "ds_gcols must hold whole chunks of 128 slots")
    _check_in("ds_gcols", gcols, 0, np.iinfo(np.int32).max)
    chunks = len(gcols) // 128
    if "ds_ucols" in host:
        _need(plan.ds_meta is None, "ds_ucols and column ranges do not combine")
        _check_in("ds_ucols", host["ds_ucols"], 0, m)
    if plan.ds_kind == "block":
        _need(len(blk) == chunks and local.shape == (-(-chunks // 8) * 8, 128),
              f"ds_local must be [ceil(C/8)*8, 128] and ds_blk [C]: {local.shape}, "
              f"{blk.shape}")
        _need(not (np.diff(blk) < 0).any(), "ds_blk must not decrease")
        _check_in("ds_blk", blk, 0, m // span)
        _check_in("ds_local", local, 0, span + 1)
        return segment_arrays("ds_seg", row_segments(local, blk, None, g, chunks))
    meta = plan.ds_meta
    if meta is None:
        _need(len(lt) == chunks, "ds_lt must hold one tile per chunk")
        _check_tile_stream(local, blk, lt, g, m)
        return segment_arrays("ds_seg", row_segments(local, blk, lt, g, chunks))
    rr = int(meta["range_rows"])
    ranges = _ranges(meta)
    _need(len(ranges) == len(meta["r0"]) and 0 < rr <= m,
          f"ds_meta: {len(meta['r0'])} ranges of {rr} rows over M={m}")
    _need(ranges[-1][1] == len(blk) and ranges[-1][3] == chunks
          and ranges[-1][5] == local.shape[0], "ds_meta must cover the whole stream")
    extra = {}
    for p, (s0, s1, c0, c1, l0, l1) in enumerate(ranges):
        _need(0 <= s0 <= s1 and 0 <= l0 <= l1 and c0 == s0 * g and c1 == s1 * g,
              f"ds_meta range {p}: bounds out of order")
        r0 = int(meta["r0"][p])
        _need(0 <= r0 and r0 + rr <= m, f"ds_meta range {p}: rows {r0} + {rr} leave M={m}")
        if s1 == s0:
            continue
        _check_tile_stream(local[l0:l1], blk[s0:s1], lt[c0:c1], g, m, name=f" range {p}")
        extra.update(segment_arrays(f"ds_seg{p}", row_segments(
            local[l0:l1], blk[s0:s1], lt[c0:c1], g, c1 - c0)))
    return extra
