"""NumPy constructors of the spill streams and packed band blocks.

``format.plan`` calls these while it builds a plan.  In the JAX package
they live beside the Pallas kernels that consume their output
(hcspmm_tpu/kernels/dstream.py, tspill.py and tband.py), so importing
them there pulls in JAX; here they are carried verbatim into the host
side, and tests/test_torch_plan.py holds the plans of both packages
equal.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_SENTINEL = 128  # local-dst sentinel: matches no lane -> zero one-hot row


def pick_group(padded_rows: int, max_group: int = 8) -> int:
    """Largest G in {max_group..1} with padded_rows % (G*128) == 0.

    G chunks are merged per grid step into one G*128-row destination
    block; bigger G amortizes the ~0.2-0.3 us grid-step floor over more
    DMA bytes.  band_h=256 guarantees G >= 2."""
    g = max_group
    while g > 1 and padded_rows % (g * 128):
        g //= 2
    return max(g, 1)


def build_dstream(rows: np.ndarray, cols: np.ndarray, padded_rows: int,
                  pad_col: int, group: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                             int]:
    """Chunk dst-sorted spill edges for the streamed merge.

    rows: int [E] destination rows (must be nondecreasing; CSR edge
    order is), all < padded_rows.  cols: int [E] X-row per edge.
    Returns (gcols [C*128] int32 — take indices, pad ``pad_col``;
    local [ceil(S/8)*8, G*128] int32 — dst row within its 128-row tile
    (row s holds step s's G chunks; 8-row sublane padding for the VMEM
    block, pad value 128);
    blk [S] int32 — destination block per step (S = C/G);
    lt [C] int32 — chunk's tile within its block; group).
    """
    if not group:
        group = pick_group(padded_rows)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    e = len(rows)
    if e:
        assert rows.max() < padded_rows, (rows.max(), padded_rows)
        tile = rows >> 7
        # chunk boundaries: every tile change, every 128 edges within one
        new_t = np.empty(e, dtype=bool)
        new_t[0] = True
        np.not_equal(tile[1:], tile[:-1], out=new_t[1:])
        tseg = np.cumsum(new_t) - 1
        tstart = np.zeros(tseg[-1] + 1, dtype=np.int64)
        tstart[tseg[new_t]] = np.where(new_t)[0]
        within = np.arange(e) - tstart[tseg]
        newc = new_t | ((within & 127) == 0)
        chunk_of = np.cumsum(newc) - 1                     # [E]
        nchunks = int(chunk_of[-1]) + 1
        slot = np.empty(e, dtype=np.int64)
        cstart = np.zeros(nchunks, dtype=np.int64)
        cstart[chunk_of[newc]] = np.where(newc)[0]
        slot = np.arange(e) - cstart[chunk_of]
        chunk_tile = tile[newc]                            # [C_real]
        chunk_blk = chunk_tile // group                    # [C_real]
        # group chunks G-per-step inside each destination block: pad each
        # block's chunk count to a multiple of G with no-op chunks
        ub, inv = np.unique(chunk_blk, return_inverse=True)
        nb = np.bincount(inv)
        mb = -(-nb // group) * group
        off = np.concatenate([[0], np.cumsum(mb)[:-1]])
        first_chunk = np.zeros(len(ub), dtype=np.int64)
        newb = np.empty(nchunks, dtype=bool)
        newb[0] = True
        np.not_equal(inv[1:], inv[:-1], out=newb[1:])
        first_chunk[inv[newb]] = np.where(newb)[0]
        chunk_pos = off[inv] + (np.arange(nchunks) - first_chunk[inv])
        c_cap = int(mb.sum())
        gcols = np.full(c_cap * 128, pad_col, dtype=np.int32)
        local = np.full((c_cap, 128), _SENTINEL, dtype=np.int32)
        lt = np.zeros(c_cap, dtype=np.int32)
        pos_e = chunk_pos[chunk_of]
        gcols[pos_e * 128 + slot] = cols.astype(np.int32)
        local[pos_e, slot] = (rows & 127).astype(np.int32)
        # pad slots re-fetch their chunk's FIRST row instead of a fixed
        # far-away pad row: the padding gathers are real HBM reads
        # (24-36% of the gather stream on low-fill graphs) and a repeat
        # of an already-open page is far cheaper than a cold row.  The
        # sentinel local row zeroes their one-hot contribution either
        # way, so any index is correct.  Chunks with no real edge (the
        # per-block group padding) keep pad_col.
        gv = gcols.reshape(c_cap, 128)
        csz = np.bincount(pos_e, minlength=c_cap)
        padm = np.arange(128)[None, :] >= csz[:, None]
        gv[:] = np.where(padm, gv[:, :1], gv)
        lt[chunk_pos] = (chunk_tile % group).astype(np.int32)
        # padding chunks inside a block keep lt=0 (their one-hot is zero)
        blk = np.repeat(ub, mb // group).astype(np.int32)
        s_steps = c_cap // group
        s_pad = -(-s_steps // 8) * 8
        local2 = np.full((s_pad, group * 128), _SENTINEL, dtype=np.int32)
        local2[:s_steps] = local.reshape(s_steps, group * 128)
        local = local2
    else:
        c_cap = group
        gcols = np.full(c_cap * 128, pad_col, dtype=np.int32)
        local = np.full((8, group * 128), _SENTINEL, dtype=np.int32)
        lt = np.zeros(c_cap, dtype=np.int32)
        blk = np.zeros(1, dtype=np.int32)
    return gcols, local, blk, lt, group


def build_bstream(rows: np.ndarray, cols: np.ndarray, padded_rows: int,
                  pad_col: int, group: int = 0, chunk_edges: int = 128
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """BLOCK-wide chunking for the streamed merge (round-3 low-density
    fix).  ``build_dstream``'s chunks are destination-TILE-pure, so at
    low edges-per-tile the gather stream inflates ~1/fill with padding
    rows (measured 2.2x on the RD stand-in at 59 edges/tile,
    artifacts/round3_hw.jsonl).  Here a chunk only breaks at G*128-row
    destination BLOCK boundaries — fill recovers (each block pads at
    most one partial chunk) and the kernel routes each chunk with ONE
    taller one-hot dot [G*128, 128] instead of G tile dots.  The extra
    MXU work is idle capacity in this regime (the spill population is
    gather-bound).

    ``chunk_edges`` (round 5, 128-multiple): edges per chunk.  Wider
    chunks amortize the ~400 ns per-grid-step fixed cost of the merge
    kernel over more edges (RD's 24k 128-edge chunks carried ~11.6 ms
    of pure step overhead); the lane merge (kernels/tspill.py
    tbstream_merge) consumes any width.  The row-path kernels
    (_bstream_kernel) remain 128-edge only — callers of those keep the
    default.

    Returns (gcols [C*chunk_edges] int32 take indices (pad ``pad_col``);
    local [ceil(C/8)*8, chunk_edges] int32 — dst row within its
    G*128-row block, sentinel G*128; blk [C] int32 — destination block
    per chunk, nondecreasing; group).  One grid step per chunk.
    """
    if not group:
        group = pick_group(padded_rows)
    bw = int(chunk_edges)
    assert bw % 128 == 0 and bw > 0, bw
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    e = len(rows)
    span = group * 128
    sent = span
    if e:
        assert rows.max() < padded_rows, (rows.max(), padded_rows)
        blko = rows // span
        new_b = np.empty(e, dtype=bool)
        new_b[0] = True
        np.not_equal(blko[1:], blko[:-1], out=new_b[1:])
        bseg = np.cumsum(new_b) - 1
        bstart = np.zeros(bseg[-1] + 1, dtype=np.int64)
        bstart[bseg[new_b]] = np.where(new_b)[0]
        within = np.arange(e) - bstart[bseg]
        newc = new_b | (within % bw == 0)
        chunk_of = np.cumsum(newc) - 1
        c = int(chunk_of[-1]) + 1
        cstart = np.zeros(c, dtype=np.int64)
        cstart[chunk_of[newc]] = np.where(newc)[0]
        slot = np.arange(e) - cstart[chunk_of]
        gcols = np.full(c * bw, pad_col, dtype=np.int32)
        lpad = -(-c // 8) * 8
        local = np.full((lpad, bw), sent, dtype=np.int32)
        gcols[chunk_of * bw + slot] = cols.astype(np.int32)
        local[chunk_of, slot] = (rows % span).astype(np.int32)
        blk = blko[newc].astype(np.int32)
        # pad slots re-fetch the chunk's first row (see build_dstream):
        # repeat-page gathers are much cheaper than a cold pad row, and
        # the sentinel local zeroes their contribution regardless
        gv = gcols.reshape(c, bw)
        csz = np.bincount(chunk_of, minlength=c)
        padm = np.arange(bw)[None, :] >= csz[:, None]
        gv[:] = np.where(padm, gv[:, :1], gv)
    else:
        c = 1
        gcols = np.full(c * bw, pad_col, dtype=np.int32)
        local = np.full((8, bw), sent, dtype=np.int32)
        blk = np.zeros(1, dtype=np.int32)
    return gcols, local, blk, group


def build_dstream_ranges(rows: np.ndarray, cols: np.ndarray,
                         padded_rows: int, pad_col: int,
                         num_ranges: int, range_rows: int,
                         group: int = 0):
    """Column-range-blocked dstream layout (round-3 spill gather fix).

    Hardware motivation (artifacts/round3_hw.jsonl take_vs_table probe,
    v5e): XLA's random row gather rate degrades with the SOURCE TABLE
    footprint — 3.9 ns/row from a 102 MB table vs 8.6 ns/row from
    1.23 GB (and ~19 ns/row measured end-to-end on the RD stand-in's
    ~0.5 GB activation) — a page-locality latency wall, not bandwidth.
    Splitting the spill edges by COLUMN range and gathering each range
    from a materialized contiguous slice of X restores the small-table
    rate; the merges chain through the same aliased output (dstream is
    additive), so correctness is unchanged.  Reference analog: the
    CUDA-core path's L2 captures exactly this locality on GPU
    (hybrid_all_kernel.cu:964-1036, report §IV-B).

    Edges must arrive dst-sorted (CSR order); the stable column-range
    partition preserves that within each range.  Range p gathers from
    ``x[r0_p : r0_p + range_rows]`` with ``r0_p = min(p*range_rows,
    padded_rows - range_rows)`` (the last range rebases against the
    clamped start).  Returns (gcols, local, blk, lt, group, meta) with
    the per-range arrays concatenated and ``meta`` holding the static
    slice table: dict(r0 [P], steps [P+1], chunks [P+1], lrows [P+1],
    range_rows).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if not group:
        group = pick_group(padded_rows)
    r0s, g_l, l_l, b_l, t_l = [], [], [], [], []
    steps = [0]
    chunks = [0]
    lrows = [0]
    for p in range(num_ranges):
        r0 = min(p * range_rows, max(padded_rows - range_rows, 0))
        c0, c1 = p * range_rows, (p + 1) * range_rows
        if p == num_ranges - 1:
            c1 = max(c1, padded_rows, int(cols.max()) + 1 if len(cols)
                     else 0)
        m = (cols >= c0) & (cols < c1)
        r0s.append(r0)
        if not m.any():
            steps.append(steps[-1])
            chunks.append(chunks[-1])
            lrows.append(lrows[-1])
            continue
        # rebase against the clamped slice start; pad_col -> range_rows
        # (clip mode keeps it in the slice, sentinel local zeroes it)
        g, l, b, t, _ = build_dstream(rows[m], cols[m] - r0, padded_rows,
                                      pad_col=range_rows, group=group)
        g_l.append(g)
        l_l.append(l)
        b_l.append(b)
        t_l.append(t)
        steps.append(steps[-1] + len(b))
        chunks.append(chunks[-1] + len(t))
        lrows.append(lrows[-1] + l.shape[0])
    if not g_l:  # no spill edges at all (callers normally gate on this)
        g, l, b, t, _ = build_dstream(rows[:0], cols[:0], padded_rows,
                                      pad_col=range_rows, group=group)
        g_l, l_l, b_l, t_l = [g], [l], [b], [t]
        steps = [0, len(b)]
        chunks = [0, len(t)]
        lrows = [0, l.shape[0]]
        r0s = [0] * max(num_ranges, 1)
    meta = dict(r0=np.asarray(r0s, dtype=np.int64),
                steps=np.asarray(steps, dtype=np.int64),
                chunks=np.asarray(chunks, dtype=np.int64),
                lrows=np.asarray(lrows, dtype=np.int64),
                range_rows=int(range_rows))
    return (np.concatenate(g_l), np.concatenate(l_l, axis=0),
            np.concatenate(b_l), np.concatenate(t_l), group, meta)


def build_mx_chunks(ucols: np.ndarray, span: int, k: int, m: int):
    """Greedy chunking of SORTED unique cols for mxgather: each chunk
    covers <= k cols whose lanes fit in a ``span`` window from a
    128-aligned slab base.  Returns (lo [C] int32 slab bases,
    rel [C, 1, k] int32 in-slab offsets (-1 pad -> zero rows),
    slot [U] int32 — each col's row in the compact [C*k, ...] table)."""
    ucols = np.asarray(ucols, dtype=np.int64)
    u = len(ucols)
    if u == 0:
        return (np.zeros(0, np.int32), np.zeros((0, 1, k), np.int32),
                np.zeros(0, np.int32))
    assert m >= span and m % 128 == 0, (m, span)  # padded lane spaces only
    los, rels = [], []
    slot = np.empty(u, dtype=np.int32)
    hi_base = ((m - span) // 128) * 128  # keep slabs 128-aligned AND in-bounds
    i = 0
    while i < u:
        base = min((int(ucols[i]) // 128) * 128, hi_base)
        j = min(i + k, int(np.searchsorted(ucols, base + span)))
        r = np.full(k, -1, dtype=np.int32)
        r[: j - i] = ucols[i:j] - base
        slot[i:j] = len(los) * k + np.arange(j - i)
        los.append(base)
        rels.append(r)
        i = j
    return (np.asarray(los, dtype=np.int32),
            np.stack(rels)[:, None, :].astype(np.int32), slot)


def pack_a_nibble(at):
    """Host-side nibble packing of transposed band blocks: uint8
    [Sb, W, bh/2] where the LOW nibble of byte j holds output row j and
    the HIGH nibble holds row j + bh/2.  The in-kernel unpack is then
    two constant shifts + one concat at a 128-lane tile boundary —
    natural output order, no per-lane variable shifts, no permutation
    of the X column space (bh = 256 -> two aligned 128-lane groups)."""
    sb, w, bh = at.shape
    h = bh // 2
    a = at.astype(np.uint8) if at.dtype != np.uint8 else at
    return (a[:, :, :h] | (a[:, :, h:] << 4)).astype(np.uint8)


def pack_a_bits(at):
    """Host-side 1-bit packing along the W (contraction) axis: uint8
    [Sb, W/8, bh] where bit g of byte row w8 holds W-row g*(W/8) + w8.
    The unpack is 8 constant shift+mask passes concatenated along
    sublanes in group order — natural W order, so the X^T columns are
    NOT permuted (only A's internal storage is grouped)."""
    sb, w, bh = at.shape
    assert w % 8 == 0, w
    g = w // 8
    a = at.astype(np.uint8) if at.dtype != np.uint8 else at
    out = np.zeros((sb, g, bh), dtype=np.uint8)
    for i in range(8):
        out |= a[:, i * g:(i + 1) * g, :] << i
    return out


def pack_a_int4(a):
    """Host-side int4 packing of the wide layout's band blocks and the tiled
    pairs' A tiles along their last (column) axis: uint8 [..., Bb/2] where
    the LOW nibble of byte j holds column 2j and the HIGH nibble column
    2j + 1, as two's-complement int4 (the reference's ``astype(jnp.int4)``
    of values in [-8, 7]; band blocks hold 0/1).  A 16-byte chunk then holds
    32 consecutive columns, which csrc/block_spmm.cu reads as stored.  This
    differs from ``pack_a_nibble``'s halves order for the transposed
    blocks."""
    a = np.asarray(a)
    if a.shape[-1] % 2:
        raise ValueError(f"an int4 row needs an even column count, got {a.shape[-1]}")
    u = a.astype(np.uint8) & 15
    return (u[..., 0::2] | (u[..., 1::2] << 4)).astype(np.uint8)


def unpack_a_int4(p):
    """The int8 blocks [..., 2 * last] that ``pack_a_int4`` stored, each
    nibble sign-extended."""
    p = np.asarray(p, dtype=np.uint8)
    lo, hi = (p & 15).astype(np.int8), (p >> 4).astype(np.int8)
    out = np.stack([lo, hi], axis=-1).reshape(p.shape[:-1] + (2 * p.shape[-1],))
    return ((out ^ 8) - 8).astype(np.int8)
