"""The merges' destination segment tables and the lane merge's composed
columns (hcspmm_tpu_torch/kernels/dstream.py ``row_segments``,
kernels/tspill.py ``lane_segments`` and ``compose_lane_src``), built from
the reference's own streams and plans on the CPU.

The CUDA merges read only the segment table (each destination's one
contiguous run of slots) and, in the lane merge, one composed column per
slot.  So each table is checked against the stream it came from: a merge
that follows the table in slot order must equal the plain versions, which
read local/blk/lt, bit for bit, and the JAX kernels (interpret mode)
within the usual tolerance (fp32 1e-5 of max|ref|, bf16 1e-2).  The
composed columns must pick exactly the columns the reference's
``segmented_gather`` gathers.  The tests marked ``cuda`` hold the kernels
against the plain versions on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcspmm_tpu.config import PlanConfig as JaxPlanConfig
from hcspmm_tpu.format.plan import build_plan as jax_build_plan
from hcspmm_tpu.kernels import dstream as jax_dstream
from hcspmm_tpu.kernels import tspill as jax_tspill
from hcspmm_tpu.kernels.dstream import build_bstream, build_dstream, build_dstream_ranges

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.format.plan import build_plan
from hcspmm_tpu_torch.kernels import dstream, tspill
from hcspmm_tpu_torch.ops.spmm import HybridSpMM

from conftest import small_graph

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def rel_err(got, ref):
    got, ref = (np.asarray(v.float().numpy() if isinstance(v, torch.Tensor) else v,
                           dtype=np.float64) for v in (got, ref))
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


def merge_edges(e, seed, mp, hub_rows=0):
    """``e`` dst-sorted edges, a third of them on a few hub rows when
    ``hub_rows`` (multi-chunk rows and tiles, long segments)."""
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, mp, e)
    if hub_rows:
        rows[: e // 3] = rng.randint(0, hub_rows, e // 3)
    return np.sort(rows), rng.randint(0, mp, e)


def check_table(table, dest, long_min):
    """``table`` is ``dest``'s run-length encoding: each destination one
    run, -1 exactly on the sentinel runs, the long list the runs of more
    than ``long_min`` slots."""
    dst, ptr, long = table
    assert ptr[0] == 0 and ptr[-1] == len(dest) and (np.diff(ptr) > 0).all()
    np.testing.assert_array_equal(np.repeat(dst, np.diff(ptr)), dest)
    real = dst[dst >= 0]
    assert len(np.unique(real)) == len(real)
    assert (np.diff(dst[dst >= 0]) > 0).all()  # sorted streams: ascending runs
    np.testing.assert_array_equal(long, np.flatnonzero((dst >= 0) & (np.diff(ptr) > long_min)))


def merge_by_segments(table, gcols, xsrc, out):
    """The row merge as csrc/dstream.cu's short path computes it: each
    segment's row read once, its slots' xsrc rows added in slot order in
    fp32, the row written once in out's dtype."""
    dst, ptr, _ = table
    acc = out.float()
    x = xsrc.float()
    for s in np.flatnonzero(dst >= 0):
        v = acc[dst[s]].clone()
        for e in range(ptr[s], ptr[s + 1]):
            v = v + x[min(int(gcols[e]), x.shape[0] - 1)]
        acc[dst[s]] = v
    return acc.to(out.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["block", "tile"])
@pytest.mark.parametrize("e", [0, 7, 2500])
def test_row_segments_follow_the_reference_streams(kind, e, dtype):
    """Block and tile form from the reference's builders: an empty stream
    (one all-sentinel chunk), a few edges, and hub rows whose runs cross
    chunks and exceed the long threshold; the tile form's group padding
    chunks are all sentinel."""
    mp, dp = 2048, 24
    rows, cols = merge_edges(e, e, mp, hub_rows=20)
    if kind == "block":
        gcols, local, blk, g = build_bstream(rows, cols, mp, pad_col=mp)
        lt, chunks = None, len(blk)
    else:
        gcols, local, blk, lt, g = build_dstream(rows, cols, mp, pad_col=mp)
        chunks = len(lt)
    dest = dstream.row_dest(local, blk, lt, g, chunks)
    assert (dest >= 0).sum() == e
    table = dstream.row_segments(local, blk, lt, g, chunks)
    check_table(table, dest, dstream._ROW_LONG)
    if e == 2500:
        assert len(table[2]) > 0  # the hub rows take the long path
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(mp, dp).astype(np.float32)).to(dtype)
    out0 = torch.from_numpy(rng.randn(mp, dp).astype(np.float32)).to(dtype)
    t = [torch.from_numpy(v.astype(np.int32)) for v in (gcols, local, blk)]
    if kind == "block":
        plain = dstream.bstream_merge_plain(*t, x, out0.clone(), group=g)
        want = jax.jit(lambda *v: jax_dstream.bstream_merge(*v, group=g))(
            gcols, local, blk, jnp.asarray(x.float().numpy()).astype(JDT[dtype]),
            jnp.asarray(out0.float().numpy()).astype(JDT[dtype]))
    else:
        plain = dstream.dstream_merge_plain(*t, torch.from_numpy(lt), x, out0.clone(), group=g)
        want = jax.jit(lambda *v: jax_dstream.dstream_merge(*v, group=g))(
            gcols, local, blk, lt, jnp.asarray(x.float().numpy()).astype(JDT[dtype]),
            jnp.asarray(out0.float().numpy()).astype(JDT[dtype]))
    got = merge_by_segments(table, gcols, x, out0.clone())
    assert torch.equal(got, plain)
    assert rel_err(got, np.asarray(want.astype(jnp.float32))) < TOL[dtype]


def test_row_segments_of_column_ranges_and_compact_tables():
    """A column-range stream with an empty middle range (one table per
    non-empty range, none for the empty one) and a ``ds_ucols`` plan: the
    segment-driven merge of every launch equals the plain dispatch bit for
    bit."""
    rng = np.random.RandomState(8)
    mp = 3 * 1024
    rows = np.sort(rng.randint(0, mp, 500))
    cols = np.concatenate([rng.randint(0, 512, 250), rng.randint(mp - 512, mp, 250)])
    gcols, local, blk, lt, g, meta = build_dstream_ranges(rows, cols, mp, pad_col=mp,
                                                          num_ranges=3, range_rows=1024)
    assert meta["steps"][2] == meta["steps"][1]

    class Plan:
        padded_rows, ds_rows, ds_group, ds_meta, ds_kind = mp, mp, g, meta, "tile"
        has_spill, ds_ucols = True, None

    host = dict(ds_gcols=gcols, ds_local=local, ds_blk=blk, ds_lt=lt)
    extra = dstream.check_row_spill_arrays(host, Plan)
    assert tspill.segments_of(extra, "ds_seg1") is None
    x = torch.from_numpy(rng.randn(mp, 16).astype(np.float32))
    out0 = torch.from_numpy(rng.randn(mp, 16).astype(np.float32))
    want = dstream.dstream_spill({k: torch.from_numpy(v) for k, v in host.items()}, x,
                                 out0.clone(), Plan)
    got = out0.clone()
    for p, (s0, s1, c0, c1, l0, l1) in enumerate(dstream._ranges(meta)):
        if s1 == s0:
            continue
        table = tspill.segments_of(extra, f"ds_seg{p}")
        check_table(table, dstream.row_dest(local[l0:l1], blk[s0:s1], lt[c0:c1], g, c1 - c0),
                    dstream._ROW_LONG)
        r0 = max(min(int(meta["r0"][p]), mp - 1024), 0)
        got = merge_by_segments(table, gcols[c0 * 128: c1 * 128], x[r0: r0 + 1024], got)
    assert torch.equal(got, want)

    hubs = np.sort(rng.choice(4096, 40, replace=False))
    rows = np.sort(rng.randint(0, 4096, 3000))
    gcols, local, blk, g = build_bstream(rows, hubs[rng.randint(0, 40, 3000)], 4096,
                                         pad_col=4096)
    ucols = np.unique(gcols[gcols < 4096])
    host = dict(ds_gcols=np.searchsorted(ucols, gcols).astype(np.int32), ds_local=local,
                ds_blk=blk, ds_lt=np.zeros(0, np.int32), ds_ucols=ucols.astype(np.int32))

    class UPlan:
        padded_rows, ds_rows, ds_group, ds_meta, ds_kind = 4096, 4096, g, None, "block"
        has_spill = True

    table = tspill.segments_of(dstream.check_row_spill_arrays(host, UPlan), "ds_seg")
    check_table(table, dstream.row_dest(local, blk, None, g, len(blk)), dstream._ROW_LONG)
    x = torch.from_numpy(rng.randn(4096, 16).astype(np.float32))
    out0 = torch.from_numpy(rng.randn(4096, 16).astype(np.float32))
    want = dstream.dstream_spill({k: torch.from_numpy(v) for k, v in host.items()}, x,
                                 out0.clone(), UPlan)
    got = merge_by_segments(table, host["ds_gcols"], x[torch.from_numpy(ucols).long()],
                            out0.clone())
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["block", "tile", "lane"])
def test_segment_check_refuses_a_row_named_twice(kind):
    """A hand-broken stream whose slots name one destination in two
    separate runs: two owners would race, so the host check raises."""
    mp = 2048
    rows, cols = merge_edges(300, 1, mp)
    if kind == "lane":
        _, local, blk, g = build_bstream(rows, cols, mp, pad_col=mp, chunk_edges=256)
    elif kind == "block":
        _, local, blk, g = build_bstream(rows, cols, mp, pad_col=mp)
    else:
        _, local, blk, lt, g = build_dstream(rows, cols, mp, pad_col=mp)
    local = local.copy()
    flat = local.reshape(-1)
    sentinel = 128 if kind == "tile" else g * 128
    width = 256 if kind == "lane" else 128  # slots a chunk
    i = np.flatnonzero((flat[:-2] < sentinel) & (flat[1:-1] != flat[:-2])
                       & (flat[1:-1] < sentinel) & (flat[2:] < sentinel)
                       & (np.arange(len(flat) - 2) % width <= width - 3))[0]
    flat[i + 2] = flat[i]  # row A, row B, row A
    with pytest.raises(ValueError, match="two runs"):
        if kind == "lane":
            tspill.lane_segments(local, blk, g)
        elif kind == "block":
            dstream.row_segments(local, blk, None, g, len(blk))
        else:
            dstream.row_segments(local, blk, lt, g, len(lt))


TINY_CAPS = dict(impl="pallas", band_impl="tband", band_h=128, band_widths=(128,),
                 band_mode="auto", ts_table_mb=1e-3, ts_span=256, ts_k=32,
                 ts2_table_mb=48 * 64 / 1e6)
LANE_PLANS = {
    "t1_t2": (lambda: small_graph(1400, 9, span=1300), TINY_CAPS),
    "hub_split": (lambda: small_graph(1400, 9, span=1300),
                  dict(TINY_CAPS, spill_hub_mb=64 * 64 / 1e6, spill_hub_min_cov=0.01,
                       spill_hub_min_reuse=0.0)),
    "no_t1": (lambda: small_graph(500, 8, span=400),
              dict(impl="pallas", band_impl="tband", band_h=128, band_widths=(128,),
                   band_mode="auto")),
}


@pytest.mark.parametrize("name", sorted(LANE_PLANS))
def test_lane_src_picks_the_columns_segmented_gather_takes(name):
    """``ds_lsrc`` against the reference's gather: T1 + T2 (composed through
    the pieces and segment parts), the hub-split plan's cold stream, and a
    plan with neither (``ds_laneg`` into X^T itself)."""
    graph, fields = LANE_PLANS[name]
    rp, ci, nn = graph()
    plan = build_plan(rp, ci, nn, PlanConfig(**fields))
    jplan = jax_build_plan(rp, ci, nn, JaxPlanConfig(**fields))
    host = plan.device_arrays(dense_band=False)
    extra = tspill.check_spill_arrays(host, plan)
    lsrc = extra["ds_lsrc"]
    bw = plan.ds_tlocal.shape[1]
    assert lsrc.dtype == np.int32 and lsrc.shape == (len(plan.ds_lblk) * bw,)
    if name == "no_t1":
        assert plan.ts_lo is None and not plan.ts2_segs
        np.testing.assert_array_equal(lsrc, plan.ds_laneg)
        return
    assert plan.ts_lo is not None and len(plan.ts2_segs) > 1
    if name == "hub_split":
        assert plan.hub_lo is not None and tspill.segments_of(extra, "ds_h_lseg") is not None
    t1w = tspill.mx_width(len(plan.ts_lo), plan.ts_rel.shape[2])
    t1 = np.random.RandomState(0).randn(16, t1w).astype(np.float32)
    want = np.asarray(jax.jit(lambda t, r, g: jax_tspill.segmented_gather(
        t, r, g, jplan.ts2_segs, jplan.ts2_pieces, bw=bw))(
        jnp.asarray(t1), jnp.asarray(jplan.ts2_ranks), jnp.asarray(jplan.ds_laneg)))
    np.testing.assert_array_equal(t1[:, lsrc], want)
    port = tspill.segmented_gather(torch.from_numpy(t1), torch.from_numpy(plan.ts2_ranks),
                                   torch.from_numpy(plan.ds_laneg), plan.ts2_segs,
                                   plan.ts2_pieces, bw=bw)
    np.testing.assert_array_equal(t1[:, lsrc], port.numpy())
    with pytest.raises(ValueError, match="ts2_ranks"):
        tspill.check_spill_arrays(dict(host, ts2_ranks=np.full_like(plan.ts2_ranks, 1 << 20)),
                                  plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bw", [128, 512])
def test_tbstream_merge_with_gidx_matches_the_jax_take_then_merge(bw, dtype):
    """``tbstream_merge(src, ..., gidx=)`` (the take folded in) against the
    JAX package's take followed by its merge, and the lane segment table
    against the stream; a merge that follows the table equals the plain
    version bit for bit."""
    rng = np.random.RandomState(bw)
    dt, m, e, srcw = 8, 4096, 2200, 3000
    rows = np.sort(np.concatenate([rng.randint(0, m, e - 300), rng.randint(0, 10, 300)]))
    gidx_e = rng.randint(0, srcw, e)
    _, local, blk, g = build_bstream(rows, np.arange(e), m, pad_col=e, group=4, chunk_edges=bw)
    gidx = np.zeros(len(blk) * bw, np.int32)  # pad slots: any column inside src
    real = local[: len(blk)].reshape(-1) < g * 128
    gidx[real] = gidx_e
    src = rng.randn(dt, srcw).astype(np.float32)
    buf = rng.randn(dt, m).astype(np.float32)
    jd = JDT[dtype]
    want = jax.jit(lambda s, i, lo, b, bu: jax_tspill.tbstream_merge(
        jnp.take(s, i, axis=1), lo, b, bu, group=g))(
        jnp.asarray(src).astype(jd), jnp.asarray(gidx), jnp.asarray(local), jnp.asarray(blk),
        jnp.asarray(buf).astype(jd))
    t_src, t_buf = (torch.from_numpy(v).to(dtype) for v in (src, buf))
    t = [torch.from_numpy(v.astype(np.int32)) for v in (local, blk)]
    got = tspill.tbstream_merge(t_src, *t, t_buf.clone(), group=g, gidx=torch.from_numpy(gidx))
    assert rel_err(got, np.asarray(want.astype(jnp.float32))) < TOL[dtype]
    assert torch.equal(got, tspill.tbstream_merge_plain(
        t_src.index_select(1, torch.from_numpy(gidx).long()), *t, t_buf.clone(), group=g))
    table = tspill.lane_segments(local, blk, g)
    check_table(table, tspill.lane_dest(local, blk, g), tspill._LANE_LONG)
    assert len(table[2]) > 0  # the 10 hub lanes take the long path
    dst, ptr, _ = table
    acc = t_buf.float()
    for s in np.flatnonzero(dst >= 0):
        v = acc[:, dst[s]].clone()
        for k in range(ptr[s], ptr[s + 1]):
            v = v + t_src[:, gidx[k]].float()
        acc[:, dst[s]] = v
    assert torch.equal(acc.to(dtype), got)


def test_hybrid_spmm_without_a_device_needs_a_card(monkeypatch):
    """No device means the CUDA device: without one the operator raises and
    names the way to run on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rp, ci, nn = small_graph(200, 6)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        HybridSpMM(rp, ci, nn)
    assert HybridSpMM(rp, ci, nn, device="cpu").device == torch.device("cpu")


# ---------------------------------------------------------------------------
# the CUDA merges against their plain versions (on a card only)
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/dstream.cu and csrc/tspill.cu have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dp", [24, 256, 520])
@pytest.mark.parametrize("kind", ["block", "tile"])
def test_cuda_row_merge_matches_plain_and_repeats(kind, dp, dtype):
    _need_cuda()
    mp = 4096
    rows, cols = merge_edges(6000, dp, mp, hub_rows=40)
    if kind == "block":
        gcols, local, blk, g = build_bstream(rows, cols, mp, pad_col=mp)
        arrs, fn, plain = (gcols, local, blk), dstream.bstream_merge, dstream.bstream_merge_plain
    else:
        gcols, local, blk, lt, g = build_dstream(rows, cols, mp, pad_col=mp)
        arrs = (gcols, local, blk, lt)
        fn, plain = dstream.dstream_merge, dstream.dstream_merge_plain
    t = [torch.from_numpy(v.astype(np.int32)).cuda() for v in arrs]
    x = torch.randn(mp, dp, device="cuda").to(dtype)
    out0 = torch.randn(mp, dp, device="cuda").to(dtype)
    before = dstream.launches[fn.__name__]
    got = fn(*t, x, out0.clone(), group=g)
    again = fn(*t, x, out0.clone(), group=g)
    torch.cuda.synchronize()
    assert dstream.launches[fn.__name__] == before + 2
    assert torch.equal(got, again)
    assert rel_err(got.cpu(), plain(*t, x, out0.clone(), group=g).cpu()) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_gidx", [False, True])
def test_cuda_lane_merge_matches_plain_and_repeats(with_gidx, dtype):
    _need_cuda()
    rng = np.random.RandomState(5)
    dt, m, e, srcw = 48, 16384, 6000, 9000
    rows = np.sort(np.concatenate([rng.randint(0, m, e - 600), rng.randint(0, 30, 600)]))
    _, local, blk, g = build_bstream(rows, np.arange(e), m, pad_col=e, group=8, chunk_edges=256)
    gidx = torch.from_numpy(rng.randint(0, srcw, len(blk) * 256).astype(np.int32)).cuda()
    t = [torch.from_numpy(v.astype(np.int32)).cuda() for v in (local, blk)]
    src = torch.randn(dt, srcw if with_gidx else len(blk) * 256, device="cuda").to(dtype)
    buf = torch.randn(dt, m, device="cuda").to(dtype)
    kw = dict(group=g, gidx=gidx if with_gidx else None)
    got = tspill.tbstream_merge(src, *t, buf.clone(), **kw)
    again = tspill.tbstream_merge(src, *t, buf.clone(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = tspill.tbstream_merge_plain(src, *t, buf.clone(), **kw)
    assert rel_err(got.cpu(), ref.cpu()) < TOL[dtype]


@pytest.mark.cuda
def test_cuda_hybrid_spmm_defaults_to_the_card():
    _need_cuda()
    rp, ci, nn = small_graph(200, 6)
    op = HybridSpMM(rp, ci, nn)
    assert op.device.type == "cuda" and op.arrays["f"]["band0_start"].is_cuda
