"""The normalised padded operators D^-1/2 A D^-1/2 with D^-1/2 applied
inside the kernels (``folds_scale``) against the composed form the operator
runs elsewhere: ``X * D^-1/2``, the unscaled SpMM, ``* D^-1/2``,
differentiated by autograd.  Outputs and input gradients agree within the
wide kernels' tolerance (tests/test_torch_wide.py ``TOL``): the folded sums
round once where the composed form rounds twice.

The wide layout (``WideLayout``: the band kernel's scaled mode, the row
merge's scaled form, the take path's scaled gathers): plans with two band
buckets (bucket mode scales its blocks by their superwindows' rows), a
missing superwindow, the row merge in block form, tile form, column ranges
and the compact table, with long and short segments, the take path, and
int4 band blocks.  The tband layout (``TbandLayout``: tband_kernel's scaled
mode, the lane spill chain's scaled gathers and merges, or the row layout's
scaled spill on the legacy path): plans with hub + T1 + T2 tables, T1
alone, no T1 (the cold merge reads X^T itself, scaled by its columns), a
missing superwindow, two band buckets, A_t packed at 2 and 8, and the
legacy row merge and take path.  ``spmm.scale_folded`` counts one a SpMM in
both layouts.

This file imports no JAX, so that its ``cuda`` tests, the same comparisons
on the card (CUDA kernels, scaled and unscaled, against their plain
versions and the composed form), run there:

    python -m pytest --noconftest tests/test_torch_fold.py
"""

import numpy as np
import pytest
import torch

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.format.streams import (build_bstream, build_dstream, pack_a_bits,
                                              pack_a_int4, pack_a_nibble)
from hcspmm_tpu_torch.graphs import io
from hcspmm_tpu_torch.kernels import block_spmm, dstream, tband, tspill
from hcspmm_tpu_torch.models.net import Net, init_net_params
from hcspmm_tpu_torch.ops.spmm import HybridSpMM
from hcspmm_tpu_torch.train.loop import layout_input, make_train_step
from hcspmm_tpu_torch.utils import profiling

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
WIDE = dict(impl="pallas", band_impl="wide")
SPILL = dict(band_h=128, band_widths=(128,), band_mode="auto")


def small_graph(n, deg, seed=0, span=16):
    src, dst, nn = io.synthetic_graph(n, deg, seed=seed, span=span)
    rp, ci = io.to_csr(src, dst, nn)
    return rp, ci, nn


def edges_graph(n, *pairs):
    """A symmetric CSR graph of ``n`` nodes from (src, dst) arrays."""
    src = np.concatenate([p[0] for p in pairs] + [p[1] for p in pairs]).astype(np.int32)
    dst = np.concatenate([p[1] for p in pairs] + [p[0] for p in pairs]).astype(np.int32)
    rp, ci = io.to_csr(src, dst, n)
    return rp, ci, n


def random_graph():
    """Sparse random edges: one superwindow no band entry covers."""
    rs = np.random.RandomState(5120)
    return edges_graph(4096, (rs.randint(0, 4096, 1024), rs.randint(0, 4096, 1024)))


def hub_rows_graph():
    """Banded local edges plus 20000 edges between 100 hub rows and random
    columns: merge segments of hundreds of slots beside short ones."""
    rs = np.random.RandomState(2)
    a = np.arange(4096).repeat(3)
    b = np.clip(a + rs.randint(-30, 31, a.size), 0, 4095)
    return edges_graph(4096, (a, b), (rs.randint(0, 100, 20000), rs.randint(0, 4096, 20000)))


def hub_cols_graph():
    """Local band edges plus directed edges onto 64 hub columns: a spill
    onto few columns (the compact table's regime)."""
    rng = np.random.RandomState(0)
    src = rng.randint(0, 4096, 12000)
    dst = (src + rng.randint(1, 48, 12000)) % 4096
    hubs = rng.choice(4096, 64, replace=False)
    src_h, dst_h = rng.randint(0, 4096, 9000), hubs[rng.randint(0, 64, 9000)]
    rp, ci = io.to_csr(np.concatenate([src, dst, src_h]).astype(np.int32),
                       np.concatenate([dst, src, dst_h]).astype(np.int32), 4096)
    return rp, ci, 4096


#: name -> (graph, PlanConfig fields, what the plan must have)
PLANS = {
    "two_buckets": (lambda: small_graph(300, 6),
                    dict(band_h=64, band_widths=(128, 256), band_mode="always"), "buckets"),
    "missing_sw": (random_graph, SPILL, "missing"),
    "block": (lambda: small_graph(500, 8, span=400), dict(SPILL, ds_kind="block"), "long"),
    "tile": (lambda: small_graph(500, 8, span=400), dict(SPILL, ds_kind="tile"), "long"),
    "take": (lambda: small_graph(500, 8, span=400), dict(SPILL, ds_kind="take"), "take"),
    "hub_block": (hub_rows_graph, dict(band_h=128, band_widths=(256,), band_mode="auto",
                                       ds_kind="block"), "long"),
    "ranges": (hub_rows_graph, dict(band_h=128, band_widths=(256,), band_mode="auto",
                                    ds_table_mb=0.6, ds_blocked_min_edges=1, ds_kind="tile"),
               "ranges"),
    "ucols": (hub_cols_graph, dict(band_widths=(384,), band_mode="auto", ds_table_mb=0.2,
                                   ds_blocked_min_edges=0), "ucols"),
    "int4": (lambda: small_graph(500, 8, span=400), dict(SPILL, ds_kind="block", a_dtype="int4"),
             "int4"),
}

TBAND = dict(impl="pallas", band_impl="tband", band_h=128, band_widths=(128,),
             band_mode="auto")
TBAND_T1 = dict(TBAND, ts_table_mb=1e-3, ts_span=256, ts_k=32)
TBAND_HUB = dict(TBAND_T1, ts2_table_mb=48 * 64 / 1e6, spill_hub_mb=64 * 64 / 1e6,
                 spill_hub_min_cov=0.01, spill_hub_min_reuse=0.0)


def lane_graph():
    """Local edges reaching far: the tband plan's spill needs the T1 and T2
    tables and, with the hub caps, a hub stream."""
    return small_graph(1400, 9, span=1300)


#: the tband layout's plans: name -> (graph, PlanConfig fields, what it must have)
TBAND_PLANS = {
    "hub_t1_t2": (lane_graph, TBAND_HUB, "hub"),
    "t1_only": (lane_graph, TBAND_T1, "t1"),
    "no_t1": (lambda: small_graph(500, 8, span=400), TBAND, "no_t1"),
    "missing_sw": (random_graph, TBAND, "missing"),
    "two_buckets": (lambda: small_graph(700, 10, span=500), dict(TBAND, band_widths=(128, 256)),
                    "buckets"),
    "pack2": (lane_graph, dict(TBAND_HUB, tband_pack=2), "hub"),
    "pack8": (lane_graph, dict(TBAND_HUB, tband_pack=8), "hub"),
    "row_merge": (lambda: small_graph(500, 8, span=400),
                  dict(TBAND, spill_lane="off", spill_impl="dstream", ds_kind="block"),
                  "row_merge"),
    "row_take": (lambda: small_graph(500, 8, span=400), dict(TBAND, spill_impl="take"), "take"),
}

_GRAPHS = {}


def graph_of(graph):
    if graph not in _GRAPHS:
        _GRAPHS[graph] = graph()
    return _GRAPHS[graph]


def make_op(name, dtype="float32", device="cpu"):
    graph, fields, _ = PLANS[name]
    return HybridSpMM(*graph_of(graph), PlanConfig(compute_dtype=dtype, **WIDE, **fields),
                      normalize=True, device=device)


def make_tband_op(name, dtype="float32", device="cpu"):
    graph, fields, what = TBAND_PLANS[name]
    op = HybridSpMM(*graph_of(graph), PlanConfig(compute_dtype=dtype, **fields),
                    normalize=True, device=device)
    check_tband_shape(op, what)
    assert op.plan.tband_pack == fields.get("tband_pack", 1)
    return op


def check_shape(op, what):
    """The plan has what its case is there to cover."""
    p, arrs = op.plan, op.arrays["f"]
    longs = [v for k, v in arrs.items() if k.startswith("ds_seg") and k.endswith("_long")]
    assert op.layout.folds_scale and op.layout._agg == op.layout._folded
    if what == "buckets":
        assert sum(len(s) > 0 for s in p.band_sw_ids) >= 2
    elif what == "missing":
        assert len(p.band_missing_sw) > 0 and p.spill_nnz > 0
    elif what == "take":
        assert p.spill_nnz > 0 and p.ds_blk is None
    elif what == "ranges":
        assert p.ds_meta is not None and any(v.numel() for v in longs)
    elif what == "ucols":
        assert p.ds_ucols is not None
    elif what == "int4":
        assert arrs["band0_a"].dtype == torch.uint8 and p.spill_nnz > 0
    if what in ("long", "ranges"):
        # long segments (a thread block each) beside short ones
        assert any(v.numel() for v in longs)
        assert p.spill_nnz > sum(int(v.numel()) for v in longs)


def check_tband_shape(op, what):
    """The tband plan has what its case is there to cover, and folds."""
    p, arrs = op.plan, op.arrays["f"]
    assert op.transposed and op.layout.folds_scale and op.layout._agg == op.layout._folded
    assert op.rows._agg == op.rows._scaled  # the row layout keeps its nodes
    assert p.spill_nnz > 0 or what == "buckets"
    lane = "ds_tlocal" in arrs
    if what == "hub":
        assert lane and "hub_lo" in arrs and "ts_lo" in arrs and p.ts2_segs
    elif what == "t1":
        assert lane and "ts_lo" in arrs and "hub_lo" not in arrs and not p.ts2_segs
    elif what == "no_t1":
        assert lane and "ts_lo" not in arrs and "hub_lo" not in arrs
    elif what == "missing":
        assert len(p.band_missing_sw) > 0 and lane
    elif what == "buckets":
        assert sum(len(s) > 0 for s in p.band_sw_ids) >= 2
    elif what == "row_merge":
        assert not lane and "ds_blk" in arrs and p.ds_rows == p.padded_rows
    elif what == "take":
        assert not lane and "ds_blk" not in arrs


def rel_err(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


def folded_and_composed(op, x, cot):
    """(output, input gradient) of the folded ``apply_padded`` and of the
    composed form, from x [N, d] with cotangent ``cot`` [N, d]."""
    arrays = op.arrays
    d = x.shape[1]

    def composed(xp):
        inv = op.layout._lanes(arrays["inv_sqrt_deg"])
        return (op.layout.raw((xp * inv).to(xp.dtype)) * inv).to(xp.dtype)

    res = []
    for fn in (lambda v: op.apply_padded(arrays, v), composed):
        xv = op.pad_input(x).requires_grad_(True)
        out = fn(xv)
        g = op.pad_input(cot).to(out.dtype)
        out.backward(g)
        res.append((op.unpad_output(out, d), op.unpad_output(xv.grad, d)))
    return res


def check_against_composed(op, dtype, d=40):
    """The folded operator's output and input gradient against the composed
    form's at TOL, and the closure of its padded layout."""
    gen = torch.Generator().manual_seed(7)
    n = op.plan.num_nodes
    x = torch.randn((n, d), generator=gen).to(op.device)
    cot = torch.randn((n, d), generator=gen).to(op.device)
    (out, gx), (want, want_gx) = folded_and_composed(op, x, cot)
    assert out.dtype == want.dtype == gx.dtype == DTYPES[dtype]
    tol = TOL[DTYPES[dtype]]
    assert rel_err(out, want) < tol
    assert rel_err(gx, want_gx) < tol
    # the closure: pad rows (lanes) and columns (feature rows) stay zero
    full = op.apply_padded(op.arrays, op.pad_input(x))
    if op.transposed:
        full = full.T
    assert not full[n:].any() and not full[:, d:].any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(PLANS))
def test_folded_scale_equals_the_composed_form(name, dtype):
    op = make_op(name, dtype)
    check_shape(op, PLANS[name][2])
    check_against_composed(op, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(TBAND_PLANS))
def test_tband_folded_scale_equals_the_composed_form(name, dtype):
    """The tband layout's folded SpMM (``spmm_tband_padded`` given
    ``row_scale``) against the composed form, forward and backward."""
    check_against_composed(make_tband_op(name, dtype), dtype, d=20)


def dense_oracle(rp, ci, n):
    """float64 (A, D^-1/2 as a vector) of a CSR graph."""
    a = np.zeros((n, n))
    for r in range(n):
        a[r, ci[rp[r]: rp[r + 1]]] = 1.0
    return a, 1.0 / np.sqrt(np.maximum(a.sum(1), 1.0))


@pytest.mark.parametrize("name", sorted(TBAND_PLANS))
def test_tband_folded_scale_matches_the_dense_oracle(name):
    """The folded tband operator is D^-1/2 A D^-1/2 X and its input
    gradient D^-1/2 A^T D^-1/2 G, held against float64."""
    op = make_tband_op(name)
    rp, ci, n = graph_of(TBAND_PLANS[name][0])
    a, inv = dense_oracle(rp, ci, n)
    rs = np.random.RandomState(3)
    x, cot = rs.randn(n, 20), rs.randn(n, 20)
    xv = op.pad_input(torch.from_numpy(x).float()).requires_grad_(True)
    out = op.apply_padded(op.arrays, xv)
    out.backward(op.pad_input(torch.from_numpy(cot).float()))
    want = inv[:, None] * (a @ (inv[:, None] * x))
    want_g = inv[:, None] * (a.T @ (inv[:, None] * cot))
    assert rel_err(op.unpad_output(out, 20), torch.from_numpy(want)) < 1e-5
    assert rel_err(op.unpad_output(xv.grad, 20), torch.from_numpy(want_g)) < 1e-5


def test_folded_scale_matches_the_dense_oracle():
    """The folded operator is D^-1/2 A D^-1/2 X, held against float64."""
    op = make_op("block")
    rp, ci, n = graph_of(PLANS["block"][0])
    a, inv = dense_oracle(rp, ci, n)
    x = np.random.RandomState(3).randn(n, 24)
    got = op.unpad_output(op.apply_padded(op.arrays, op.pad_input(torch.from_numpy(x).float())), 24)
    want = inv[:, None] * (a @ (inv[:, None] * x))
    assert rel_err(got, torch.from_numpy(want)) < 1e-5


def test_tiled_tband_and_row_layouts_keep_the_scale_nodes():
    """The tiled band and the row layout scale around the SpMM, and the
    band wrapper refuses a scale on a tiled plan; the tband layout folds,
    as the wide layout does on plans that are not tiled (its row layout
    keeps the nodes)."""
    rp, ci, nn = small_graph(300, 6)
    tiled = HybridSpMM(rp, ci, nn, PlanConfig(**dict(WIDE, band_impl="tiled", band_h=128)),
                       normalize=True, device="cpu")
    tb = HybridSpMM(rp, ci, nn, PlanConfig(impl="pallas", band_impl="tband", band_h=128,
                                           band_widths=(128,)), normalize=True, device="cpu")
    assert tiled.supports_padded and not tiled.layout.folds_scale
    assert tiled.layout._agg == tiled.layout._scaled
    assert tb.supports_padded and tb.layout.folds_scale and tb.layout._agg == tb.layout._folded
    for op in (tiled, tb):
        assert op.rows._agg == op.rows._scaled
    assert tiled.plan.tiled and tb.transposed
    xp = tiled.pad_input(torch.randn(nn, 8))
    with pytest.raises(ValueError, match="tiled"):
        block_spmm.spmm_wide_padded(dict(tiled.arrays["f"], row_scale=torch.ones(xp.shape[0])),
                                    xp, tiled.plan, torch.float32)
    wide = make_op("block")
    profiling.reset()
    with profiling.tracing():
        tiled.apply_padded(tiled.arrays, xp)
        tb.apply_padded(tb.arrays, tb.pad_input(torch.randn(nn, 8)))
        wide.apply(wide.arrays, torch.randn(wide.plan.num_nodes, 8))  # the row layout
    names = [r["name"] for r in profiling.spans() if r["name"] != profiling.CLOCK]
    assert names.count("spmm.scale") == 4  # the tiled band's two, the row layout's two
    assert profiling.counters().get("spmm.scale_folded") == 1  # the tband SpMM
    profiling.reset()


@pytest.mark.parametrize("band_impl", ["wide", "tband"])
def test_scale_folded_counts_each_spmm_of_a_gcn_step(band_impl):
    """``spmm.scale_folded``: two a layer a step (its forward and its
    backward SpMM) in the wide layout and in the tband layout."""
    layers = 3
    if band_impl == "wide":
        op = make_op("block")
    else:
        rp, ci, nn = small_graph(500, 8, span=400)
        op = HybridSpMM(rp, ci, nn, PlanConfig(impl="pallas", band_impl="tband", band_h=128,
                                               band_widths=(128,)), normalize=True,
                        device="cpu")
    net = Net(model="gcn", num_features=24, hidden=16, num_classes=5, num_layers=layers,
              dropout=0.5)
    params = init_net_params(net, torch.Generator().manual_seed(0), init="glorot",
                             device="cpu")
    step = make_train_step(net, op, torch.optim.Adam(
        [t for layer in params for t in layer.values()], lr=0.01))
    n = op.plan.num_nodes
    x = layout_input(op, torch.randn((n, 24), generator=torch.Generator().manual_seed(1)))
    y = torch.randint(0, 5, (n,), generator=torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    step(params, x, y, gen)
    profiling.reset()
    with profiling.tracing():
        for _ in range(2):
            step(params, x, y, gen)
    got = profiling.counters().get("spmm.scale_folded", 0)
    profiling.reset()
    assert got == 2 * layers * 2


# ---------------------------------------------------------------------------
# the scaled kernels' plain versions, each against its own composed form
# ---------------------------------------------------------------------------


def band_inputs(seed, sb=7, bh=32, bb=128, dp=256, m=512, trash=2):
    """Band entries with 16-aligned starts and ``trash`` capacity-padded
    entries (sw == num_sw) after a permutation of the real ones, and a
    positive scale over the m rows."""
    rng = np.random.RandomState(seed)
    a = (rng.rand(sb, bh, bb) < 0.08).astype(np.int8)
    st = (rng.randint(0, (m - bb) // 16 + 1, sb) * 16).astype(np.int32)
    sw = np.concatenate([rng.permutation(sb - trash), np.full(trash, sb - trash)]).astype(np.int32)
    x = rng.randn(m, dp).astype(np.float32)
    scale = (0.1 + rng.rand(m)).astype(np.float32)
    return [torch.from_numpy(v) for v in (a, st, sw, x, scale)]


def test_scaled_band_plain_is_the_scaled_product():
    num_sw = 5  # the scale covers the real entries' superwindows, not the padding's
    a, st, sw, x, scale = band_inputs(0, bh=32, m=num_sw * 32)
    got = block_spmm.band_bucket_spmm_direct_plain(sw, st, a, x, num_sw, torch.float32, scale)
    want = block_spmm.band_bucket_spmm_direct_plain(sw, st, a, x * scale[:, None], num_sw,
                                                    torch.float32)
    want = want * scale[: num_sw * 32].view(num_sw, 32, 1)
    assert rel_err(got, want) < 1e-6
    part = block_spmm.band_bucket_spmm_plain(st, a, x, scale, sw)
    assert torch.equal(part[:num_sw][sw[:num_sw].argsort()], got)
    assert not part[num_sw:].any()  # capacity padding: scaled by 0


@pytest.mark.parametrize("kind", ["block", "tile"])
def test_scaled_merge_plain_is_the_scaled_scatter(kind):
    mp, dp = 2048, 16
    rng = np.random.RandomState(1)
    rows = np.sort(rng.randint(0, mp, 3000))
    cols = rng.randint(0, mp, 3000)
    x = torch.from_numpy(rng.randn(mp, dp).astype(np.float32))
    out0 = torch.from_numpy(rng.randn(mp, dp).astype(np.float32))
    scale = torch.from_numpy((0.1 + rng.rand(mp)).astype(np.float32))
    if kind == "block":
        t = [torch.from_numpy(v.astype(np.int32))
             for v in build_bstream(rows, cols, mp, pad_col=mp)[:3]]
        fn = dstream.bstream_merge_plain
    else:
        t = [torch.from_numpy(v.astype(np.int32))
             for v in build_dstream(rows, cols, mp, pad_col=mp)[:4]]
        fn = dstream.dstream_merge_plain
    want = out0.double().index_add(0, torch.from_numpy(rows),
                                   (x.double() * scale.double()[:, None])[cols]
                                   * scale.double()[rows][:, None])
    got = fn(*t, x, out0.clone(), group=8, cscale=scale, rscale=scale)
    assert rel_err(got, want) < 1e-6


PACKERS = {1: lambda at: at, 2: pack_a_nibble, 8: pack_a_bits}


def tband_inputs(seed, pack=1, dt=32, w=256, bh=128, m=1024, real=5, trash=2):
    """tband_kernel's operands: ``real`` entries on distinct superwindows
    (a permutation) then ``trash`` capacity-padded ones (sw == num_sw), 0/1
    A_t blocks [Sb, W, bh] in encoding ``pack``, 128-aligned starts with st
    + W <= M, X^T [dt, M], a positive scale over the M lanes, and the
    superwindows no entry owns (``missing``); num_sw = M / bh."""
    rng = np.random.RandomState(seed)
    num_sw = m // bh
    owned = rng.permutation(num_sw)
    sw = np.concatenate([owned[:real], np.full(trash, num_sw)]).astype(np.int32)
    at = (rng.rand(real + trash, w, bh) < 0.05).astype(np.int8)
    st = (rng.randint(0, (m - w) // 128 + 1, real + trash) * 128).astype(np.int32)
    xt = rng.randn(dt, m).astype(np.float32)
    scale = (0.1 + rng.rand(m)).astype(np.float32)
    missing = np.sort(owned[real:]).astype(np.int32)
    t = [torch.from_numpy(v) for v in (sw, st, PACKERS[pack](at), xt, scale, missing)]
    return (*t, num_sw)


@pytest.mark.parametrize("pack", sorted(PACKERS))
def test_scaled_tband_plain_is_the_scaled_product(pack):
    """The band product's scaled plain versions (direct and bucket) equal
    the composed form bit for bit in fp32: X^T D, the unscaled plain
    version, each output lane times its scale; the capacity padding's
    blocks scale by 0, the missing superwindows stay zero."""
    sw, st, at, xt, scale, missing, num_sw = tband_inputs(pack, pack)
    f32 = torch.float32
    got = tband.tband_spmm_direct_plain(sw, st, at, xt, num_sw, f32, missing=missing, pack=pack,
                                        scale=scale)
    want = tband.tband_spmm_direct_plain(sw, st, at, xt * scale, num_sw, f32, missing=missing,
                                         pack=pack) * scale
    assert torch.equal(got, want)
    assert not got.view(xt.shape[0], num_sw, -1)[:, missing.long()].any()
    part = tband.tband_spmm_bucket_plain(st, at, xt, pack, scale, sw)
    bh = part.shape[1] // sw.shape[0]
    real = sw < num_sw
    blocks = part.view(xt.shape[0], -1, bh)
    assert torch.equal(blocks[:, real], got.view(xt.shape[0], num_sw, bh)[:, sw[real].long()])
    assert not blocks[:, ~real].any()


def lane_table_inputs(seed, dtype, m=2048, span=256, c=7, k=32, dt=16):
    """mxgather's operands: 128-aligned slab bases with lo + span <= M,
    offsets in [-1, span), X^T and a positive scale over the M lanes."""
    rng = np.random.RandomState(seed)
    lo = torch.from_numpy((rng.randint(0, (m - span) // 128 + 1, c) * 128).astype(np.int32))
    rel = torch.from_numpy(rng.randint(-1, span, (c, 1, k)).astype(np.int32))
    xt = torch.from_numpy(rng.randn(dt, m).astype(np.float32)).to(dtype)
    scale = torch.from_numpy((0.1 + rng.rand(m)).astype(np.float32))
    return xt, lo, rel, scale, span


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_scaled_mxgather_plain_is_the_table_of_the_scaled_lanes(dtype):
    """The scaled gather equals the gather of (X^T D) rounded to X^T's
    dtype, bit for bit; the pads stay zero."""
    xt, lo, rel, scale, _ = lane_table_inputs(1, DTYPES[dtype])
    got = tspill.mxgather_lanes_plain(xt, lo, rel, scale)
    assert got.dtype == xt.dtype
    assert torch.equal(got, tspill.mxgather_lanes_plain((xt * scale).to(xt.dtype), lo, rel))
    assert not got[:, : rel.numel()][:, (rel.reshape(-1) < 0)].any()


def lane_merge_case(name, device="cpu", dtype=torch.float32, hub=False):
    """A tband plan's cold (or hub) lane stream with its source: the
    scaled T1 (hub) table and no column scale, or X^T itself and its
    column scale (a plan with no T1); X^T, a buffer, the scale over M."""
    op = make_tband_op(name, device=device)
    arrs, p = op.arrays["f"], op.plan
    scale = op.layout._inv_sqrt.view(-1)
    gen = torch.Generator().manual_seed(11)
    xt = torch.randn((16, p.padded_rows), generator=gen).to(device, dtype)
    buf = torch.randn((16, p.padded_rows), generator=gen).to(device, dtype)
    pre = "hub" if hub else "ts"
    if f"{pre}_lo" in arrs:
        src = tspill.mxgather_lanes_plain(xt, arrs[f"{pre}_lo"], arrs[f"{pre}_rel"], scale)
        cscale = None
    else:
        src, cscale = xt, scale
    stream = (arrs["ds_h_tlocal"], arrs["ds_h_lblk"]) if hub else (arrs["ds_tlocal"],
                                                                      arrs["ds_lblk"])
    kw = dict(group=p.ds_hgroup if hub else p.ds_lgroup,
              gidx=arrs["ds_h_laneg"] if hub else arrs["ds_lsrc"])
    segs = tspill.segments_of(arrs, "ds_h_lseg" if hub else "ds_lseg")
    return src, stream, buf, scale, cscale, kw, segs


@pytest.mark.parametrize("case", ["t1", "x_itself", "hub"])
def test_scaled_lane_merge_plain_is_the_scaled_scatter(case):
    """The lane merge's scaled plain version: buf + D (sum of the slots'
    values, each times its column's scale where the merge reads X^T),
    against float64; a column scale alone is refused."""
    name = {"t1": "t1_only", "x_itself": "no_t1", "hub": "hub_t1_t2"}[case]
    src, stream, buf, scale, cscale, kw, _ = lane_merge_case(name, hub=case == "hub")
    assert (cscale is None) == (case != "x_itself")
    got = tspill.tbstream_merge_plain(src, *stream, buf.clone(), rscale=scale, cscale=cscale,
                                      **kw)
    src_c = src if cscale is None else src * cscale
    sums = tspill.tbstream_merge_plain(src_c, *stream, torch.zeros_like(buf), **kw)
    want = buf.double() + scale.double() * sums.double()
    assert rel_err(got, want) < 1e-6
    assert not torch.equal(got, buf)
    with pytest.raises(ValueError, match="row scale"):
        tspill.tbstream_merge(src, *stream, buf.clone(), cscale=scale, **kw)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/block_spmm.cu, csrc/dstream.cu, csrc/tband.cu "
                    "and csrc/tspill.cu have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(PLANS))
def test_cuda_folded_scale_equals_the_composed_form(name, dtype):
    _need_cuda()
    op = make_op(name, dtype, "cuda")
    check_shape(op, PLANS[name][2])
    check_against_composed(op, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bb", [640, 100, 1024])
def test_cuda_scaled_band_kernel_matches_plain(bb, dtype):
    """The band kernel's scaled mode (direct and bucket mode; Bb 640 and
    1024 by tensor copies, 100 by cp.async; int8 and int4 blocks) against
    its plain version, two runs bitwise equal; its unscaled mode against
    the unscaled plain version."""
    _need_cuda()
    dt = DTYPES[dtype]
    for dp in (128, 384):
        a, st, sw, x, scale = (v.cuda() for v in band_inputs(bb + dp, bh=128, bb=bb, dp=dp,
                                                              m=2048))
        num_sw = 2048 // 128
        sw = torch.where(sw == sw.max(), num_sw, sw).int()
        xv = x.to(dt)
        packed = torch.from_numpy(pack_a_int4(a.cpu().numpy())).cuda()
        for a_s in (a, packed) if bb % 8 == 0 else (a,):
            got = block_spmm.band_bucket_spmm_direct(sw, st, a_s, xv, num_sw, dt, scale)
            again = block_spmm.band_bucket_spmm_direct(sw, st, a_s, xv, num_sw, dt, scale)
            part = block_spmm.band_bucket_spmm(st, a_s, xv, scale, sw)
            plain = block_spmm.band_bucket_spmm_direct_plain(sw, st, a_s, xv, num_sw, dt, scale)
            torch.cuda.synchronize()
            own = sw < num_sw
            idx = sw[own].long()  # the other blocks are left unset
            assert torch.equal(got[idx], again[idx])
            assert rel_err(got[idx], plain[idx]) < TOL[dt]
            assert rel_err(part, block_spmm.band_bucket_spmm_plain(st, a_s, xv, scale, sw)) < 1e-5
            assert not part[~own].any()
            bare = block_spmm.band_bucket_spmm_direct(sw, st, a_s, xv, num_sw, dt)
            assert rel_err(bare[idx], block_spmm.band_bucket_spmm_direct_plain(
                sw, st, a_s, xv, num_sw, dt)[idx]) < TOL[dt]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["block", "tile"])
def test_cuda_scaled_merges_match_plain_and_are_deterministic(kind, dtype):
    _need_cuda()
    dt = DTYPES[dtype]
    mp, dp = 8192, 256
    rng = np.random.RandomState(5)
    rows = np.sort(np.concatenate([rng.randint(0, mp, 20000), np.full(3000, 77)]))
    cols = rng.randint(0, mp, rows.size)
    if kind == "block":
        arrs = build_bstream(rows, cols, mp, pad_col=mp)[:3]
        fn, plain = dstream.bstream_merge, dstream.bstream_merge_plain
    else:
        arrs = build_dstream(rows, cols, mp, pad_col=mp)[:4]
        fn, plain = dstream.dstream_merge, dstream.dstream_merge_plain
    t = [torch.from_numpy(v.astype(np.int32)).cuda() for v in arrs]
    x = torch.from_numpy(rng.randn(mp, dp).astype(np.float32)).to("cuda", dt)
    out0 = torch.from_numpy(rng.randn(mp, dp).astype(np.float32)).to("cuda", dt)
    scale = torch.from_numpy((0.1 + rng.rand(mp)).astype(np.float32)).cuda()
    got = fn(*t, x, out0.clone(), group=8, cscale=scale, rscale=scale)
    again = fn(*t, x, out0.clone(), group=8, cscale=scale, rscale=scale)
    ref = plain(*t, x, out0.clone(), group=8, cscale=scale, rscale=scale)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert rel_err(got, ref) < TOL[dt]
    bare = fn(*t, x, out0.clone(), group=8)
    assert rel_err(bare, plain(*t, x, out0.clone(), group=8)) < TOL[dt]
    for one in (dict(cscale=scale), dict(rscale=scale)):
        with pytest.raises(ValueError, match="both"):
            fn(*t, x, out0.clone(), group=8, **one)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(TBAND_PLANS))
def test_cuda_tband_folded_scale_equals_the_composed_form(name, dtype):
    _need_cuda()
    check_against_composed(make_tband_op(name, dtype, "cuda"), dtype, d=20)


@pytest.mark.cuda
@pytest.mark.parametrize("pack", sorted(PACKERS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_scaled_tband_kernel_matches_plain(dtype, pack):
    """tband_kernel's scaled mode, direct (the missing superwindows zeroed
    in the same launch) and bucket mode, against its plain version, two
    runs bitwise equal; in fp32 equal bit for bit to the composed form (X^T
    D, the unscaled kernel, times D) where no spill follows; its unscaled
    mode against the unscaled plain version."""
    _need_cuda()
    dt = DTYPES[dtype]
    for shape in (dict(dt=32, w=256, bh=128, m=1024), dict(dt=16, w=896, bh=256, m=2048),
                  dict(dt=48, w=192, bh=320, m=1280, real=3)):
        sw, st, at, xt, scale, missing, num_sw = (
            v.cuda() if torch.is_tensor(v) else v for v in tband_inputs(pack, pack, **shape))
        xv = xt.to(dt)

        def direct(s=None, x=xv):
            return tband.tband_spmm_direct(sw, st, at, x, num_sw, dt, missing=missing,
                                           pack=pack, scale=s)

        got, again = direct(scale), direct(scale)
        part = tband.tband_spmm_bucket(st, at, xv, pack, scale, sw)
        part_again = tband.tband_spmm_bucket(st, at, xv, pack, scale, sw)
        torch.cuda.synchronize()
        assert torch.equal(got, again) and torch.equal(part, part_again)
        ref = tband.tband_spmm_direct_plain(sw, st, at, xv, num_sw, dt, missing=missing,
                                            pack=pack, scale=scale)
        assert rel_err(got, ref) < TOL[dt]
        assert rel_err(part, tband.tband_spmm_bucket_plain(st, at, xv, pack, scale, sw)) < 1e-5
        bh = part.shape[1] // sw.shape[0]
        assert not part.view(xv.shape[0], -1, bh)[:, sw == num_sw].any()
        if dt == torch.float32:
            assert torch.equal(got, direct(x=xv * scale) * scale)
        bare = direct()
        assert rel_err(bare, tband.tband_spmm_direct_plain(sw, st, at, xv, num_sw, dt,
                                                           missing=missing, pack=pack)) < TOL[dt]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_scaled_mxgather_matches_plain(dtype):
    """The scaled gather equals its plain version bit for bit (a copy
    times one scale, rounded once) and two runs are bitwise equal; so does
    the unscaled one."""
    _need_cuda()
    xt, lo, rel, scale, span = (v.cuda() if torch.is_tensor(v) else v
                                for v in lane_table_inputs(2, DTYPES[dtype]))
    for s in (scale, None):
        got = tspill.mxgather_lanes(xt, lo, rel, span=span, scale=s)
        again = tspill.mxgather_lanes(xt, lo, rel, span=span, scale=s)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert torch.equal(got, tspill.mxgather_lanes_plain(xt, lo, rel, s))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["t1", "x_itself", "hub"])
def test_cuda_scaled_lane_merge_matches_plain(case, dtype):
    """The lane merge's scaled forms (from a scaled table; from X^T itself
    with its column scale) against the plain version, two runs bitwise
    equal; the unscaled form against its own."""
    _need_cuda()
    dt = DTYPES[dtype]
    name = {"t1": "t1_only", "x_itself": "no_t1", "hub": "hub_t1_t2"}[case]
    src, stream, buf, scale, cscale, kw, segs = lane_merge_case(name, "cuda", dt,
                                                                hub=case == "hub")
    for rs, cs in ((scale, cscale), (None, None)):
        got = tspill.tbstream_merge(src, *stream, buf.clone(), segs=segs, rscale=rs,
                                    cscale=cs, **kw)
        again = tspill.tbstream_merge(src, *stream, buf.clone(), segs=segs, rscale=rs,
                                      cscale=cs, **kw)
        ref = tspill.tbstream_merge_plain(src, *stream, buf.clone(), rscale=rs, cscale=cs, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert rel_err(got, ref) < TOL[dt]


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [False, True])
def test_cuda_tband_kernel_launches_from_a_fresh_thread(scaled):
    """A host thread whose first CUDA work is the band launch (its output
    from the caching allocator's free blocks, so that no runtime call has
    made a context current there, as in an autograd worker whose first node
    is the SpMM's backward) launches it and gets the main thread's result:
    the tensor maps are encoded under the device's current context."""
    import threading

    _need_cuda()
    sw, st, at, xt, scale, missing, num_sw = (
        v.cuda() if torch.is_tensor(v) else v for v in tband_inputs(5))
    s = scale if scaled else None

    def direct():
        return tband.tband_spmm_direct(sw, st, at, xt, num_sw, torch.float32, missing=missing,
                                       scale=s)

    want = direct()
    spare = direct()
    torch.cuda.synchronize()
    del spare  # a free block of the output's size for the thread's output
    res = {}

    def run():
        try:
            res["out"] = direct()
            torch.cuda.synchronize()
        except RuntimeError as e:
            res["err"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert "err" not in res, res.get("err")
    assert torch.equal(res["out"], want)
