"""The normalised wide operator D^-1/2 A D^-1/2 with D^-1/2 applied inside
the kernels (``WideLayout.folds_scale``: the band kernel's scaled mode, the
row merge's scaled form, the take path's scaled gathers) against the
composed form the operator runs elsewhere: ``X * D^-1/2``, the unscaled
SpMM, ``* D^-1/2``, differentiated by autograd.  Outputs and input
gradients agree within the wide kernels' tolerance (tests/test_torch_wide.py
``TOL``): the folded FMA rounds once where the composed form rounds twice.

The plans cover two band buckets (bucket mode scales its blocks by their
superwindows' rows), a missing superwindow, the row merge in block form,
tile form, column ranges and the compact table, with long and short
segments, the take path, and int4 band blocks.  ``spmm.scale_folded``
counts one a SpMM in the wide layout and none in the tband layout.

This file imports no JAX, so that its ``cuda`` tests, the same comparisons
on the card (CUDA kernels, scaled and unscaled, against their plain
versions and the composed form), run there:

    python -m pytest --noconftest tests/test_torch_fold.py
"""

import numpy as np
import pytest
import torch

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.format.streams import build_bstream, build_dstream, pack_a_int4
from hcspmm_tpu_torch.graphs import io
from hcspmm_tpu_torch.kernels import block_spmm, dstream
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

_GRAPHS = {}


def make_op(name, dtype="float32", device="cpu"):
    graph, fields, _ = PLANS[name]
    if graph not in _GRAPHS:
        _GRAPHS[graph] = graph()
    rp, ci, nn = _GRAPHS[graph]
    return HybridSpMM(rp, ci, nn, PlanConfig(compute_dtype=dtype, **WIDE, **fields),
                      normalize=True, device=device)


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


def check_against_composed(name, dtype, device):
    op = make_op(name, dtype, device)
    check_shape(op, PLANS[name][2])
    gen = torch.Generator().manual_seed(7)
    n = op.plan.num_nodes
    x = torch.randn((n, 40), generator=gen).to(device)
    cot = torch.randn((n, 40), generator=gen).to(device)
    (out, gx), (want, want_gx) = folded_and_composed(op, x, cot)
    assert out.dtype == want.dtype == gx.dtype == DTYPES[dtype]
    tol = TOL[DTYPES[dtype]]
    assert rel_err(out, want) < tol
    assert rel_err(gx, want_gx) < tol
    # the closure: pad rows and columns stay zero
    full = op.apply_padded(op.arrays, op.pad_input(x))
    assert not full[n:].any() and not full[:, 40:].any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(PLANS))
def test_folded_scale_equals_the_composed_form(name, dtype):
    check_against_composed(name, dtype, "cpu")


def test_folded_scale_matches_the_dense_oracle():
    """The folded operator is D^-1/2 A D^-1/2 X, held against float64."""
    op = make_op("block")
    rp, ci, n = _GRAPHS[PLANS["block"][0]]
    a = np.zeros((n, n))
    for r in range(n):
        a[r, ci[rp[r]: rp[r + 1]]] = 1.0
    inv = 1.0 / np.sqrt(np.maximum(a.sum(1), 1.0))
    x = np.random.RandomState(3).randn(n, 24)
    got = op.unpad_output(op.apply_padded(op.arrays, op.pad_input(torch.from_numpy(x).float())), 24)
    want = inv[:, None] * (a @ (inv[:, None] * x))
    assert rel_err(got, torch.from_numpy(want)) < 1e-5


def test_tiled_tband_and_row_layouts_keep_the_scale_nodes():
    """Only the wide padded path on plans that are not tiled folds: the
    tiled band, the tband layout and the row layout scale around the SpMM,
    and the band wrapper refuses a scale on a tiled plan."""
    rp, ci, nn = small_graph(300, 6)
    tiled = HybridSpMM(rp, ci, nn, PlanConfig(**dict(WIDE, band_impl="tiled", band_h=128)),
                       normalize=True, device="cpu")
    tb = HybridSpMM(rp, ci, nn, PlanConfig(impl="pallas", band_impl="tband", band_h=128,
                                           band_widths=(128,)), normalize=True, device="cpu")
    for op in (tiled, tb):
        assert op.supports_padded and not op.layout.folds_scale
        assert op.layout._agg == op.layout._scaled and op.rows._agg == op.rows._scaled
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
    assert names.count("spmm.scale") == 6
    assert "spmm.scale_folded" not in profiling.counters()
    profiling.reset()


@pytest.mark.parametrize("band_impl", ["wide", "tband"])
def test_scale_folded_counts_each_spmm_of_a_gcn_step(band_impl):
    """``spmm.scale_folded``: two a layer a step (its forward and its
    backward SpMM) in the wide layout, none in the tband layout."""
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
    assert got == (2 * layers * 2 if band_impl == "wide" else 0)


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


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/block_spmm.cu and csrc/dstream.cu have no "
                    "CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(PLANS))
def test_cuda_folded_scale_equals_the_composed_form(name, dtype):
    _need_cuda()
    check_against_composed(name, dtype, "cuda")


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
