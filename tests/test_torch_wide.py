"""The port's wide padded layout [M, dp] against the JAX package on the CPU:
the row-layout band product, the row zero-fill and the row spill merges
(hcspmm_tpu_torch/kernels/{block_spmm,tspill,dstream}.py) against their
Pallas kernels in interpret mode, then the wide ``HybridSpMM`` against the
JAX package's and the dense oracle: values and gradients in the padded and
row layouts, the GCN/GIN cores, normalized and mean aggregation, a directed
graph, every spill form (block, tile, take, column ranges, compact
columns), a partial cover, a two-bucket plan, and the gate.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
(csrc/block_spmm.cu, csrc/dstream.cu, csrc/tspill.cu) are held against the
same plain versions by the tests marked ``cuda`` and by chip_smoke.py.
Tolerance: fp32 within 1e-5 of max|ref| (the order of fp32 sums only; the
zero-fill is exact), bf16 within 1e-2 (one rounding of fp32 sums).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcspmm_tpu.config import PlanConfig as JaxPlanConfig
from hcspmm_tpu.kernels import block_spmm as jax_block_spmm
from hcspmm_tpu.kernels import dstream as jax_dstream
from hcspmm_tpu.kernels import tspill as jax_tspill
from hcspmm_tpu.ops.spmm import HybridSpMM as JaxHybridSpMM

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.format.plan import build_plan
from hcspmm_tpu_torch.format.streams import build_bstream, build_dstream, build_dstream_ranges
from hcspmm_tpu_torch.graphs import io
from hcspmm_tpu_torch.kernels import block_spmm, dstream, tspill
from hcspmm_tpu_torch.ops.spmm import HybridSpMM, spmm_reference_dense

from conftest import small_graph

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
RTOL = 1e-5
WIDE = dict(impl="pallas", band_impl="wide")


def to_np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def rel_err(got, ref):
    got, ref = (np.asarray(to_np(v), dtype=np.float64) for v in (got, ref))
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


def jx(v, dtype=torch.float32):
    """A torch tensor (or numpy array) as a JAX array; floats in ``dtype``."""
    is_float = isinstance(v, torch.Tensor) and v.is_floating_point()
    a = v.float().numpy() if is_float else np.asarray(v)
    return jnp.asarray(a).astype(JDT[dtype]) if a.dtype == np.float32 else jnp.asarray(a)


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def band_inputs(seed, sb=7, bh=32, bb=128, dp=256, m=512, trash=2):
    """Band entries with 16-aligned starts and ``trash`` capacity-padded
    entries (sw == num_sw) after a permutation of the real ones."""
    rng = np.random.RandomState(seed)
    a = (rng.rand(sb, bh, bb) < 0.08).astype(np.int8)
    st = (rng.randint(0, (m - bb) // 16 + 1, sb) * 16).astype(np.int32)
    sw = np.concatenate([rng.permutation(sb - trash), np.full(trash, sb - trash)]).astype(np.int32)
    x = rng.randn(m, dp).astype(np.float32)
    return a, st, sw, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dp", [128, 384])
def test_band_bucket_spmm_direct_matches_jax(dp, dtype):
    a, st, sw, x = band_inputs(dp, dp=dp)
    num_sw = len(sw) - 2
    want = jax_block_spmm.band_bucket_spmm_direct(
        jnp.asarray(sw), jnp.asarray(st), jnp.asarray(a), jx(x, dtype), num_sw, JDT[dtype],
        trash=True)
    xv = torch.from_numpy(x).to(dtype)
    got = block_spmm.band_bucket_spmm_direct(torch.from_numpy(sw), torch.from_numpy(st),
                                             torch.from_numpy(a), xv, num_sw, dtype)
    assert got.shape == want.shape == (num_sw, a.shape[1], dp) and got.dtype == dtype
    assert rel_err(got, np.asarray(want.astype(jnp.float32))) < TOL[dtype]
    oracle = np.einsum("sbk,skd->sbd", a.astype(np.float64),
                       to_np(xv).astype(np.float64)[st[:, None] + np.arange(a.shape[2])])
    assert rel_err(got, oracle[np.argsort(sw[:num_sw])]) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_bucket_spmm_matches_jax(dtype):
    a, st, _, x = band_inputs(11, bh=64, bb=256, dp=128, m=1024)
    want = np.asarray(jax_block_spmm.band_bucket_spmm(jnp.asarray(st), jnp.asarray(a),
                                                      jx(x, dtype)))
    got = block_spmm.band_bucket_spmm(torch.from_numpy(st), torch.from_numpy(a),
                                      torch.from_numpy(x).to(dtype))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert rel_err(got, want) < RTOL


@pytest.mark.parametrize("eight", [False, True])
def test_zero_row_blocks_matches_jax(eight):
    rng = np.random.RandomState(0)
    bh, dp = 32, 128
    w = 8 * bh if eight else bh
    buf = rng.randn(4 * 8 * bh, dp).astype(np.float32)
    ids = np.array([0, 2, 3] if eight else [0, 3, 7, 30], dtype=np.int32)
    want = np.asarray(jax_tspill.zero_row_blocks(jnp.asarray(buf), jnp.asarray(ids), w))
    t = torch.from_numpy(buf.copy())
    got = tspill.zero_row_blocks(t, torch.from_numpy(ids), w)
    assert got is t  # in place
    np.testing.assert_array_equal(got.numpy(), want)
    for i in ids:
        assert not got[i * w:(i + 1) * w].any()


def test_zero_row_blocks_empty_ids_launch_nothing():
    before = dict(tspill.launches)
    meta = torch.empty(1024, 128, device="meta")
    assert tspill.zero_row_blocks(meta, torch.zeros(0, dtype=torch.int32), 128) is meta
    buf = torch.randn(1024, 128)
    want = jax_tspill.zero_row_blocks(jnp.asarray(buf.numpy()), jnp.zeros(0, jnp.int32), 128)
    np.testing.assert_array_equal(np.asarray(want), buf.numpy())
    assert tspill.launches == before


def merge_edges(seed, e, mp, n_cols, hub_rows=64):
    """Dst-sorted edges, a third of them onto a few hub rows (multi-chunk
    blocks and tiles)."""
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, mp, e)
    rows[: e // 3] = rng.randint(0, hub_rows, e // 3)
    return np.sort(rows), rng.randint(0, n_cols, e)


def scatter_ref(out0, rows, xsrc, cols):
    ref = np.asarray(out0, dtype=np.float64).copy()
    np.add.at(ref, rows, np.asarray(xsrc, dtype=np.float64)[cols])
    return ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e", [5, 1800])
def test_bstream_merge_matches_jax(e, dtype):
    """Block form, pad_col == len(xsrc) (clip mode), an empty block range
    (rows concentrated low), multi-chunk blocks; untouched blocks keep
    out bit for bit."""
    mp, dp = 4096, 128
    rows, cols = merge_edges(e, e, mp // 2, mp)
    gcols, local, blk, g = build_bstream(rows, cols, mp, pad_col=mp)
    rng = np.random.RandomState(1)
    x = rng.randn(mp, dp).astype(np.float32)
    out0 = rng.randn(mp, dp).astype(np.float32)
    want = jax.jit(lambda *v: jax_dstream.bstream_merge(*v, group=g))(
        jnp.asarray(gcols), jnp.asarray(local), jnp.asarray(blk), jx(x, dtype), jx(out0, dtype))
    t = [torch.from_numpy(v.astype(np.int32)) for v in (gcols, local, blk)]
    xv, ov = torch.from_numpy(x).to(dtype), torch.from_numpy(out0.copy()).to(dtype)
    got = dstream.bstream_merge(*t, xv, ov, group=g)
    assert got is ov and got.dtype == dtype
    assert rel_err(got, np.asarray(want.astype(jnp.float32))) < TOL[dtype]
    assert rel_err(got, scatter_ref(to_np(torch.from_numpy(out0).to(dtype)), rows,
                                    to_np(xv), cols)) < TOL[dtype]
    untouched = np.ones(mp // (g * 128), dtype=bool)
    untouched[rows // (g * 128)] = False
    keep = np.repeat(untouched, g * 128)
    assert keep.any()
    np.testing.assert_array_equal(to_np(got)[keep],
                                  to_np(torch.from_numpy(out0).to(dtype))[keep])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e", [3, 900, 5000])
def test_dstream_merge_matches_jax(e, dtype):
    """Tile form: G chunks per step, all-padding group chunks gathering at
    pad_col == len(xsrc), hub tiles of many chunks."""
    mp, dp = 2048, 128
    rows, cols = merge_edges(e + 7, e, mp, mp, hub_rows=384)
    gcols, local, blk, lt, g = build_dstream(rows, cols, mp, pad_col=mp)
    rng = np.random.RandomState(2)
    x = rng.randn(mp, dp).astype(np.float32)
    out0 = rng.randn(mp, dp).astype(np.float32)
    want = jax.jit(lambda *v: jax_dstream.dstream_merge(*v, group=g))(
        jnp.asarray(gcols), jnp.asarray(local), jnp.asarray(blk), jnp.asarray(lt),
        jx(x, dtype), jx(out0, dtype))
    t = [torch.from_numpy(v.astype(np.int32)) for v in (gcols, local, blk, lt)]
    xv = torch.from_numpy(x).to(dtype)
    got = dstream.dstream_merge(*t, xv, torch.from_numpy(out0.copy()).to(dtype), group=g)
    assert rel_err(got, np.asarray(want.astype(jnp.float32))) < TOL[dtype]
    assert rel_err(got, scatter_ref(to_np(torch.from_numpy(out0).to(dtype)), rows,
                                    to_np(xv), cols)) < TOL[dtype]


@pytest.mark.parametrize("kind", ["block", "tile"])
def test_merges_skip_sentinel_slots(kind):
    """Sentinel slots re-fetch a real row: a NaN there adds nothing (as a
    CSR product), where the reference's one-hot dot would spread 0 * NaN."""
    mp, dp = 2048, 128
    rows, cols = merge_edges(4, 700, mp, mp - 1)
    x = np.random.RandomState(3).randn(mp, dp).astype(np.float32)
    if kind == "block":
        gcols, local, blk, g = build_bstream(rows, cols, mp, pad_col=mp - 1)
        sentinel, extra = g * 128, ()
        fn = dstream.bstream_merge
    else:
        gcols, local, blk, lt, g = build_dstream(rows, cols, mp, pad_col=mp - 1)
        sentinel, extra = 128, (lt,)
        fn = dstream.dstream_merge
    pad = local.reshape(-1)[: len(gcols)] == sentinel
    assert pad.any()
    gcols[pad] = mp - 1  # a row that only sentinel slots read
    only_pad = np.setdiff1d(gcols[pad], cols)
    assert len(only_pad)
    args = [torch.from_numpy(v.astype(np.int32)) for v in (gcols, local, blk, *extra)]
    x[only_pad] = np.nan
    got = fn(*args, torch.from_numpy(x), torch.zeros(mp, dp), group=g)
    assert torch.isfinite(got).all()
    assert rel_err(got, scatter_ref(np.zeros((mp, dp)), rows, x, cols)) < RTOL


class _Plan:
    """The plan fields ``dstream_spill`` reads."""

    def __init__(self, group, meta=None, kind="tile"):
        self.ds_group, self.ds_meta, self.ds_kind = group, meta, kind


@pytest.mark.parametrize("num_ranges,range_rows", [(3, 1024), (2, 2048)])
def test_dstream_spill_ranges_match_jax(num_ranges, range_rows):
    """Column ranges (tests/test_dstream.py:219): three ranges with an
    empty middle one, or two whose last slice start is clamped to
    mp - range_rows."""
    rng = np.random.RandomState(8)
    mp = 3 * 1024
    rows = np.sort(rng.randint(0, mp, 500))
    cols = np.concatenate([rng.randint(0, 512, 250), rng.randint(mp - 512, mp, 250)])
    gcols, local, blk, lt, g, meta = build_dstream_ranges(
        rows, cols, mp, pad_col=mp, num_ranges=num_ranges, range_rows=range_rows)
    if num_ranges == 3:
        assert meta["steps"][2] == meta["steps"][1], "the middle range must be empty"
    else:
        assert meta["r0"][-1] == mp - range_rows < range_rows
    x = rng.randn(mp, 128).astype(np.float32)
    out0 = rng.randn(mp, 128).astype(np.float32)
    arrs = dict(ds_gcols=gcols, ds_local=local, ds_blk=blk, ds_lt=lt)
    want = jax_dstream.dstream_spill({k: jnp.asarray(v) for k, v in arrs.items()},
                                     jnp.asarray(x), jnp.asarray(out0), _Plan(g, meta))
    got = dstream.dstream_spill({k: torch.from_numpy(v) for k, v in arrs.items()},
                                torch.from_numpy(x), torch.from_numpy(out0.copy()),
                                _Plan(g, meta))
    assert rel_err(got, np.asarray(want)) < RTOL
    assert rel_err(got, scatter_ref(out0, rows, x, cols)) < RTOL


@pytest.mark.parametrize("kind", ["block", "tile"])
def test_dstream_spill_compact_columns_matches_jax(kind):
    """``ds_ucols``: one take builds the compact table, the chunk gathers
    index it (pad entries clip to its last row)."""
    rng = np.random.RandomState(9)
    mp = 4096
    hubs = np.sort(rng.choice(mp, 40, replace=False))
    rows = np.sort(rng.randint(0, mp, 3000))
    cols = hubs[rng.randint(0, 40, 3000)]
    ucols = np.unique(cols).astype(np.int32)
    if kind == "block":
        gcols, local, blk, g = build_bstream(rows, cols, mp, pad_col=mp)
        lt = np.zeros(0, np.int32)
    else:
        gcols, local, blk, lt, g = build_dstream(rows, cols, mp, pad_col=mp)
    gcols = np.searchsorted(ucols, gcols).astype(np.int32)
    x = rng.randn(mp, 128).astype(np.float32)
    out0 = rng.randn(mp, 128).astype(np.float32)
    arrs = dict(ds_gcols=gcols, ds_local=local, ds_blk=blk, ds_lt=lt, ds_ucols=ucols)
    want = jax_dstream.dstream_spill({k: jnp.asarray(v) for k, v in arrs.items()},
                                     jnp.asarray(x), jnp.asarray(out0), _Plan(g, kind=kind))
    got = dstream.dstream_spill({k: torch.from_numpy(v) for k, v in arrs.items()},
                                torch.from_numpy(x), torch.from_numpy(out0.copy()),
                                _Plan(g, kind=kind))
    assert rel_err(got, np.asarray(want)) < RTOL
    assert rel_err(got, scatter_ref(out0, rows, x, cols)) < RTOL


def ranges_graph():
    """Banded local edges plus 20000 directed edges from 100 hub rows to
    random columns: a dense spill into few tiles, so a small
    ``ds_table_mb`` blocks it into column ranges."""
    rs = np.random.RandomState(2)
    nn = 4096
    a = np.arange(nn).repeat(3)
    b = np.clip(a + rs.randint(-30, 31, a.size), 0, nn - 1)
    hr, hc = rs.randint(0, 100, 20000), rs.randint(0, nn, 20000)
    rp, ci = io.to_csr(np.concatenate([a, b, hr]).astype(np.int32),
                       np.concatenate([b, a, hc]).astype(np.int32), nn)
    return rp, ci, nn


RANGES = dict(WIDE, band_h=128, band_widths=(256,), band_mode="auto", ds_table_mb=0.6,
              ds_blocked_min_edges=1, ds_kind="tile")


def test_check_row_spill_arrays_accepts_plans_and_rejects_bad_indices():
    plan = build_plan(*ranges_graph(), PlanConfig(**RANGES))
    assert plan.ds_meta is not None and len(plan.ds_meta["r0"]) > 1
    host = plan.device_arrays(dense_band=False)
    extra = dstream.check_row_spill_arrays(host, plan)
    assert sorted(extra) == sorted(f"ds_seg{p}_{f}" for p in range(len(plan.ds_meta["r0"]))
                                   if plan.ds_meta["steps"][p + 1] > plan.ds_meta["steps"][p]
                                   for f in tspill.SEG_FIELDS)
    g = plan.ds_group
    m = plan.padded_rows
    bad = {
        "ds_blk": np.full_like(plan.ds_blk, m // (g * 128)),        # outside M
        "ds_lt": np.full_like(plan.ds_lt, g),                       # tile past the block
        "ds_local": np.full_like(plan.ds_local, 129),               # past the sentinel
        "ds_gcols": np.full_like(plan.ds_gcols, -1),
    }
    for key, value in bad.items():
        with pytest.raises(ValueError, match=key):
            dstream.check_row_spill_arrays(dict(host, **{key: value}), plan)
    blocks = build_plan(*small_graph(500, 8, span=400), PlanConfig(
        **dict(WIDE, band_h=128, band_widths=(128,), ds_kind="block")))
    host = blocks.device_arrays(dense_band=False)
    extra = dstream.check_row_spill_arrays(host, blocks)
    for got, want in zip(tspill.segments_of(extra, "ds_seg"), dstream.row_segments(
            blocks.ds_local, blocks.ds_blk, None, blocks.ds_group, len(blocks.ds_blk))):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="ds_blk"):
        dstream.check_row_spill_arrays(dict(host, ds_blk=np.full_like(
            blocks.ds_blk, blocks.padded_rows // (blocks.ds_group * 128))), blocks)
    with pytest.raises(ValueError, match="16-aligned"):
        block_spmm.check_band_arrays(np.array([8], np.int32), np.array([0], np.int32),
                                     128, 1024, 4)


H100_SMEM = dict(per_sm=233472, reserved=1024, optin=232448)  # bytes, as the card reports them

# band width -> (tensor copies?, box bytes, boxes, rows a stage): the widest
# box of at most 256 bytes that divides Bb, or 256 bytes with a zero-filled
# tail past eight boxes; cp.async where Bb is no 16-byte multiple or A is not
# 16-byte aligned; the rows halve only when two stages would not fit a block
RINGS = {640: (True, 128, 5, 32), 1024: (True, 256, 4, 32), 384: (True, 128, 3, 32),
         896: (True, 128, 7, 32), 48: (True, 16, 3, 32), 1008: (True, 256, 4, 32),
         100: (False, 112, 1, 32), 4100: (False, 4112, 1, 16), 65536: (True, 256, 256, 1)}


@pytest.mark.parametrize("bb", sorted(RINGS))
def test_band_launch_ring(bb):
    ring = block_spmm.band_launch(bb, **H100_SMEM)
    tma, box_w, nbox, rows = RINGS[bb]
    assert (ring["tma"], ring["box_w"], ring["nbox"], ring["rows"]) == RINGS[bb]
    assert nbox * box_w >= bb and (nbox - 1) * box_w < bb  # no box wholly past Bb
    if tma:
        assert box_w <= 256 and box_w % 16 == 0 and (nbox == 1 or box_w & (box_w - 1) == 0)
    stage = rows * box_w * nbox
    assert 2 <= ring["stages"] <= 8
    assert ring["smem"] == block_spmm._BAND_FIXED_SMEM + ring["stages"] * stage
    assert ring["smem"] <= H100_SMEM["optin"]
    # more stages only while three blocks still fit an SM
    three = H100_SMEM["per_sm"] // 3 - H100_SMEM["reserved"]
    assert ring["stages"] == 2 or ring["smem"] <= three
    assert ring["stages"] == 8 or ring["smem"] + stage > three


def test_band_launch_unaligned_a_and_oversized_rows():
    """A not 16-byte aligned takes cp.async at any width; a row too wide for
    two one-row stages is refused on the host."""
    ring = block_spmm.band_launch(640, **H100_SMEM, aligned=False)
    assert (ring["tma"], ring["box_w"], ring["nbox"]) == (False, 640, 1)
    with pytest.raises(ValueError):
        block_spmm.band_launch(1 << 17, **H100_SMEM, aligned=False)


@pytest.mark.parametrize("kernel", ["band", "merge"])
def test_wrappers_reject_meta_tensors(kernel):
    """A wrapper takes the plain version only for CPU tensors; on any other
    device without a kernel it raises."""
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        if kernel == "band":
            block_spmm.band_bucket_spmm(torch.zeros(2, dtype=torch.int32, **meta),
                                        torch.zeros(2, 32, 128, dtype=torch.int8, **meta),
                                        torch.empty(1024, 128, **meta))
        else:
            dstream.bstream_merge(torch.zeros(128, dtype=torch.int32, **meta),
                                  torch.zeros(8, 128, dtype=torch.int32, **meta),
                                  torch.zeros(1, dtype=torch.int32, **meta),
                                  torch.empty(1024, 128, **meta),
                                  torch.empty(1024, 128, **meta), group=8,
                                  segs=(torch.zeros(1, dtype=torch.int32, **meta),
                                        torch.zeros(2, dtype=torch.int32, **meta),
                                        torch.zeros(0, dtype=torch.int32, **meta)))


# ---------------------------------------------------------------------------
# the wide HybridSpMM against the JAX package and the dense oracle
# ---------------------------------------------------------------------------


def both(rp, ci, nn, **kw):
    """The port's operator and the JAX package's, on one graph and config."""
    fields = dict(WIDE, **kw.pop("cfg", {}))
    return (HybridSpMM(rp, ci, nn, PlanConfig(**fields), device="cpu", **kw),
            JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(**fields), **kw))


def dense_a(rp, ci, nn):
    return spmm_reference_dense(rp, ci, nn, np.eye(nn))


def check_forward(op, jop, rp, ci, nn, d=40, seed=1, tol=RTOL):
    """Padded (twice chained) and row layouts against JAX and the oracle;
    the closure invariant: padded rows and columns stay exactly zero."""
    x = np.random.RandomState(seed).randn(nn, d).astype(np.float32)
    xp = op.pad_input(x)
    assert xp.shape == (op.plan.padded_rows, -(-d // 128) * 128)
    out = op.apply_padded(op.arrays, xp)
    assert not out[nn:].any() and not out[:, d:].any()
    got = op.unpad_output(op.apply_padded(op.arrays, out), d)
    jxp = jop.pad_input(jnp.asarray(x))
    want = jop.unpad_output(jax.jit(lambda a, v: jop.apply_padded(a, jop.apply_padded(a, v)))(
        jop.arrays, jxp), d)
    assert rel_err(got, want) < tol
    a = dense_a(rp, ci, nn)
    assert rel_err(got, a @ (a @ x)) < tol
    row = op(torch.from_numpy(x))
    assert rel_err(row, jax.jit(jop)(jnp.asarray(x))) < tol
    assert rel_err(row, a @ x) < tol


def test_default_config_builds_the_wide_layout():
    """``HybridSpMM(rp, ci, n)`` with the default config builds a wide plan
    and runs it (the library's default operator)."""
    rp, ci, nn = small_graph(300, 6)
    op = HybridSpMM(rp, ci, nn, device="cpu")
    jop = JaxHybridSpMM(rp, ci, nn)
    assert not op.transposed and not op.plan.tband
    check_forward(op, jop, rp, ci, nn)


@pytest.mark.parametrize("d", [8, 130])
def test_normalized_and_mean_match_jax(d):
    rp, ci, nn = small_graph(200, 5)
    op, jop = both(rp, ci, nn, normalize=True)
    x = np.random.RandomState(6).randn(nn, d).astype(np.float32)
    xp, jxp = op.pad_input(torch.from_numpy(x)), jop.pad_input(jnp.asarray(x))
    got = op.unpad_output(op.apply_padded(op.arrays, xp), d)
    want = jop.unpad_output(jop.apply_padded(jop.arrays, jxp), d)
    assert rel_err(got, want) < RTOL
    a = dense_a(rp, ci, nn)
    deg = np.maximum(a.sum(1), 1.0)
    assert rel_err(got, (a @ (x / np.sqrt(deg)[:, None])) / np.sqrt(deg)[:, None]) < RTOL
    got_m = op.unpad_output(op.mean_apply_padded(op.arrays, xp), d)
    want_m = jop.unpad_output(jop.mean_apply_padded(jop.arrays, jxp), d)
    assert rel_err(got_m, want_m) < RTOL
    assert rel_err(got_m, (a @ x) / deg[:, None]) < RTOL
    assert rel_err(op.mean(torch.from_numpy(x)), jop.mean(jnp.asarray(x))) < RTOL
    assert rel_err(op(torch.from_numpy(x)), jop(jnp.asarray(x))) < RTOL


def _grads(op, jop, x, cot, layout):
    """d/dX of sum(A X * cot) through the port (torch autograd) and the
    JAX package (custom_vjp), in the padded or the row layout."""
    d = x.shape[1]
    xv = torch.from_numpy(x).requires_grad_(True)
    if layout == "padded":
        out = op.unpad_output(op.apply_padded(op.arrays, op.pad_input(xv)), d)
    else:
        out = op.apply(op.arrays, xv)
    (out * torch.from_numpy(cot)).sum().backward()

    def loss(v):
        if layout == "padded":
            o = jop.unpad_output(jop.apply_padded(jop.arrays, jop.pad_input(v)), d)
        else:
            o = jop.apply(jop.arrays, v)
        return jnp.sum(o * cot)

    return xv.grad.numpy(), np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(x)))


@pytest.mark.parametrize("layout", ["padded", "rows"])
@pytest.mark.parametrize("symmetric", [True, False])
def test_spmm_gradient_matches_jax_custom_vjp(layout, symmetric):
    """Symmetric: the backward reuses the forward plan; directed: it runs
    on the plan built over A^T."""
    rp, ci, nn = small_graph(300, 6, symmetric=symmetric)
    op, jop = both(rp, ci, nn, symmetric=symmetric)
    a = dense_a(rp, ci, nn)
    assert (op.plan_bwd is None) == symmetric == np.array_equal(a, a.T)
    rs = np.random.RandomState(5)
    x = rs.randn(nn, 16).astype(np.float32)
    cot = rs.randn(nn, 16).astype(np.float32)
    got, want = _grads(op, jop, x, cot, layout)
    assert rel_err(got, want) < RTOL
    assert rel_err(got, a.T @ cot) < RTOL


@pytest.mark.parametrize("core", ["gcn", "gin"])
def test_layer_cores_values_and_grads_match_jax(core):
    rp, ci, nn = small_graph(300, 6)
    op, jop = both(rp, ci, nn)
    d, h = 24, 140
    rs = np.random.RandomState(4)
    x = rs.randn(nn, d).astype(np.float32)
    w = (rs.randn(d, h) * 0.1).astype(np.float32)
    xv = torch.from_numpy(x).requires_grad_(True)
    wv = torch.from_numpy(w).requires_grad_(True)
    apply = getattr(op, f"{core}_apply_padded")
    outp = apply(op.arrays, op.pad_input(xv), wv)
    assert outp.shape == (op.plan.padded_rows, 256)
    out = op.unpad_output(outp, h)
    (out ** 2).sum().backward()
    japply = getattr(jop, f"{core}_apply_padded")

    def loss(xj, wj):
        return jnp.sum(jop.unpad_output(japply(jop.arrays, jop.pad_input(xj), wj), h) ** 2)

    jout = jop.unpad_output(japply(jop.arrays, jop.pad_input(jnp.asarray(x)),
                                   jnp.asarray(w)), h)
    gx, gw = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w))
    assert rel_err(out.detach(), jout) < RTOL
    assert rel_err(xv.grad, gx) < RTOL
    assert rel_err(wv.grad, gw) < RTOL


def random_graph(n=4096, e=1024, seed=5120):
    rs = np.random.RandomState(seed)
    src, dst = rs.randint(0, n, e), rs.randint(0, n, e)
    rp, ci = io.to_csr(np.concatenate([src, dst]).astype(np.int32),
                       np.concatenate([dst, src]).astype(np.int32), n)
    return rp, ci, n


SPILL = dict(band_h=128, band_widths=(128,), band_mode="auto")


@pytest.mark.parametrize("form", ["block", "tile", "take", "ranges", "ucols"])
def test_spill_plans_match_jax_and_oracle(form):
    """Every spill form of the wide layout, forward in both layouts."""
    if form == "ranges":
        rp, ci, nn = ranges_graph()
        cfg = RANGES
    elif form == "ucols":
        rp, ci, nn = _ucols_graph()
        cfg = dict(compute_dtype="float32", band_widths=(384,), band_mode="auto",
                   ds_table_mb=0.2, ds_blocked_min_edges=0)
    else:
        rp, ci, nn = small_graph(500, 8, span=400)
        cfg = dict(SPILL, ds_kind=form)
    op, jop = both(rp, ci, nn, cfg=cfg)
    p = op.plan
    assert p.spill_nnz > 0
    assert (p.ds_blk is None) == (form == "take")
    assert (p.ds_meta is not None) == (form == "ranges")
    assert (p.ds_ucols is not None) == (form == "ucols")
    check_forward(op, jop, rp, ci, nn)


def _ucols_graph():
    """tests/test_dstream.py:334's graph: local band edges plus a spill onto
    64 hub columns (the compact-table regime)."""
    rng = np.random.RandomState(0)
    nn = 4096
    src_l = rng.randint(0, nn, 12000)
    dst_l = (src_l + rng.randint(1, 48, 12000)) % nn
    hubs = rng.choice(nn, 64, replace=False)
    src_h = rng.randint(0, nn, 9000)
    dst_h = hubs[rng.randint(0, 64, 9000)]
    rp, ci = io.to_csr(np.concatenate([src_l, dst_l, src_h]).astype(np.int32),
                       np.concatenate([dst_l, src_l, dst_h]).astype(np.int32), nn)
    return rp, ci, nn


@pytest.mark.parametrize("layout", ["padded", "rows"])
def test_spill_plan_gradient_matches_jax_custom_vjp(layout):
    rp, ci, nn = small_graph(500, 8, span=400)
    op, jop = both(rp, ci, nn, cfg=dict(SPILL, ds_kind="block"))
    rs = np.random.RandomState(6)
    x = rs.randn(nn, 16).astype(np.float32)
    cot = rs.randn(nn, 16).astype(np.float32)
    got, want = _grads(op, jop, x, cot, layout)
    assert rel_err(got, want) < RTOL
    assert rel_err(got, dense_a(rp, ci, nn).T @ cot) < RTOL


def test_partial_cover_and_two_bucket_plans_match_jax():
    """A plan with a superwindow no bucket covers (its block is zeroed,
    its edges spill), and a two-bucket plan (main bucket's direct write,
    the other's blocks scattered)."""
    rp, ci, nn = random_graph()
    op, jop = both(rp, ci, nn, cfg=SPILL)
    assert len(op.plan.band_missing_sw) > 0 and op.plan.spill_nnz > 0
    check_forward(op, jop, rp, ci, nn)
    rp, ci, nn = small_graph(300, 6)
    op, jop = both(rp, ci, nn, cfg=dict(band_h=64, band_widths=(128, 256),
                                        band_mode="always"))
    assert [len(s) > 0 for s in op.plan.band_sw_ids] == [True, True]
    check_forward(op, jop, rp, ci, nn)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_bf16_and_fp32_plans_match_oracle(cd):
    """bf16 activations in the wide layout: the band product and the merge
    sum in fp32 and round once (1e-2 of max|ref|; fp32 1e-5)."""
    rp, ci, nn = small_graph(500, 8, span=400)
    op = HybridSpMM(rp, ci, nn, PlanConfig(**dict(WIDE, **SPILL, ds_kind="block",
                                                  compute_dtype=cd)), device="cpu")
    x = np.random.RandomState(2).randn(nn, 64).astype(np.float32)
    xp = op.pad_input(x)
    assert xp.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[cd]
    got = op.unpad_output(op.apply_padded(op.arrays, xp), 64)
    ref = dense_a(rp, ci, nn) @ to_np(xp[:nn, :64])
    assert rel_err(got, ref) < TOL[xp.dtype]


def test_gate_refuses_what_the_wide_layout_would_not_apply():
    """Plans with dense or sparse row-merge populations have no wide padded
    path: the gate refuses them, and the operator runs them in the row
    layout and matches the oracle.  A hand-broken cover raises; no partial
    answer is computed.  The tiled band and the fused mode run."""
    rp, ci, nn = small_graph(300, 6)
    x = np.random.RandomState(7).randn(nn, 20).astype(np.float32)
    for cfg in (dict(band_mode="never"), dict(band_mode="never", loi_mode="all_dense")):
        op = HybridSpMM(rp, ci, nn, PlanConfig(**dict(WIDE, **cfg)), device="cpu")
        assert not op.supports_padded
        with pytest.raises(NotImplementedError, match="row layout"):
            block_spmm.check_plan(op.plan)
        assert rel_err(op(torch.from_numpy(x)), dense_a(rp, ci, nn) @ x) < RTOL
    op = HybridSpMM(rp, ci, nn, PlanConfig(**WIDE), device="cpu")
    partial = dataclasses.replace(op.plan, band_sw_ids=[op.plan.band_sw_ids[0][1:]])
    with pytest.raises(NotImplementedError, match="cover"):
        block_spmm.check_plan(partial)
    with pytest.raises(NotImplementedError, match="cover"):
        block_spmm.spmm_wide_padded(op.arrays["f"], op.pad_input(torch.zeros(nn, 16)),
                                    partial, torch.float32)
    # the tiled band and the fused kernels run now (ROADMAP A.11)
    tiled = HybridSpMM(rp, ci, nn, PlanConfig(**dict(WIDE, band_impl="tiled", band_h=128)),
                       device="cpu")
    assert tiled.plan.tiled
    got = tiled.unpad_output(tiled.apply_padded(tiled.arrays, tiled.pad_input(x)), 20)
    assert rel_err(got, dense_a(rp, ci, nn) @ x) < RTOL
    w = torch.from_numpy(np.random.RandomState(8).randn(20, 8).astype(np.float32))
    composed = op.gcn_apply_padded(op.arrays, op.pad_input(x), w)
    op.plan.prefer_fused_kernel = True
    fused = op.gcn_apply_padded(op.arrays, op.pad_input(x), w)
    assert rel_err(fused.detach(), composed) < RTOL


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on a card only)
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/block_spmm.cu and csrc/dstream.cu have no "
                    "CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dp", [128, 256, 384])
def test_cuda_band_kernel_matches_plain(dp, dtype):
    _need_cuda()
    a, st, sw, x = band_inputs(dp, bh=96, bb=640, dp=dp, m=2048)
    num_sw = len(sw) - 2
    a, st, sw = (torch.from_numpy(v).cuda() for v in (a, st, sw))
    xv = torch.from_numpy(x).to("cuda", dtype)
    before = block_spmm.launches
    got = block_spmm.band_bucket_spmm_direct(sw, st, a, xv, num_sw, dtype)
    part = block_spmm.band_bucket_spmm(st, a, xv)
    torch.cuda.synchronize()
    assert block_spmm.launches == before + 2
    assert rel_err(got.cpu(), block_spmm.band_bucket_spmm_direct_plain(
        sw, st, a, xv, num_sw, dtype).cpu()) < TOL[dtype]
    assert rel_err(part.cpu(), block_spmm.band_bucket_spmm_plain(st, a, xv).cpu()) < RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bb", [640, 100, 1024])
def test_cuda_band_kernel_modes_and_rings(bb, dtype):
    """The ring kernel in its three modes against the plain versions (Bb 640
    and 1024 by tensor copies, 100 by cp.async; dp 128 and 384), two runs
    bitwise equal, and in fp32 equal bit for bit to the fused kernel's
    aggregate; the grouped mode at G 1/2/4/8 with entries past num_sw."""
    _need_cuda()
    for dp in (128, 384):
        a, st, sw, x = band_inputs(bb + dp, bh=128, bb=bb, dp=dp, m=2048)
        num_sw = len(sw) - 2
        a, st, sw = (torch.from_numpy(v).cuda() for v in (a, st, sw))
        xv = torch.from_numpy(x).to("cuda", dtype)
        got = block_spmm.band_bucket_spmm_direct(sw, st, a, xv, num_sw, dtype)
        again = block_spmm.band_bucket_spmm_direct(sw, st, a, xv, num_sw, dtype)
        part = block_spmm.band_bucket_spmm(st, a, xv)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert rel_err(got.cpu(), block_spmm.band_bucket_spmm_direct_plain(
            sw, st, a, xv, num_sw, dtype).cpu()) < TOL[dtype]
        assert rel_err(part.cpu(), block_spmm.band_bucket_spmm_plain(st, a, xv).cpu()) < RTOL
        if dtype == torch.float32:
            wp = torch.randn((dp, 128), device="cuda")
            agg, _ = block_spmm.band_fused_spmm_direct(sw, st, a, xv, wp, num_sw, dtype)
            assert torch.equal(agg, got)
        a8, st8 = a[:4].repeat(2, 1, 1), st[:4].repeat(2)
        for group in (1, 2, 4, 8):
            grouped = block_spmm.band_bucket_spmm_grouped(st8, a8, xv, 5, dtype, group)
            ref = block_spmm.band_bucket_spmm_grouped_plain(st8, a8, xv, 5, dtype, group)
            torch.cuda.synchronize()
            assert rel_err(grouped.cpu(), ref.cpu()) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["block", "tile"])
def test_cuda_merges_match_plain_and_are_deterministic(kind, dtype):
    _need_cuda()
    mp, dp = 8192, 256
    rows, cols = merge_edges(5, 20000, mp, mp)
    if kind == "block":
        arrs = build_bstream(rows, cols, mp, pad_col=mp)[:3]
        fn, plain = dstream.bstream_merge, dstream.bstream_merge_plain
    else:
        arrs = build_dstream(rows, cols, mp, pad_col=mp)[:4]
        fn, plain = dstream.dstream_merge, dstream.dstream_merge_plain
    t = [torch.from_numpy(v.astype(np.int32)).cuda() for v in arrs]
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(mp, dp).astype(np.float32)).to("cuda", dtype)
    out0 = torch.from_numpy(rng.randn(mp, dp).astype(np.float32)).to("cuda", dtype)
    got = fn(*t, x, out0.clone(), group=8)
    again = fn(*t, x, out0.clone(), group=8)
    ref = plain(*t, x, out0.clone(), group=8)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert rel_err(got.cpu(), ref.cpu()) < TOL[dtype]
    ids = torch.tensor([1, 5], dtype=torch.int32, device="cuda")
    assert torch.equal(tspill.zero_row_blocks(out0.clone(), ids, 1024),
                       tspill.zero_row_blocks_plain(out0.clone(), ids, 1024))
