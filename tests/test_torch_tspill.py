"""The port's spill-chain kernels (hcspmm_tpu_torch/kernels/tspill.py)
against the JAX package's Pallas kernels in interpret mode on the CPU,
mirroring tests/test_tspill.py: zero-fill (the plain version, and its fold
into the band kernel's direct launch), mxgather table, block merge,
segmented gather, the host checks of the spill arrays, and the wrappers'
device rules.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
(csrc/tspill.cu) are held against the same plain versions by the tests
marked ``cuda`` and by chip_smoke.py.  Tolerance: fp32 within 1e-5 of
max|ref| (sum order only; the gathers and the zero-fill are exact), bf16
within 1e-2 (one rounding of the fp32 block sum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcspmm_tpu.config import PlanConfig as JaxPlanConfig
from hcspmm_tpu.format.plan import build_plan as jax_build_plan
from hcspmm_tpu.kernels import tspill as jax_tspill
from hcspmm_tpu.kernels.dstream import build_bstream

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.format.plan import build_plan
from hcspmm_tpu_torch.format.streams import build_mx_chunks
from hcspmm_tpu_torch.kernels import tband, tspill

from conftest import small_graph

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def to_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def rel_err(got, ref):
    got, ref = (np.asarray(to_np(v) if isinstance(v, torch.Tensor) else v, dtype=np.float64)
                for v in (got, ref))
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


@pytest.mark.parametrize("wide", [False, True])
def test_zero_lane_blocks_matches_jax(wide):
    """The zero-fill's plain version (on the card the band kernel's direct
    launch zeroes these blocks, kernels/tband.py) against the Pallas kernel."""
    rng = np.random.RandomState(0)
    dt, bh = 16, 128
    w = 8 * bh if wide else bh
    m = 4 * 8 * bh
    buf = rng.randn(dt, m).astype(np.float32)
    ids = np.array([0, 2, 3] if wide else [0, 3, 7, 30], dtype=np.int32)
    want = np.asarray(jax_tspill.zero_lane_blocks(jnp.asarray(buf), jnp.asarray(ids), w))
    t = torch.from_numpy(buf.copy())
    got = tspill.zero_lane_blocks_plain(t, torch.from_numpy(ids), w)
    assert got is t  # in place
    np.testing.assert_array_equal(got.numpy(), want)
    for i in ids:
        assert not got[:, i * w:(i + 1) * w].any()


def test_zero_lane_blocks_empty_ids_launch_nothing():
    """Empty missing lists zero nothing: the plain zero-fill leaves the
    buffer as the Pallas kernel does, and the folded direct launch equals
    the one given no lists, counting no zero-fill."""
    buf = torch.randn(16, 1024)
    before = dict(tband.kernel_launches)
    empty = torch.zeros(0, dtype=torch.int32)
    same = tspill.zero_lane_blocks_plain(buf.clone(), empty, 128)
    np.testing.assert_array_equal(same.numpy(), buf.numpy())
    want = jax_tspill.zero_lane_blocks(jnp.asarray(buf.numpy()), jnp.zeros(0, jnp.int32), 128)
    np.testing.assert_array_equal(np.asarray(want), buf.numpy())
    rng = np.random.RandomState(3)
    at = torch.from_numpy((rng.rand(4, 128, 128) < 0.05).astype(np.int8))
    st = torch.tensor([0, 128, 256, 384], dtype=torch.int32)
    sw = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    xt = torch.from_numpy(rng.randn(16, 512).astype(np.float32))
    direct = tband.tband_spmm_direct(sw, st, at, xt, 4, torch.float32)
    folded = tband.tband_spmm_direct(sw, st, at, xt, 4, torch.float32, empty, empty)
    assert torch.equal(direct, folded)
    assert tband.kernel_launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_cols", [700, 37])
def test_mxgather_lanes_matches_jax(n_cols, dtype):
    """Exact copy; the table keeps the reference's ceil(C/4)*4*k width,
    with pad slots and tail chunks exactly zero."""
    rng = np.random.RandomState(4)
    dt, m, span, k = 16, 8192, 512, 32
    xt = rng.randn(dt, m).astype(np.float32)
    ucols = np.unique(rng.randint(0, m, size=n_cols))
    lo, rel, slot = build_mx_chunks(ucols, span, k, m)
    c = len(lo)
    xj = jnp.asarray(xt).astype(JDT[dtype])
    want = np.asarray(jax.jit(lambda x, a, b: jax_tspill.mxgather_lanes(x, a, b, span=span))(
        xj, jnp.asarray(lo), jnp.asarray(rel)).astype(jnp.float32))
    xv = torch.from_numpy(xt).to(dtype)
    got = tspill.mxgather_lanes(xv, torch.from_numpy(lo), torch.from_numpy(rel), span=span)
    assert got.dtype == dtype
    assert got.shape == want.shape == (dt, -(-c // 4) * 4 * k) == (dt, tspill.mx_width(c, k))
    np.testing.assert_array_equal(to_np(got), want)
    np.testing.assert_array_equal(to_np(got[:, slot]), to_np(xv[:, ucols]))
    used = np.zeros(got.shape[1], dtype=bool)
    used[slot] = True
    assert not got[:, torch.from_numpy(~used)].any()


def merge_inputs(bw, dtype, seed, dt=8, m=4096, group=4, e=1800):
    """A dst-sorted edge stream chunked as the reference's build_bstream
    does, its gathered columns, and a random buffer."""
    rng = np.random.RandomState(seed)
    rows = np.sort(rng.randint(0, m, size=e)).astype(np.int64)
    xsrc = rng.randn(dt, e).astype(np.float32)
    gcols, local, blk, grp = build_bstream(rows, np.arange(e), m, pad_col=e, group=group,
                                           chunk_edges=bw)
    gathered = xsrc[:, np.minimum(gcols, e - 1)]  # the reference's clip-mode take
    buf = rng.randn(dt, m).astype(np.float32)
    want = buf.astype(np.float64)
    np.add.at(want.T, rows, xsrc.T.astype(np.float64))
    t = [torch.from_numpy(v) for v in (gathered, local.astype(np.int32), blk, buf)]
    t[0], t[3] = t[0].to(dtype), t[3].to(dtype)
    return t, grp, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bw", [128, 256, 512])
def test_tbstream_merge_matches_jax(bw, dtype):
    (g, local, blk, buf), grp, want = merge_inputs(bw, dtype, seed=bw)
    assert local.shape == (-(-blk.shape[0] // 8) * 8, bw)
    jout = jax.jit(lambda *a: jax_tspill.tbstream_merge(*a, group=grp))(
        *(jnp.asarray(to_np(v)).astype(JDT[dtype]) if v.is_floating_point()
          else jnp.asarray(v.numpy()) for v in (g, local, blk, buf)))
    got = tspill.tbstream_merge(g, local, blk, buf, group=grp)
    assert got is buf and got.dtype == dtype
    assert rel_err(got, np.asarray(jout.astype(jnp.float32))) < TOL[dtype]
    assert rel_err(got, want) < TOL[dtype]


def test_tbstream_merge_skips_pad_slots():
    """Pad slots carry the sentinel lane and a real column: a non-finite
    value there adds nothing (as scipy's CSR product), where the
    reference's one-hot dot would spread 0 * NaN over its block."""
    (g, local, blk, buf), grp, want = merge_inputs(128, torch.float32, seed=3)
    pad = (local[: blk.shape[0]] == grp * 128).reshape(-1)
    assert pad.any()
    g = g.clone()
    g[:, pad] = float("nan")
    got = tspill.tbstream_merge(g, local, blk, buf, group=grp)
    assert torch.isfinite(got).all()
    assert rel_err(got, want) < 1e-5


def test_block_runs():
    """The merges' destination runs (``segment_table``): one segment per
    run of equal destinations, pad runs kept as -1, the long list by
    length, and a single run."""
    dst, ptr, long = tspill.segment_table(np.array([0, 0, 2, 2, 2, 5, -1, -1]), 2)
    np.testing.assert_array_equal(dst, [0, 2, 5, -1])
    np.testing.assert_array_equal(ptr, [0, 2, 5, 6, 8])
    np.testing.assert_array_equal(long, [1])
    assert dst.dtype == ptr.dtype == long.dtype == np.int32
    dst, ptr, long = tspill.segment_table(np.array([3]), 0)
    np.testing.assert_array_equal(dst, [3])
    np.testing.assert_array_equal(ptr, [0, 1])
    np.testing.assert_array_equal(long, [0])
    with pytest.raises(ValueError, match="two runs"):
        tspill.segment_table(np.array([0, 0, 2, 0]), 2)


TINY_CAPS =dict(impl="pallas", band_impl="tband", band_h=128, band_widths=(128,),
                 band_mode="auto", ts_table_mb=1e-3, ts_span=256, ts_k=32,
                 ts2_table_mb=48 * 64 / 1e6)


def test_segmented_gather_matches_jax():
    rp, ci, nn = small_graph(1400, 9, span=1300)
    plan = build_plan(rp, ci, nn, PlanConfig(**TINY_CAPS))
    jplan = jax_build_plan(rp, ci, nn, JaxPlanConfig(**TINY_CAPS))
    assert plan.ts2_segs and len(plan.ts2_segs) > 1 and plan.ts_lo is not None
    bw = plan.ds_tlocal.shape[1]
    t1w = tspill.mx_width(len(plan.ts_lo), plan.ts_rel.shape[2])
    t1 = np.random.RandomState(0).randn(16, t1w).astype(np.float32)
    want = np.asarray(jax.jit(lambda t, r, g: jax_tspill.segmented_gather(
        t, r, g, jplan.ts2_segs, jplan.ts2_pieces, bw=bw))(
        jnp.asarray(t1), jnp.asarray(jplan.ts2_ranks), jnp.asarray(jplan.ds_laneg)))
    got = tspill.segmented_gather(torch.from_numpy(t1), torch.from_numpy(plan.ts2_ranks),
                                  torch.from_numpy(plan.ds_laneg), plan.ts2_segs,
                                  plan.ts2_pieces, bw=bw)
    assert got.shape == want.shape == (16, len(plan.ds_lblk) * bw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_check_spill_arrays_accepts_plans_and_rejects_bad_indices():
    rp, ci, nn = small_graph(1400, 9, span=1300)
    plan = build_plan(rp, ci, nn, PlanConfig(**TINY_CAPS))
    host = plan.device_arrays(dense_band=False)
    extra = tspill.check_spill_arrays(host, plan)
    for got, want in zip(tspill.segments_of(extra, "ds_lseg"), tspill.lane_segments(
            plan.ds_tlocal, plan.ds_lblk, plan.ds_lgroup)):
        np.testing.assert_array_equal(got, want)
    assert extra["ds_lsrc"].shape == plan.ds_laneg.shape
    m = plan.padded_rows
    bad = {
        "ds_lblk": plan.ds_lblk[::-1].copy(),                     # decreasing
        "ds_tlocal": np.full_like(plan.ds_tlocal, plan.ds_lgroup * 128 + 1),
        "ts_lo": np.full_like(plan.ts_lo, m - 128),               # slab leaves M
        "ts_rel": np.full_like(plan.ts_rel, plan.ts_span),
        "ds_laneg": np.full_like(plan.ds_laneg, 1 << 20),         # outside its table
        "ts2_ranks": np.full_like(plan.ts2_ranks, -1),
        "band_missing_sw": np.array([m // 128], np.int32),
    }
    for key, value in bad.items():
        with pytest.raises(ValueError, match=key.split("_sw")[0]):
            tspill.check_spill_arrays(dict(host, **{key: value}), plan)


@pytest.mark.parametrize("kernel", ["zero", "mxgather", "merge"])
def test_wrappers_reject_meta_tensors(kernel):
    """A wrapper takes the plain version only for CPU tensors; on any
    other device without a kernel it raises."""
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        if kernel == "zero":  # the zero-fill folded into the band kernel's direct launch
            tband.tband_spmm_direct(torch.zeros(2, dtype=torch.int32, **meta),
                                    torch.zeros(2, dtype=torch.int32, **meta),
                                    torch.zeros(2, 64, 128, dtype=torch.int8, **meta),
                                    torch.empty(16, 1024, **meta), 8, torch.float32,
                                    torch.zeros(1, dtype=torch.int32, **meta),
                                    torch.zeros(2, dtype=torch.int32, **meta))
        elif kernel == "mxgather":
            tspill.mxgather_lanes(torch.empty(16, 1024, **meta),
                                  torch.zeros(2, dtype=torch.int32, **meta),
                                  torch.zeros(2, 1, 32, dtype=torch.int32, **meta), span=512)
        else:
            tspill.tbstream_merge(torch.empty(16, 1024, **meta),
                                  torch.zeros(8, 128, dtype=torch.int32, **meta),
                                  torch.zeros(8, dtype=torch.int32, **meta),
                                  torch.empty(16, 1024, **meta), group=4,
                                  segs=(torch.zeros(1, dtype=torch.int32, **meta),
                                        torch.zeros(2, dtype=torch.int32, **meta),
                                        torch.zeros(0, dtype=torch.int32, **meta)))


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on a card only)
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/tspill.cu has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_zero_and_mxgather_match_plain(dtype):
    """mxgather against its plain version, and the zero-fill folded into the
    band kernel's direct launch: the missing superwindows' blocks (runs of
    eight, singles, both) equal zero_lane_blocks_plain's."""
    _need_cuda()
    rng = np.random.RandomState(1)
    dt, m, span, k = 48, 8192, 512, 32
    xt = torch.from_numpy(rng.randn(dt, m).astype(np.float32)).to("cuda", dtype)
    lo, rel, _ = build_mx_chunks(np.unique(rng.randint(0, m, 500)), span, k, m)
    lo, rel = torch.from_numpy(lo).cuda(), torch.from_numpy(rel).cuda()
    before, zero_before = dict(tspill.launches), tband.kernel_launches["zero_lane_blocks"]
    got = tspill.mxgather_lanes(xt, lo, rel, span=span)
    torch.cuda.synchronize()
    assert torch.equal(got, tspill.mxgather_lanes_plain(xt, lo, rel))
    assert tspill.launches["mxgather_lanes"] == before["mxgather_lanes"] + 1
    bh, num_sw = 128, 64  # superwindows 16-23 and 1, 5, 63 are missing
    owned = np.setdiff1d(np.arange(num_sw), np.r_[16:24, 1, 5, 63])
    at = torch.from_numpy((rng.rand(len(owned), 256, bh) < 0.05).astype(np.int8)).cuda()
    st = torch.from_numpy((rng.randint(0, (m - 256) // 128 + 1, len(owned)) * 128)
                          .astype(np.int32)).cuda()
    sw = torch.from_numpy(rng.permutation(owned).astype(np.int32)).cuda()
    cases = ([2], [1, 5, 63]), ([2], []), ([], [1, 5, 63])
    for m8, m1 in cases:
        ids = [torch.tensor(v, dtype=torch.int32, device="cuda") for v in (m8, m1)]
        out = tband.tband_spmm_direct(sw, st, at, xt, num_sw, dtype, *ids)
        ref = tband.tband_spmm_direct_plain(sw, st, at, xt, num_sw, dtype, *ids)
        torch.cuda.synchronize()
        zero = torch.zeros(num_sw, dtype=torch.bool)
        for r in m8:
            zero[8 * r:8 * r + 8] = True
        zero[m1] = True
        cols = zero.clone()
        cols[torch.from_numpy(owned)] = True
        assert rel_err(out[:, cols.repeat_interleave(bh).cuda()].cpu(),
                       ref[:, cols.repeat_interleave(bh).cuda()].cpu()) < TOL[dtype]
        assert not out[:, zero.repeat_interleave(bh).cuda()].any()
    assert tband.kernel_launches["zero_lane_blocks"] == zero_before + len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [4, 8, 16, 32])
def test_cuda_merge_matches_plain_and_is_deterministic(group, dtype):
    _need_cuda()
    (g, local, blk, buf), grp, _ = merge_inputs(256, dtype, seed=group, dt=48, m=16384,
                                                group=group, e=6000)
    g, local, blk, buf = (v.cuda() for v in (g, local, blk, buf))
    ref = tspill.tbstream_merge_plain(g, local, blk, buf.clone(), group=grp)
    got = tspill.tbstream_merge(g, local, blk, buf.clone(), group=grp)
    again = tspill.tbstream_merge(g, local, blk, buf.clone(), group=grp)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert rel_err(got.cpu(), to_np(ref.cpu())) < TOL[dtype]
