"""The port's transposed-band SpMM (hcspmm_tpu_torch/kernels/tband.py)
against the JAX package's Pallas kernels (interpret mode on the CPU) and a
scipy float64 oracle.

On the CPU the wrappers run their plain PyTorch versions; the CUDA kernel
they launch on a card is held against the same plain versions by
``test_cuda_kernel_matches_plain`` (marked ``cuda``) and by chip_smoke.py.
Tolerance: fp32 within 1e-5 of max|ref|, which only the order of the fp32
sums may use up.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hcspmm_tpu.config import PlanConfig as JaxPlanConfig
from hcspmm_tpu.format.plan import build_plan as jax_build_plan
from hcspmm_tpu.kernels import tband as jax_tband
from hcspmm_tpu.kernels import tspill as jax_tspill
from hcspmm_tpu.ops.spmm import HybridSpMM as JaxHybridSpMM

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.format import streams
from hcspmm_tpu_torch.graphs import io
from hcspmm_tpu_torch.kernels import tband
from hcspmm_tpu_torch.ops.spmm import HybridSpMM

from conftest import small_graph

RTOL = 1e-5


def rel_err(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


def band_inputs(dt, trash, sb=5, w=256, bh=128, m=1024, seed=0):
    """Random 0/1 A_t blocks, 128-aligned starts with st + W <= M, a
    permutation of the superwindows plus ``trash`` capacity-padded entries
    (sw == num_sw), and X^T, all as numpy."""
    rs = np.random.RandomState(seed)
    at = (rs.rand(sb + trash, w, bh) < 0.05).astype(np.int8)
    st = (rs.randint(0, (m - w) // 128 + 1, sb + trash) * 128).astype(np.int32)
    sw = np.concatenate([rs.permutation(sb), np.full(trash, sb)]).astype(np.int32)
    xt = rs.randn(dt, m).astype(np.float32)
    return sw, st, at, xt, sb


# (dt, trash, W, bh, M): the first six at the default W 256, bh 128, M 1024;
# then the shapes the band kernel's ring must handle: one 64-row stage, GH's
# W 896 (14 stages, a multiple of no ring depth), bh 32, 256 and 512 (the
# tensor copies' 32-, 128- and 128-column boxes; bh 96 takes three 32-column
# boxes), dt 48 (three 16-row feature slabs); then the 64-column boxes of
# the 64-byte swizzle: bh 64 (one box), bh 192 (three) and bh 320 (five,
# read by warps of 32 columns)
BAND_SHAPES = {
    **{f"{dt}-{trash}": (dt, trash, 256, 128, 1024) for dt in (16, 32, 96) for trash in (0, 2)},
    "w64": (16, 2, 64, 128, 1024),
    "w896-bh256": (32, 2, 896, 256, 2048),
    "bh32-dt48": (48, 0, 256, 32, 512),
    "bh96": (32, 2, 192, 96, 768),
    "bh512-dt48": (48, 2, 128, 512, 1024),
    "w896-bh512": (16, 0, 896, 512, 1024),
    "bh64": (16, 2, 256, 64, 512),
    "bh192": (32, 2, 384, 192, 1024),
    "bh320-dt48": (48, 2, 192, 320, 768),
}


@pytest.mark.parametrize("shape", list(BAND_SHAPES.values()), ids=list(BAND_SHAPES))
def test_plain_direct_and_bucket_match_jax_kernels(shape):
    dt, trash, w, bh, m = shape
    sw, st, at, xt, num_sw = band_inputs(dt, trash, w=w, bh=bh, m=m, seed=dt + trash)
    want = np.asarray(jax_tband.tband_spmm_direct(
        jnp.asarray(sw), jnp.asarray(st), jnp.asarray(at), jnp.asarray(xt),
        num_sw, jnp.float32))
    t = [torch.from_numpy(v) for v in (sw, st, at, xt)]
    got = tband.tband_spmm_direct(*t, num_sw, torch.float32)
    assert got.shape == want.shape == (dt, num_sw * at.shape[2])
    assert rel_err(got, want) < RTOL
    want_b = np.asarray(jax_tband.tband_spmm_bucket(
        jnp.asarray(st), jnp.asarray(at), jnp.asarray(xt)))
    got_b = tband.tband_spmm_bucket(t[1], t[2], t[3])
    assert got_b.dtype == torch.float32 and got_b.shape == want_b.shape
    assert rel_err(got_b, want_b) < RTOL


PACKERS = {2: streams.pack_a_nibble, 8: streams.pack_a_bits}


@pytest.mark.parametrize("pack", [2, 8])
@pytest.mark.parametrize("shape", list(BAND_SHAPES.values()), ids=list(BAND_SHAPES))
def test_expand_at_inverts_the_packers(shape, pack):
    """The packed A_t encodings (``tband_pack`` 2: nibbles, 8: bits):
    ``expand_at`` gives the int8 0/1 blocks back exactly and ``logical_wh``
    their (W, bh), at every BAND_SHAPES shape (W/8 from 8 to 112: below 64,
    64 and its multiples, and 96 and 112, neither); the port's packers give
    the JAX package's bytes."""
    dt, trash, w, bh, m = shape
    at = band_inputs(dt, trash, w=w, bh=bh, m=m, seed=pack + w)[2]
    packed = PACKERS[pack](at)
    jpacker = {2: jax_tband.pack_a_nibble, 8: jax_tband.pack_a_bits}[pack]
    np.testing.assert_array_equal(packed, jpacker(at))
    t = torch.from_numpy(packed)
    assert t.dtype == torch.uint8
    assert tband.logical_wh(t, pack) == (w, bh)
    got = tband.expand_at(t, pack)
    assert got.dtype == torch.int8 and torch.equal(got, torch.from_numpy(at))


# packed plain versions against the Pallas kernels at a pack: W/8 8 and 112,
# nibble rows of 16, 48 and 160 bytes, three feature slabs, padded entries
PACK_SHAPES = ("w64", "w896-bh256", "bh32-dt48", "bh96", "bh320-dt48")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pack", [2, 8])
@pytest.mark.parametrize("name", PACK_SHAPES)
def test_plain_packed_direct_and_bucket_match_jax_kernels(name, pack, dtype):
    """tband_spmm_direct and tband_spmm_bucket on packed A_t (their plain
    versions on the CPU, which expand it first) against the JAX package's
    kernels with the same ``pack`` (interpret mode); fp32 within 1e-5, bf16
    within 1e-2 of max|ref|."""
    dt, trash, w, bh, m = BAND_SHAPES[name]
    sw, st, at, xt, num_sw = band_inputs(dt, trash, w=w, bh=bh, m=m, seed=dt + trash)
    packed = PACKERS[pack](at)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jxt = jnp.asarray(xt).astype(jdt)
    want = np.asarray(jax_tband.tband_spmm_direct(
        jnp.asarray(sw), jnp.asarray(st), jnp.asarray(packed), jxt, num_sw, jdt,
        pack=pack).astype(jnp.float32))
    t = [torch.from_numpy(v) for v in (sw, st, packed)]
    xtt = torch.from_numpy(xt).to(dtype)
    got = tband.tband_spmm_direct(*t, xtt, num_sw, dtype, pack=pack)
    assert got.shape == want.shape == (dt, num_sw * bh) and got.dtype == dtype
    tol = RTOL if dtype == torch.float32 else 1e-2
    assert rel_err(got.float(), want) < tol
    want_b = np.asarray(jax_tband.tband_spmm_bucket(jnp.asarray(st), jnp.asarray(packed), jxt,
                                                    pack=pack))
    got_b = tband.tband_spmm_bucket(t[1], t[2], xtt, pack=pack)
    assert got_b.dtype == torch.float32 and got_b.shape == want_b.shape
    assert rel_err(got_b, want_b) < tol
    # and equal to the unpacked blocks' result
    assert torch.equal(got, tband.tband_spmm_direct(t[0], t[1], torch.from_numpy(at), xtt,
                                                    num_sw, dtype))


# missing superwindows of a 24-superwindow layout (bh 128): (runs of eight,
# singles), zeroed by the direct launch as the reference's zero_lane_blocks
# zeroes them after its direct write
MISSING = {"eights": ([1], []), "singles": ([], [3, 17, 22]), "both": ([2], [0, 5]),
           "neither": ([], [])}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(MISSING))
def test_plain_direct_zeroes_missing_like_jax(case, dtype):
    """tband_spmm_direct with the missing superwindows (its plain version
    on the CPU) against the JAX package's tband_spmm_direct followed by
    zero_lane_blocks on the runs of eight, then on the singles (interpret
    mode).  fp32 on integer X, where every sum order is exact: equal; bf16
    within 1e-2 of max|ref|."""
    m8, m1 = MISSING[case]
    bh, num_sw, w = 128, 24, 256
    m = num_sw * bh
    missing = set(m1) | {8 * r + j for r in m8 for j in range(8)}
    rs = np.random.RandomState(len(missing))
    owned = np.array([s for s in range(num_sw) if s not in missing])
    sw = np.concatenate([rs.permutation(owned), [num_sw]]).astype(np.int32)  # + one padded
    at = (rs.rand(len(sw), w, bh) < 0.05).astype(np.int8)
    st = (rs.randint(0, (m - w) // 128 + 1, len(sw)) * 128).astype(np.int32)
    if dtype == torch.float32:
        xt = rs.randint(-8, 9, (16, m)).astype(np.float32)
    else:
        xt = rs.randn(16, m).astype(np.float32)
    ids = [np.asarray(v, dtype=np.int32) for v in (m8, m1)]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_tband.tband_spmm_direct(jnp.asarray(sw), jnp.asarray(st), jnp.asarray(at),
                                       jnp.asarray(xt).astype(jdt), num_sw, jdt, trash=True)
    for v, width in zip(ids, (8 * bh, bh)):
        want = jax_tspill.zero_lane_blocks(want, jnp.asarray(v), width)
    want = np.asarray(want.astype(jnp.float32))
    got = tband.tband_spmm_direct(torch.from_numpy(sw), torch.from_numpy(st),
                                  torch.from_numpy(at), torch.from_numpy(xt).to(dtype), num_sw,
                                  dtype, *(torch.from_numpy(v) for v in ids))
    assert got.shape == want.shape == (16, m) and got.dtype == dtype
    got = got.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_array_equal(got, want)
    else:
        assert rel_err(got, want) < 1e-2
    for s in missing:
        assert not got[:, s * bh:(s + 1) * bh].any()


def banded_graph(n, deg, near, far, seed=0):
    """Symmetric banded graph: rows of the first half reach +-near, of
    the second +-far; at band widths (128, 384) its tband plan fills two
    buckets and covers every superwindow (chip_smoke.py uses the same)."""
    rs = np.random.RandomState(seed)
    src = np.repeat(np.arange(n), deg)
    half = np.where(src < n // 2, near, far)
    dst = np.clip(src + rs.randint(0, 1 << 20, src.size) % (2 * half + 1) - half, 0, n - 1)
    s = np.concatenate([src, dst]).astype(np.int32)
    d = np.concatenate([dst, src]).astype(np.int32)
    return (*io.to_csr(s, d, n), n)


PLANS = {
    "single_bucket": (lambda: small_graph(300, 6),
                      dict(impl="pallas", band_impl="tband", band_h=128,
                           band_mode="always")),
    "two_buckets": (lambda: banded_graph(600, 4, 10, 100),
                    dict(impl="pallas", band_impl="tband", band_h=128,
                         band_widths=(128, 384), band_spill="never",
                         band_mode="always")),
}


@pytest.mark.parametrize("dt", [16, 32])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_spmm_tband_padded_matches_jax_and_scipy(name, dt):
    graph, fields = PLANS[name]
    rp, ci, n = graph()
    op = HybridSpMM(rp, ci, n, PlanConfig(**fields), device="cpu")
    plan = op.plan
    nonempty = [len(s) > 0 for s in plan.band_sw_ids]
    assert nonempty == ([True, True] if name == "two_buckets" else [True])
    m = plan.padded_rows
    xt = np.zeros((dt, m), np.float32)
    xt[:, :n] = np.random.RandomState(7).randn(dt, n)
    got = tband.spmm_tband_padded(op.arrays["f"], torch.from_numpy(xt), plan,
                                  torch.float32)
    jplan = jax_build_plan(rp, ci, n, JaxPlanConfig(**fields))
    jarrs = {k: jnp.asarray(v) for k, v in jplan.device_arrays().items()}
    want = np.asarray(jax_tband.spmm_tband_padded(jarrs, jnp.asarray(xt), jplan,
                                                  jnp.float32))
    assert got.shape == want.shape == (dt, m)
    assert rel_err(got, want) < RTOL
    a = sp.csr_matrix((np.ones(len(ci)), ci, rp), shape=(n, n))
    oracle = (a @ xt[:, :n].T.astype(np.float64)).T
    assert rel_err(got[:, :n], oracle) < RTOL
    assert not got[:, n:].any()  # padded lanes stay zero: the layout closes


def random_graph(n, e, seed):
    """Symmetric uniform random graph of 2e edges: at low degree its tband
    plan leaves superwindows uncovered (or, sparse enough, all of them)."""
    rs = np.random.RandomState(seed)
    src, dst = rs.randint(0, n, e), rs.randint(0, n, e)
    s = np.concatenate([src, dst]).astype(np.int32)
    d = np.concatenate([dst, src]).astype(np.int32)
    return (*io.to_csr(s, d, n), n)


SPILL = dict(impl="pallas", band_impl="tband", band_h=128, band_widths=(128,),
             band_mode="auto")
TINY_CAPS = dict(SPILL, ts_table_mb=1e-3, ts_span=256, ts_k=32, ts2_table_mb=48 * 64 / 1e6)

# the reference's own spill plans (tests/test_tband.py:53, 65, 97, 118),
# partial and empty band cover, and the take form of the spill
SPILL_PLANS = {
    "spill": (lambda: small_graph(500, 8, span=400), SPILL),
    "t1_t2": (lambda: small_graph(1400, 9, span=1300), TINY_CAPS),
    "hub_split": (lambda: small_graph(1400, 9, span=1300),
                  dict(TINY_CAPS, spill_hub_mb=64 * 64 / 1e6, spill_hub_min_cov=0.01,
                       spill_hub_min_reuse=0.0)),
    "two_buckets": (lambda: small_graph(700, 10, span=500),
                    dict(SPILL, band_widths=(128, 256))),
    "missing_supers": (lambda: random_graph(4096, 1024, 5120), SPILL),
    "no_cover": (lambda: random_graph(16384, 4096, 20480), SPILL),
    "take": (lambda: small_graph(500, 8, span=400), dict(SPILL, spill_impl="take")),
}


def spill_case(name, dt, dtype, with_jax=True):
    """(port output, JAX output or None, scipy float64 oracle, plan) for
    one plan of SPILL_PLANS on a seeded X^T."""
    graph, fields = SPILL_PLANS[name]
    rp, ci, n = graph()
    op = HybridSpMM(rp, ci, n, PlanConfig(**dict(fields, compute_dtype=dtype)), device="cpu")
    plan = op.plan
    xt = np.zeros((dt, plan.padded_rows), np.float32)
    xt[:, :n] = np.random.RandomState(7).randn(dt, n)
    cd = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    got = tband.spmm_tband_padded(op.arrays["f"], torch.from_numpy(xt), plan, cd)
    want = None
    if with_jax:
        jplan = jax_build_plan(rp, ci, n, JaxPlanConfig(**dict(fields, compute_dtype=dtype)))
        jarrs = {k: jnp.asarray(v) for k, v in jplan.device_arrays().items()}
        jcd = getattr(jnp, dtype)
        want = np.asarray(jax.jit(lambda a, x: jax_tband.spmm_tband_padded(a, x, jplan, jcd))(
            jarrs, jnp.asarray(xt)).astype(jnp.float32))
    a = sp.csr_matrix((np.ones(len(ci)), ci, rp), shape=(n, n))
    xr = xt[:, :n] if dtype == "float32" else torch.from_numpy(xt[:, :n]).to(cd).float().numpy()
    oracle = (a @ xr.T.astype(np.float64)).T
    return got.float(), want, oracle, plan


@pytest.mark.parametrize("name", sorted(SPILL_PLANS))
def test_spill_plans_match_jax_and_scipy(name):
    got, want, oracle, plan = spill_case(name, 16, "float32")
    n = plan.num_nodes
    assert plan.spill_nnz > 0
    assert plan.band_nnz + plan.spill_nnz == plan.nnz  # every edge applied once
    if name == "t1_t2":
        assert plan.ts_lo is not None and len(plan.ts2_segs) > 1
    if name == "hub_split":
        assert plan.hub_lo is not None and plan.ds_h_laneg is not None
    if name == "missing_supers":
        arrs = plan.device_arrays(dense_band=False)
        assert len(arrs["band_missing_sw8"]) and len(arrs["band_missing_sw"])
    if name == "no_cover":
        assert not any(len(s) for s in plan.band_sw_ids)
    if name == "take":
        assert plan.ds_tlocal is None and plan.ds_blk is None
    assert got.shape == want.shape == (16, plan.padded_rows)
    assert rel_err(got, want) < RTOL
    assert rel_err(got[:, :n], oracle) < RTOL
    assert not got[:, n:].any()  # padded lanes stay zero: the layout closes


@pytest.mark.parametrize("name", ["spill", "two_buckets", "missing_supers", "hub_split"])
def test_spill_plans_bf16_match_jax_and_scipy(name):
    """bf16: the band output is rounded first, the merge adds in fp32 and
    rounds once, as the reference does; within 1e-2 of max|ref|.  The JAX
    package cannot run its bf16 mxgather on the CPU (XLA's CPU dot has no
    bf16 x bf16 -> f32), so the hub split is held against scipy only."""
    with_jax = name != "hub_split"
    got, want, oracle, plan = spill_case(name, 32, "bfloat16", with_jax=with_jax)
    if with_jax:
        assert rel_err(got, want) < 1e-2
    assert rel_err(got[:, :plan.num_nodes], oracle) < 1e-2


@pytest.mark.parametrize("pack", [2, 8])
@pytest.mark.parametrize("name", ["single_bucket", "two_buckets", "spill", "missing_supers"])
def test_packed_plans_match_jax_and_scipy(name, pack):
    """``HybridSpMM`` on a ``PlanConfig(band_impl='tband', tband_pack=p)``
    plan (full cover with one and two buckets, a spill plan and one with
    missing superwindows): the upload holds ``band{s}_at`` packed (uint8, the
    stored shape), and ``apply_padded`` matches the JAX operator on the same
    config, the unpacked plan's output bit for bit, and scipy."""
    graph, fields = PLANS[name] if name in PLANS else SPILL_PLANS[name]
    rp, ci, n = graph()
    ops = {p: HybridSpMM(rp, ci, n, PlanConfig(**dict(fields, tband_pack=p)), device="cpu")
           for p in (1, pack)}
    op = ops[pack]
    assert op.plan.tband_pack == pack
    for s, w in enumerate(op.plan.band_widths):
        at = op.arrays["f"][f"band{s}_at"]
        if at.shape[0]:
            assert at.dtype == torch.uint8
            assert tband.logical_wh(at, pack) == (w, op.plan.band_h)
            assert torch.equal(tband.expand_at(at, pack), ops[1].arrays["f"][f"band{s}_at"])
    jop = JaxHybridSpMM(rp, ci, n, JaxPlanConfig(**dict(fields, tband_pack=pack)))
    x = np.random.RandomState(7).randn(n, 24).astype(np.float32)
    got = op.unpad_output(op.apply_padded(op.arrays, op.pad_input(x)), 24)
    want = jop.unpad_output(jop.apply_padded(jop.arrays, jop.pad_input(jnp.asarray(x))), 24)
    assert rel_err(got, want) < RTOL
    assert torch.equal(got, ops[1].unpad_output(ops[1].apply_padded(
        ops[1].arrays, ops[1].pad_input(x)), 24))
    a = sp.csr_matrix((np.ones(len(ci)), ci, rp), shape=(n, n))
    assert rel_err(got, a @ x.astype(np.float64)) < RTOL
    assert (op.plan.spill_nnz > 0) == (name not in PLANS)


def test_check_band_arrays_rejects_out_of_range_slices():
    st = np.array([0, 128], np.int32)
    sw = np.array([0, 1], np.int32)
    tband.check_band_arrays(st, sw, 256, 384, 2)
    with pytest.raises(ValueError):
        tband.check_band_arrays(st + 64, sw, 256, 1024, 2)   # not 128-aligned
    with pytest.raises(ValueError):
        tband.check_band_arrays(st, sw, 256, 256, 2)         # st + W > M
    with pytest.raises(ValueError):
        tband.check_band_arrays(st, sw + 2, 256, 384, 2)     # sw > num_sw


def test_bench_needs_cuda_and_builds_its_yardstick():
    """utils/bench.py refuses to run without a card, and its yardstick (the
    blocks as one CSR matrix) computes the direct mode's product on the
    owned blocks."""
    from hcspmm_tpu_torch.utils import bench

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            bench.main()
    sw, st, at, xt, num_sw = band_inputs(16, 2)
    t = [torch.from_numpy(v) for v in (sw, st, at, xt)]
    csr = bench.block_csr(t[2].transpose(1, 2), t[1], t[0], num_sw, xt.shape[1])
    want = tband.tband_spmm_direct(*t, num_sw, torch.float32)
    assert rel_err(torch.sparse.mm(csr, t[3].T.contiguous()).T, want) < RTOL


def test_wrapper_rejects_devices_it_has_no_kernel_for():
    sw, st, at, xt, num_sw = band_inputs(16, 0)
    t = [torch.from_numpy(v).to("meta") for v in (sw, st, at, xt)]
    with pytest.raises(ValueError):
        tband.tband_spmm_direct(*t, num_sw, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(BAND_SHAPES.values()), ids=list(BAND_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(dtype, shape):
    """Both modes against the plain versions; two runs bitwise equal; in
    fp32 the direct output equals the fused kernel's aggregate bit for bit
    (both sum each element over its rows in increasing k)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    dt, trash, w, bh, m = shape
    sw, st, at, xt, num_sw = band_inputs(dt, trash, w=w, bh=bh, m=m, seed=dt + trash)
    t = [torch.from_numpy(v).cuda() for v in (sw, st, at, xt)]
    t[3] = t[3].to(dtype)
    before = tband.launches
    got = tband.tband_spmm_direct(*t, num_sw, dtype)
    again = tband.tband_spmm_direct(*t, num_sw, dtype)
    got_b = tband.tband_spmm_bucket(t[1], t[2], t[3])
    torch.cuda.synchronize()
    assert tband.launches == before + 3
    assert torch.equal(got, again)
    ref = tband.tband_spmm_direct_plain(*t, num_sw, dtype)
    assert rel_err(got.float().cpu(), ref.float().cpu()) < tol
    assert rel_err(got_b.cpu(), tband.tband_spmm_bucket_plain(t[1], t[2], t[3]).cpu()) < tol
    if dtype == torch.float32:
        wt = torch.randn((16, dt), device="cuda")
        agg, _ = tband.tband_fused_direct(*t, wt, num_sw, dtype)
        assert torch.equal(agg, got)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(BAND_SHAPES.values()), ids=list(BAND_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_packed_kernels_equal_pack_1(dtype, shape):
    """The kernel reading packed A_t (``tband_pack`` 2 and 8, never expanded
    on the card): the direct and bucket modes and the fused forms (ht 32
    and 96) give the pack-1 kernel's outputs bit for bit, and two runs are
    bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dt, trash, w, bh, m = shape
    sw, st, at, xt, num_sw = band_inputs(dt, trash, w=w, bh=bh, m=m, seed=dt + trash)
    sw, st, xt = (torch.from_numpy(v).cuda() for v in (sw, st, xt))
    xt = xt.to(dtype)
    ats = {1: torch.from_numpy(at).cuda(),
           **{p: torch.from_numpy(f(at)).cuda() for p, f in PACKERS.items()}}
    wts = [torch.randn((ht, dt), device="cuda").to(dtype) for ht in (32, 96)]

    def outs(p):
        res = [tband.tband_spmm_direct(sw, st, ats[p], xt, num_sw, dtype, pack=p),
               tband.tband_spmm_bucket(st, ats[p], xt, pack=p)]
        for wt in wts:
            res += tband.tband_fused_direct(sw, st, ats[p], xt, wt, num_sw, dtype, pack=p)
        return res

    ref = outs(1)
    for p in PACKERS:
        before = tband.pack_launches[p]
        got, again = outs(p), outs(p)
        torch.cuda.synchronize()
        assert tband.pack_launches[p] == before + 8
        for g, a, r in zip(got, again, ref):
            assert torch.equal(g, a) and torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hub_split", "missing_supers", "no_cover"])
def test_cuda_spill_chain_matches_cpu(name):
    """The whole padded SpMM through the CUDA kernels against the CPU run
    of the same plan (plain versions), fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    graph, fields = SPILL_PLANS[name]
    rp, ci, n = graph()
    ops = [HybridSpMM(rp, ci, n, PlanConfig(**fields), device=d) for d in ("cpu", "cuda")]
    x = np.random.RandomState(2).randn(n, 24).astype(np.float32)
    with torch.no_grad():
        out = [op.unpad_output(op.apply_padded(op.arrays, op.pad_input(x)), 24).cpu()
               for op in ops]
    assert rel_err(out[1], out[0]) < RTOL
