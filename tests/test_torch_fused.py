"""The port's kernel-fusion mode against the JAX package on the CPU: the two
fused kernels' plain versions (hcspmm_tpu_torch/kernels/tband.py
``tband_fused_direct``, kernels/block_spmm.py ``band_fused_spmm_direct``)
against the Pallas kernels in interpret mode, then the fused GCN/GIN layer
cores with ``prefer_fused_kernel`` set on both packages' plans, in the
transposed (tband), wide and row layouts, with and without spill: values
and gradients against the JAX package's custom VJPs and the dense oracle,
the fused launches counted, and a network trained from weights carried
across by ``params_from_jax``.

The JAX tests never set ``prefer_fused_kernel``, so these are its fused
kernels' only tests.  On the CPU each wrapper runs its plain version; the
CUDA kernels are held against the same plain versions by the tests marked
``cuda`` and by chip_smoke.py.  Tolerance: fp32 within 1e-5 of max|ref| (the
order of fp32 sums only), bf16 within 1e-2 (one rounding of fp32 sums, and
the aggregate's rounding to bf16 before the second product, as in JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hcspmm_tpu.config import PlanConfig as JaxPlanConfig
from hcspmm_tpu.kernels import block_spmm as jax_block_spmm
from hcspmm_tpu.kernels import tband as jax_tband
from hcspmm_tpu.models.net import Net as JaxNet
from hcspmm_tpu.models.net import init_net_params as jax_init_net_params
from hcspmm_tpu.models.net import net_forward as jax_net_forward
from hcspmm_tpu.ops.spmm import HybridSpMM as JaxHybridSpMM
from hcspmm_tpu.ops.spmm import make_fused_ops as jax_make_fused_ops
from hcspmm_tpu.train.loop import make_train_step as jax_make_train_step

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.format import reorder
from hcspmm_tpu_torch.format.streams import pack_a_bits, pack_a_nibble
from hcspmm_tpu_torch.graphs import io
from hcspmm_tpu_torch.kernels import block_spmm, tband
from hcspmm_tpu_torch.models.net import Net, net_forward, params_from_jax
from hcspmm_tpu_torch.ops.spmm import HybridSpMM, spmm_reference_dense
from hcspmm_tpu_torch.train.loop import make_train_step

from conftest import small_graph

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
RTOL = 1e-5


def to_np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def rel_err(got, ref):
    got, ref = (np.asarray(to_np(v), dtype=np.float64) for v in (got, ref))
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


def jx(a, dtype):
    return jnp.asarray(a).astype(JDT[dtype])


def as_dtype(a, dtype):
    """``a`` rounded to ``dtype``, as float64 (the oracle's inputs)."""
    return torch.from_numpy(a).to(dtype).double().numpy()


# ---------------------------------------------------------------------------
# the fused kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def entries(rng, sb, trash):
    """Entry -> superwindow ids: a permutation of the real ones, then
    ``trash`` capacity-padded entries (sw == num_sw)."""
    return np.concatenate([rng.permutation(sb - trash),
                           np.full(trash, sb - trash)]).astype(np.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dt,ht", [(16, 48), (48, 16), (96, 32), (192, 32), (64, 608)])
def test_tband_fused_direct_matches_jax(dt, ht, dtype):
    """dt 192 / ht 32 and dt 64 / ht 608 would not fit whole in one block's
    shared memory at bh 256 (csrc/tband.cu works slab by slab): every shape
    the reference runs, the port runs."""
    rng = np.random.RandomState(dt + ht)
    sb, w, bh, m, trash = 6, 256, 128, 1024, 2
    at = (rng.rand(sb, w, bh) < 0.05).astype(np.int8)
    st = (rng.randint(0, (m - w) // 128 + 1, sb) * 128).astype(np.int32)
    sw = entries(rng, sb, trash)
    xt = rng.randn(dt, m).astype(np.float32)
    wt = rng.randn(ht, dt).astype(np.float32)
    num_sw = sb - trash
    jagg, jout = jax_tband.tband_fused_direct(jnp.asarray(sw), jnp.asarray(st),
                                              jnp.asarray(at), jx(xt, dtype), jx(wt, dtype),
                                              num_sw, JDT[dtype])
    agg, out = tband.tband_fused_direct(
        torch.from_numpy(sw), torch.from_numpy(st), torch.from_numpy(at),
        torch.from_numpy(xt).to(dtype), torch.from_numpy(wt).to(dtype), num_sw, dtype)
    assert agg.shape == (dt, num_sw * bh) and out.shape == (ht, num_sw * bh)
    assert agg.dtype == out.dtype == dtype
    assert rel_err(agg, jagg.astype(jnp.float32)) < TOL[dtype]
    assert rel_err(out, jout.astype(jnp.float32)) < TOL[dtype]
    # oracle: each entry's block, in superwindow order
    blocks = np.einsum("dsk,skb->dsb", as_dtype(xt, dtype)[:, st[:, None] + np.arange(w)],
                       at.astype(np.float64))
    order = np.argsort(sw[:num_sw])
    want = blocks[:, order].reshape(dt, -1)
    assert rel_err(agg, want) < TOL[dtype]
    agg_w = torch.from_numpy(want).to(dtype).double().numpy()  # agg.astype(wt.dtype)
    assert rel_err(out, as_dtype(wt, dtype) @ agg_w) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dt,ht", [(16, 48), (96, 32)])
@pytest.mark.parametrize("pack", [2, 8])
def test_tband_fused_direct_packed_matches_jax(pack, dt, ht, dtype):
    """tband_fused_direct on packed A_t (``tband_pack`` 2, 8; its plain
    version expands it) against the JAX package's kernel with the same
    ``pack`` (interpret mode), and bit for bit the unpacked blocks' result."""
    rng = np.random.RandomState(dt + ht + pack)
    sb, w, bh, m, trash = 6, 256, 128, 1024, 2
    at = (rng.rand(sb, w, bh) < 0.05).astype(np.int8)
    packed = {2: pack_a_nibble, 8: pack_a_bits}[pack](at)
    st = (rng.randint(0, (m - w) // 128 + 1, sb) * 128).astype(np.int32)
    sw = entries(rng, sb, trash)
    xt = rng.randn(dt, m).astype(np.float32)
    wt = rng.randn(ht, dt).astype(np.float32)
    num_sw = sb - trash
    jagg, jout = jax_tband.tband_fused_direct(jnp.asarray(sw), jnp.asarray(st),
                                              jnp.asarray(packed), jx(xt, dtype), jx(wt, dtype),
                                              num_sw, JDT[dtype], pack=pack)
    args = [torch.from_numpy(sw), torch.from_numpy(st), torch.from_numpy(packed),
            torch.from_numpy(xt).to(dtype), torch.from_numpy(wt).to(dtype), num_sw, dtype]
    agg, out = tband.tband_fused_direct(*args, pack=pack)
    assert agg.shape == (dt, num_sw * bh) and out.shape == (ht, num_sw * bh)
    assert rel_err(agg, jagg.astype(jnp.float32)) < TOL[dtype]
    assert rel_err(out, jout.astype(jnp.float32)) < TOL[dtype]
    args[2] = torch.from_numpy(at)
    agg1, out1 = tband.tband_fused_direct(*args)
    assert torch.equal(agg, agg1) and torch.equal(out, out1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dp,hp", [(128, 256), (256, 128), (384, 128), (1920, 128)])
def test_band_fused_spmm_direct_matches_jax(dp, hp, dtype):
    """dp 1920 is past the 32 aggregate rows of dp 1792 that csrc/block_spmm.cu
    keeps in shared memory: its slab path runs it."""
    rng = np.random.RandomState(dp + hp)
    sb, bh, bb, m, trash = 6, 32, 256, 1024, 2
    a = (rng.rand(sb, bh, bb) < 0.08).astype(np.int8)
    st = (rng.randint(0, (m - bb) // 16 + 1, sb) * 16).astype(np.int32)
    sw = entries(rng, sb, trash)
    x = rng.randn(m, dp).astype(np.float32)
    w = rng.randn(dp, hp).astype(np.float32)
    num_sw = sb - trash
    jagg, jout = jax_block_spmm.band_fused_spmm_direct(
        jnp.asarray(sw), jnp.asarray(st), jnp.asarray(a), jx(x, dtype), jx(w, dtype), num_sw,
        JDT[dtype])
    agg, out = block_spmm.band_fused_spmm_direct(
        torch.from_numpy(sw), torch.from_numpy(st), torch.from_numpy(a),
        torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype), num_sw, dtype)
    assert agg.shape == (num_sw, bh, dp) and out.shape == (num_sw, bh, hp)
    assert agg.dtype == out.dtype == dtype
    # the Pallas kernel's trailing trash block absorbs the padded entries
    assert rel_err(agg, jagg[:num_sw].astype(jnp.float32)) < TOL[dtype]
    assert rel_err(out, jout[:num_sw].astype(jnp.float32)) < TOL[dtype]
    blocks = np.einsum("sbk,skd->sbd", a.astype(np.float64),
                       as_dtype(x, dtype)[st[:, None] + np.arange(bb)])
    want = blocks[np.argsort(sw[:num_sw])]
    assert rel_err(agg, want) < TOL[dtype]
    agg_w = torch.from_numpy(want).to(dtype).double().numpy()
    assert rel_err(out, agg_w @ as_dtype(w, dtype)) < TOL[dtype]


def test_fused_wrapper_on_zero_blocks_and_bf16_exact_values():
    rng = np.random.RandomState(0)
    sw, st = np.arange(2, dtype=np.int32), np.zeros(2, np.int32)
    a = torch.zeros((2, 32, 128), dtype=torch.int8)
    x = torch.zeros((256, 128))
    agg, out = block_spmm.band_fused_spmm_direct(torch.from_numpy(sw), torch.from_numpy(st),
                                                 a, x, torch.from_numpy(
                                                     rng.randn(128, 64).astype(np.float32)),
                                                 2, torch.float32)
    assert not agg.any() and not out.any() and out.shape == (2, 32, 64)
    # the bf16 product needs the aggregate rounded first: a CPU bf16 call
    # equals the fp32 one on bf16-exact values
    xb = torch.from_numpy(rng.randint(-3, 4, (256, 128)).astype(np.float32))
    a1 = (torch.from_numpy(rng.rand(2, 32, 128)) < 0.1).to(torch.int8)
    wb = torch.from_numpy(rng.randint(-2, 3, (128, 16)).astype(np.float32))
    f32 = block_spmm.band_fused_spmm_direct(torch.from_numpy(sw), torch.from_numpy(st), a1, xb,
                                            wb, 2, torch.float32)
    b16 = block_spmm.band_fused_spmm_direct(torch.from_numpy(sw), torch.from_numpy(st), a1,
                                            xb.bfloat16(), wb.bfloat16(), 2, torch.float32)
    assert torch.equal(f32[0], b16[0]) and torch.equal(f32[1], b16[1])


# ---------------------------------------------------------------------------
# the fused layer cores: tband, wide and row layouts, with and without spill
# ---------------------------------------------------------------------------


def blocks_graph():
    """tests/test_models.py:160's graph: full band cover, no spill."""
    src, dst, nn = io.synthetic_blocks(600, 6, block_size=100, seed=2)
    rp, ci = io.to_csr(src, dst, nn)
    return (*reorder.apply_permutation(rp, ci, nn, reorder.rcm_reorder(rp, ci, nn)), nn)


def banded_graph(n=600, deg=4, near=10, far=100):
    """A symmetric banded graph whose first half reaches +-near and second
    half +-far: its tband plan at widths (128, 384) fills both buckets."""
    rng = np.random.RandomState(0)
    src = np.repeat(np.arange(n), deg)
    half = np.where(src < n // 2, near, far)
    dst = np.clip(src + rng.randint(0, 1 << 20, src.size) % (2 * half + 1) - half, 0, n - 1)
    return (*io.to_csr(np.concatenate([src, dst]).astype(np.int32),
                       np.concatenate([dst, src]).astype(np.int32), n), n)


def powerlaw_graph():
    """tests/test_spill.py:117's graph: a wide plan that spills."""
    src, dst, nn = io.synthetic_powerlaw(512, 4.0, seed=5)
    return (*io.to_csr(src, dst, nn), nn)


CASES = {
    # layout, spill: (graph, config, the fused kernel that must run or None)
    ("tband", False): (blocks_graph, dict(impl="pallas", band_impl="tband", band_h=128,
                                          band_mode="always"), "tband"),
    ("tband", True): (lambda: small_graph(500, 8, span=400),
                      dict(impl="pallas", band_impl="tband", band_h=128, band_widths=(128,),
                           band_mode="auto"), None),
    ("wide", False): (blocks_graph, dict(impl="pallas", band_mode="always", band_h=64,
                                         band_widths=(256,)), "wide"),
    ("wide", True): (powerlaw_graph, dict(impl="pallas", band_mode="always", band_h=64,
                                          band_widths=(128,), band_spill="auto"), "wide"),
}


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the fused kernels' plain versions as the wrappers call them."""
    calls = {"tband": 0, "wide": 0}
    for key, mod, name in (("tband", tband, "tband_fused_direct_plain"),
                           ("wide", block_spmm, "band_fused_spmm_direct_plain")):
        fn = getattr(mod, name)

        def counted(*a, fn=fn, key=key, **k):
            calls[key] += 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return calls


def fused_pair(graph, cfg):
    rp, ci, nn = graph()
    op = HybridSpMM(rp, ci, nn, PlanConfig(**cfg), device="cpu")
    jop = JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(**cfg))
    op.plan.prefer_fused_kernel = True
    jop.plan.prefer_fused_kernel = True
    return op, jop, spmm_reference_dense(rp, ci, nn, np.eye(nn))


def oracle(a, core, x, w):
    """(Z, dX, dW) of loss = sum(Z^2), Z = A X W (both cores)."""
    x, w = x.astype(np.float64), w.astype(np.float64)
    z = a @ x @ w
    g = 2 * z
    return z, a.T @ g @ w.T, (a @ x).T @ g


def core_case(op, core, layout, x, w):
    """The port's core in ``layout`` ('padded' or 'rows'): (Z, dX, dW)."""
    h = w.shape[1]
    xv = torch.from_numpy(x).requires_grad_(True)
    wv = torch.from_numpy(w).requires_grad_(True)
    if layout == "padded":
        out = op.unpad_output(getattr(op, f"{core}_apply_padded")(op.arrays, op.pad_input(xv), wv),
                              h)
    else:
        out = getattr(op, f"{core}_apply")(op.arrays, xv, wv)
    (out ** 2).sum().backward()
    return out.detach(), xv.grad, wv.grad


def jax_core_case(jop, core, layout, x, w):
    h = w.shape[1]
    if layout == "padded":
        japply = getattr(jop, f"{core}_apply_padded")

        def fn(xj, wj):
            return jop.unpad_output(japply(jop.arrays, jop.pad_input(xj), wj), h)
    else:
        # the JAX package reads prefer_fused_kernel when it builds its row
        # layout ops (make_fused_ops), so they are built here, after it is set
        ops = jax_make_fused_ops(jop.plan, jop.plan_bwd, compute_dtype="float32",
                                 impl="pallas")

        def fn(xj, wj):
            return ops[core](jop.arrays["f"], jop.arrays["b"], xj, wj)

    xj, wj = jnp.asarray(x), jnp.asarray(w)
    gx, gw = jax.grad(lambda a, b: jnp.sum(fn(a, b) ** 2), argnums=(0, 1))(xj, wj)
    return fn(xj, wj), gx, gw


@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("core", ["gcn", "gin"])
@pytest.mark.parametrize("layout", ["tband", "wide", "rows"])
def test_fused_layer_cores_match_jax_and_oracle(layout, core, spill, fused_calls):
    """GCN: the forward A (X W), the backward one fused launch on the
    backward plan for (A^T dZ) W^T and A^T dZ.  GIN: the forward one fused
    launch for (A X) W and A X.  The row layout runs on the wide plans.
    Where the JAX package's fused route returns None (a tband plan that
    spills) both compose, and no fused kernel runs."""
    graph, cfg, kernel = CASES[("wide" if layout == "rows" else layout, spill)]
    op, jop, a = fused_pair(graph, cfg)
    assert op.plan.has_spill == spill
    rs = np.random.RandomState(4)
    d, h = 24, 12
    x = rs.randn(a.shape[0], d).astype(np.float32)
    w = (rs.randn(d, h) * 0.1).astype(np.float32)
    mode = "rows" if layout == "rows" else "padded"
    got = core_case(op, core, mode, x, w)
    want = jax_core_case(jop, core, mode, x, w)
    for g, j, o in zip(got, want, oracle(a, core, x, w)):
        assert rel_err(g, j) < RTOL
        assert rel_err(g, o) < RTOL
    # one fused launch: GCN's backward, GIN's forward
    assert fused_calls[kernel] == 1 if kernel else sum(fused_calls.values()) == 0
    if kernel:
        assert fused_calls["tband" if kernel == "wide" else "wide"] == 0


@pytest.mark.parametrize("core", ["gcn", "gin"])
@pytest.mark.parametrize("pack", [2, 8])
def test_fused_layer_cores_on_packed_plans_match_jax_and_oracle(pack, core, fused_calls):
    """The tband fused cores on a ``tband_pack`` 2 or 8 plan: values and
    gradients against the JAX package's cores on the same config and the
    oracle, with the one fused launch reading the packed blocks."""
    graph, cfg, _ = CASES[("tband", False)]
    op, jop, a = fused_pair(graph, dict(cfg, tband_pack=pack))
    assert op.arrays["f"]["band0_at"].dtype == torch.uint8
    rs = np.random.RandomState(4)
    x = rs.randn(a.shape[0], 24).astype(np.float32)
    w = (rs.randn(24, 12) * 0.1).astype(np.float32)
    got = core_case(op, core, "padded", x, w)
    want = jax_core_case(jop, core, "padded", x, w)
    for g, j, o in zip(got, want, oracle(a, core, x, w)):
        assert rel_err(g, j) < RTOL
        assert rel_err(g, o) < RTOL
    assert fused_calls == {"tband": 1, "wide": 0}


@pytest.mark.parametrize("core", ["gcn", "gin"])
def test_fused_mode_is_read_at_call_time(core, fused_calls):
    """``prefer_fused_kernel`` set after construction turns the mode on and
    unset turns it off, in the padded and the row layout, with the values
    unchanged."""
    graph, cfg, _ = CASES[("wide", False)]
    rp, ci, nn = graph()
    op = HybridSpMM(rp, ci, nn, PlanConfig(**cfg), device="cpu")
    rs = np.random.RandomState(5)
    x = rs.randn(nn, 16).astype(np.float32)
    w = rs.randn(16, 8).astype(np.float32)
    res = {}
    for prefer in (False, True, False):
        op.plan.prefer_fused_kernel = prefer
        before = fused_calls["wide"]
        for layout in ("padded", "rows"):
            res[(prefer, layout)] = core_case(op, core, layout, x, w)
        assert fused_calls["wide"] - before == (2 if prefer else 0)
    for layout in ("padded", "rows"):
        for g, c in zip(res[(True, layout)], res[(False, layout)]):
            assert rel_err(g, c) < RTOL


def test_normalized_aggregation_composes_in_the_fused_mode(fused_calls):
    """``normalize=True`` (D^-1/2 A D^-1/2) composes through apply_padded
    whatever the plan prefers, as the JAX package does."""
    graph, cfg, _ = CASES[("wide", False)]
    rp, ci, nn = graph()
    op = HybridSpMM(rp, ci, nn, PlanConfig(**cfg), normalize=True, device="cpu")
    jop = JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(**cfg), normalize=True)
    op.plan.prefer_fused_kernel = jop.plan.prefer_fused_kernel = True
    x = np.random.RandomState(6).randn(nn, 16).astype(np.float32)
    w = np.random.RandomState(7).randn(16, 8).astype(np.float32)
    for core in ("gcn", "gin"):
        got = core_case(op, core, "padded", x, w)
        want = jax_core_case(jop, core, "padded", x, w)
        for g, j in zip(got, want):
            assert rel_err(g, j) < RTOL
    assert fused_calls["wide"] == 0


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["tband", "wide"])
def test_fused_cores_in_the_compute_dtype(layout, cd, fused_calls):
    """The fused cores with a bf16 compute dtype against the composed ones
    (bf16 within 1e-2: the fused kernel rounds the aggregate to bf16 before
    the second product, as the composed path's bf16 SpMM output is)."""
    graph, cfg, kernel = CASES[(layout, False)]
    rp, ci, nn = graph()
    op = HybridSpMM(rp, ci, nn, PlanConfig(**dict(cfg, compute_dtype=cd)), device="cpu")
    rs = np.random.RandomState(8)
    x = rs.randn(nn, 16).astype(np.float32)
    w = (rs.randn(16, 8) * 0.1).astype(np.float32)
    tol = TOL[torch.float32 if cd == "float32" else torch.bfloat16]
    for core in ("gcn", "gin"):
        res = []
        for prefer in (False, True):
            op.plan.prefer_fused_kernel = prefer
            res.append(core_case(op, core, "padded", x, w))
        for g, c in zip(*res[::-1]):
            assert rel_err(g, c) < tol
    assert fused_calls[kernel] == 2


@pytest.mark.parametrize("model", ["gcn", "gin"])
@pytest.mark.parametrize("layout", ["tband", "wide"])
def test_fused_network_with_jax_weights_matches_jax(layout, model):
    """A 3-layer network in the fused mode with weights carried across by
    ``params_from_jax``: the forward pass and three Adam steps (lr 0.01,
    dropout 0) match the JAX package's fused mode within rtol 1e-4."""
    graph, cfg, _ = CASES[(layout, False)]
    op, jop, _ = fused_pair(graph, cfg)
    dims = dict(num_features=24, hidden=16, num_classes=5, num_layers=3)
    net = Net(model=model, dropout=0.0, **dims)
    jnet = JaxNet(model=model, dropout=0.0, **dims)
    jparams = jax_init_net_params(jnet, jax.random.PRNGKey(0), init="glorot")
    x = np.random.RandomState(0).randn(op.plan.num_nodes, 24).astype(np.float32)
    y = np.ones(x.shape[0], dtype=np.int64)
    with torch.no_grad():
        got = net_forward(net, params_from_jax(jparams, device=op.device), op.layout,
                          op.pad_input(x), out_slice=lambda v: op.unpad_output(v, 5))
    assert rel_err(got, jax_net_forward(jnet, jparams, jop, jnp.asarray(x))) < RTOL
    opt = optax.adam(0.01)
    jstep = jax_make_train_step(jnet, jop, opt)
    jstate = opt.init(jparams)
    params = params_from_jax(jparams, device=op.device)
    step = make_train_step(net, op, torch.optim.Adam(
        [t for layer in params for t in layer.values()], lr=0.01))
    key = jax.random.PRNGKey(1)
    for _ in range(3):
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(x), jnp.asarray(y), key)
        loss = step(params, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    for layer, jlayer in zip(params, jparams):
        for k in jlayer:
            np.testing.assert_allclose(layer[k].detach().numpy(), np.asarray(jlayer[k]),
                                       rtol=1e-4, atol=1e-6)


def test_fused_routes_return_none_where_jax_does():
    """The fused wrappers at layer level compose (None) for the plan shapes
    the JAX package's return None for: spill (tband), more than one
    non-empty bucket, a bucket that does not own every superwindow; the
    wide route also for tband and tiled plans."""
    for (rp, ci, nn), cfg in (
            (small_graph(500, 8, span=400),
             dict(band_impl="tband", band_h=128, band_widths=(128,), band_mode="auto")),
            (banded_graph(), dict(band_impl="tband", band_h=128, band_widths=(128, 384),
                                  band_mode="always", band_spill="never"))):
        op = HybridSpMM(rp, ci, nn, PlanConfig(impl="pallas", **cfg), device="cpu")
        jop = JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(impl="pallas", **cfg))
        xt = op.pad_input(torch.zeros(nn, 16))
        wt = torch.zeros(16, 16)
        got = tband.spmm_tband_fused_padded(op.arrays["f"], xt, wt, op.plan)
        want = jax_tband.spmm_tband_fused_padded(jop.arrays["f"], jnp.asarray(xt.numpy()),
                                                 jnp.zeros((16, 16)), jop.plan)
        assert (got is None) == (want is None)
        assert len([v for v in op.plan.band_sw_ids if len(v)]) == 1 + (len(cfg["band_widths"]) > 1)
    op = HybridSpMM(rp, ci, nn, PlanConfig(impl="pallas", band_impl="tband", band_h=128,
                                           band_mode="always"), device="cpu")
    assert block_spmm.spmm_fused_wide_padded(op.arrays["f"], torch.zeros(op.plan.padded_rows, 128),
                                             torch.zeros(128, 128), op.plan) is None
    assert block_spmm.spmm_fused_rows(op.arrays["f"], torch.zeros(nn, 16), torch.zeros(16, 8),
                                      op.plan, torch.float32) is None


# ---------------------------------------------------------------------------
# the fused kernels' launch sizing on the host (an H100's shared memory)
# ---------------------------------------------------------------------------

H100_SMEM = dict(per_sm=233472, reserved=1024, optin=232448)  # bytes, as the card reports them
TWO_BLOCKS = H100_SMEM["per_sm"] // 2 - H100_SMEM["reserved"]


@pytest.mark.parametrize("bb", [384, 640, 1024, 100])
@pytest.mark.parametrize("dp", range(128, 3712 + 1, 128))
def test_fused_launch_wide_fits_every_dp(dp, bb):
    """Every dp from 128 to 3712 (CiteSeer's 3703 features) gets an A tile of
    the unit's 128 rows and the update's slabs in one block, at the plans'
    band widths and one that takes cp.async; rows are staged as the band
    kernel stages them."""
    cfg = block_spmm.fused_launch(bb, dp, 256, **H100_SMEM)
    ring = block_spmm.band_launch(bb, **H100_SMEM)
    assert (cfg["tma"], cfg["box_w"], cfg["nbox"]) == (ring["tma"], ring["box_w"], ring["nbox"])
    assert cfg["arows"] == cfg["unit_rows"] == 128
    assert cfg["smem"] == (block_spmm._FUSED_FIXED_SMEM + block_spmm._FUSED_SLAB_SMEM
                           + cfg["arows"] * cfg["box_w"] * cfg["nbox"])
    assert cfg["smem"] <= H100_SMEM["optin"] and cfg["blocks_per_sm"] == 1
    assert dp % (128 * cfg["ng"]) == 0 and cfg["ng"] in (1, 2, 3, 4)
    assert dp % cfg["w_slab"] == 0 and cfg["passes"] == -(-256 // cfg["tile_cols"])


def test_fused_launch_wide_halves_the_tile_for_wide_bands():
    """A band width whose 128 rows do not fit one block stages fewer rows a
    tile, each tile still beside the update's slabs."""
    cfg = block_spmm.fused_launch(4096, 256, 256, **H100_SMEM)
    assert cfg["arows"] < 128 and cfg["smem"] <= H100_SMEM["optin"]
    assert cfg["smem"] + cfg["arows"] * cfg["box_w"] * cfg["nbox"] > H100_SMEM["optin"]


@pytest.mark.parametrize("bb,dp,hp", [(1 << 18, 256, 256), (640, 200, 256), (640, 0, 256),
                                      (640, 256, 0)])
def test_fused_launch_wide_refuses_what_cannot_run(bb, dp, hp):
    """A band width of which one row and the update's slabs do not fit one
    block, a dp that is no 128-multiple and an empty W are refused on the
    host."""
    with pytest.raises(ValueError):
        block_spmm.fused_launch(bb, dp, hp, **H100_SMEM, aligned=False)


# (dt, ht) the fused routes reach: the GCN backward (dt the layer's output,
# at most 64 in the tband layout; ht its input, any width) and the GIN
# forward (dt the layer's input, any width; ht its output, at most 64)
TBAND_SHAPES = sorted({(dt, ht) for dt in (16, 32, 48, 64)
                       for ht in (16, 32, 64, 96, 608, 3712)}
                      | {(dt, ht) for dt in (16, 96, 192, 512, 3712) for ht in (16, 32, 64)})


@pytest.mark.parametrize("x_elt", [4, 2])
@pytest.mark.parametrize("dt,ht", TBAND_SHAPES)
def test_fused_launch_tband_fits_the_routes(dt, ht, x_elt):
    """Every (dt, ht) the fused routes can reach at bh 256 gets a form that
    fits one block; the register form wherever ht <= 32 (two blocks an SM),
    the whole-aggregate form for a wider ht where dt allows it, and the band
    walked more than once only past both."""
    bh = 256
    cfg = tband.fused_launch(bh, dt, ht, x_elt, **H100_SMEM)
    slab = 32 if dt % 32 == 0 else 16
    stage = 64 * bh + 64 * slab * x_elt
    stride = dt + 1 if cfg["form"] == tband.FUSE_WHOLE else slab + 1
    assert cfg["slab"] == slab
    assert cfg["wsm"] in (0, 32 * cfg["htiles"]) and not (cfg["wsm"] and
                                                           cfg["form"] == tband.FUSE_WHOLE)
    assert cfg["smem"] == (tband._FIXED_SMEM + bh * stride * 4 + cfg["wsm"] * dt * 4
                           + cfg["stages"] * stage)
    room = TWO_BLOCKS if cfg["blocks_per_sm"] == 2 else H100_SMEM["optin"]
    assert 2 <= cfg["stages"] <= 6 and cfg["smem"] <= room
    assert cfg["stages"] == 6 or cfg["smem"] + stage > room
    if ht <= 32:
        one = tband.FUSE_ONE if dt == slab else tband.FUSE_SLAB
        assert (cfg["form"], cfg["htiles"], cfg["blocks_per_sm"]) == (one, 1, 2)
        assert bool(cfg["wsm"]) == (dt <= 192)  # W^T staged while two blocks still fit
    elif dt <= 64:
        assert (cfg["form"], cfg["htiles"]) == (tband.FUSE_WHOLE, 1)
    else:
        whole = tband._FIXED_SMEM + bh * (dt + 1) * 4 + 2 * stage <= H100_SMEM["optin"]
        assert cfg["form"] == (tband.FUSE_WHOLE if whole else tband.FUSE_SLAB)
        assert cfg["htiles"] == (1 if whole else -(-ht // 32))


@pytest.mark.parametrize("pack", [2, 8])
@pytest.mark.parametrize("dt,ht", [(32, 32), (96, 32), (64, 608), (192, 32)])
def test_fused_launch_tband_sizes_the_packed_stage(dt, ht, pack):
    """The ring's stage holds A_t's slab as stored: half the bytes at pack
    2 (rows of bh/2 bytes), pack 1's at pack 8 (a byte row a logical row),
    so pack 2 gets at least pack 1's stages in the same form."""
    bh = 256
    one, packed = (tband.fused_launch(bh, dt, ht, 4, **H100_SMEM, pack=p) for p in (1, pack))
    assert packed["form"] == one["form"] and packed["htiles"] == one["htiles"]
    slab = packed["slab"]
    stride = dt + 1 if packed["form"] == tband.FUSE_WHOLE else slab + 1
    stage = 64 * tband.a_row_bytes(bh, pack) + 64 * slab * 4
    assert packed["smem"] == (tband._FIXED_SMEM + bh * stride * 4 + packed["wsm"] * dt * 4
                              + packed["stages"] * stage)
    if pack == 8:
        assert packed == one
    else:
        assert packed["stages"] >= one["stages"] and stage < 64 * bh + 64 * slab * 4


@pytest.mark.parametrize("bh,dt,ht,smem", [(544, 32, 32, H100_SMEM), (256, 40, 32, H100_SMEM),
                                           (256, 32, 24, H100_SMEM),
                                           (512, 32, 32, dict(H100_SMEM, optin=96 * 1024))])
def test_fused_launch_tband_refuses_what_cannot_run(bh, dt, ht, smem):
    """A band height past 512, dt or ht that is no 16-multiple, and a device
    whose block cannot hold two stages and the sums are refused on the
    host."""
    with pytest.raises(ValueError):
        tband.fused_launch(bh, dt, ht, 4, **smem)


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on a card only)
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/tband.cu and csrc/block_spmm.cu have no CPU "
                    "mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_kernels_match_plain(dtype):
    """Both fused kernels against their plain versions, at small shapes and
    at the C.1 shapes (dt 192 / ht 32, dt 64 / ht 608, dp 3712), two runs
    bitwise equal; in fp32 the aggregate equals the band kernel's output
    bit for bit."""
    _need_cuda()
    rng = np.random.RandomState(0)
    sb, trash = 7, 2
    num_sw = sb - trash
    sw = torch.from_numpy(entries(rng, sb, trash)).cuda()
    at = torch.from_numpy((rng.rand(sb, 256, 128) < 0.05).astype(np.int8)).cuda()
    st = torch.from_numpy((rng.randint(0, 7, sb) * 128).astype(np.int32)).cuda()
    before = tband.kernel_launches["tband_fused_direct"]
    for dt, ht in ((48, 16), (192, 32), (64, 608)):
        xt = torch.from_numpy(rng.randn(dt, 1024).astype(np.float32)).to("cuda", dtype)
        wt = torch.from_numpy(rng.randn(ht, dt).astype(np.float32)).to("cuda", dtype)
        got = tband.tband_fused_direct(sw, st, at, xt, wt, num_sw, dtype)
        again = tband.tband_fused_direct(sw, st, at, xt, wt, num_sw, dtype)
        ref = tband.tband_fused_direct_plain(sw, st, at, xt, wt, num_sw, dtype)
        torch.cuda.synchronize()
        for g, a, r in zip(got, again, ref):
            assert torch.equal(g, a) and rel_err(g.cpu(), r.cpu()) < TOL[dtype]
        if dtype == torch.float32:
            assert torch.equal(got[0], tband.tband_spmm_direct(sw, st, at, xt, num_sw, dtype))
    assert tband.kernel_launches["tband_fused_direct"] == before + 6
    a = torch.from_numpy((rng.rand(sb, 128, 640) < 0.05).astype(np.int8)).cuda()
    st = torch.from_numpy((rng.randint(0, 80, sb) * 16).astype(np.int32)).cuda()
    for dp, hp in ((256, 128), (3712, 256)):
        xp = torch.from_numpy(rng.randn(2048, dp).astype(np.float32)).to("cuda", dtype)
        wp = torch.from_numpy(rng.randn(dp, hp).astype(np.float32)).to("cuda", dtype)
        got = block_spmm.band_fused_spmm_direct(sw, st, a, xp, wp, num_sw, dtype)
        again = block_spmm.band_fused_spmm_direct(sw, st, a, xp, wp, num_sw, dtype)
        ref = block_spmm.band_fused_spmm_direct_plain(sw, st, a, xp, wp, num_sw, dtype)
        torch.cuda.synchronize()
        for g, a_, r in zip(got, again, ref):
            assert torch.equal(g, a_) and rel_err(g.cpu(), r.cpu()) < TOL[dtype]
        if dtype == torch.float32:
            assert torch.equal(got[0], block_spmm.band_bucket_spmm_direct(sw, st, a, xp, num_sw,
                                                                          dtype))
