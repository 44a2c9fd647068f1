"""The port's row layout [N, d] against the JAX package on the CPU: HC-SpMM's
own hybrid of dense windows, ELL rows and residual rows
(hcspmm_tpu_torch/kernels/block_spmm.py: ``dense_bucket_spmm``,
``ell_bucket_spmm``, ``ell_residual_spmm``, ``spmm_rows``) and the plain
``impl='xla'`` form (ops/spmm.py ``_spmm_xla``).

The kernels' plain versions are held against the Pallas kernels in
interpret mode; ``spmm_rows`` against ``spmm_pallas`` and ``_spmm_xla``
against the JAX ``_spmm_xla`` through the two packages' operators, over
the cases of tests/test_spmm.py and tests/test_pallas_kernels.py (LOI
modes, unaligned N, windows wider than the last bucket, empty rows, self
loops and duplicates, bf16, a residual population, a plan mixing band,
dense and ELL rows, full-cover band plans); then gradients, the GCN/GIN
cores, the padded fallback, and GCN/GIN/SAGE training steps against JAX's
``make_train_step`` with the same weights.

Tolerance: fp32 within 1e-5 of max|ref| (the order of fp32 sums only),
bf16 within 1e-2 (X rounded to bf16 once, sums in fp32).  On the CPU each
wrapper runs its plain version; the CUDA kernels (csrc/rows.cu) are held
against the same plain versions by the tests marked ``cuda`` and by
chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hcspmm_tpu.config import PlanConfig as JaxPlanConfig
from hcspmm_tpu.kernels import block_spmm as jax_block_spmm
from hcspmm_tpu.models.net import Net as JaxNet
from hcspmm_tpu.models.net import init_net_params as jax_init_net_params
from hcspmm_tpu.models.net import net_forward as jax_net_forward
from hcspmm_tpu.ops import spmm as jax_spmm
from hcspmm_tpu.ops.spmm import HybridSpMM as JaxHybridSpMM
from hcspmm_tpu.train.loop import make_train_step as jax_make_train_step

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.format.plan import build_plan
from hcspmm_tpu_torch.graphs import io
from hcspmm_tpu_torch.kernels import block_spmm
from hcspmm_tpu_torch.models.net import Net, net_forward, params_from_jax
from hcspmm_tpu_torch.models.sag import SAG
from hcspmm_tpu_torch.ops import spmm as port_spmm
from hcspmm_tpu_torch.ops.spmm import HybridSpMM, spmm_reference_dense
from hcspmm_tpu_torch.train.loop import Bound, make_train_step, train

from conftest import small_graph

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NEVER = dict(band_mode="never")


def to_np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def rel_err(got, ref):
    got, ref = (np.asarray(to_np(v), dtype=np.float64) for v in (got, ref))
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


def bf16_values(x):
    """x rounded to bf16, as fp32 (the reference's f32 gather container)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def table(seed, n, d):
    """[n + 1, d] features whose last row is the zero row."""
    x = np.random.RandomState(seed).randn(n + 1, d).astype(np.float32)
    x[n] = 0
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kb,d", [(32, 20), (64, 1), (96, 33)])
def test_dense_bucket_spmm_matches_jax(kb, d, dtype):
    """Windows with pad columns at the zero row, one all-pad window; the
    reference widens bf16 to an f32 container before this kernel
    (block_spmm.py:928-932), the port in registers."""
    rng = np.random.RandomState(kb)
    n, wb, wh = 200, 8, 16
    cols = np.stack([np.sort(rng.choice(n, kb, replace=False)) for _ in range(wb)])
    cols[:, kb - 5:] = n
    cols[wb - 1] = n
    cols = cols.astype(np.int32)
    a = (rng.rand(wb, wh, kb) < 0.2).astype(np.int8)
    a[:, :, kb - 5:] = 0
    x = table(kb + 1, n, d)
    xj = bf16_values(x) if dtype == torch.bfloat16 else x
    want = np.asarray(jax_block_spmm.dense_bucket_spmm(
        jnp.asarray(cols), jnp.asarray(a), jnp.asarray(xj), window_h=wh))
    got = block_spmm.dense_bucket_spmm(torch.from_numpy(cols), torch.from_numpy(a),
                                       torch.from_numpy(x).to(dtype))
    assert got.dtype == torch.float32 and got.shape == want.shape == (wb, wh, d)
    assert rel_err(got, want) < TOL[torch.float32]
    assert not got[wb - 1].any()
    # the table without its zero row: pad columns point past it
    short = block_spmm.dense_bucket_spmm(torch.from_numpy(cols), torch.from_numpy(a),
                                         torch.from_numpy(x[:n]).to(dtype))
    assert torch.equal(short, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wh", [32, 64])
def test_dense_bucket_spmm_tall_windows_match_jax(wh, dtype):
    """Windows taller than 16 rows (``PlanConfig(window_h=32)``): the
    reference's kernel takes any height, and so does the port's."""
    rng = np.random.RandomState(wh)
    n, wb, kb, d = 300, 5, 64, 24
    cols = np.stack([np.sort(rng.choice(n, kb, replace=False)) for _ in range(wb)])
    cols[:, kb - 3:] = n
    cols = cols.astype(np.int32)
    a = (rng.rand(wb, wh, kb) < 0.2).astype(np.int8)
    a[:, :, kb - 3:] = 0
    x = table(wh, n, d)
    xj = bf16_values(x) if dtype == torch.bfloat16 else x
    want = np.asarray(jax_block_spmm.dense_bucket_spmm(
        jnp.asarray(cols), jnp.asarray(a), jnp.asarray(xj), window_h=wh))
    got = block_spmm.dense_bucket_spmm(torch.from_numpy(cols), torch.from_numpy(a),
                                       torch.from_numpy(x).to(dtype))
    assert got.shape == want.shape == (wb, wh, d)
    assert rel_err(got, want) < TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("de,d", [(4, 32), (8, 7), (16, 130)])
def test_ell_bucket_spmm_matches_jax(de, d, dtype):
    rng = np.random.RandomState(de)
    n, rb = 300, 16
    cols = rng.randint(0, n, (rb, de)).astype(np.int32)
    deg = rng.randint(1, de + 1, rb)
    cols[np.arange(de)[None, :] >= deg[:, None]] = n
    x = table(de + 3, n, d)
    xj = bf16_values(x) if dtype == torch.bfloat16 else x
    want = np.asarray(jax_block_spmm.ell_bucket_spmm(jnp.asarray(cols), jnp.asarray(xj)))
    got = block_spmm.ell_bucket_spmm(torch.from_numpy(cols), torch.from_numpy(x).to(dtype))
    assert got.dtype == torch.float32 and got.shape == want.shape == (rb, d)
    assert rel_err(got, want) < TOL[torch.float32]
    out = torch.full((rb, d), float("nan"))
    assert block_spmm.ell_bucket_spmm(torch.from_numpy(cols), torch.from_numpy(x[:n]).to(dtype),
                                      out=out) is out
    assert torch.equal(out, got)


def test_ell_residual_spmm_matches_segment_sum():
    """CSR mode: rows of sorted edges (one empty row, padding edges after
    the last start) against the reference's sorted segment-sum."""
    rng = np.random.RandomState(4)
    n, rs, d = 400, 5, 24
    seg = np.sort(np.concatenate([rng.randint(0, rs, 900), np.full(7, rs)]))
    seg[seg == 2] = 3  # row 2 is empty
    cols = rng.randint(0, n + 1, seg.size).astype(np.int32)
    x = table(5, n, d)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x)[cols], jnp.asarray(seg),
                                          num_segments=rs + 1, indices_are_sorted=True))[:rs]
    ptr = block_spmm.sparse_seg_ptr(seg, rs)
    np.testing.assert_array_equal(ptr, np.searchsorted(seg, np.arange(rs + 1)))
    got = block_spmm.ell_residual_spmm(torch.from_numpy(ptr), torch.from_numpy(cols),
                                       torch.from_numpy(x[:n]))
    assert rel_err(got, want) < TOL[torch.float32]
    assert not got[2].any()
    with pytest.raises(ValueError, match="sorted"):
        block_spmm.sparse_seg_ptr(seg[::-1], rs)


# ---------------------------------------------------------------------------
# spmm_rows and _spmm_xla against the JAX package, through the operators
# ---------------------------------------------------------------------------


def hub_graph():
    """tests/test_spmm.py:40: a window with ~41 unique columns (wider than
    every bucket of (8, 16))."""
    n = 48
    src = np.concatenate([np.zeros(40, np.int32), np.array([17], np.int32)])
    dst = np.concatenate([np.arange(1, 41, dtype=np.int32), np.array([3], np.int32)])
    rp, ci = io.to_csr(np.concatenate([src, dst]), np.concatenate([dst, src]), n)
    return rp, ci, n


def edges_graph(src, dst, n):
    rp, ci = io.to_csr(np.asarray(src, np.int32), np.asarray(dst, np.int32), n)
    return rp, ci, n


def bucket_graph(windows=12, seed=0):
    """Directed graph whose 16-row window w reaches 3 + 4w distinct columns:
    at the widths of NINE its dense windows fill ten buckets, more than the
    dense kernel's table of eight."""
    rs = np.random.RandomState(seed)
    n = 16 * windows
    src, dst = [], []
    for w in range(windows):
        cols = rs.choice(n, 3 + 4 * w, replace=False)
        rows = 16 * w + np.arange(16)
        src += [rows[j % 16] for j in range(len(cols))] + list(np.repeat(rows, 2))
        dst += list(cols) + list(rs.choice(cols, 32))
    return edges_graph(src, dst, n)


NINE = dict(NEVER, loi_mode="all_dense", bucket_widths=(4, 8, 12, 16, 20, 24, 28, 32, 40, 48))


MIXED = dict(band_spill="never", band_h=64, band_widths=(128,), loi_mode="calibrated")

CASES = {
    # name: (graph, config, dim)
    "intended": (lambda: small_graph(100, 6), NEVER, 7),
    "all_dense": (lambda: small_graph(100, 6), dict(NEVER, loi_mode="all_dense"), 32),
    "all_sparse": (lambda: small_graph(100, 6), dict(NEVER, loi_mode="all_sparse"), 96),
    "degenerate": (lambda: small_graph(100, 6), dict(NEVER, loi_mode="degenerate"), 7),
    "calibrated": (lambda: small_graph(300, 6, span=40), dict(NEVER, loi_mode="calibrated"), 20),
    "unaligned": (lambda: small_graph(37, 3, span=8), NEVER, 5),
    "wide_window": (hub_graph, dict(NEVER, loi_mode="all_dense", bucket_widths=(8, 16)), 9),
    "empty_rows": (lambda: edges_graph([0, 5], [5, 0], 100), NEVER, 4),
    "self_loops": (lambda: edges_graph([0, 0, 1, 1, 1], [0, 1, 0, 0, 2], 20), NEVER, 3),
    "residual": (lambda: small_graph(200, 9, span=60), dict(NEVER, ell_widths=(4, 8)), 16),
    "mixed": (lambda: small_graph(300, 6), MIXED, 24),
    "full_cover": (lambda: small_graph(300, 6), dict(band_h=64, band_widths=(128, 256),
                                                     band_mode="always"), 40),
    "default": (lambda: small_graph(101, 12, span=64), {}, 33),
    "nine_buckets": (bucket_graph, NINE, 24),
    "window32": (lambda: small_graph(300, 6, span=40), dict(NEVER, loi_mode="calibrated",
                                                            window_h=32), 20),
}


def both(name, impl="pallas", cd="float32", **kw):
    graph, cfg, d = CASES[name]
    rp, ci, nn = graph()
    fields = dict(cfg, impl=impl, compute_dtype=cd)
    op = HybridSpMM(rp, ci, nn, PlanConfig(**fields), device="cpu", **kw)
    jop = JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(**fields), **kw)
    x = np.random.RandomState(len(name)).randn(nn, d).astype(np.float32)
    return op, jop, x, spmm_reference_dense(rp, ci, nn, x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_spmm_rows_matches_jax_spmm_pallas(name):
    op, jop, x, ref = both(name)
    p = op.plan
    assert op.supports_padded == jop.supports_padded
    if name == "mixed":
        assert p.band_nnz and p.dense_nnz and p.sparse_nnz and not op.supports_padded
    if name == "residual":
        assert (p.sparse_edge_seg < p.num_sparse_rows).sum() > 0
    if name == "wide_window":
        assert p.sparse_nnz > 0 and p.num_dense_windows < 3
    got = block_spmm.spmm_rows(op.arrays["f"], torch.from_numpy(x), p, torch.float32)
    want = jax.jit(lambda a, v: jax_block_spmm.spmm_pallas(a, v, jop.plan, jnp.float32))(
        jop.arrays["f"], jnp.asarray(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    assert rel_err(got, want) < TOL[torch.float32]
    assert rel_err(got, ref) < TOL[torch.float32]
    assert rel_err(op(torch.from_numpy(x)), ref) < TOL[torch.float32]


@pytest.mark.parametrize("name", ["intended", "calibrated", "residual", "mixed", "full_cover",
                                  "empty_rows"])
def test_spmm_xla_matches_jax_spmm_xla(name):
    op, jop, x, ref = both(name, impl="xla")
    assert not op.supports_padded and not jop.supports_padded
    p = op.plan
    got = port_spmm._spmm_xla(op.arrays["f"], torch.from_numpy(x), p, torch.float32)
    want = jax.jit(lambda a, v: jax_spmm._spmm_xla(
        a, v, num_buckets=len(p.bucket_widths), num_ell=len(p.ell_widths),
        num_band=len(p.band_widths), window_h=p.window_h, band_h=p.band_h,
        num_sparse_rows=p.num_sparse_rows, xp_rows=p.xp_rows, compute_dtype=jnp.float32,
        num_spill_rows=p.num_spill_rows if p.has_spill else 0))(jop.arrays["f"],
                                                                jnp.asarray(x))
    assert rel_err(got, want) < TOL[torch.float32]
    assert rel_err(got, ref) < TOL[torch.float32]
    assert rel_err(op(torch.from_numpy(x)), jax.jit(jop)(jnp.asarray(x))) < TOL[torch.float32]


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("name", ["calibrated", "mixed"])
def test_bf16_rows_match_jax_and_oracle(name, impl):
    """bf16 compute: X rounded to bf16 once, every population summed in
    fp32, the output back in x's dtype (fp32 here, as the reference)."""
    op, jop, x, _ = both(name, impl=impl, cd="bfloat16")
    got = op(torch.from_numpy(x))
    assert got.dtype == torch.float32
    ref = spmm_reference_dense(*CASES[name][0](), bf16_values(x))
    assert rel_err(got, ref) < TOL[torch.bfloat16]
    if impl == "pallas":
        assert rel_err(got, jax.jit(jop)(jnp.asarray(x))) < TOL[torch.bfloat16]


def test_spill_plan_row_form_matches_jax():
    """A wide plan with missing superwindows and a spill population, in the
    row layout: band buckets, zero rows for the missing superwindows, and
    the take path onto [N, d]."""
    rs = np.random.RandomState(5120)
    src, dst = rs.randint(0, 4096, 1024), rs.randint(0, 4096, 1024)
    rp, ci, nn = edges_graph(np.concatenate([src, dst]), np.concatenate([dst, src]), 4096)
    cfg = dict(band_h=128, band_widths=(128,), band_mode="auto")
    op = HybridSpMM(rp, ci, nn, PlanConfig(**cfg), device="cpu")
    jop = JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(**cfg))
    assert op.plan.spill_nnz > 0 and len(op.plan.band_missing_sw) > 0
    x = np.random.RandomState(3).randn(nn, 12).astype(np.float32)
    got = block_spmm.spmm_rows(op.arrays["f"], torch.from_numpy(x), op.plan, torch.float32)
    assert rel_err(got, jax.jit(jop)(jnp.asarray(x))) < TOL[torch.float32]
    assert rel_err(got, spmm_reference_dense(rp, ci, nn, x)) < TOL[torch.float32]


@pytest.mark.parametrize("layout", ["rows", "padded"])
@pytest.mark.parametrize("symmetric", [True, False])
def test_row_layout_gradient_matches_jax(symmetric, layout):
    """d/dX of sum(A X * cot): the backward runs the row SpMM on the plan
    over A^T for a directed graph (tests/test_spmm.py:73); ``apply_padded``
    without the padded path goes through the row op."""
    rp, ci, nn = small_graph(120, 5, symmetric=symmetric)
    cfg = dict(NEVER, loi_mode="calibrated")
    op = HybridSpMM(rp, ci, nn, PlanConfig(**cfg), symmetric=symmetric, device="cpu")
    jop = JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(**cfg), symmetric=symmetric)
    assert not op.supports_padded and (op.plan_bwd is None) == symmetric
    rs = np.random.RandomState(5)
    x = rs.randn(nn, 6).astype(np.float32)
    cot = rs.randn(nn, 6).astype(np.float32)
    xv = torch.from_numpy(x).requires_grad_(True)
    if layout == "rows":
        out = op.apply(op.arrays, xv)
    else:
        out = op.unpad_output(op.apply_padded(op.arrays, op.pad_input(xv)), 6)
    (out * torch.from_numpy(cot)).sum().backward()
    want = jax.jit(jax.grad(lambda v: jnp.sum(jop.apply(jop.arrays, v) * cot)))(jnp.asarray(x))
    a = spmm_reference_dense(rp, ci, nn, np.eye(nn))
    assert rel_err(xv.grad, want) < TOL[torch.float32]
    assert rel_err(xv.grad, a.T @ cot) < TOL[torch.float32]


def test_padded_fallback_matches_jax():
    """tests/test_pallas_kernels.py:168: without the padded path,
    ``pad_input`` gives [M, dp] and ``apply_padded`` runs the row op on its
    first N rows."""
    op, jop, x, ref = both("mixed")
    xp = op.pad_input(x)
    jxp = jop.pad_input(jnp.asarray(x))
    assert tuple(xp.shape) == tuple(jxp.shape) and not op.transposed
    got = op.apply_padded(op.arrays, xp)
    assert not got[op.plan.num_nodes:].any()
    want = jax.jit(jop.apply_padded)(jop.arrays, jxp)
    assert rel_err(got, want) < TOL[torch.float32]
    assert rel_err(op.unpad_output(got, x.shape[1]), ref) < TOL[torch.float32]


@pytest.mark.parametrize("core", ["gcn", "gin"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_row_layer_cores_match_jax(impl, core):
    """The row layout's GCN and GIN cores (``make_fused_ops``): values and
    both gradients against the JAX package's custom VJPs."""
    op, jop, x, _ = both("calibrated", impl=impl)
    w = (np.random.RandomState(1).randn(x.shape[1], 9) * 0.3).astype(np.float32)
    xv = torch.from_numpy(x).requires_grad_(True)
    wv = torch.from_numpy(w).requires_grad_(True)
    out = getattr(op, f"{core}_apply")(op.arrays, xv, wv)
    (out ** 2).sum().backward()
    japply = getattr(jop, f"{core}_apply")

    def loss(a, b):
        return jnp.sum(japply(jop.arrays, a, b) ** 2)

    want = japply(jop.arrays, jnp.asarray(x), jnp.asarray(w))
    gx, gw = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w))
    assert rel_err(out, want) < TOL[torch.float32]
    assert rel_err(xv.grad, gx) < TOL[torch.float32]
    assert rel_err(wv.grad, gw) < TOL[torch.float32]


def test_normalized_and_mean_rows_match_jax():
    op, jop, x, _ = both("mixed", normalize=True)
    assert rel_err(op(torch.from_numpy(x)), jax.jit(jop)(jnp.asarray(x))) < TOL[torch.float32]
    assert rel_err(op.mean(torch.from_numpy(x)), jop.mean(jnp.asarray(x))) < TOL[torch.float32]
    w = np.random.RandomState(2).randn(x.shape[1], 5).astype(np.float32)
    for core in ("gcn_apply", "gin_apply"):
        got = getattr(op, core)(op.arrays, torch.from_numpy(x), torch.from_numpy(w))
        want = getattr(jop, core)(jop.arrays, jnp.asarray(x), jnp.asarray(w))
        assert rel_err(got, want) < TOL[torch.float32]


def test_sag_profiles_a_row_layout_operator():
    op, _, x, ref = both("calibrated")
    res = SAG(op).profile(x, num_rounds=2, warmup=1)
    assert res["device"] == "cpu" and res["avg_ms"] > 0
    assert rel_err(res["out"], ref) < TOL[torch.float32]


def test_sag_refuses_an_operator_without_a_device():
    """SAG times on the operator's device and never falls back to the CPU."""
    with pytest.raises(ValueError, match="spmm.device"):
        SAG(lambda x: x)


# ---------------------------------------------------------------------------
# models and training steps in the row layout
# ---------------------------------------------------------------------------

DIMS = dict(num_features=12, hidden=16, num_classes=5, num_layers=3)


def model_case(model, cfg):
    rp, ci, nn = small_graph(300, 6)
    op = HybridSpMM(rp, ci, nn, PlanConfig(**cfg), device="cpu")
    jop = JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(**cfg))
    net = Net(model=model, dropout=0.0, **DIMS)
    jnet = JaxNet(model=model, dropout=0.0, **DIMS)
    jparams = jax_init_net_params(jnet, jax.random.PRNGKey(0), init="glorot")
    x = np.random.RandomState(0).randn(nn, DIMS["num_features"]).astype(np.float32)
    return op, jop, net, jnet, jparams, x


@pytest.mark.parametrize("model", ["gcn", "gin", "sage"])
@pytest.mark.parametrize("cfg", [MIXED, dict(NEVER, impl="xla")], ids=["mixed", "xla"])
def test_row_layout_forward_and_adam_steps_match_jax(model, cfg):
    """Log-probabilities, then three Adam steps (lr 0.01, dropout 0):
    torch.optim.Adam against optax.adam through JAX's make_train_step, both
    in the row layout; losses and parameters within rtol 1e-4."""
    op, jop, net, jnet, jparams, x = model_case(model, cfg)
    assert not op.supports_padded and not Bound(op).padded_layout
    with torch.no_grad():
        got = net_forward(net, params_from_jax(jparams, device=op.device), Bound(op),
                          torch.from_numpy(x))
    want = jax_net_forward(jnet, jparams, jop, jnp.asarray(x))
    assert rel_err(got, want) < 1e-5
    y = np.ones(x.shape[0], dtype=np.int64)
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


def test_row_and_padded_training_agree():
    """tests/test_models.py:188: the same network trained in the wide
    padded layout and in the row layout (band_mode='never') reaches the
    same loss."""
    src, dst, nn = io.synthetic_blocks(256, 4, 32, seed=3)
    rp, ci = io.to_csr(src, dst, nn)
    op_p = HybridSpMM(rp, ci, nn, PlanConfig(band_mode="always", band_h=32,
                                             band_widths=(128,)), device="cpu")
    op_u = HybridSpMM(rp, ci, nn, PlanConfig(**NEVER), device="cpu")
    assert op_p.supports_padded and not op_u.supports_padded
    x = np.random.RandomState(0).randn(nn, 12).astype(np.float32)
    y = np.ones(nn, dtype=np.int64)
    for model in ("gcn", "gin", "sage"):
        net = Net(model=model, dropout=0.0, num_features=12, hidden=8, num_classes=5,
                  num_layers=3)
        res = [train(net, op, x, y, epochs=4, warmup_epochs=0, seed=1) for op in (op_p, op_u)]
        np.testing.assert_allclose(res[0]["final_loss"], res[1]["final_loss"], rtol=1e-3,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the gates and the host checks
# ---------------------------------------------------------------------------


def test_row_layout_gates_name_their_roadmap_items():
    """int4 band blocks (A.12) raise naming their item; shard-uniform proxy
    plans raise (each rank runs its own shard plan); rectangular plans
    (A.10) and the tiled band (A.11) run in the row layout."""
    rp, ci, nn = small_graph(300, 6)
    op = HybridSpMM(rp, ci, nn, PlanConfig(band_impl="tiled", band_h=128), device="cpu")
    x = np.random.RandomState(0).randn(nn, 10).astype(np.float32)
    assert op.plan.tiled
    assert rel_err(op(torch.from_numpy(x)), spmm_reference_dense(rp, ci, nn, x)) < 1e-5
    with pytest.raises(NotImplementedError, match="A.12"):
        HybridSpMM(rp, ci, nn, PlanConfig(a_dtype="int4"), device="cpu")
    plan = build_plan(rp, ci, nn, PlanConfig(**NEVER))
    bad = dataclasses.replace(plan, shard_uniform=True)
    with pytest.raises(NotImplementedError, match="shard-uniform"):
        block_spmm.rows_check(bad)
    with pytest.raises(NotImplementedError, match="shard-uniform"):
        port_spmm.make_spmm(bad)
    # a rectangular plan: 8 more columns than rows, X carrying them
    rect = build_plan(rp, ci, nn, PlanConfig(**NEVER), num_cols=nn + 8)
    block_spmm.rows_check(rect)
    xr = np.concatenate([x, np.random.RandomState(1).randn(8, 10).astype(np.float32)])
    got = port_spmm.make_spmm(rect)(port_spmm._to_device(rect, "cpu"), None,
                                    torch.from_numpy(xr))
    assert rel_err(got, spmm_reference_dense(rp, ci, nn, x)) < 1e-5
    with pytest.raises(ValueError, match="column space"):
        port_spmm.make_spmm(rect)(port_spmm._to_device(rect, "cpu"), None, torch.from_numpy(x))
    with pytest.raises(ValueError, match="impl"):
        HybridSpMM(rp, ci, nn, PlanConfig(band_impl="tband", band_h=128, impl="xla"), device="cpu")


def test_make_spmm_padded_returns_none_without_the_padded_path():
    rp, ci, nn = small_graph(300, 6)
    for cfg, has in ((NEVER, False), (MIXED, False), ({}, True)):
        plan = build_plan(rp, ci, nn, PlanConfig(**cfg))
        assert (port_spmm.make_spmm_padded(plan) is not None) == has
        assert block_spmm.spmm_padded_supported(plan) == jax_block_spmm.spmm_padded_supported(
            build_plan(rp, ci, nn, PlanConfig(**cfg)))


def test_check_row_arrays_rejects_bad_indices():
    plan = build_plan(*small_graph(300, 6), PlanConfig(**MIXED))
    host = plan.device_arrays(dense_band=False)
    extra = block_spmm.check_row_arrays(host, plan)
    assert extra["sparse_seg_ptr"].shape == (plan.num_sparse_rows + 1,)
    b = next(i for i, c in enumerate(plan.bucket_cols) if len(c))
    e = next(i for i, c in enumerate(plan.ell_cols) if len(c))
    total = block_spmm.row_population_rows(plan)
    for key, value in ((f"b{b}_cols", np.full_like(host[f"b{b}_cols"], plan.num_cols + 1)),
                       (f"e{e}_cols", np.full_like(host[f"e{e}_cols"], -1)),
                       ("sparse_edge_col", np.full_like(host["sparse_edge_col"], -2)),
                       ("out_perm", np.full_like(host["out_perm"], total + 1))):
        with pytest.raises(ValueError, match=key):
            block_spmm.check_row_arrays(dict(host, **{key: value}), plan)
    graph, cfg, _ = CASES["residual"]
    plan = build_plan(*graph(), PlanConfig(**cfg))
    host = plan.device_arrays(dense_band=False)
    assert (host["sparse_edge_seg"] < plan.num_sparse_rows).sum() > 1
    with pytest.raises(ValueError, match="sorted"):
        block_spmm.check_row_arrays(dict(host, sparse_edge_seg=host["sparse_edge_seg"][::-1]),
                                    plan)


def test_window_masks_hold_the_dense_blocks_bits():
    """The dense kernel's row masks (``window_masks``, built on the host):
    bit k of row r is A[r, k] != 0, for widths that are and are not
    multiples of 32."""
    rng = np.random.RandomState(3)
    for kb in (8, 16, 32, 40, 96, 256):
        a = (rng.rand(5, 16, kb) < 0.3).astype(np.int8)
        m = block_spmm.window_masks(a)
        assert m.dtype == np.int32 and m.shape == (5, 16, -(-kb // 32))
        words = m.view(np.uint32).astype(np.int64)
        bits = (words[..., :, None] >> np.arange(32)) & 1
        np.testing.assert_array_equal(bits.reshape(5, 16, -1)[..., :kb], a)
        assert not bits.reshape(5, 16, -1)[..., kb:].any()


def _row_table_rows(tab):
    """{node: entries} of the upload's row table."""
    ptr = tab["rw_ptr"]
    return {int(v): tab["rw_cols"][ptr[i]:ptr[i + 1]].tolist()
            for i, v in enumerate(tab["rw_node"])}


@pytest.mark.parametrize("name", ["residual", "mixed", "unaligned", "empty_rows", "intended"])
def test_row_table_holds_the_buckets_real_entries(name):
    """The ELL kernel's row table: each ELL row and each residual row with
    its real entries in order (pad entries at num_cols dropped), each node
    of no population as an empty row, every node once; hub, middle and short
    rows in that order, counted in ``rows_meta``."""
    graph, cfg, _ = CASES[name]
    rp, ci, nn = graph()
    plan = build_plan(rp, ci, nn, PlanConfig(**cfg))
    host = plan.device_arrays(dense_band=False)
    tab = block_spmm.check_row_arrays(host, plan)
    got = _row_table_rows(tab)
    assert len(got) == tab["rw_node"].size  # no node twice
    want = {}
    for e in range(len(plan.ell_widths)):
        for i, v in enumerate(plan.ell_row_ids[e]):
            row = plan.ell_cols[e][i]
            want[int(v)] = row[row != plan.num_cols].tolist()
    rs = plan.num_sparse_rows
    for r in np.unique(plan.sparse_edge_seg[plan.sparse_edge_seg < rs]):
        want[int(plan.sparse_rows[r])] = plan.sparse_edge_col[plan.sparse_edge_seg == r].tolist()
    total = block_spmm.row_population_rows(plan)
    for v in np.flatnonzero(plan.out_perm == total):
        want[int(v)] = []
    assert got == want
    lens = np.diff(tab["rw_ptr"])
    n_hub, n_mid, n_short, n_res = tab["rows_meta"].tolist()
    assert n_hub + n_mid + n_short == lens.size
    assert (lens[:n_hub] >= 64).all() and ((lens[n_hub:n_hub + n_mid] > 16)
                                           & (lens[n_hub:n_hub + n_mid] < 64)).all()
    assert (lens[n_hub + n_mid:] <= 16).all()
    assert n_res == np.unique(plan.sparse_edge_seg[plan.sparse_edge_seg < rs]).size
    if name == "residual":
        assert n_res > 0 and n_hub > 0


def test_owner_partition_refuses_a_node_owned_twice_or_by_none():
    """The upload derives each node's owner from the plan's populations and
    holds it against ``out_perm``: a node claimed by two rows, or a node
    that ``out_perm`` gives a population row no table claims, is refused."""
    plan = build_plan(*small_graph(300, 6), PlanConfig(**MIXED))
    host = plan.device_arrays(dense_band=False)
    tab = block_spmm.check_row_arrays(host, plan)
    assert {"b0_wid", "b0_m", "rw_node", "band0_rq", "band0_rnode"} <= set(tab)
    e = next(i for i, r in enumerate(plan.ell_row_ids) if len(r))
    b = next(i for i, w in enumerate(plan.bucket_window_ids) if len(w))
    dense_node = int(plan.bucket_window_ids[b][0]) * plan.window_h
    twice = list(plan.ell_row_ids)
    twice[e] = np.concatenate([twice[e][:-1], [dense_node]])  # a dense window's row
    with pytest.raises(ValueError, match="already owns"):
        block_spmm.check_row_arrays(host, dataclasses.replace(plan, ell_row_ids=twice))
    none = list(plan.ell_row_ids)
    none[e] = none[e][1:]  # its first row is left to nobody
    with pytest.raises(ValueError, match="owned by none"):
        block_spmm.check_row_arrays(host, dataclasses.replace(plan, ell_row_ids=none))
    zero = np.flatnonzero(plan.out_perm == block_spmm.row_population_rows(plan))
    if zero.size:  # a node of no population that out_perm sends to a row
        perm = host["out_perm"].copy()
        perm[zero[0]] = perm[plan.ell_row_ids[e][0]]
        with pytest.raises(ValueError, match="out_perm disagrees"):
            block_spmm.check_row_arrays(dict(host, out_perm=perm), plan)
    outside = list(plan.bucket_window_ids)
    outside[b] = outside[b] - plan.num_nodes  # negative window ids
    with pytest.raises(ValueError, match="outside"):
        block_spmm.check_row_arrays(host, dataclasses.replace(plan, bucket_window_ids=outside))


@pytest.mark.parametrize("name", ["mixed", "unaligned", "empty_rows", "residual", "calibrated",
                                  "nine_buckets", "window32"])
def test_population_launches_write_every_row_by_node_id(name):
    """The whole-population entries (``dense_rows``: every dense bucket;
    ``ell_rows``: ELL, residual and empty rows), through their plain
    versions, into a NaN-filled [N, d]: every row not owned by a band
    bucket is written, and with the band rows they give the SpMM of the JAX
    ``spmm_pallas`` and of scipy.  N is no multiple of 16 in 'unaligned'
    and 'mixed', 'empty_rows' has zero-degree nodes, 'mixed' is a
    partial-cover plan with band, dense and ELL rows."""
    op, jop, x, ref = both(name)
    p, arrs = op.plan, op.arrays["f"]
    n, d = x.shape
    if name in ("unaligned", "mixed"):
        assert n % 16 and p.num_dense_windows
    if name == "mixed":
        assert p.band_nnz and not p.band_full_cover and len(p.ell_row_ids[0])
    xt = torch.from_numpy(x)
    out = torch.full((n, d), float("nan"))
    block_spmm.dense_rows(arrs, p, xt, out)
    block_spmm.ell_rows(arrs, xt, out)
    band = torch.zeros(n, dtype=torch.bool)
    for s in range(len(p.band_widths)):
        band[arrs[f"band{s}_rnode"]] = True
    assert not out[~band].isnan().any() and out[band].isnan().all()
    got = block_spmm.spmm_rows(arrs, xt, p, torch.float32)
    assert rel_err(got[~band], ref[~band.numpy()]) < TOL[torch.float32]
    want = jax.jit(lambda a, v: jax_block_spmm.spmm_pallas(a, v, jop.plan, jnp.float32))(
        jop.arrays["f"], jnp.asarray(x))
    assert rel_err(got, want) < TOL[torch.float32]
    assert rel_err(got, ref) < TOL[torch.float32]


def test_dense_launches_split_the_bucket_table():
    """``dense_rows`` launches once for each group of at most eight
    non-empty dense buckets (the table a launch takes by value), widest
    first, every bucket in one group: two launches for the ten buckets of
    'nine_buckets', one for the others."""
    for name in ("nine_buckets", "calibrated", "mixed"):
        op, _, _, _ = both(name)
        p, arrs = op.plan, op.arrays["f"]
        groups = block_spmm.dense_launch_groups(arrs, p)
        order = [b for g in groups for b in g]
        nonempty = [b for b in range(len(p.bucket_widths)) if len(p.bucket_window_ids[b])]
        assert sorted(order) == nonempty
        assert order == sorted(nonempty, key=lambda b: -p.bucket_widths[b])
        assert all(0 < len(g) <= 8 for g in groups)
        assert len(groups) == -(-len(nonempty) // 8)
        if name == "nine_buckets":
            assert len(nonempty) >= 9 and len(groups) == 2


def test_window_heights_16_and_32_agree():
    """One graph's row plans at window_h 16 and 32 on the same X: both
    give scipy's product, so they agree with each other to fp32 tolerance."""
    rp, ci, nn = small_graph(300, 6, span=40)
    x = np.random.RandomState(3).randn(nn, 20).astype(np.float32)
    ref = spmm_reference_dense(rp, ci, nn, x)
    outs = []
    for wh in (16, 32):
        op = HybridSpMM(rp, ci, nn, PlanConfig(**dict(NEVER, loi_mode="calibrated", window_h=wh)),
                        device="cpu")
        assert op.plan.window_h == wh and op.plan.num_dense_windows
        outs.append(op(torch.from_numpy(x)))
        assert rel_err(outs[-1], ref) < TOL[torch.float32]
    assert rel_err(outs[1], outs[0]) < TOL[torch.float32]


def test_backward_plan_has_its_own_owner_tables():
    """A directed graph (``symmetric=False``): the backward plan over A^T
    has its own row table, whose empty rows are the nodes without
    out-edges, and the gradient through it matches JAX and A^T @ g."""
    rs = np.random.RandomState(9)
    n = 203
    src = rs.randint(0, 150, 900)  # nodes 150.. have no out-edges
    dst = np.clip(src + rs.randint(-20, 21, src.size), 0, n - 1)
    rp, ci = io.to_csr(src.astype(np.int32), dst.astype(np.int32), n)
    cfg = dict(NEVER, loi_mode="calibrated", ell_widths=(4, 8))
    op = HybridSpMM(rp, ci, n, PlanConfig(**cfg), symmetric=False, device="cpu")
    jop = JaxHybridSpMM(rp, ci, n, JaxPlanConfig(**cfg), symmetric=False)
    fwd, bwd = (_row_table_rows({k: v.numpy() for k, v in op.arrays[k].items()
                                 if k.startswith("rw_")}) for k in ("f", "b"))

    def empty(table):
        return {v for v, e in table.items() if not e}

    def in_windows(plan):  # rows of dense windows: the dense launch writes them
        return {int(w) * plan.window_h + r for ids in plan.bucket_window_ids for w in ids
                for r in range(plan.window_h)}

    no_out = set(np.flatnonzero(np.diff(rp) == 0).tolist())
    no_in = set(np.flatnonzero(np.bincount(ci, minlength=n) == 0).tolist())
    assert empty(fwd) == no_out - in_windows(op.plan)
    assert empty(bwd) == no_in - in_windows(op.plan_bwd)
    assert empty(fwd) != empty(bwd)
    x = rs.randn(n, 5).astype(np.float32)
    g = rs.randn(n, 5).astype(np.float32)
    xv = torch.from_numpy(x).requires_grad_(True)
    (op.apply(op.arrays, xv) * torch.from_numpy(g)).sum().backward()
    want = jax.jit(jax.grad(lambda v: jnp.sum(jop.apply(jop.arrays, v) * g)))(jnp.asarray(x))
    a = spmm_reference_dense(rp, ci, n, np.eye(n))
    assert rel_err(xv.grad, want) < TOL[torch.float32]
    assert rel_err(xv.grad, a.T @ g) < TOL[torch.float32]


def test_row_wrappers_reject_meta_tensors():
    """A wrapper takes the plain version only for CPU tensors; on any other
    device without a kernel it raises."""
    meta = dict(device="meta")
    cols = torch.zeros(8, 32, dtype=torch.int32, **meta)
    with pytest.raises(ValueError):
        block_spmm.dense_bucket_spmm(cols, torch.zeros(8, 16, 32, dtype=torch.int8, **meta),
                                     torch.empty(100, 32, **meta))
    with pytest.raises(ValueError):
        block_spmm.ell_bucket_spmm(cols, torch.empty(100, 32, **meta))
    with pytest.raises(ValueError):
        block_spmm.ell_residual_spmm(torch.zeros(3, dtype=torch.int32, **meta),
                                     torch.zeros(9, dtype=torch.int32, **meta),
                                     torch.empty(100, 32, **meta))


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on a card only)
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/rows.cu has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 20, 32, 96, 256])
def test_cuda_row_kernels_match_plain_and_are_deterministic(d, dtype):
    _need_cuda()
    rng = np.random.RandomState(d)
    n = 5000
    x = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to("cuda", dtype)
    before = dict(block_spmm.row_launches)
    for kb in (32, 64, 96, 256):
        wb = 37
        cols = torch.from_numpy(np.where(rng.rand(wb, kb) < 0.1, n, rng.randint(0, n, (wb, kb)))
                                .astype(np.int32)).cuda()
        a = torch.from_numpy((rng.rand(wb, 16, kb) < 0.1).astype(np.int8)).cuda()
        got = block_spmm.dense_bucket_spmm(cols, a, x)
        assert torch.equal(got, block_spmm.dense_bucket_spmm(cols, a, x))
        assert rel_err(got.cpu(), block_spmm.dense_bucket_spmm_plain(cols, a, x).cpu()) < 1e-5
    for de in (4, 8, 16, 32, 64, 128, 256):
        cols = torch.from_numpy(rng.randint(0, n + 1, (301, de)).astype(np.int32)).cuda()
        got = block_spmm.ell_bucket_spmm(cols, x)
        assert torch.equal(got, block_spmm.ell_bucket_spmm(cols, x))
        assert rel_err(got.cpu(), block_spmm.ell_bucket_spmm_plain(cols, x).cpu()) < 1e-5
    ptr = torch.tensor([0, 0, 3000, 3001, 9000], dtype=torch.int32, device="cuda")
    cols = torch.from_numpy(rng.randint(0, n, 9000).astype(np.int32)).cuda()
    got = block_spmm.ell_residual_spmm(ptr, cols, x)
    assert torch.equal(got, block_spmm.ell_residual_spmm(ptr, cols, x))
    assert rel_err(got.cpu(), block_spmm.ell_residual_spmm_plain(ptr, cols, x).cpu()) < 1e-5
    torch.cuda.synchronize()
    assert block_spmm.row_launches["dense_bucket_spmm"] == before["dense_bucket_spmm"] + 8
    assert block_spmm.row_launches["ell_bucket_spmm"] == before["ell_bucket_spmm"] + 14


@pytest.mark.cuda
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_cuda_spmm_rows_matches_cpu(cd):
    _need_cuda()
    for name in ("calibrated", "mixed", "residual"):
        graph, cfg, d = CASES[name]
        rp, ci, nn = graph()
        x = torch.from_numpy(np.random.RandomState(0).randn(nn, d).astype(np.float32))
        ops = [HybridSpMM(rp, ci, nn, PlanConfig(**dict(cfg, compute_dtype=cd)), device=dev)
               for dev in ("cpu", "cuda")]
        got = ops[1](x.cuda())
        assert torch.equal(got, ops[1](x.cuda()))
        assert rel_err(got.cpu(), ops[0](x)) < TOL[DT[cd]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["calibrated", "mixed", "residual", "unaligned", "nine_buckets",
                                  "window32"])
def test_cuda_population_launches_match_plain(name, dtype):
    """``dense_rows`` and ``ell_rows`` on the card against their plain
    versions (every row they own written, bitwise repeatable), and one
    SpMM's launches: one ELL launch, the residual riding it, and one dense
    launch for each group of at most eight dense buckets."""
    _need_cuda()
    graph, cfg, _ = CASES[name]
    rp, ci, nn = graph()
    op = HybridSpMM(rp, ci, nn, PlanConfig(**cfg), device="cuda")
    p, arrs = op.plan, op.arrays["f"]
    for d in (1, 20, 32, 96, 256):
        x = torch.from_numpy(np.random.RandomState(d).randn(nn, d).astype(np.float32)).to(
            "cuda", dtype)

        def run(kernel):
            out = torch.zeros((nn, d), device="cuda")
            if kernel:
                block_spmm.dense_rows(arrs, p, x, out)
                return block_spmm.ell_rows(arrs, x, out)
            block_spmm.dense_rows_plain(arrs, p, x, out)
            return block_spmm.ell_rows_plain(arrs["rw_node"], arrs["rw_ptr"], arrs["rw_cols"],
                                             x, out)

        got = run(True)
        assert torch.equal(got, run(True))
        assert rel_err(got.cpu(), run(False).cpu()) < 1e-5
    before = dict(block_spmm.row_launches)
    with torch.no_grad():
        op(torch.randn((nn, 8), device="cuda"))
    torch.cuda.synchronize()
    after = {k: v - before[k] for k, v in block_spmm.row_launches.items()}
    n_res = int(arrs["rows_meta"][3])
    assert after == {"dense_bucket_spmm": len(block_spmm.dense_launch_groups(arrs, p)),
                     "ell_bucket_spmm": int(arrs["rw_node"].shape[0] > 0),
                     "ell_residual": int(n_res > 0)}


def test_row_variants_substitutes_named_constants():
    """``utils/row_variants.py`` rebuilds csrc/rows.cu with named constants
    changed: each name must match exactly one ``constexpr int``."""
    from hcspmm_tpu_torch.kernels import _build
    from hcspmm_tpu_torch.utils.row_variants import variant_source

    with open(f"{_build.CSRC}/rows.cu") as f:
        src = f.read()
    got = variant_source(src, "STAGES=2,EU=8")
    assert "constexpr int STAGES = 2;" in got and "constexpr int EU = 8;" in got
    assert got.replace("STAGES = 2;", "STAGES = 1;").replace("EU = 8;", "EU = 4;") == src
    with pytest.raises(ValueError, match="NOPE"):
        variant_source(src, "NOPE=1")
