"""The port's differentiable SpMM (hcspmm_tpu_torch/ops/spmm.py) against
the JAX package's HybridSpMM on the same graphs: values and gradients in
the transposed padded layout and the row layout, the normalized and mean
variants, the transposed backward plan of a directed graph, plans that
spill or leave superwindows uncovered, and the gate that refuses every
plan whose edges it would not all apply.

Tolerance: fp32 within 1e-5 of max|ref| (the order of fp32 sums only).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcspmm_tpu.config import PlanConfig as JaxPlanConfig
from hcspmm_tpu.graphs import io as jax_io
from hcspmm_tpu.ops.spmm import HybridSpMM as JaxHybridSpMM

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.graphs import io
from hcspmm_tpu_torch.kernels import tband
from hcspmm_tpu_torch.ops.spmm import HybridSpMM, spmm_reference_dense

from conftest import small_graph

RTOL = 1e-5
TBAND = dict(impl="pallas", band_impl="tband", band_h=128, band_mode="always")


def rel_err(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


def both(rp, ci, nn, **kw):
    """The port's operator and the JAX package's, on one graph and config."""
    fields = dict(TBAND, **kw.pop("cfg", {}))
    return (HybridSpMM(rp, ci, nn, PlanConfig(**fields), device="cpu", **kw),
            JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(**fields), **kw))


def dense_a(rp, ci, nn):
    return spmm_reference_dense(rp, ci, nn, np.eye(nn))


def test_padded_closure_matches_jax_and_oracle():
    """pad_input -> apply_padded twice -> unpad_output == A @ (A @ X)."""
    rp, ci, nn = small_graph(300, 6)
    op, jop = both(rp, ci, nn)
    d = 32
    x = np.random.RandomState(3).randn(nn, d).astype(np.float32)
    xp = op.pad_input(torch.from_numpy(x))
    assert xp.shape == (32, op.plan.padded_rows)
    got = op.unpad_output(op.apply_padded(op.arrays, op.apply_padded(op.arrays, xp)), d)
    jxp = jop.pad_input(jnp.asarray(x))
    want = jop.unpad_output(jop.apply_padded(jop.arrays, jop.apply_padded(jop.arrays, jxp)), d)
    assert rel_err(got, want) < RTOL
    a = dense_a(rp, ci, nn)
    assert rel_err(got, a @ (a @ x)) < RTOL


@pytest.mark.parametrize("d", [8, 20])
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

    return xv.grad.numpy(), np.asarray(jax.grad(loss)(jnp.asarray(x)))


@pytest.mark.parametrize("layout", ["padded", "rows"])
def test_spmm_gradient_matches_jax_custom_vjp(layout):
    rp, ci, nn = small_graph(200, 5)
    op, jop = both(rp, ci, nn)
    rs = np.random.RandomState(5)
    x = rs.randn(nn, 16).astype(np.float32)
    cot = rs.randn(nn, 16).astype(np.float32)
    got, want = _grads(op, jop, x, cot, layout)
    assert rel_err(got, want) < RTOL
    assert rel_err(got, dense_a(rp, ci, nn).T @ cot) < RTOL


@pytest.mark.parametrize("layout", ["padded", "rows"])
def test_directed_graph_backward_uses_transposed_plan(layout):
    rp, ci, nn = small_graph(300, 6, symmetric=False)
    op, jop = both(rp, ci, nn, symmetric=False)
    assert op.plan_bwd is not None and op.arrays["b"] is not op.arrays["f"]
    a = dense_a(rp, ci, nn)
    assert not np.array_equal(a, a.T), "the test graph must be directed"
    rs = np.random.RandomState(8)
    x = rs.randn(nn, 16).astype(np.float32)
    cot = rs.randn(nn, 16).astype(np.float32)
    got, want = _grads(op, jop, x, cot, layout)
    assert rel_err(got, want) < RTOL
    assert rel_err(got, a.T @ cot) < RTOL
    assert rel_err(op(torch.from_numpy(x)), a @ x) < RTOL


@pytest.mark.parametrize("core", ["gcn", "gin"])
def test_layer_cores_values_and_grads_match_jax(core):
    rp, ci, nn = small_graph(300, 6)
    op, jop = both(rp, ci, nn)
    d, h = 24, 12
    rs = np.random.RandomState(4)
    x = rs.randn(nn, d).astype(np.float32)
    w = (rs.randn(d, h) * 0.1).astype(np.float32)
    xv = torch.from_numpy(x).requires_grad_(True)
    wv = torch.from_numpy(w).requires_grad_(True)
    apply = getattr(op, f"{core}_apply_padded")
    out = op.unpad_output(apply(op.arrays, op.pad_input(xv), wv), h)
    (out ** 2).sum().backward()

    japply = getattr(jop, f"{core}_apply_padded")

    def loss(xj, wj):
        return jnp.sum(jop.unpad_output(japply(jop.arrays, jop.pad_input(xj), wj), h) ** 2)

    jout = jop.unpad_output(japply(jop.arrays, jop.pad_input(jnp.asarray(x)),
                                   jnp.asarray(w)), h)
    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    assert rel_err(out.detach(), jout) < RTOL
    assert rel_err(xv.grad, gx) < RTOL
    assert rel_err(wv.grad, gw) < RTOL


SPILL = dict(TBAND, band_widths=(128,), band_mode="auto")


@pytest.mark.parametrize("ds_kind", ["tile", "block"])
def test_spill_plan_matches_jax_on_lane_and_legacy_paths(ds_kind):
    """A plan that spills runs: once in the padded layout and once in the
    row layout, against the JAX package and the dense oracle, on the lane
    path and on the legacy row-layout merge (``spill_lane='off'`` with
    ``spill_impl='dstream'``, tile and block chunks)."""
    rp, ci, nn = small_graph(500, 8, span=400)
    x = np.random.RandomState(1).randn(nn, 16).astype(np.float32)
    for cfg in (dict(SPILL, band_mode="auto"),
                dict(SPILL, spill_lane="off", spill_impl="dstream", ds_kind=ds_kind)):
        op, jop = both(rp, ci, nn, cfg=cfg)
        assert op.plan.spill_nnz > 0
        assert (op.plan.ds_tlocal is None) == (cfg.get("spill_lane") == "off")
        got = op.unpad_output(op.apply_padded(op.arrays, op.pad_input(x)), 16)
        want = jop.unpad_output(jax.jit(jop.apply_padded)(jop.arrays,
                                                          jop.pad_input(jnp.asarray(x))), 16)
        assert rel_err(got, want) < RTOL
        assert rel_err(got, dense_a(rp, ci, nn) @ x) < RTOL
        assert rel_err(op(torch.from_numpy(x)), jax.jit(jop)(jnp.asarray(x))) < RTOL
    assert op.plan.ds_kind == ds_kind and "ds_gcols" in op.arrays["f"]


def test_partial_cover_plan_raises():
    """Plans whose missing superwindows ride the spill population run and
    match; the gate still refuses a plan whose blocks do not all have one
    owner (a hand-broken cover)."""
    rp, ci, nn = small_graph(700, 10, span=500)
    op, jop = both(rp, ci, nn, cfg=dict(SPILL, band_widths=(128, 256)))
    x = np.random.RandomState(2).randn(nn, 24).astype(np.float32)
    assert rel_err(op(torch.from_numpy(x)), jax.jit(jop)(jnp.asarray(x))) < RTOL
    rs = np.random.RandomState(5120)
    src, dst = rs.randint(0, 4096, 1024), rs.randint(0, 4096, 1024)
    g = io.to_csr(np.concatenate([src, dst]).astype(np.int32),
                  np.concatenate([dst, src]).astype(np.int32), 4096)
    op, jop = both(*g, 4096, cfg=SPILL)
    assert len(op.plan.band_missing_sw) > 0
    x = np.random.RandomState(3).randn(4096, 8).astype(np.float32)
    assert rel_err(op(torch.from_numpy(x)), jax.jit(jop)(jnp.asarray(x))) < RTOL
    assert rel_err(op(torch.from_numpy(x)), dense_a(*g, 4096) @ x) < RTOL

    rp, ci, nn = small_graph(300, 6)
    op = HybridSpMM(rp, ci, nn, PlanConfig(**TBAND), device="cpu")
    partial = dataclasses.replace(op.plan, band_sw_ids=[op.plan.band_sw_ids[0][1:]])
    with pytest.raises(NotImplementedError, match="cover"):
        tband.check_plan(partial)
    with pytest.raises(NotImplementedError, match="cover"):
        tband.spmm_tband_padded(op.arrays["f"], op.pad_input(torch.zeros(nn, 16)),
                                partial, torch.float32)


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_spill_chain_tiny_caps_matches_jax(seed):
    """tests/test_fuzz.py:66's first three seeds: random graphs under tiny
    caps so the mxgather T1, segmented T2 and hub split trigger at toy
    scale; the port against the JAX package (interpret mode) and the dense
    oracle, in the row layout and the padded one."""
    rng = np.random.RandomState(100 + seed)
    n = int(rng.randint(600, 1800))
    src, dst, nn = jax_io.synthetic_graph(n, float(rng.uniform(4, 10)), seed=seed,
                                          span=int(rng.randint(300, max(301, n))))
    rp, ci = jax_io.to_csr(src, dst, nn)
    cap_slots = int(rng.choice([32, 48, 96]))
    hub_slots = int(rng.choice([0, 32, 64]))
    cfg = dict(TBAND, band_mode="auto", band_widths=(128,), ts_table_mb=1e-3, ts_span=256,
               ts_k=int(rng.choice([16, 32])), ts2_table_mb=cap_slots * 64 / 1e6,
               spill_hub_mb=hub_slots * 64 / 1e6, spill_hub_min_cov=0.01,
               spill_hub_min_reuse=0.0, compute_dtype="float32")
    dim = int(rng.randint(3, 40))
    x = rng.randn(nn, dim).astype(np.float32)
    op, jop = both(rp, ci, nn, cfg=cfg)
    assert op.plan.spill_nnz > 0 and op.plan.ts_lo is not None
    got = op(torch.from_numpy(x))
    assert rel_err(got, jax.jit(jop)(jnp.asarray(x))) < RTOL
    assert rel_err(got, spmm_reference_dense(rp, ci, nn, x)) < RTOL
    got_p = op.unpad_output(op.apply_padded(op.arrays, op.pad_input(x)), dim)
    assert rel_err(got_p, got) < RTOL


@pytest.mark.parametrize("layout", ["padded", "rows"])
def test_spill_plan_gradient_matches_jax_custom_vjp(layout):
    """d/dX through a spilling plan with missing superwindows: the backward
    runs the spill chain too (symmetric plan)."""
    rp, ci, nn = small_graph(500, 8, span=400)
    op, jop = both(rp, ci, nn, cfg=SPILL)
    assert op.plan.spill_nnz > 0
    rs = np.random.RandomState(6)
    x = rs.randn(nn, 16).astype(np.float32)
    cot = rs.randn(nn, 16).astype(np.float32)
    got, want = _grads(op, jop, x, cot, layout)
    assert rel_err(got, want) < RTOL
    assert rel_err(got, dense_a(rp, ci, nn).T @ cot) < RTOL


@pytest.mark.parametrize("pack", [2, 8])
def test_packed_a_raises(pack):
    """The packed A_t encodings (``tband_pack`` 2 and 8) no longer raise:
    the plan uploads its blocks packed (uint8, the stored shape) and
    ``apply_padded`` matches the JAX package's operator on the same config
    and the oracle."""
    rp, ci, nn = small_graph(300, 6)
    op, jop = both(rp, ci, nn, cfg=dict(tband_pack=pack))
    at = op.arrays["f"]["band0_at"]
    assert at.dtype == torch.uint8
    assert tband.logical_wh(at, pack) == (op.plan.band_widths[0], op.plan.band_h)
    x = np.random.RandomState(0).randn(nn, 16).astype(np.float32)
    got = op.unpad_output(op.apply_padded(op.arrays, op.pad_input(x)), 16)
    want = jop.unpad_output(jop.apply_padded(jop.arrays, jop.pad_input(jnp.asarray(x))), 16)
    assert rel_err(got, want) < RTOL
    assert rel_err(got, dense_a(rp, ci, nn) @ x) < RTOL


@pytest.mark.parametrize("band_impl", ["wide", "tiled"])
def test_other_layouts_raise(band_impl):
    """The wide padded layout (ROADMAP A.6) and the tiled band (A.11) run
    and match the JAX package and the oracle: neither raises any more."""
    rp, ci, nn = small_graph(300, 6)
    op, jop = both(rp, ci, nn, cfg=dict(band_impl=band_impl))
    assert not op.transposed
    assert op.plan.tiled == jop.plan.tiled == (band_impl == "tiled")
    x = np.random.RandomState(0).randn(nn, 16).astype(np.float32)
    got = op.unpad_output(op.apply_padded(op.arrays, op.pad_input(x)), 16)
    assert rel_err(got, jop.unpad_output(jop.apply_padded(
        jop.arrays, jop.pad_input(jnp.asarray(x))), 16)) < RTOL
    assert rel_err(got, dense_a(rp, ci, nn) @ x) < RTOL


def test_prefer_fused_kernel_raises(monkeypatch):
    """``prefer_fused_kernel`` no longer raises: the tband layer cores run
    the fused kernel (tband_fused_direct, ROADMAP B.13) and match the JAX
    package's fused cores."""
    rp, ci, nn = small_graph(300, 6)
    op, jop = both(rp, ci, nn)
    op.plan.prefer_fused_kernel = jop.plan.prefer_fused_kernel = True
    calls = []
    plain = tband.tband_fused_direct_plain
    monkeypatch.setattr(tband, "tband_fused_direct_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    x = np.random.RandomState(2).randn(nn, 16).astype(np.float32)
    w = (np.random.RandomState(3).randn(16, 8) * 0.1).astype(np.float32)
    for core in ("gcn_apply_padded", "gin_apply_padded"):
        got = op.unpad_output(getattr(op, core)(op.arrays, op.pad_input(x), torch.from_numpy(w)),
                              8)
        want = jop.unpad_output(getattr(jop, core)(jop.arrays, jop.pad_input(jnp.asarray(x)),
                                                   jnp.asarray(w)), 8)
        assert rel_err(got.detach(), want) < RTOL
    assert len(calls) == 1  # the GIN forward; the GCN's fused launch is in its backward
