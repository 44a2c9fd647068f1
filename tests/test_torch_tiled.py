"""The port's tiled band and grouped band against the JAX package on the
CPU: the plain versions of ``band_tiled_spmm`` and
``band_bucket_spmm_grouped`` (hcspmm_tpu_torch/kernels/block_spmm.py)
against the Pallas kernels in interpret mode, then tiled plans
(``band_impl='tiled'``: a plan's (superwindow, 128-row X tile) pairs)
through ``HybridSpMM``: values and gradients in the padded and row layouts
at ring slots 2/4/16 and with empty superwindows, the host check of the
pair stream, the fallback to a wide plan where the builder cannot tile, and
``--band-impl tiled`` through the CLI on the CPU.

This mirrors tests/test_pallas_kernels.py:197-290.  On the CPU each wrapper
runs its plain version; the CUDA kernels are held against the same plain
versions by the tests marked ``cuda`` and by chip_smoke.py.  Tolerance: fp32
within 1e-5 of max|ref| (the order of fp32 sums only), bf16 within 1e-2.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcspmm_tpu.config import PlanConfig as JaxPlanConfig
from hcspmm_tpu.kernels import block_spmm as jax_block_spmm
from hcspmm_tpu.ops.spmm import HybridSpMM as JaxHybridSpMM

from hcspmm_tpu_torch.config import TILED_SCALAR_PAD, PlanConfig
from hcspmm_tpu_torch.format import reorder
from hcspmm_tpu_torch.format.plan import build_plan
from hcspmm_tpu_torch.graphs import io
from hcspmm_tpu_torch.kernels import block_spmm
from hcspmm_tpu_torch.ops import spmm as port_spmm
from hcspmm_tpu_torch.ops.spmm import HybridSpMM, spmm_reference_dense
from hcspmm_tpu_torch.train import cli

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
RTOL = 1e-5


def rel_err(got, ref):
    got, ref = (np.asarray(v.detach().float().numpy() if isinstance(v, torch.Tensor) else v,
                           dtype=np.float64) for v in (got, ref))
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


def tiled_cfg(slots=4, **kw):
    return dict(dict(impl="pallas", band_mode="always", band_h=128, band_widths=(512,),
                     band_impl="tiled", band_tile_slots=slots), **kw)


def blocks_graph():
    """tests/test_pallas_kernels.py:201's graph (rcm order)."""
    src, dst, nn = io.synthetic_blocks(512, 4, 48, seed=5)
    rp, ci = io.to_csr(src, dst, nn)
    return (*reorder.apply_permutation(rp, ci, nn, reorder.rcm_reorder(rp, ci, nn)), nn)


def empty_tail_graph():
    """Rows 199.. have no edges: the tiled plan's last superwindows are
    empty and own one zero-A pair each (tests/test_pallas_kernels.py:267)."""
    rp = np.zeros(401, np.int32)
    rp[1:200] = np.arange(1, 200)
    rp[200:] = 199
    return rp, (np.arange(199) % 150).astype(np.int32), 400


def both(graph, cfg):
    rp, ci, nn = graph
    return (HybridSpMM(rp, ci, nn, PlanConfig(**cfg), device="cpu"),
            JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(**cfg)),
            spmm_reference_dense(rp, ci, nn, np.eye(nn)))


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slots", [2, 4, 16])
def test_band_tiled_spmm_matches_jax(slots, dtype):
    """At the pair streams the plan builder gives at ring slots 2 (evictions
    and late fetches), 4 and 16: one block per superwindow, each the sum of
    its pairs' products."""
    op, jop, a = both(blocks_graph(), tiled_cfg(slots))
    assert op.plan.tiled and op.plan.tile_slots == slots
    m = op.plan.padded_rows
    x = np.random.RandomState(slots).randn(m, 128).astype(np.float32)
    x[a.shape[0]:] = 0
    xv = torch.from_numpy(x).to(dtype)
    got = block_spmm.band_tiled_spmm(op.arrays["f"], xv, op.plan, dtype)
    want = jax_block_spmm.band_tiled_spmm(jop.arrays["f"], jnp.asarray(x).astype(JDT[dtype]),
                                          jop.plan, JDT[dtype])
    assert got.shape == want.shape == (m // 128, 128, 128) and got.dtype == dtype
    assert rel_err(got, want.astype(jnp.float32)) < TOL[dtype]
    oracle = a @ xv.double().numpy()[: a.shape[0]]
    assert rel_err(got.reshape(m, 128)[: a.shape[0]], oracle) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,sb", [(1, 16), (2, 16), (4, 16), (8, 16), (8, 12)])
def test_band_bucket_spmm_grouped_matches_jax(group, sb, dtype):
    """G superwindows a step, identity order, entries past num_sw dropped;
    at Sb 12 a G of 8 halves to 4, as in the reference."""
    rng = np.random.RandomState(group + sb)
    bh, bb, dp, m = 32, 256, 128, 1024
    a = (rng.rand(sb, bh, bb) < 0.08).astype(np.int8)
    st = (rng.randint(0, (m - bb) // 16 + 1, sb) * 16).astype(np.int32)
    x = rng.randn(m, dp).astype(np.float32)
    num_sw = sb - 3
    xv = torch.from_numpy(x).to(dtype)
    got = block_spmm.band_bucket_spmm_grouped(torch.from_numpy(st), torch.from_numpy(a), xv,
                                              num_sw, dtype, group=group)
    want = jax_block_spmm.band_bucket_spmm_grouped(jnp.asarray(st), jnp.asarray(a),
                                                   jnp.asarray(x).astype(JDT[dtype]), num_sw,
                                                   JDT[dtype], group=group)
    assert got.shape == want.shape == (num_sw, bh, dp) and got.dtype == dtype
    assert rel_err(got, want.astype(jnp.float32)) < TOL[dtype]
    oracle = np.einsum("sbk,skd->sbd", a.astype(np.float64),
                       xv.double().numpy()[st[:, None] + np.arange(bb)])[:num_sw]
    assert rel_err(got, oracle) < TOL[dtype]
    assert block_spmm.grouped_size(sb, group) == (4 if (group, sb) == (8, 12) else group)


def test_grouped_equals_direct_on_a_full_cover_plan():
    """On a wide plan whose one bucket owns every superwindow, the grouped
    band in identity order, put in superwindow order, is the direct band."""
    rp, ci, nn = blocks_graph()
    op = HybridSpMM(rp, ci, nn, PlanConfig(impl="pallas", band_mode="always", band_h=64,
                                           band_widths=(256,)), device="cpu")
    arrs, m = op.arrays["f"], op.plan.padded_rows
    num_sw = m // 64
    assert len(op.plan.band_sw_ids[0]) == num_sw
    xp = op.pad_input(np.random.RandomState(0).randn(nn, 40).astype(np.float32))
    grouped = block_spmm.band_bucket_spmm_grouped(arrs["band0_start"], arrs["band0_a"], xp,
                                                  num_sw, torch.float32)
    direct = block_spmm.band_bucket_spmm_direct(arrs["band0_sw"], arrs["band0_start"],
                                                arrs["band0_a"], xp, num_sw, torch.float32)
    sw = arrs["band0_sw"][:num_sw].long()
    assert torch.equal(direct[sw], grouped)


# ---------------------------------------------------------------------------
# tiled plans through the operator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slots", [2, 4, 16])
def test_tiled_plan_matches_jax_and_oracle(slots):
    """apply_padded twice (the closed layout) and the row-layout apply; the
    padded rows stay zero, and no dense band block is uploaded."""
    op, jop, a = both(blocks_graph(), tiled_cfg(slots))
    assert op.plan.tiled and op.supports_padded and not op.transposed
    assert "band0_a" not in op.arrays["f"] and op.arrays["f"]["tp_a"].shape[1:] == (128, 128)
    nn = a.shape[0]
    x = np.random.RandomState(1).randn(nn, 24).astype(np.float32)
    out = op.apply_padded(op.arrays, op.apply_padded(op.arrays, op.pad_input(x)))
    assert not out[nn:].any()
    jout = jop.apply_padded(jop.arrays, jop.apply_padded(jop.arrays, jop.pad_input(
        jnp.asarray(x))))
    assert rel_err(op.unpad_output(out, 24), jop.unpad_output(jout, 24)) < RTOL
    assert rel_err(op.unpad_output(out, 24), a @ (a @ x)) < RTOL
    assert rel_err(op(torch.from_numpy(x)), a @ x) < RTOL


def test_tiled_plan_with_empty_superwindows():
    op, jop, a = both(empty_tail_graph(), tiled_cfg(4, band_widths=(256,)))
    assert op.plan.tiled
    ptr = op.arrays["f"]["tp_ptr"]
    runs = (ptr[1:] - ptr[:-1]).numpy()
    assert (runs == 1).any() and runs.min() == 1
    x = np.random.RandomState(0).randn(400, 8).astype(np.float32)
    got = op.unpad_output(op.apply_padded(op.arrays, op.pad_input(x)), 8)
    want = jop.unpad_output(jop.apply_padded(jop.arrays, jop.pad_input(jnp.asarray(x))), 8)
    assert rel_err(got, want) < RTOL
    assert rel_err(got, a @ x) < RTOL


@pytest.mark.parametrize("layout", ["padded", "rows"])
def test_tiled_gradient_matches_jax_and_oracle(layout):
    op, jop, a = both(blocks_graph(), tiled_cfg())
    rs = np.random.RandomState(5)
    x = rs.randn(a.shape[0], 16).astype(np.float32)
    cot = rs.randn(a.shape[0], 16).astype(np.float32)
    xv = torch.from_numpy(x).requires_grad_(True)
    if layout == "padded":
        out = op.unpad_output(op.apply_padded(op.arrays, op.pad_input(xv)), 16)
    else:
        out = op.apply(op.arrays, xv)
    (out * torch.from_numpy(cot)).sum().backward()

    def loss(v):
        if layout == "padded":
            o = jop.unpad_output(jop.apply_padded(jop.arrays, jop.pad_input(v)), 16)
        else:
            o = jop.apply(jop.arrays, v)
        return jnp.sum(o * cot)

    assert rel_err(xv.grad, jax.grad(loss)(jnp.asarray(x))) < RTOL
    assert rel_err(xv.grad, a.T @ cot) < RTOL


@pytest.mark.parametrize("core", ["gcn", "gin"])
def test_tiled_layer_cores_compose_in_the_fused_mode(core):
    """A tiled plan has no fused kernel: with ``prefer_fused_kernel`` set on
    both packages' plans the layer cores compose (tiled SpMM + product), in
    value and gradient as the JAX package."""
    op, jop, a = both(blocks_graph(), tiled_cfg())
    op.plan.prefer_fused_kernel = jop.plan.prefer_fused_kernel = True
    rs = np.random.RandomState(4)
    x = rs.randn(a.shape[0], 24).astype(np.float32)
    w = (rs.randn(24, 12) * 0.1).astype(np.float32)
    xv = torch.from_numpy(x).requires_grad_(True)
    wv = torch.from_numpy(w).requires_grad_(True)
    out = op.unpad_output(getattr(op, f"{core}_apply_padded")(op.arrays, op.pad_input(xv), wv),
                          12)
    (out ** 2).sum().backward()
    japply = getattr(jop, f"{core}_apply_padded")

    def fn(xj, wj):
        return jop.unpad_output(japply(jop.arrays, jop.pad_input(xj), wj), 12)

    gx, gw = jax.grad(lambda u, v: jnp.sum(fn(u, v) ** 2), argnums=(0, 1))(jnp.asarray(x),
                                                                            jnp.asarray(w))
    assert rel_err(out, fn(jnp.asarray(x), jnp.asarray(w))) < RTOL
    assert rel_err(out, a @ x @ w) < RTOL
    assert rel_err(xv.grad, gx) < RTOL and rel_err(wv.grad, gw) < RTOL


def test_tiled_falls_back_to_wide_where_the_builder_cannot_tile():
    """band_h 32 (not a multiple of 128) and a spilling band give wide
    plans, as in the JAX package, and still apply every edge."""
    rp, ci, nn = blocks_graph()
    x = np.random.RandomState(0).randn(nn, 24).astype(np.float32)
    for cfg in (tiled_cfg(band_h=32, band_widths=(256,)),
                tiled_cfg(band_h=128, band_widths=(128,), band_mode="auto")):
        op, jop, a = both((rp, ci, nn), cfg)
        assert not op.plan.tiled and not jop.plan.tiled
        assert rel_err(op(torch.from_numpy(x)), a @ x) < RTOL


def test_tiled_pair_stream_is_checked_before_upload():
    """The tiled kernel reads the pair stream unchecked, so the host check
    refuses a tile outside the layout, an empty run, a wrong owner or first
    flag, a fetch flag other than 0/1 and missing pad entries."""
    rp, ci, nn = blocks_graph()
    plan = build_plan(rp, ci, nn, PlanConfig(**tiled_cfg()))
    host = plan.device_arrays(dense_band=False)
    ptr = block_spmm.check_tiled_arrays(host, plan)["tp_ptr"]
    assert np.array_equal(ptr, plan.pair_ptr) and ptr.dtype == np.int32
    tiles = plan.padded_rows // 128

    def bad(key, fn):
        h = {k: np.array(v, copy=True) for k, v in host.items()}
        fn(h[key])
        return h

    for h in (bad("tp_tile", lambda v: v.__setitem__(0, tiles)),
              bad("tp_tile", lambda v: v.__setitem__(1, -1)),
              bad("tp_super", lambda v: v.__setitem__(0, 1)),
              bad("tp_first", lambda v: v.__setitem__(0, 0)),
              bad("tp_last", lambda v: v.__setitem__(0, 1 - v[0])),
              bad("tp_fetch", lambda v: v.__setitem__(0, 2)),
              {**host, "tp_late": host["tp_late"][:-TILED_SCALAR_PAD]}):
        with pytest.raises(ValueError):
            block_spmm.check_tiled_arrays(h, plan)
    empty_run = dataclasses.replace(plan, pair_ptr=np.concatenate(
        [[0, 0], plan.pair_ptr[2:]]))
    with pytest.raises(ValueError, match="non-empty runs"):
        block_spmm.check_tiled_arrays(host, empty_run)
    with pytest.raises(NotImplementedError, match="tile width"):
        block_spmm.check_plan(dataclasses.replace(plan, tile_w=64))


# ---------------------------------------------------------------------------
# --band-impl tiled through the CLI
# ---------------------------------------------------------------------------


def _npz_graph(tmp_path):
    src, dst, n = io.synthetic_blocks(1500, 5, 100, seed=7)
    path = str(tmp_path / "g.npz")
    io.save_edges_npz(path, src, dst, n)
    return path


def _records(out):
    return [json.loads(v) for v in out.splitlines() if v.startswith("{")]


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_cli_band_impl_tiled_trains_on_cpu(tmp_path, capsys, model, monkeypatch):
    """``--band-impl tiled`` builds a tiled plan (the preprocess record says
    so) and trains to a finite loss with every SpMM on the tiled band."""
    calls = []
    plain = block_spmm.band_tiled_spmm_plain
    monkeypatch.setattr(block_spmm, "band_tiled_spmm_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    path = _npz_graph(tmp_path)
    assert cli.main(["--dataset", path, "--reorder", "rcm", "--dim", "24", "--hidden", "130",
                     "--classes", "5", "--num_layers", "3", "--epochs", "2", "--model", model,
                     "--band-impl", "tiled", "--device", "cpu"]) == 0
    recs = _records(capsys.readouterr().out)
    prep = [r for r in recs if r.get("event") == "preprocess"]
    done = [r for r in recs if r.get("event") == "done"]
    assert prep[0]["layout"] == "tiled" and prep[0]["spill_nnz"] == 0
    assert len(done) == 1 and np.isfinite(done[0]["final_loss"])
    per_step = {"gcn": 6, "gin": 5}[model]  # GIN's first layer needs no input gradient
    assert len(calls) == per_step * (9 + 2)


def test_cli_single_kernel_band_impl_tiled_on_cpu(tmp_path, capsys):
    """``--single_kernel --band-impl tiled`` (models/sag.py) on a tiled plan."""
    path = _npz_graph(tmp_path)
    assert cli.main(["--dataset", path, "--reorder", "rcm", "--dim", "32", "--single_kernel",
                     "--band-impl", "tiled", "--device", "cpu"]) == 0
    recs = _records(capsys.readouterr().out)
    assert [r for r in recs if r.get("event") == "preprocess"][0]["layout"] == "tiled"
    sag = [r for r in recs if r.get("event") == "sag"]
    assert len(sag) == 1 and sag[0]["avg_ms"] > 0


def test_tiled_plans_through_make_spmm_padded():
    """The padded layout and check_plan admit tiled plans (and rows_check no
    longer refuses them): their layout is the wide one, fused cores and
    all."""
    rp, ci, nn = blocks_graph()
    plan = build_plan(rp, ci, nn, PlanConfig(**tiled_cfg()))
    block_spmm.rows_check(plan)
    block_spmm.check_plan(plan)
    assert port_spmm.padded_layout(plan) is port_spmm.WideLayout
    arrs = port_spmm._to_device(plan, "cpu")
    assert port_spmm.WideLayout(plan, None, {"f": arrs, "b": arrs}, "cpu")._fused


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on a card only)
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/block_spmm.cu has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tiled_and_grouped_kernels_match_plain(dtype):
    _need_cuda()
    op = HybridSpMM(*blocks_graph(), PlanConfig(**tiled_cfg(2)), device="cuda")
    xp = torch.randn((op.plan.padded_rows, 256), device="cuda").to(dtype)
    before = block_spmm.kernel_launches["band_tiled_spmm"]
    got = block_spmm.band_tiled_spmm(op.arrays["f"], xp, op.plan, dtype)
    again = block_spmm.band_tiled_spmm(op.arrays["f"], xp, op.plan, dtype)
    ref = block_spmm.band_tiled_spmm_plain(op.arrays["f"], xp, op.plan, dtype)
    torch.cuda.synchronize()
    assert block_spmm.kernel_launches["band_tiled_spmm"] == before + 2
    assert torch.equal(got, again) and rel_err(got.cpu(), ref.cpu()) < TOL[dtype]
    rng = np.random.RandomState(0)
    a = torch.from_numpy((rng.rand(16, 128, 640) < 0.05).astype(np.int8)).cuda()
    st = torch.from_numpy((rng.randint(0, 80, 16) * 16).astype(np.int32)).cuda()
    x = torch.randn((2048, 128), device="cuda").to(dtype)
    for group in (1, 2, 4, 8):
        got = block_spmm.band_bucket_spmm_grouped(st, a, x, 13, dtype, group)
        ref = block_spmm.band_bucket_spmm_grouped_plain(st, a, x, 13, dtype, group)
        torch.cuda.synchronize()
        assert rel_err(got.cpu(), ref.cpu()) < TOL[dtype]
