"""The port's experiment tools (hcspmm_tpu_torch/tools/) against the JAX
package's (tools/calibrate_loi.py, ablate_loi.py, ablate_loa.py,
ablate_fusion.py) on the CPU, at small sizes.

The calibration's procedure is held to the JAX tool's with one
deterministic fake timer (a cost of the plan's dense-window columns and
sparse nnz) put in place of both tools' ``time_path``: the same bins,
labels, accuracy line, collapse decision and coefficients, in grid and
mixed mode, with fakes that take each collapse branch.  The plans each tool
times are held to the JAX package's (their routing stats) and their SpMMs
to scipy: fp32 within 1e-5 of max|ref|, bf16 within 1e-2 (X rounded to bf16
once, sums in fp32).  The fused and composed GCN backward cores agree
within the same tolerances.  Each tool's ``main`` runs end to end on the
host and prints the JAX tool's keys; the tools import no JAX.
"""

import argparse
import contextlib
import io as _io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hcspmm_tpu.train.cli as jax_cli
from hcspmm_tpu.config import PlanConfig as JaxPlanConfig
from hcspmm_tpu.format import reorder as jax_reorder
from hcspmm_tpu.kernels import block_spmm as jax_block_spmm
from hcspmm_tpu.kernels import tband as jax_tband
from hcspmm_tpu.ops.spmm import HybridSpMM as JaxHybridSpMM
import tools.calibrate_loi as jax_calibrate

from hcspmm_tpu_torch.config import LOICoefficients, PlanConfig
from hcspmm_tpu_torch.format.plan import build_plan
from hcspmm_tpu_torch.graphs import io
from hcspmm_tpu_torch.tools import ablate_fusion, ablate_loa, ablate_loi, calibrate_loi, common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
TOOLS = ("calibrate_loi", "ablate_loi", "ablate_loa", "ablate_fusion")


def scipy_spmm(rp, ci, n, x):
    return sp.csr_matrix((np.ones(len(ci)), ci, rp), shape=(n, n)) @ np.asarray(x, np.float64)


def rel_err(got, ref):
    got = np.asarray(got.detach().float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


def rounded(x, dtype):
    """x as the tool's compute dtype holds it, back in fp32."""
    return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()


def stats(plan):
    """A row-layout plan's routing: dense windows and nnz, ELL and residual
    shapes."""
    return dict(dense_windows=int(plan.num_dense_windows), dense_nnz=int(plan.dense_nnz),
                sparse_nnz=int(plan.sparse_nnz), sparse_rows=int(plan.num_sparse_rows),
                buckets=[tuple(c.shape) for c in plan.bucket_cols],
                ell=[tuple(c.shape) for c in plan.ell_cols])


# ---------------------------------------------------------------------------
# calibrate_loi
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("unique,nnz,copies", [
    (8, 12, 64), (8, 115, 3), (17, 40, 2), (64, 921, 5), (256, 3686, 4), (100, 0, 3)])
def test_window_graph_matches_jax(unique, nnz, copies):
    got, ref = calibrate_loi.window_graph(unique, nnz, copies), jax_calibrate.window_graph(
        unique, nnz, copies)
    assert got[2] == ref[2]
    for g, r in zip(got[:2], ref[:2]):
        assert g.dtype == r.dtype and np.array_equal(g, r)


def fake_time_path(gamma, penalty):
    """A deterministic timer of the plan ``time_path`` would time: dense
    windows cost their columns squared / 120, sparse edges ``gamma`` each,
    and a plan with both populations ``penalty`` more (the contention that
    the collapse rule answers)."""
    def time_path(rp, ci, n, dim, mode, dtype="bfloat16", coeffs=None, **kw):
        extra = {"loi": coeffs} if coeffs is not None else {}
        plan = build_plan(rp, ci, n, PlanConfig(loi_mode=mode, band_mode="never", **extra))
        t = (sum(int(c.shape[0]) * int(c.shape[1]) ** 2 for c in plan.bucket_cols) / 120
             + gamma * plan.sparse_nnz)
        if plan.num_dense_windows and plan.sparse_nnz:
            t += penalty
        return t * 1e-9 + 1e-6
    return time_path


COMPARED = ("bin ", "u=", "# mixture standin", "# selector accuracy", "# mixture lost",
            "LOICoefficients(", "# mixed end-to-end calibrated ", "# mixed end-to-end all_")


def compared_lines(run) -> list:
    out, err = _io.StringIO(), _io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        run()
    return [v for v in (out.getvalue() + err.getvalue()).splitlines() if v.startswith(COMPARED)]


@pytest.mark.parametrize("gamma,penalty,collapse", [
    (1.0, 0.0, None), (1.0, 1e6, "sparse"), (1.3, 1e6, "dense")])
def test_mixed_calibration_matches_jax(monkeypatch, gamma, penalty, collapse):
    fake = fake_time_path(gamma, penalty)
    monkeypatch.setattr(jax_calibrate, "time_path", fake)
    monkeypatch.setattr(calibrate_loi, "time_path", fake)
    monkeypatch.setattr(jax_cli, "enable_compile_cache", lambda: None)
    args = argparse.Namespace(mixed="standin:DD@0.02", copies=64, dim=8, dtype="float32",
                              max_bins=6, device=torch.device("cpu"))
    ref = compared_lines(lambda: jax_calibrate.calibrate_mixed(args))
    got = compared_lines(lambda: calibrate_loi.calibrate_mixed(args))
    assert got == ref
    labels = {v.split("-> ")[1] for v in got if v.startswith("bin ")}
    assert labels == {"dense", "sparse"}  # the fit sees both labels
    lost = [v for v in got if v.startswith("# mixture lost")]
    if collapse is None:
        assert not lost
    else:
        assert lost and f"collapsed to the {collapse} path" in lost[0]


@pytest.mark.parametrize("gamma", [1.0, 1.3])
def test_grid_calibration_matches_jax(monkeypatch, gamma):
    fake = fake_time_path(gamma, 0.0)
    monkeypatch.setattr(jax_calibrate, "time_path", fake)
    monkeypatch.setattr(calibrate_loi, "time_path", fake)
    monkeypatch.setattr(jax_cli, "enable_compile_cache", lambda: None)
    argv = ["--uniques", "8,32,64,256", "--fills", "0.1,0.9", "--copies", "16"]
    monkeypatch.setattr(sys, "argv", ["calibrate_loi.py", *argv])
    ref = compared_lines(jax_calibrate.main)
    got = compared_lines(lambda: calibrate_loi.main([*argv, "--device", "cpu"]))
    assert got == ref and len(got) == 9
    assert {v.split("-> ")[1] for v in got if v.startswith("u=")} == {"dense", "sparse"}


@pytest.fixture(scope="module")
def mixed_windows():
    """A window graph and a small stand-in, the two kinds of graph
    ``time_path`` times."""
    return {"window": calibrate_loi.window_graph(24, 150, 40),
            "DD@0.02": common._target_graph("standin:DD@0.02")}


@pytest.mark.parametrize("graph", ["window", "DD@0.02"])
@pytest.mark.parametrize("mode", ["all_dense", "all_sparse"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_path_plans_match_jax(mixed_windows, graph, mode, dtype):
    rp, ci, n = mixed_windows[graph]
    op = calibrate_loi.path_op(rp, ci, n, mode, dtype, device="cpu")
    ref_op = JaxHybridSpMM(rp, ci, n, JaxPlanConfig(loi_mode=mode, compute_dtype=dtype,
                                                     impl="pallas", band_mode="never"))
    assert stats(op.plan) == stats(ref_op.plan)
    assert (op.plan.num_dense_windows == 0) == (mode == "all_sparse")
    x = np.random.RandomState(3).randn(n, 16).astype(np.float32)
    got = op(torch.from_numpy(x))
    assert rel_err(got, scipy_spmm(rp, ci, n, rounded(x, dtype))) <= TOL[dtype]
    assert calibrate_loi.time_op(op, 16) > 0


# ---------------------------------------------------------------------------
# ablate_loi and ablate_loa
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bias,dtype", [(-12.0, "float32"), (-3.149, "float32"),
                                        (1000.0, "float32"), (-12.0, "bfloat16")])
def test_ablate_loi_bias_plans_match_jax(bias, dtype):
    args = argparse.Namespace(nodes=2048, degree=8.0, span=16)
    rp, ci, nn = ablate_loi.locality_graph(args)
    src, dst, _ = io.synthetic_graph(2048, 8.0, seed=7, span=16, locality=0.7)
    assert np.array_equal(rp, io.to_csr(src, dst, nn)[0])
    (b, op, prep_s), = ablate_loi.bias_ops(rp, ci, nn, [bias], dtype, "cpu")
    co = LOICoefficients(max_cols=256, bias=bias)
    ref_op = JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(loi_mode="intended", loi=co, impl="pallas",
                                                     compute_dtype=dtype, band_mode="never"))
    assert b == bias and prep_s >= 0 and stats(op.plan) == stats(ref_op.plan)
    x = np.random.RandomState(0).randn(nn, 24).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = op(xt)
    assert rel_err(got, scipy_spmm(rp, ci, nn, rounded(x, dtype))) <= TOL[dtype]
    rec = ablate_loi.record(b, op, prep_s, xt)
    assert rec["dense_windows"] == op.plan.num_dense_windows and rec["dim"] == 24
    assert abs(rec["dense_nnz_frac"] + rec["sparse_nnz_frac"] - 1.0) < 1e-3


@pytest.fixture(scope="module")
def loa_variants():
    src, dst, nn, _ = io.reference_standin("DD", seed=7, scale=0.01)
    rp0, ci0 = io.to_csr(src, dst, nn)
    return rp0, ci0, nn, ablate_loa.variants(rp0, ci0, nn, "cpu")


@pytest.mark.parametrize("order", ablate_loa.ORDERS)
def test_ablate_loa_orders_match_jax(loa_variants, order):
    rp0, ci0, nn, ops = loa_variants
    op, reo_s, perm = ops[order]
    rp, ci = rp0, ci0
    if order != "none":
        fn = jax_reorder.loa_reorder if order == "loa" else jax_reorder.cluster_reorder
        ref_perm = fn(rp0, ci0, nn)
        assert np.array_equal(perm, ref_perm)
        rp, ci = jax_reorder.apply_permutation(rp0, ci0, nn, ref_perm)
    ref_op = JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(
        compute_dtype="bfloat16", impl="pallas", band_mode="never", loi_mode="calibrated"))
    assert stats(op.plan) == stats(ref_op.plan) and reo_s >= 0
    # the SpMM of the reordered graph, read back in the original order
    x = np.random.RandomState(0).randn(nn, 32).astype(np.float32)
    xin = x if perm is None else x[perm]
    got = op(torch.from_numpy(xin).to(torch.bfloat16)).float().numpy()
    if perm is not None:
        back = np.empty_like(got)
        back[perm] = got
        got = back
    assert rel_err(got, scipy_spmm(rp0, ci0, nn, rounded(x, "bfloat16"))) <= TOL["bfloat16"]


def test_ablate_loa_round_record(loa_variants):
    _, _, nn, ops = loa_variants
    x = torch.zeros((nn, 32), dtype=torch.bfloat16)
    row = ablate_loa.round_record(ops, x, {"graph": "DD", "round": 0})
    assert list(row)[:3] == ["graph", "round", "regime"]
    for name in ablate_loa.ORDERS:
        assert row[name + "_us"] > 0 and name + "_reorder_s" in row
    assert row["loa_gain_pct"] == round(100 * (1 - row["loa_us"] / row["none_us"]), 1)


# ---------------------------------------------------------------------------
# ablate_fusion
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_blocks():
    return common.blocks_standin(0.01)


@pytest.mark.parametrize("band_impl,dim", [("tband", 32), ("wide", 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fusion_cores_agree(small_blocks, band_impl, dim, dtype):
    rp, ci, nn = small_blocks
    op = ablate_fusion.fusion_op(rp, ci, nn, band_impl, "cpu", dtype)
    fused, composed, available, xp = ablate_fusion.cores(op, dim, dim)
    assert available and not op.plan.has_spill
    assert xp.shape == ((32, op.plan.padded_rows) if band_impl == "tband"
                        else (op.plan.padded_rows, 128))
    out_f, agg_f = fused(xp)
    out_c, agg_c = composed(xp)
    for got, ref in ((out_f, out_c), (agg_f, agg_c)):
        assert rel_err(got, ref.double().numpy()) <= TOL[dtype]
    # the aggregate is the SpMM
    x = op.unpad_output(xp, dim).float().numpy()
    agg = op.unpad_output(agg_c, dim)
    assert rel_err(agg, scipy_spmm(rp, ci, nn, x)) <= TOL[dtype]
    assert ablate_fusion.hold_equal(fused, composed, xp) <= TOL[dtype]


def jax_fused_available(rp, ci, nn, band_impl, dim):
    """The JAX tool's ``fused_available`` on the same graph (fp32: the
    conditions do not depend on the dtype)."""
    import jax.numpy as jnp

    op = JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(compute_dtype="float32", impl="pallas",
                                                 band_impl=band_impl, loi_mode="calibrated"))
    xp = op.pad_input(jnp.ones((nn, dim), jnp.float32))
    if band_impl == "tband":
        wf = jnp.zeros((xp.shape[0], xp.shape[0]), xp.dtype)
        return jax_tband.spmm_tband_fused_padded(op.arrays["f"], xp, wf, op.plan) is not None
    wp = jnp.zeros((xp.shape[1], xp.shape[1]), xp.dtype)
    return jax_block_spmm.spmm_fused_pallas_padded(op.arrays["f"], xp, wp, op.plan) is not None


@pytest.mark.parametrize("key,scale,expect", [("blocks", 0.01, True), ("YS", 0.005, False)])
def test_fusion_measure_availability_matches_jax(capsys, key, scale, expect):
    rec = ablate_fusion.measure(key, scale, 32, 32, "tband", device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == rec and rec["fused_kernel_available"] is expect
    rp, ci, nn = (common.blocks_standin(scale) if key == "blocks"
                  else common._graph(key, scale)[:3])
    assert jax_fused_available(rp, ci, nn, "tband", 32) is expect
    assert (rec["spill_frac"] > 0) is (not expect)
    assert len(rec["fused_us"]) == 6 and rec["fused_med_us"] == rec["fused_us"][2]


# ---------------------------------------------------------------------------
# the mains, the device and the imports
# ---------------------------------------------------------------------------


def run_main(module, argv, capsys) -> tuple:
    assert module.main([*argv, "--device", "cpu"]) == 0
    cap = capsys.readouterr()
    return cap.out.splitlines(), cap.err.splitlines()


def test_calibrate_main_grid_and_mixed(capsys):
    out, err = run_main(calibrate_loi, ["--uniques", "8,64", "--fills", "0.1,0.9",
                                        "--copies", "32", "--dim", "16"], capsys)
    assert out[-1].startswith("LOICoefficients(w_cols=") and err[0].startswith("# device: cpu")
    assert sum(v.startswith("u=") for v in err) == 4
    out, err = run_main(calibrate_loi, ["--mixed", "standin:DD@0.01", "--max-bins", "3",
                                        "--copies", "32", "--dim", "16"], capsys)
    assert out[0].startswith("# selector accuracy vs measured oracle:")
    assert out[-1].startswith("LOICoefficients(w_cols=")
    assert sum(v.startswith("bin u=") for v in err) == 3
    assert any(v.startswith("# mixed end-to-end LOI_TPU_V5E") for v in err)


JAX_KEYS = {
    "ablate_loi": ["bias", "spmm_us", "gnnz_per_s", "dense_windows", "dense_nnz_frac",
                   "sparse_nnz_frac", "prep_s", "nodes", "nnz", "dim"],
    "ablate_loa": ["graph", "scale", "nnz", "dim", "round", "regime", "none_us",
                   "none_reorder_s", "loa_us", "loa_reorder_s", "cluster_us",
                   "cluster_reorder_s", "loa_gain_pct", "cluster_gain_pct"],
    "ablate_fusion": ["table", "graph", "dim", "nnz", "band_impl", "layout",
                      "fused_kernel_available", "spill_frac", "fused_us", "composed_us",
                      "fused_med_us", "composed_med_us", "gain_pct"],
}


@pytest.mark.parametrize("name,argv,records", [
    ("ablate_loi", ["--nodes", "2048", "--biases=-12,1000", "--dim", "16"], 2),
    ("ablate_loa", [], 2),
    ("ablate_fusion", ["--scale", "0.002"], 5)])
def test_ablation_mains_print_the_jax_keys(monkeypatch, capsys, name, argv, records):
    monkeypatch.setenv("LOA_GRAPHS", "DD@0.005")
    monkeypatch.setenv("LOA_ROUNDS", "2")
    monkeypatch.setenv("LOA_DIM", "16")
    out, _ = run_main({"ablate_loi": ablate_loi, "ablate_loa": ablate_loa,
                       "ablate_fusion": ablate_fusion}[name], argv, capsys)
    recs = [json.loads(v) for v in out]
    assert len(recs) == records
    for rec in recs:
        assert list(rec)[:len(JAX_KEYS[name])] == JAX_KEYS[name]
    if name == "ablate_fusion":
        assert [r["graph"] for r in recs] == ["blocks", "blocks", "DD", "YS", "RD"]
        assert [r["layout"] for r in recs] == ["tband", "padded", "tband", "tband", "tband"]


@pytest.mark.parametrize("name", TOOLS)
def test_tools_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    module = {"calibrate_loi": calibrate_loi, "ablate_loi": ablate_loi, "ablate_loa": ablate_loa,
              "ablate_fusion": ablate_fusion}[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])


def test_tools_import_without_jax():
    """Every module of hcspmm_tpu_torch.tools imports with JAX, the JAX
    package and its tools unimportable."""
    code = """
import sys
for name in ("jax", "jaxlib", "optax", "hcspmm_tpu", "tools"):
    sys.modules[name] = None
import importlib
for name in ("common", "calibrate_loi", "ablate_loi", "ablate_loa", "ablate_fusion"):
    importlib.import_module("hcspmm_tpu_torch.tools." + name)
print("OK")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "OK"
