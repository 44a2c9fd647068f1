"""The SAGE configuration's plain reference (``reference/sage.py``) against a
dense NumPy computation (float64) on a small graph: forward, loss,
gradients and Adam; what it imports and counts; the cell ``sage3.products``
as the harness loads it; and a CPU rehearsal of a small cell of its
configuration, sound and with half the batch left out."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import conftest
from benchmark import harness, roofline
from benchmark.graphs import generators
from benchmark.reference import sage
from hcspmm_tpu_torch.train import loop

ROOT = harness.ROOT
CFG = {"dim": 12, "hidden": 8, "classes": 5, "num_layers": 3, "dropout": 0.5, "lr": 0.01,
       "betas": [0.9, 0.999], "eps": 1e-8}


def _dense_mean(rp, ci, n):
    """D^-1 A of the binary adjacency, D the row degree (at least 1)."""
    a = np.zeros((n, n))
    for r in range(n):
        a[r, ci[rp[r]:rp[r + 1]]] = 1.0
    return a / np.maximum(np.diff(rp), 1)[:, None]


def _numpy_step(ws, p, x, y, mask, keep):
    """Loss and gradients of GraphSAGE-mean by hand: Z_l = [H | P H] W_l,
    P = D^-1 A."""
    hs, pre = [x], []
    h = x
    last = len(ws) - 1
    for i, w in enumerate(ws):
        z = np.concatenate([h, p @ h], axis=1) @ w
        if i != last:
            pre.append(z)
            h = np.maximum(z, 0.0)
            if i == 0:
                h = np.where(mask, h / keep, 0.0)
        else:
            h = z
        hs.append(h)
    logits = hs[-1]
    m = logits.max(1, keepdims=True)
    logp = logits - (m + np.log(np.exp(logits - m).sum(1, keepdims=True)))
    n = len(y)
    loss = -logp[np.arange(n), y].mean()
    g = np.exp(logp)
    g[np.arange(n), y] -= 1.0
    g /= n
    grads = [None] * len(ws)
    for i in range(last, -1, -1):
        if i != last:
            if i == 0:
                g = np.where(mask, g / keep, 0.0)
            g = g * (pre[i] > 0)
        cat = np.concatenate([hs[i], p @ hs[i]], axis=1)
        grads[i] = cat.T @ g
        gcat = g @ ws[i].T
        d = hs[i].shape[1]
        g = gcat[:, :d] + p.T @ gcat[:, d:]
    return loss, grads, logp


def test_reference_against_numpy():
    src, dst, n = generators.synthetic_dcsbm(300, 6.0, mixing=0.2, seed=5)
    rp, ci = generators.to_csr(src, dst, n)
    rng = np.random.RandomState(0)
    shapes = sage.layer_shapes(CFG)
    assert shapes == [(24, 8), (16, 8), (16, 5)]
    ws = [rng.randn(i, o) * np.sqrt(2.0 / (i + o)) for i, o in shapes]
    x = rng.randn(n, CFG["dim"])
    y = rng.randint(0, CFG["classes"], n)
    masks = [rng.rand(n, CFG["hidden"]) < 0.5 for _ in range(2)]
    p_np = _dense_mean(rp, ci, n)

    a, at, inv = sage.prepare(rp, ci, n, CFG, "cpu")
    assert np.allclose((a.to_dense() * inv[:, None]).numpy(), p_np, rtol=1e-6, atol=1e-7)
    assert np.array_equal(at.to_dense().numpy(), a.to_dense().numpy().T)
    t = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    logp = sage.forward([t(w) for w in ws], a, at, inv, t(x), torch.from_numpy(masks[0]), 0.5)
    _, _, logp_np = _numpy_step(ws, p_np, x, y, masks[0], 0.5)
    assert np.allclose(logp.numpy(), logp_np, rtol=1e-5, atol=1e-5)

    res = sage.train_steps(CFG, (a, at, inv), [t(w) for w in ws], t(x), torch.from_numpy(y),
                           [torch.from_numpy(m) for m in masks])
    w_np = [w.copy() for w in ws]
    m_ = [np.zeros_like(w) for w in ws]
    v_ = [np.zeros_like(w) for w in ws]
    for k, mask in enumerate(masks, start=1):
        loss, grads, _ = _numpy_step(w_np, p_np, x, y, mask, 0.5)
        assert abs(res["losses"][k - 1] - loss) <= 1e-5 * abs(loss)
        if k == 1:
            for g_t, g in zip(res["first_grads"], grads):
                assert np.allclose(g_t.numpy(), g, rtol=1e-4, atol=1e-6)
        for i, g in enumerate(grads):
            m_[i] = 0.9 * m_[i] + 0.1 * g
            v_[i] = 0.999 * v_[i] + 0.001 * g * g
            w_np[i] -= 0.01 * (m_[i] / (1 - 0.9 ** k)) / (np.sqrt(v_[i] / (1 - 0.999 ** k)) + 1e-8)
    for w_t, w in zip(res["weights"], w_np):
        assert np.allclose(w_t.numpy(), w, rtol=1e-4, atol=1e-6)


def test_epoch_flops_and_agg_widths_by_hand():
    n, nnz = 10, 20
    assert sage.agg_widths(CFG) == [12, 8, 8, 8, 8]
    dense = 2 * (2 * n * 24 * 8) + 3 * (2 * n * 16 * 8) + 3 * (2 * n * 16 * 5)
    sparse = 2 * nnz * (12 + 8 + 8 + 8 + 8)
    assert sage.epoch_flops(CFG, n, nnz) == dense + sparse


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, json; import benchmark.reference.sage; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, env=dict(os.environ, PYTHONPATH=ROOT))
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"hcspmm_tpu_torch", "hcspmm_tpu", "jax", "jaxlib", "flax"}


def test_products_cell_loads():
    """``sage3.products`` as a run loads it: the SAGE reference, every
    published width, nothing reduced, the wide layout, and the precision the
    device ``resolve_device`` leaves (the CPU here: no TF32)."""
    cell = harness.load_cell("sage3.products")
    cfg = cell["cfg"]
    assert cell["reference"].MODELS == ("sage",) and cfg["model"] == "sage"
    assert harness.reference_of(cfg) is not None
    assert (cfg["num_layers"], cfg["dim"], cfg["hidden"], cfg["classes"]) == (3, 100, 256, 47)
    assert harness.layout_of(cfg) == "wide" and cfg["normalize"] is False
    harness.check_precision(cfg, torch.device("cpu"))
    entry = next(c for c in harness.load_spec()["configs"] if c["name"] == cfg["name"])
    assert entry["reduced"] == [] and entry["source"] == cfg["source"]
    assert cell["traffic_spec"]["generator"] == "synthetic_dcsbm"
    assert cell["traffic_spec"]["args"]["num_nodes"] == 2449029
    names = [m["name"] for m in cell["metrics"]["per_layer"]]
    assert "kernels.mean_roofline" in names and "kernels.scale_ms" in names


def test_mean_roofline_on_a_fake_record(monkeypatch):
    """``kernels.mean_roofline``: the least time of the reference's
    ``agg_widths`` SpMMs over the device ms an epoch in every ``spmm.*``
    span, the mean's D^-1 among them; nothing for a reference without
    ``agg_widths`` or a run without a spans profile."""
    from benchmark import spans

    red = {"ms": {"spmm.band": 2.0, "spmm.spill.rows": 1.0, "spmm.scale.mean": 1.0,
                  "models.dense": 9.0, "train.backward": 5.0}}
    monkeypatch.setattr(spans, "measure", lambda rec: {"window": red, "epochs": 2})
    rec = {"cfg": dict(CFG), "reference": sage, "nodes": 1000, "nnz": 5000,
           "device_kind": "NVIDIA H100 80GB HBM3"}
    read = harness.load_reader("kernels.mean_roofline")
    peak = roofline.peaks(rec["device_kind"])
    least = sum(roofline.spmm_least_s(1000, 5000, w, peak) for w in [12, 8, 8, 8, 8])
    assert read(rec) == pytest.approx(100 * least / 2e-3)
    from benchmark.reference import gcn

    assert read(dict(rec, reference=gcn)) is None
    monkeypatch.setattr(spans, "measure", lambda rec: None)
    assert read(rec) is None


@pytest.fixture
def sage_root(tiny_root):
    """The tiny root with a small cell of the SAGE configuration."""
    return conftest.make_root(os.path.dirname(tiny_root) + "/sage",
                              cells={"tiny.sage": "sage3.products"})


def test_sound_sage_run_is_correct(sage_root):
    res = conftest.rehearse(sage_root, "tiny.sage")
    assert res["correct"] is True


def test_sage_half_the_batch_left_out(sage_root, monkeypatch):
    def half(log_probs, labels):
        k = labels.shape[0] // 2
        return -log_probs[k:].gather(1, labels[k:, None]).mean()

    monkeypatch.setattr(loop, "nll_loss", half)
    assert conftest.rehearse(sage_root, "tiny.sage")["correct"] is False
