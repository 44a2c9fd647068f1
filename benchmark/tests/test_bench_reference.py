"""The plain reference against a dense NumPy computation (float64) on a
small graph: forward, loss, gradients and Adam; and what it imports."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from benchmark.graphs import generators
from benchmark.reference import gcn

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _dense_norm_adj(rp, ci, n):
    a = np.zeros((n, n))
    for r in range(n):
        a[r, ci[rp[r]:rp[r + 1]]] = 1.0
    inv = 1.0 / np.sqrt(np.maximum(np.diff(rp), 1))
    return inv[:, None] * a * inv[None, :]


def _numpy_step(ws, a, x, y, mask, keep):
    """Loss and gradients of the GCN by hand: Z_l = A (H W_l)."""
    hs, zs, pre = [x], [], []
    h = x
    last = len(ws) - 1
    for i, w in enumerate(ws):
        z = a @ (h @ w)
        zs.append(z)
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
    lse = m + np.log(np.exp(logits - m).sum(1, keepdims=True))
    logp = logits - lse
    n = len(y)
    loss = -logp[np.arange(n), y].mean()
    g = np.exp(logp)
    g[np.arange(n), y] -= 1.0
    g /= n  # d loss / d logits
    grads = [None] * len(ws)
    for i in range(last, -1, -1):
        if i != last:
            if i == 0:
                g = np.where(mask, g / keep, 0.0)
            g = g * (pre[i] > 0)
        gxw = a.T @ g
        grads[i] = hs[i].T @ gxw
        g = gxw @ ws[i].T
    return loss, grads, logp


def test_reference_against_numpy():
    src, dst, n = generators.synthetic_dcsbm(300, 6.0, mixing=0.2, seed=5)
    rp, ci = generators.to_csr(src, dst, n)
    rng = np.random.RandomState(0)
    dims = [12, 8, 8, 5]
    ws = [rng.randn(i, o) * np.sqrt(2.0 / (i + o)) for i, o in zip(dims[:-1], dims[1:])]
    x = rng.randn(n, dims[0])
    y = rng.randint(0, dims[-1], n)
    masks = [rng.rand(n, dims[1]) < 0.5 for _ in range(2)]
    a_np = _dense_norm_adj(rp, ci, n)

    a, at = gcn.normalized_adjacency(rp, ci, n, "cpu")
    assert np.allclose(a.to_dense().numpy(), a_np, rtol=1e-6, atol=1e-7)
    assert np.allclose(at.to_dense().numpy(), a_np.T, rtol=1e-6, atol=1e-7)
    t = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    logp = gcn.forward([t(w) for w in ws], a, at, t(x), torch.from_numpy(masks[0]), 0.5)
    _, _, logp_np = _numpy_step(ws, a_np, x, y, masks[0], 0.5)
    assert np.allclose(logp.numpy(), logp_np, rtol=1e-5, atol=1e-5)

    cfg = {"dropout": 0.5, "lr": 0.01, "betas": [0.9, 0.999], "eps": 1e-8, "normalize": True}
    assert gcn.prepare(rp, ci, n, cfg, "cpu")[0].to_dense().equal(a.to_dense())
    res = gcn.train_steps(cfg, (a, at), [t(w) for w in ws], t(x), torch.from_numpy(y),
                          [torch.from_numpy(m) for m in masks])
    # NumPy: two steps of Adam from the same weights
    w_np = [w.copy() for w in ws]
    m_ = [np.zeros_like(w) for w in ws]
    v_ = [np.zeros_like(w) for w in ws]
    for k, mask in enumerate(masks, start=1):
        loss, grads, _ = _numpy_step(w_np, a_np, x, y, mask, 0.5)
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


def test_unnormalized_adjacency():
    src, dst, n = generators.synthetic_dcsbm(200, 5.0, mixing=0.2, seed=2)
    rp, ci = generators.to_csr(src, dst, n)
    a, at = gcn.prepare(rp, ci, n, {"normalize": False}, "cpu")
    dense = np.zeros((n, n))
    for r in range(n):
        dense[r, ci[rp[r]:rp[r + 1]]] = 1.0
    assert np.array_equal(a.to_dense().numpy(), dense)
    assert np.array_equal(at.to_dense().numpy(), dense.T)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, json; import benchmark.reference.gcn, benchmark.check; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, env=dict(os.environ, PYTHONPATH=ROOT))
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"hcspmm_tpu_torch", "hcspmm_tpu", "jax", "jaxlib", "flax"}
