"""The port's GraphSAGE-mean (``models.layers.SAGEConv`` through ``Net``,
``make_train_step`` and ``HybridSpMM``, the path ``--model sage`` and the
benchmark take) against the benchmark's plain reference,
``benchmark/reference/sage.py``, on the CPU: seeded glorot weights in the
reference's one [2 d_in, d_out] leaf a layer, a small stand-in of the
``sage3.products`` traffic's kind (a clustered block model whose wide plan
spills), and each layout the port trains SAGE in (wide, tband, row).  Held:
the log-probabilities, the first step's gradient of every leaf and the
losses of three Adam steps.

Tolerances: both sides compute in float32 and differ only in the order of
their sums (the port's band blocks, row merge or row kernels against
torch.sparse's CSR product; the port's two products into one output against
the reference's product of the concatenation), so each reading lies within
a few float32 ulps of its scale.  The limits (``TOL``) sit about ten times
above what the three layouts read and ten times or more under what the
port reads with ``compute_dtype='bfloat16'``, the precision below the
configuration's (``test_bfloat16_is_refused``)."""

import numpy as np
import pytest
import torch

from benchmark.graphs import generators
from benchmark.reference import sage as ref

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.format import reorder
from hcspmm_tpu_torch.models.net import Net, net_forward
from hcspmm_tpu_torch.ops.spmm import HybridSpMM
from hcspmm_tpu_torch.train.loop import Bound, layout_input, make_train_step

CFG = {"num_layers": 3, "dim": 20, "hidden": 72, "classes": 7, "dropout": 0.0, "lr": 0.01,
       "betas": [0.9, 0.999], "eps": 1e-08}
LAYOUTS = {
    "wide": dict(band_impl="wide"),
    "tband": dict(impl="pallas", band_impl="tband", band_h=128, band_mode="always"),
    "rows": dict(band_mode="never"),
}
STEPS = 3
#: limits, relative: the logits and each leaf's gradient to their max |ref|,
#: the losses to the reference's loss.  The three layouts read at most
#: 2.2e-7, 3.1e-7 and 1.2e-7; the port in bfloat16 at least 2.4e-3, 4.8e-3
#: (its worst leaf 1.9e-2) and 3.5e-4 (its worst step 1.6e-3)
TOL = {"logits": 3e-6, "grads": 3e-6, "losses": 2e-6}


def _graph():
    src, dst, n = generators.synthetic_dcsbm(3000, 12.0, mixing=0.3, comm_min=16,
                                             comm_max=512, seed=7)
    rp, ci = generators.to_csr(src, dst, n)
    perm = reorder.cluster_reorder(rp, ci, n)
    rp, ci = reorder.apply_permutation(rp, ci, n, perm)
    return rp, ci, n


@pytest.fixture(scope="module")
def case():
    rp, ci, n = _graph()
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((n, CFG["dim"]), generator=gen)
    y = torch.randint(0, CFG["classes"], (n,), generator=gen)
    weights = [torch.randn(shape, generator=gen) * (2.0 / sum(shape)) ** 0.5
               for shape in ref.layer_shapes(CFG)]
    graph = ref.prepare(rp, ci, n, CFG, "cpu")
    with torch.no_grad():
        logits = ref.forward(weights, *graph, x, None, 1.0)
    steps = ref.train_steps(CFG, graph, weights, x, y, [None] * STEPS)
    return {"csr": (rp, ci, n), "x": x, "y": y, "weights": weights, "logits": logits,
            "ref": steps}


def _rel(got, want):
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / want.abs().max())


def _port(case, layout, compute_dtype="float32"):
    """The port's log-probabilities, first gradients and losses from the
    case's weights, trained as ``train.loop`` trains."""
    op = HybridSpMM(*case["csr"], PlanConfig(compute_dtype=compute_dtype, **LAYOUTS[layout]),
                    device="cpu")
    net = Net(model="sage", num_features=CFG["dim"], hidden=CFG["hidden"],
              num_classes=CFG["classes"], num_layers=CFG["num_layers"], dropout=0.0)
    params = [{"weights": w.clone().requires_grad_(True)} for w in case["weights"]]
    x = layout_input(op, case["x"])
    out_slice = ((lambda h: op.unpad_output(h, CFG["classes"], torch.float32))
                 if op.supports_padded else None)
    with torch.no_grad():
        logits = net_forward(net, params, Bound(op), x, out_slice=out_slice)
    step = make_train_step(net, op, torch.optim.Adam(
        [p["weights"] for p in params], lr=CFG["lr"], betas=tuple(CFG["betas"]),
        eps=CFG["eps"]))
    losses, grads = [], None
    for _ in range(STEPS):
        losses.append(float(step(params, x, case["y"])))
        if grads is None:
            grads = [p["weights"].grad.clone() for p in params]
    return op, logits, grads, losses


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sage_matches_the_plain_reference(case, layout):
    op, logits, grads, losses = _port(case, layout)
    padded, transposed = {"wide": (True, False), "tband": (True, True),
                          "rows": (False, False)}[layout]
    assert op.supports_padded == padded and op.transposed == transposed
    if layout == "wide":
        assert op.plan.spill_nnz > 0  # the row merge runs in every SpMM
    assert _rel(logits, case["logits"]) < TOL["logits"]
    want = case["ref"]["first_grads"]
    assert [g.shape for g in grads] == [w.shape for w in want]
    for got, w in zip(grads, want):
        assert _rel(got, w) < TOL["grads"]
    assert np.allclose(losses, case["ref"]["losses"], rtol=TOL["losses"], atol=0)


def test_bfloat16_is_refused(case):
    """The port in bfloat16 (its own lower-precision path) reads at least
    ten times every limit."""
    _, logits, grads, losses = _port(case, "wide", "bfloat16")
    assert _rel(logits, case["logits"]) > 10 * TOL["logits"]
    assert max(_rel(g, w) for g, w in zip(grads, case["ref"]["first_grads"])) > 10 * TOL["grads"]
    assert max(abs(a / b - 1) for a, b in zip(losses, case["ref"]["losses"])) > 10 * TOL["losses"]
