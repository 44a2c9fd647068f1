"""The port's GraphSAGE-mean (``models.layers.SAGEConv`` through ``Net``,
``make_train_step`` and ``HybridSpMM``, the path ``--model sage`` and the
benchmark take) against the benchmark's plain reference,
``benchmark/reference/sage.py``, on the CPU: seeded glorot weights in the
reference's one [2 d_in, d_out] leaf a layer, a small stand-in of the
``sage3.products`` traffic's kind (a clustered block model whose wide plan
spills), and each layout the port trains SAGE in (wide, tband, row), at
two widths: hidden 72, where the wide layout pads layer 3's 72 and 7 alike
to 128, and hidden 200, where layer 3 runs 256 -> 128 wide, 208 -> 16
tband and 200 -> 7 in rows.  Held: the log-probabilities, the first step's
gradient of every leaf and the losses of three Adam steps; which layers
project before they aggregate (``models.sage_project_first``: those whose
SpMM runs narrower at d_out than at d_in, never the first); and that a
layer which projects first keeps no [M, d_in] aggregate for its backward.

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
from hcspmm_tpu_torch.models.layers import FIXED_FINAL, SAGEConv
from hcspmm_tpu_torch.models.net import Net, net_forward
from hcspmm_tpu_torch.ops.spmm import HybridSpMM
from hcspmm_tpu_torch.train.loop import layout_input, make_train_step
from hcspmm_tpu_torch.utils import profiling

CFG = {"num_layers": 3, "dim": 20, "hidden": 72, "classes": 7, "dropout": 0.0, "lr": 0.01,
       "betas": [0.9, 0.999], "eps": 1e-08}
LAYOUTS = {
    "wide": dict(band_impl="wide"),
    "tband": dict(impl="pallas", band_impl="tband", band_h=128, band_mode="always"),
    "rows": dict(band_mode="never"),
}
STEPS = 3
#: the hidden widths held, and the layouts where layer 3 (hidden -> 7)
#: projects first: at 72 the wide layout's 128 -> 128 is a tie
HIDDEN = (72, 200)
PROJECTS_FIRST = {72: {"tband", "rows"}, 200: {"wide", "tband", "rows"}}
#: a layer's forward spans, aggregating first and projecting first
AGG_FIRST = ["spmm.fwd", "spmm.scale.mean", "models.dense"]
PROJECT_FIRST = ["models.dense", "spmm.fwd", "spmm.scale.mean", "models.dense"]
#: limits, relative: the logits and each leaf's gradient to their max |ref|,
#: the losses to the reference's loss.  The three layouts at both widths
#: read at most 2.2e-7, 3.8e-7 and 2.1e-7; the port in bfloat16 at least 2.4e-3, 4.8e-3
#: (its worst leaf 1.9e-2) and 3.5e-4 (its worst step 1.6e-3)
TOL = {"logits": 3e-6, "grads": 3e-6, "losses": 2e-6}


def _graph():
    src, dst, n = generators.synthetic_dcsbm(3000, 12.0, mixing=0.3, comm_min=16,
                                             comm_max=512, seed=7)
    rp, ci = generators.to_csr(src, dst, n)
    perm = reorder.cluster_reorder(rp, ci, n)
    rp, ci = reorder.apply_permutation(rp, ci, n, perm)
    return rp, ci, n


def _case(hidden):
    cfg = dict(CFG, hidden=hidden)
    rp, ci, n = _graph()
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((n, cfg["dim"]), generator=gen)
    y = torch.randint(0, cfg["classes"], (n,), generator=gen)
    weights = [torch.randn(shape, generator=gen) * (2.0 / sum(shape)) ** 0.5
               for shape in ref.layer_shapes(cfg)]
    graph = ref.prepare(rp, ci, n, cfg, "cpu")
    with torch.no_grad():
        logits = ref.forward(weights, *graph, x, None, 1.0)
    steps = ref.train_steps(cfg, graph, weights, x, y, [None] * STEPS)
    return {"cfg": cfg, "csr": (rp, ci, n), "x": x, "y": y, "weights": weights,
            "logits": logits, "ref": steps}


@pytest.fixture(scope="module")
def cases():
    made = {}

    def get(hidden):
        if hidden not in made:
            made[hidden] = _case(hidden)
        return made[hidden]

    return get


@pytest.fixture(scope="module")
def case(cases):
    return cases(CFG["hidden"])


def _rel(got, want):
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / want.abs().max())


def _op(csr, layout, compute_dtype="float32"):
    return HybridSpMM(*csr, PlanConfig(compute_dtype=compute_dtype, **LAYOUTS[layout]),
                      device="cpu")


def _port(case, layout, compute_dtype="float32"):
    """The port's log-probabilities, first gradients and losses from the
    case's weights, trained as ``train.loop`` trains, with the counters and
    the ``train.forward`` span's children of the first step, traced."""
    cfg = case["cfg"]
    op = _op(case["csr"], layout, compute_dtype)
    net = Net(model="sage", num_features=cfg["dim"], hidden=cfg["hidden"],
              num_classes=cfg["classes"], num_layers=cfg["num_layers"], dropout=0.0)
    params = [{"weights": w.clone().requires_grad_(True)} for w in case["weights"]]
    x = layout_input(op, case["x"])
    out_slice = ((lambda h: op.unpad_output(h, cfg["classes"], torch.float32))
                 if op.supports_padded else None)
    with torch.no_grad():
        logits = net_forward(net, params, op.layout, x, out_slice=out_slice)
    step = make_train_step(net, op, torch.optim.Adam(
        [p["weights"] for p in params], lr=cfg["lr"], betas=tuple(cfg["betas"]),
        eps=cfg["eps"]))
    losses, grads = [], None
    profiling.reset()
    with profiling.tracing():
        losses.append(float(step(params, x, case["y"])))
    counters = profiling.counters()
    recs = profiling.spans()
    (fwd,) = [r for r in recs if r["name"] == "train.forward"]
    forward = [r["name"] for r in recs if r["parent"] == fwd["id"]]
    profiling.reset()
    grads = [p["weights"].grad.clone() for p in params]
    for _ in range(STEPS - 1):
        losses.append(float(step(params, x, case["y"])))
    return op, logits, grads, losses, counters, forward


@pytest.mark.parametrize("layout,hidden", [
    pytest.param(layout, hidden, id=layout if hidden == CFG["hidden"] else f"{layout}-h{hidden}")
    for hidden in HIDDEN for layout in sorted(LAYOUTS)])
def test_sage_matches_the_plain_reference(cases, layout, hidden):
    case = cases(hidden)
    op, logits, grads, losses, counters, forward = _port(case, layout)
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
    # layers 1 and 2 aggregate first; layer 3 projects first where it narrows
    first = layout in PROJECTS_FIRST[hidden]
    assert counters.get("models.sage_project_first", 0) == int(first)
    assert forward == AGG_FIRST * 2 + (PROJECT_FIRST if first else AGG_FIRST)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_an_input_without_gradient_projects_first_where_it_halves(layout):
    """An input that takes no gradient (a first layer's) whose weight does:
    projecting first adds the backward SpMM that dW needs, so a layer
    narrowing 20 -> 16 (rows 20 -> 16, tband 32 -> 16, wide a tie)
    aggregates first, while 300 -> 7 (rows 300 -> 7, tband 304 -> 16, wide
    384 -> 128) projects first; with no gradient at all, 20 -> 16 projects
    first in the row and tband layouts.  Each output and dW equal the aggregate-first
    form's."""
    rp, ci, n = _graph()
    op = _op((rp, ci, n), layout)
    lay = op.layout
    for d_in, d_out, grad, first in [(20, 16, True, False), (300, 7, True, True),
                                     (20, 16, False, layout != "wide")]:
        x = layout_input(op, torch.randn((n, d_in), generator=torch.Generator().manual_seed(1)))
        w = torch.randn((2 * d_in, d_out), generator=torch.Generator().manual_seed(2))
        w.requires_grad_(grad)
        profiling.reset()
        with profiling.tracing():
            got = SAGEConv()({"weights": w}, lay, x)
        assert profiling.counters().get("models.sage_project_first", 0) == int(first)
        profiling.reset()
        want = lay.dense_sum(x, w[:d_in], lay.mean(x), w[d_in:])
        assert _rel(got, want) < TOL["logits"]
        if grad:
            (dw,) = torch.autograd.grad(got.square().sum(), w)
            (dw_want,) = torch.autograd.grad(want.square().sum(), w)
            assert _rel(dw, dw_want) < TOL["grads"]


def _saved(fn):
    """The tensors autograd saves while ``fn()`` runs, by storage."""
    saved = {}

    def pack(t):
        saved[t.untyped_storage().data_ptr()] = t
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return saved


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_projecting_first_keeps_no_aggregate_for_the_backward(layout):
    """Layer 3 at hidden 200 (200 -> 7) projects first and saves its input
    and the weight's two padded halves; aggregating first at the same shape
    saves, besides, the [M, d_in] aggregate for dW, the bytes the
    ``peak_mem_gib`` of a SAGE cell loses with the new order."""
    rp, ci, n = _graph()
    op = _op((rp, ci, n), layout)
    lay = op.layout
    hidden, classes = HIDDEN[1], CFG["classes"]
    x = layout_input(op, torch.randn((n, hidden), generator=torch.Generator().manual_seed(1)))
    x.requires_grad_(True)
    w = torch.randn((2 * hidden, classes), generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    assert lay.spmm_width(classes) < lay.spmm_width(hidden)
    profiling.reset()
    with profiling.tracing():
        new = _saved(lambda: SAGEConv(FIXED_FINAL)({"weights": w}, lay, x))
    assert profiling.counters()["models.sage_project_first"] == 1
    profiling.reset()
    old = _saved(lambda: lay.dense_sum(x, w[:hidden], lay.mean(x), w[hidden:]))
    xptr = x.untyped_storage().data_ptr()
    assert xptr in new and xptr in old

    def big(saved):
        return [t for p, t in saved.items() if p != xptr and t.numel() >= x.numel()]

    (agg,) = big(old)
    assert agg.shape == x.shape
    assert big(new) == []
    nbytes = lambda saved: sum(t.untyped_storage().nbytes() for t in saved.values())
    assert nbytes(new) <= nbytes(old) - agg.untyped_storage().nbytes()


def test_bfloat16_is_refused(case):
    """The port in bfloat16 (its own lower-precision path) reads at least
    ten times every limit."""
    _, logits, grads, losses, _, _ = _port(case, "wide", "bfloat16")
    assert _rel(logits, case["logits"]) > 10 * TOL["logits"]
    assert max(_rel(g, w) for g, w in zip(grads, case["ref"]["first_grads"])) > 10 * TOL["grads"]
    assert max(abs(a / b - 1) for a, b in zip(losses, case["ref"]["losses"])) > 10 * TOL["losses"]
