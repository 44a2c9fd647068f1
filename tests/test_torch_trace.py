"""The port's spans and counters (hcspmm_tpu_torch/utils/profiling.py) on a
normalised GCN step: nothing recorded and no clock read while tracing is
off; the span tree of a step in every layout (a tband and a wide plan that
spill, a tiled plan and a row-layout plan); the spill counter; the spans as
ranges of a torch.profiler trace, placed through the ``profiling.clock``
anchor; the D^-1/2 scalings, as autograd nodes of their own in the tiled
and row layouts (equal bit for bit to the composed form, with its peak
memory) and inside the SpMM's kernels in the tband and wide layouts (equal
to it within the kernels' tolerance, at most its peak memory); a SAGE step's
mean scalings (``spmm.scale.mean``, counter ``spmm.mean``); and the build
counts on the CLI's ``done`` line."""

import gc
import threading
import time

import pytest
import torch

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.models.net import Net, init_net_params
from hcspmm_tpu_torch.ops.spmm import HybridSpMM
from hcspmm_tpu_torch.train.loop import layout_input, make_train_step
from hcspmm_tpu_torch.utils import profiling

from conftest import small_graph

# (graph, PlanConfig fields): the tband and wide plans spill in every SpMM
PLANS = {
    "tband": ((1400, 9, 1300), dict(
        impl="pallas", band_impl="tband", band_h=128, band_widths=(128,), band_mode="auto",
        ts_table_mb=1e-3, ts_span=256, ts_k=32, ts2_table_mb=48 * 64 / 1e6,
        spill_hub_mb=64 * 64 / 1e6, spill_hub_min_cov=0.01, spill_hub_min_reuse=0.0)),
    "wide": ((500, 8, 400), dict(impl="pallas", band_impl="wide", band_h=128,
                                 band_widths=(128,), ds_kind="block")),
    "tiled": ((500, 8, 400), dict(impl="pallas", band_impl="tiled", band_h=128)),
    "rows": ((500, 8, 400), dict(impl="pallas", band_mode="never")),
}
#: the spill spans each plan's SpMM runs, in order (none: the plan never spills)
SPILL = {"tband": ["spmm.spill.hub", "spmm.spill.cold"], "wide": ["spmm.spill.rows"],
         "tiled": [], "rows": []}
#: the layouts whose SpMM kernels apply D^-1/2 (no ``spmm.scale`` around them)
FOLDED = {"tband": True, "wide": True, "tiled": False, "rows": False}
#: the layouts where the SAGE net's last layer (16 -> 5) projects first: the
#: row layout's SpMM runs 5 columns against 16; the padded layouts pad both
#: widths alike (16 sublanes, 128 lanes)
SAGE_PROJECTS_FIRST = {"rows"}
#: the wide kernels' tolerance (tests/test_torch_wide.py), relative to max |ref|
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LAYERS = 3


def make_op(layout, compute_dtype="float32"):
    (n, deg, span), fields = PLANS[layout]
    rp, ci, nn = small_graph(n, deg, span=span)
    return HybridSpMM(rp, ci, nn, PlanConfig(compute_dtype=compute_dtype, **fields),
                      normalize=True, device="cpu")


def make_step(op):
    net = Net(model="gcn", num_features=24, hidden=16, num_classes=5, num_layers=LAYERS,
              dropout=0.5)
    params = init_net_params(net, torch.Generator().manual_seed(0), init="glorot",
                             device="cpu")
    step = make_train_step(net, op, torch.optim.Adam(
        [t for layer in params for t in layer.values()], lr=0.01))
    n = op.plan.num_nodes
    x = layout_input(op, torch.randn((n, 24), generator=torch.Generator().manual_seed(1)))
    y = torch.randint(0, 5, (n,), generator=torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(3)

    def run():
        return step(params, x, y, gen)

    run.params = params
    return run


@pytest.fixture(scope="module")
def ops():
    return {layout: make_op(layout) for layout in PLANS}


def children(recs, parent):
    return [r for r in recs if r["parent"] == parent["id"]]


@pytest.mark.parametrize("layout", sorted(PLANS))
def test_tracing_off_records_nothing_and_reads_no_clock(ops, layout, monkeypatch):
    step = make_step(ops[layout])
    profiling.reset()

    def refuse(*args, **kwargs):
        raise AssertionError("a span site read the clock or opened a range with tracing off")

    monkeypatch.setattr(time, "perf_counter_ns", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    step()
    assert profiling.spans() == [] and profiling.counters() == {}


@pytest.mark.parametrize("layout", sorted(PLANS))
def test_span_tree_of_a_gcn_step(ops, layout):
    """One ``train.step`` over forward, backward and optimizer; each SpMM
    a ``spmm.fwd`` or ``spmm.bwd`` holding the band and the spill chain (the
    tiled and row-layout plans spill nothing), between its two
    ``spmm.scale`` scalings in the tiled and row layouts and alone in the
    tband and wide layouts, whose kernels scale (``spmm.scale_folded``
    counts one a SpMM there, none elsewhere); every span of the step with
    the step's id."""
    op = ops[layout]
    step = make_step(op)
    step()
    profiling.reset()
    with profiling.tracing():
        step()
    recs = [r for r in profiling.spans() if r["name"] != profiling.CLOCK]
    assert all(r["end_ns"] is not None and r["end_ns"] >= r["start_ns"] for r in recs)
    (root,) = [r for r in recs if r["name"] == "train.step"]
    assert root["parent"] is None and root["step"] is not None
    assert all(r["step"] == root["step"] for r in recs)
    assert [r["name"] for r in children(recs, root)] == [
        "train.forward", "train.backward", "train.optimizer"]
    fwd, bwd, _ = children(recs, root)
    if FOLDED[layout]:
        assert [r["name"] for r in children(recs, fwd)] == ["models.dense", "spmm.fwd"] * LAYERS
        assert [r["name"] for r in children(recs, bwd)] == ["spmm.bwd"] * LAYERS
    else:
        assert [r["name"] for r in children(recs, fwd)] == [
            "models.dense", "spmm.scale", "spmm.fwd", "spmm.scale"] * LAYERS
        assert [r["name"] for r in children(recs, bwd)] == [
            "spmm.scale", "spmm.bwd", "spmm.scale"] * LAYERS
    for r in recs:
        if r["name"] in ("spmm.fwd", "spmm.bwd"):
            assert [c["name"] for c in children(recs, r)] == ["spmm.band", *SPILL[layout]]
    n_spmm = sum(r["name"] in ("spmm.fwd", "spmm.bwd") for r in recs)
    assert n_spmm == 2 * LAYERS
    want = {"spmm.spill_edges": n_spmm * op.plan.spill_nnz}
    if FOLDED[layout]:
        want["spmm.scale_folded"] = n_spmm
    assert profiling.counters() == {k: v for k, v in want.items() if v}
    assert (op.plan.spill_nnz > 0) == bool(SPILL[layout])


@pytest.mark.parametrize("layout", sorted(PLANS))
def test_sage_step_spans_and_counts_its_mean_scalings(layout):
    """One 3-layer SAGE step (``models.layers.SAGEConv``, unnormalised):
    each layer's mean aggregation is a ``spmm.fwd`` then its D^-1 as a
    ``spmm.scale.mean`` span before the layer's ``models.dense`` (after one
    where the last layer projects first); the backward runs 2 of each, the
    first layer's input needing no gradient, so the step holds 5
    ``spmm.scale.mean`` spans (3 forward, 2 backward) and the counter
    ``spmm.mean`` reads 5.  The benchmark's spans profile counts
    a kernel launched inside such a span under ``spmm.scale``
    (``kernels.scale_ms``)."""
    from benchmark import spans, traces

    (n, deg, span), fields = PLANS[layout]
    op = HybridSpMM(*small_graph(n, deg, span=span), PlanConfig(**fields), device="cpu")
    net = Net(model="sage", num_features=24, hidden=16, num_classes=5, num_layers=LAYERS,
              dropout=0.5)
    params = init_net_params(net, torch.Generator().manual_seed(0), init="glorot",
                             device="cpu")
    assert [tuple(p["weights"].shape) for p in params] == [(48, 16), (32, 16), (32, 5)]
    step = make_train_step(net, op, torch.optim.Adam([p["weights"] for p in params]))
    x = layout_input(op, torch.randn((op.plan.num_nodes, 24),
                                     generator=torch.Generator().manual_seed(1)))
    y = torch.randint(0, 5, (op.plan.num_nodes,), generator=torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    step(params, x, y, gen)
    profiling.reset()
    with profiling.tracing():
        step(params, x, y, gen)
    recs = [r for r in profiling.spans() if r["name"] != profiling.CLOCK]
    (root,) = [r for r in recs if r["name"] == "train.step"]
    fwd, bwd, _ = children(recs, root)
    first = layout in SAGE_PROJECTS_FIRST
    agg_first = ["spmm.fwd", "spmm.scale.mean", "models.dense"]
    assert [r["name"] for r in children(recs, fwd)] == agg_first * (LAYERS - 1) + (
        ["models.dense", *agg_first] if first else agg_first)
    assert [r["name"] for r in children(recs, bwd)] == ["spmm.scale.mean", "spmm.bwd"] * (
        LAYERS - 1)
    means = [r for r in recs if r["name"] == "spmm.scale.mean"]
    assert len(means) == 5 and not [r for r in recs if r["name"] == "spmm.scale"]
    want = {"spmm.mean": 5, "spmm.spill_edges": 5 * op.plan.spill_nnz,
            "models.sage_project_first": int(first)}
    assert profiling.counters() == {k: v for k, v in want.items() if v}

    # the spans as a trace's host ranges, a 1 us kernel launched in each mean
    events = [{"ph": "X", "cat": "user_annotation", "name": r["name"], "tid": r["thread"],
               "ts": r["start_ns"] / 1e3, "dur": (r["end_ns"] - r["start_ns"]) / 1e3}
              for r in recs]
    for corr, r in enumerate(means):
        mid = (r["start_ns"] + r["end_ns"]) / 2e3
        events += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                    "tid": r["thread"], "ts": mid, "dur": 0.0, "args": {"correlation": corr}},
                   {"ph": "X", "cat": "kernel", "name": "elementwise_kernel<MulFunctor>",
                    "tid": 7, "ts": mid, "dur": 1.0, "args": {"correlation": corr}}]
    ops, launches, ranges = spans.parse(events, {r["name"] for r in recs})
    red = spans.reduce(spans.attribute(ops, launches, ranges), ranges,
                       (root["start_ns"] / 1e3, root["end_ns"] / 1e3 + 10), traces.kernel_table())
    assert red["ms"] == {"spmm.scale.mean": pytest.approx(5e-3)}
    assert spans.span_ms(red, "spmm.scale") == pytest.approx(5e-3)


def test_a_thread_without_spans_joins_the_open_step():
    """The backward on the card runs on autograd's engine thread: a span it
    opens takes the innermost span open on the step's thread as parent, and
    the step's id."""
    profiling.reset()
    with profiling.tracing():
        with profiling.span("train.step", step=True):
            with profiling.span("train.backward"):
                t = threading.Thread(target=lambda: profiling.span("spmm.bwd").__enter__()
                                     .__exit__(None, None, None))
                t.start()
                t.join(timeout=10)
                assert not t.is_alive()
        with profiling.span("after"):
            pass
    recs = {r["name"]: r for r in profiling.spans()}
    assert recs["spmm.bwd"]["parent"] == recs["train.backward"]["id"]
    assert recs["spmm.bwd"]["step"] == recs["train.step"]["step"] is not None
    assert recs["spmm.bwd"]["thread"] != recs["train.step"]["thread"]
    assert recs["after"]["parent"] is None and recs["after"]["step"] is None


def test_set_up_spans_and_plan_phases():
    profiling.reset()
    with profiling.tracing():
        op = make_op("tband")
    recs = profiling.spans()
    names = [r["name"] for r in recs]
    assert names.count("format.upload") == 1
    (plan,) = [r for r in recs if r["name"] == "format.plan"]
    phases = children(recs, plan)
    assert {r["name"] for r in phases} == {
        "format.plan.windows", "format.plan.band", "format.plan.spill", "format.plan.lanes",
        "format.plan.rows", "format.plan.merge"}
    assert all(r["end_ns"] is not None for r in phases)
    for a, b in zip(phases, phases[1:]):  # one after another, none nested
        assert a["end_ns"] <= b["start_ns"]
    assert phases[0]["start_ns"] >= plan["start_ns"] and phases[-1]["end_ns"] <= plan["end_ns"]
    assert op.plan.spill_nnz > 0


def test_spans_are_profiler_ranges_placed_by_the_clock_anchor(ops):
    """Under torch.profiler every span is a host range of its name, and its
    start maps through the ``profiling.clock`` anchor to within 100 us."""
    step = make_step(ops["tband"])
    step()
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.tracing():
            step()
    recs = profiling.spans()
    names = {r["name"] for r in recs}
    ranges = {}
    for e in prof.events():
        if e.name in names:
            ranges.setdefault(e.name, []).append(float(e.time_range.start))
    (anchor,) = [r for r in recs if r["name"] == profiling.CLOCK]
    (anchor_us,) = ranges[profiling.CLOCK]
    for name in names:
        got = sorted(profiling.to_trace_us(r["start_ns"], anchor, anchor_us)
                     for r in recs if r["name"] == name)
        want = sorted(ranges.get(name, []))
        assert len(got) == len(want), name
        assert max(abs(g - w) for g, w in zip(got, want)) < 100.0, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", sorted(PLANS))
def test_scale_nodes_equal_the_composed_form(layout, dtype):
    """The D^-1/2 scalings against the composed form the operator ran
    before (two broadcast products around the SpMM, differentiated by
    autograd): as ``_Scale`` nodes (the tiled padded layout, the padded view
    of a row-layout plan, and the row layout) outputs and gradients
    ``torch.equal``; inside the tband and wide kernels, whose sums round
    once where the composed form rounds twice, within the kernels'
    tolerance ``TOL``."""
    op = make_op(layout, dtype)
    assert op.layout.folds_scale == FOLDED[layout]
    n, d = op.plan.num_nodes, 20
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((n, d), generator=gen)
    arrays = op.arrays

    def composed_padded(xp):
        inv = op.padded._lanes(arrays["inv_sqrt_deg"])
        xs = (xp * inv).to(xp.dtype)
        return (op.padded.raw(xs) * inv).to(xp.dtype)

    def composed_rows(v):
        inv = arrays["inv_sqrt_deg"][:, None]
        xs = (v * inv).to(v.dtype)
        return (op.rows.raw(xs) * inv).to(v.dtype)

    cases = (
        (op.pad_input(x), lambda v: op.apply_padded(arrays, v), composed_padded,
         FOLDED[layout]),
        (x.to(op.pad_input(x).dtype), lambda v: op.apply(arrays, v), composed_rows, False),
    )
    for x0, folded, composed, in_kernels in cases:
        outs, grads = [], []
        for fn in (folded, composed):
            xv = x0.clone().requires_grad_(True)
            out = fn(xv)
            g = torch.randn(out.shape, generator=torch.Generator().manual_seed(6)).to(out.dtype)
            out.backward(g)
            outs.append(out.detach())
            grads.append(xv.grad)
        assert outs[0].dtype == outs[1].dtype and grads[0].dtype == grads[1].dtype
        if not in_kernels:
            assert torch.equal(outs[0], outs[1]) and torch.equal(grads[0], grads[1])
            continue
        for got, want in ((outs[0], outs[1]), (grads[0], grads[1])):
            err = (got.double() - want.double()).abs().max() / want.double().abs().max()
            assert err < TOL[want.dtype]


def test_build_counts_reach_the_cli_done_line(capsys):
    """A library build is counted whether tracing is on or off, and the
    CLI's ``done`` line carries the counts (``compiled``)."""
    import json

    from hcspmm_tpu_torch.train import cli

    profiling.reset()
    profiling.record_build("tband")
    assert cli.main(["--synthetic-nodes", "2048", "--hidden", "16", "--classes", "5",
                     "--num_layers", "2", "--epochs", "1", "--device", "cpu"]) == 0
    done = [json.loads(v) for v in capsys.readouterr().out.splitlines()
            if v.startswith("{") and '"done"' in v]
    assert len(done) == 1 and done[0]["compiled"].get("tband") == 1
    assert [r["name"] for r in profiling.spans()] == []  # tracing stayed off
    profiling.reset()


@pytest.mark.parametrize("layout", sorted(PLANS))
def test_scale_nodes_keep_the_composed_forms_peak_memory(ops, layout, monkeypatch):
    """A normalised step's peak of live host memory (torch.profiler's
    memory events) with the scalings as ``_Scale`` nodes equals the
    composed form's: the backward frees each incoming gradient after its
    scaling, before the SpMM runs.  With the scalings inside the tband or
    wide kernels it is at most the composed form's (the layout composing as
    the tiled one does)."""
    from hcspmm_tpu_torch.ops import spmm as spmm_mod

    def peak():
        # a block allocated before the profile and freed inside it would
        # lower the reading: the warm-up step's gradients (the next step
        # drops them) are freed and cyclic garbage collected first, and the
        # collector stays off while the profile runs
        step = make_step(ops[layout])
        step()
        for layer in step.params:
            for t in layer.values():
                t.grad = None
        gc.collect()
        gc.disable()
        try:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                        profile_memory=True) as prof:
                step()
        finally:
            gc.enable()
        events = sorted((e for e in prof.profiler.kineto_results.events()
                         if e.name() == "[memory]"), key=lambda e: e.start_ns())
        cur = top = 0
        for e in events:
            cur += e.nbytes()
            top = max(top, cur)
        return top

    nodes = peak()
    if FOLDED[layout]:
        lay = ops[layout].layout
        monkeypatch.setattr(lay, "_agg", lay._scaled)
    monkeypatch.setattr(spmm_mod._Scale, "apply", lambda v, inv, dtype: (v * inv).to(dtype))
    composed = peak()
    assert nodes > 0 and composed > 0
    if FOLDED[layout]:
        assert nodes <= composed
    else:
        assert nodes == composed


def test_launched_by_gives_each_operation_its_launching_span():
    """``profiling.launched_by`` (``utils/epoch_profile.py``'s grouping):
    by the launch's correlation id and thread, whenever the kernel runs; a
    launch on a thread with no span open belongs to the innermost span open
    on any thread; an operation whose launch the trace lost, to none."""
    def rng(name, tid, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name, "tid": tid, "ts": ts,
                "dur": dur}

    def launch(corr, tid, ts, cat="cuda_runtime"):
        return {"ph": "X", "cat": cat, "name": "launch", "tid": tid, "ts": ts, "dur": 1.0,
                "args": {"correlation": corr}}

    def kernel(corr, ts):
        return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "tid": 7, "ts": ts, "dur": 5.0,
                "args": {"correlation": corr}}

    events = [rng("train.backward", 1, 0.0, 100.0), rng("spmm.bwd", 2, 10.0, 20.0),
              rng("spmm.band", 2, 12.0, 5.0), rng("other", 2, 40.0, 5.0),
              launch(1, 2, 13.0, "cuda_driver"), kernel(1, 500.0),
              launch(2, 2, 25.0), kernel(2, 510.0),
              launch(3, 2, 41.0), kernel(3, 520.0),
              kernel(4, 530.0)]
    got = profiling.launched_by(events, {"train.backward", "spmm.bwd", "spmm.band"})
    assert [(name, owner) for name, _, _, owner in got] == [
        ("k1", "spmm.band"), ("k2", "spmm.bwd"), ("k3", "train.backward"), ("k4", None)]
