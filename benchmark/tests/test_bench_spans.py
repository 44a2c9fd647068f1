"""The spans profile's reduction (benchmark/spans.py) on synthetic Chrome
trace events: each device operation belongs to the program span that
launched it, by the launch's correlation id and thread, whenever it runs;
a kernel of the program launched outside every ``spmm.*`` span fails the
run; the metrics read the profile, and read nothing where there is none."""

import pytest

from benchmark import harness, spans, traces

NAMES = {"train.step", "train.forward", "train.backward", "spmm.fwd", "spmm.bwd",
         "spmm.scale", "spmm.band", "spmm.spill.cold"}


def rng(name, tid, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "tid": tid, "ts": ts, "dur": dur}


def launch(corr, tid, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid, "ts": ts,
            "dur": 1.0, "args": {"correlation": corr}}


def kernel(name, corr, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def events():
    """A step on thread 1 whose backward SpMM runs on thread 2; the device
    runs every kernel long after its launch."""
    return [
        rng(traces.WINDOW, 1, 0.0, 1000.0),
        rng("train.step", 1, 10.0, 200.0), rng("train.forward", 1, 11.0, 80.0),
        rng("spmm.fwd", 1, 20.0, 50.0), rng("spmm.scale", 1, 21.0, 5.0),
        rng("spmm.band", 1, 30.0, 10.0), rng("spmm.spill.cold", 1, 45.0, 10.0),
        rng("train.backward", 1, 100.0, 100.0),
        rng("spmm.bwd", 2, 120.0, 40.0), rng("spmm.band", 2, 125.0, 10.0),
        launch(1, 1, 22.0), kernel("elementwise_kernel", 1, 300.0, 20.0),
        launch(2, 1, 31.0), kernel("void tband_kernel<1>", 2, 420.0, 50.0),
        launch(3, 1, 46.0), kernel("void merge_kernel", 3, 470.0, 30.0),
        launch(4, 2, 126.0), kernel("void tband_kernel<1>", 4, 600.0, 40.0),
        launch(5, 2, 170.0), kernel("gemm_kernel", 5, 700.0, 10.0),  # MmBackward
        kernel("void merge_kernel", 6, 800.0, 5.0),  # its launch lost
        {"ph": "X", "cat": "gpu_user_annotation", "name": "spmm.band", "tid": 7, "ts": 400.0,
         "dur": 100.0},
    ]


def profile(evts=None):
    evts = evts or events()
    ops, launches, ranges = spans.parse(evts, NAMES)
    assert spans.window_of(evts) == (0.0, 1000.0)
    return spans.reduce(spans.attribute(ops, launches, ranges), ranges, spans.window_of(evts),
                        traces.kernel_table())


def test_each_operation_belongs_to_the_span_that_launched_it():
    red = profile()
    assert red["ms"] == pytest.approx({"spmm.scale": 0.02, "spmm.band": 0.09,
                                       "spmm.spill.cold": 0.03, "train.backward": 0.01,
                                       spans.NO_SPAN: 0.005})
    assert red["total_ms"] == pytest.approx(0.155)
    assert red["port_launch_lost"] == ["void merge_kernel"] and red["port_outside_spmm"] == []
    assert red["other_ops_in_spmm"] == {"spmm.scale": [("elementwise_kernel", 0.02)]}
    assert spans.span_ms(red, "spmm.spill") == pytest.approx(0.03)
    assert red["busy_s"] == pytest.approx(155e-6) and red["wall_s"] == pytest.approx(1e-3)
    # the longest idle gap, 0-300 us: at its middle the innermost span open on
    # any thread is the backward SpMM on thread 2
    assert red["idle_gaps_by_span"][0] == ["spmm.bwd", pytest.approx(300e-6)]
    spans.check(red)


def test_program_kernel_outside_every_spmm_span_fails():
    evts = events() + [launch(9, 1, 15.0), kernel("void band_kernel<1>", 9, 900.0, 5.0)]
    red = profile(evts)
    assert red["port_outside_spmm"] == [["void band_kernel<1>", "train.forward"]]
    with pytest.raises(RuntimeError, match="outside every spmm"):
        spans.check(red)


def test_set_up_spans_count_the_outermost_reorder():
    recs = [dict(id=1, name="format.reorder", parent=None, start_ns=0, end_ns=3_000_000_000),
            dict(id=2, name="format.reorder", parent=1, start_ns=0, end_ns=1_000_000_000),
            dict(id=3, name="format.plan", parent=None, start_ns=0, end_ns=2_000_000_000),
            dict(id=4, name="format.plan.band", parent=3, start_ns=0, end_ns=500_000_000),
            dict(id=5, name="format.upload", parent=None, start_ns=0, end_ns=250_000_000)]
    assert spans.setup_of(recs) == {"format.reorder": 3.0, "format.plan": 2.0,
                                    "format.plan.band": 0.5, "format.upload": 0.25}


def test_readers_on_a_spans_profile():
    sp = {"epochs": 2, "spill_edges": 3_000_000, "setup": {"format.upload": 1.5},
          "window": {"ms": {"spmm.scale": 4.0, "spmm.band": 6.0, "spmm.spill.hub": 1.0,
                            "spmm.spill.cold": 2.0, "train.backward": 1.0}}}
    rec = {"spans_profile": sp}
    read = lambda name: harness.load_reader(name)(rec)  # noqa: E731
    assert read("kernels.scale_ms") == 2.0 and read("kernels.band_ms") == 3.0
    assert read("kernels.spill_ms") == 1.5 and read("format.upload_s") == 1.5
    assert read("kernels.spill_gedges_per_s") == pytest.approx(1.0)


def test_no_spans_profile_on_a_cpu_run_or_a_program_without_spans(monkeypatch):
    from hcspmm_tpu_torch.utils import profiling

    assert spans.measure({"device_kind": "cpu", "cell": "gcn6.gh"}) is None
    monkeypatch.delattr(profiling, "tracing")
    rec = {"device_kind": "NVIDIA H100 80GB HBM3", "cell": "gcn6.gh"}
    for name in ("kernels.scale_ms", "kernels.spill_gedges_per_s", "format.upload_s"):
        assert harness.load_reader(name)(rec) is None


def test_seed_of_the_run():
    assert spans._run_seed(["run.py", "--workload", "a", "--seed", "4100000001"]) == 4100000001
    assert spans._run_seed(["run.py", "--seed=7"]) == 7
