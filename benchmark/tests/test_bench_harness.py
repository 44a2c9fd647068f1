"""The harness on the CPU: cells, configurations, references and metrics
found by name; a cell and a configuration added by new files and entries
only; the configuration's keys read or refused; the per-layer arithmetic;
the result line's keys; the traced run's check against the program's
launch counters."""

import io
import json
import os

import pytest

from benchmark import harness, roofline, traces
from benchmark.reference import gcn

import conftest

SPEC = harness.load_spec()


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cells_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c["cfg"]["name"] == c["config"]
    assert c["traffic_spec"]["generator"] in __import__("benchmark.graphs").graphs.GENERATORS
    assert set(c["limits"]) == {"loss_gap", "grad_gap", "change_gap"}
    kinds = c["metrics"]
    assert "setup_s" in [m["name"] for m in kinds["end_to_end"]] and kinds["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for k in ("end_to_end", "per_layer")
                                    for m in SPEC[k]])
def test_metric_readers_found_by_name(metric):
    assert callable(harness.load_reader(metric))


def test_configs_match_their_entries():
    for conf in SPEC["configs"]:
        with open(os.path.join(harness.ROOT, conf["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == conf["name"] and conf["reduced"] == []
        assert cfg["source"] == conf["source"]
        ref = harness.reference_of(cfg)
        assert cfg["model"] in ref.MODELS and cfg["init"] in harness.INITS


def _add_config(root, name, cfg, reference_src=None):
    """A new configuration file (and reference file) and its entry, and a
    new cell ``<name>.tiny`` of it on the traffic ``tiny``."""
    bench = os.path.join(root, "benchmark")
    if reference_src is not None:
        with open(os.path.join(bench, "reference", f"{cfg['reference']}.py"), "w") as f:
            f.write(reference_src)
    with open(os.path.join(bench, "configs", f"{name}.json"), "w") as f:
        json.dump(dict(cfg, name=name), f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": name, "source": cfg["source"],
                            "file": f"benchmark/configs/{name}.json", "reduced": [],
                            "why": "a throwaway configuration"})
    spec["workloads"].append({"name": f"{name}.tiny", "config": name, "traffic": "tiny",
                              "chips": 1, "why": "CPU rehearsal"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    with open(os.path.join(bench, "workloads", f"{name}.tiny.json"), "w") as f:
        json.dump({"config": name, "traffic": "tiny",
                   "limits": harness.load_cell("gcn6.gh")["limits"]}, f)
    return f"{name}.tiny"


#: a throwaway reference: the GCN one, under another name, counting its
#: operations twice and standing for the program's ``gcn`` model
THROWAWAY_REFERENCE = """
from benchmark.reference.gcn import MODELS, layer_shapes, prepare, train_steps
from benchmark.reference import gcn

CALLS = []


def epoch_flops(cfg, nodes, nnz):
    return 2 * gcn.epoch_flops(cfg, nodes, nnz)


def train_steps(*args, **kw):
    CALLS.append(1)
    return gcn.train_steps(*args, **kw)
"""


def test_new_config_with_its_own_reference_by_new_files_only(tiny_root):
    """A configuration naming a reference file that is new too is run
    against that reference, with no other edit."""
    with open(os.path.join(harness.ROOT, "benchmark/configs/gcn6-hcspmm.json")) as f:
        base = json.load(f)
    cfg = dict(base, reference="throwaway", num_layers=2, hidden=8, dim=12)
    cell = _add_config(tiny_root, "gcn2-throwaway", cfg, THROWAWAY_REFERENCE)
    loaded = harness.load_cell(cell, tiny_root, os.path.join(tiny_root, "benchmark"))
    ref = loaded["reference"]
    assert ref.__file__.startswith(tiny_root) and loaded["cfg"]["num_layers"] == 2
    assert ref.epoch_flops(cfg, 10, 20) == 2 * gcn.epoch_flops(cfg, 10, 20)
    res = conftest.rehearse(tiny_root, cell)
    assert res["correct"] is True


@pytest.mark.parametrize("key,value,match", [
    ("reference", "missing", "no reference"),
    ("model", "gin", "stands for"),
    ("init", "randn", "init"),
    ("tf32", True, "tf32")])
def test_config_keys_are_read(tiny_root, key, value, match):
    """A configuration asking for what the harness does not do is refused,
    never run as something else."""
    with open(os.path.join(harness.ROOT, "benchmark/configs/gcn6-hcspmm.json")) as f:
        cfg = dict(json.load(f), **{key: value})
    cell = _add_config(tiny_root, "gcn6-changed", cfg)
    with pytest.raises((KeyError, ValueError), match=match):
        conftest.rehearse(tiny_root, cell)


def test_new_cell_by_new_files_only(tiny_root):
    cell = harness.load_cell("tiny.tband", tiny_root, os.path.join(tiny_root, "benchmark"))
    assert cell["traffic_spec"] == conftest.TINY_TRAFFIC
    with pytest.raises(KeyError):
        harness.load_cell("tiny.tband")  # not in this checkout's BENCHMARK.json
    res = conftest.rehearse(tiny_root, "tiny.tband")
    assert res["correct"] is True


def test_spmm_bytes_and_flops():
    assert roofline.spmm_bytes(10, 30, 4) == 2 * 10 * 4 * 4 + 4 * 30 + 4 * 11
    assert roofline.spmm_flops(30, 4) == 240
    peak = {"hbm_bytes_per_s": 1000.0, "fp32_flops_per_s": 100.0}
    assert roofline.spmm_least_s(10, 30, 4, peak) == max(484 / 1000.0, 240 / 100.0)


def test_gcn_epoch_flops_by_hand():
    cfg = {"dim": 6, "hidden": 4, "classes": 3, "num_layers": 3}
    n, nnz = 10, 20
    dense = 2 * (2 * n * 6 * 4) + 3 * (2 * n * 4 * 4) + 3 * (2 * n * 4 * 3)
    sparse = 2 * (2 * nnz * 4) * 2 + 2 * (2 * nnz * 3)
    assert gcn.epoch_flops(cfg, n, nnz) == dense + sparse
    assert gcn.layer_shapes(cfg) == [(6, 4), (4, 4), (4, 3)]


def test_per_layer_readers_on_a_fake_record():
    red = {"calls": 2, "busy_s": 0.009, "wall_s": 0.010,
           "group_ms": {"spmm": 6.0, "dense": 2.0, "other": 1.0}}
    sp = {"calls": 4, "busy_s": 0.004, "group_ms": {"spmm": 3.0, "other": 1.0}}
    rec = {"cfg": {"dim": 6, "hidden": 4, "classes": 3, "num_layers": 3}, "reference": gcn,
           "nodes": 1000,
           "nnz": 5000, "device_kind": "NVIDIA H100 80GB HBM3",
           "window": {"epoch_ms": 2.0, "epoch_times_ms": [1.0] * 19 + [3.0]},
           "traced": {"epochs": red, "spmm": sp, "enqueue_ms": [0.5, 1.5]},
           "spans": {}, "setup_s": 1.0, "peak_bytes": 2 ** 31}
    read = lambda name: harness.load_reader(name)(rec)  # noqa: E731
    assert read("kernels.spmm_ms") == 3.0 and read("models.dense_ms") == 1.0
    assert read("models.other_ms") == 0.5
    assert read("device.idle_share") == pytest.approx(10.0)
    assert read("train.enqueue_ms") == 1.0 and read("peak_mem_gib") == 2.0
    peak = roofline.peaks(rec["device_kind"])
    least = max(roofline.spmm_bytes(1000, 5000, 4) / peak["hbm_bytes_per_s"],
                roofline.spmm_flops(5000, 4) / peak["fp32_flops_per_s"])
    assert read("kernels.spmm_roofline") == pytest.approx(100 * least / 1e-3)
    flops = gcn.epoch_flops(rec["cfg"], 1000, 5000)
    assert read("device.step_mfu") == pytest.approx(100 * flops / (2e-3 * peak["fp32_flops_per_s"]))
    assert read("epoch_p95_ms") == pytest.approx(1.1)
    rec["traced"] = None
    assert read("kernels.spmm_ms") is None and read("device.idle_share") is None


def test_union_and_gaps():
    dev = [("k1", 0.0, 10.0), ("k2", 5.0, 12.0), ("k3", 20.0, 25.0)]
    host = [("aten::mm", 11.0, 21.0), ("outer", -5.0, 30.0)]
    red = traces.reduce(dev, host, traces.kernel_table(), (-4.0, 27.0))
    assert red["busy_s"] == pytest.approx(17e-6) and red["wall_s"] == pytest.approx(31e-6)
    assert red["idle_gaps"] == [["aten::mm", pytest.approx(8e-6)],
                                ["outer", pytest.approx(4e-6)], ["outer", pytest.approx(2e-6)]]
    # an operation that starts outside the window is left out, one that ends
    # past it is cut at its end
    red = traces.reduce(dev + [("k0", -9.0, -5.0)], host, traces.kernel_table(), (-4.0, 22.0))
    assert red["busy_s"] == pytest.approx(14e-6) and sum(red["launches"].values()) == 3


def test_kernel_groups():
    table = traces.kernel_table()
    g = lambda name: traces.group_of(name, table)  # noqa: E731
    assert g("void (anonymous namespace)::tband_kernel<float, float, 32, 16, 0, 1>(x)") == "spmm"
    assert g("void (anonymous namespace)::merge_kernel<float>(float const*)") == "spmm"
    assert g("void (anonymous namespace)::band_kernel<float, float, 2, 1>(x)") == "spmm"
    assert g("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x32x8") == "dense"
    assert g("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x32_8x5_nt_align1>(x)") == "dense"
    assert g("void at::native::vectorized_elementwise_kernel<4, at::native::threshold>") == "other"
    assert g("Memcpy DtoD (Device -> Device)") == "other"


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(tiny_root, trace):
    res = conftest.rehearse(tiny_root, "tiny.wide", trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[:5] == keys and list(res)[-1] == "checks"
    assert set(res) == set(keys) | {"checks"} | ({"breakdown"} if trace else set())
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    out, err = io.StringIO(), io.StringIO()
    harness.report(res, out, err)
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == json.loads(json.dumps(res))
    last = err.getvalue().strip().splitlines()[-3:]
    assert [line.split()[1] for line in last] == ["loss_gap", "grad_gap", "change_gap"]


def test_profile_that_lost_kernels_fails(tiny_root, monkeypatch):
    """A traced run whose profile holds fewer of the program's kernels than
    its counters counted over the same calls is refused."""
    counts = iter(range(0, 1000, 7))
    monkeypatch.setattr(traces, "read_counters", lambda spec: next(counts))
    with pytest.raises(RuntimeError, match="lost records"):
        conftest.rehearse(tiny_root, "tiny.tband", trace=True)


def test_profile_taken_again_after_a_loss(tiny_root, monkeypatch):
    """One profile that lost a record is taken again; the run goes on."""
    counts = iter([0, 7] + [7] * 1000)  # the first profile: 7 counted, none kept
    monkeypatch.setattr(traces, "read_counters", lambda spec: next(counts))
    res = conftest.rehearse(tiny_root, "tiny.tband", trace=True)
    assert res["correct"] is True and "breakdown" in res


def test_host_ranges_on_the_device_timeline_left_out():
    """A record_function range shows on the device's timeline over its
    kernels; it is no device operation."""
    from types import SimpleNamespace

    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def evt(name, dev, s, e, ann=False):
        return SimpleNamespace(name=name, device_type=dev, is_user_annotation=ann,
                               time_range=SimpleNamespace(start=s, end=e))

    prof = SimpleNamespace(events=lambda: [
        evt(traces.WINDOW, cpu, 0.0, 10.0), evt(traces.WINDOW, cuda, 1.0, 9.0),
        evt("mine", cuda, 1.0, 9.0, ann=True), evt("k", cuda, 2.0, 3.0)])
    dev, host = traces.split_events(prof)
    assert dev == [("k", 2.0, 3.0)] and traces.window_of(host) == (0.0, 10.0)
