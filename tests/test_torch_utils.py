"""The port's profiling helpers (hcspmm_tpu_torch/utils/profiling.py) and
real graphs (hcspmm_tpu_torch/graphs/real.py, ``GraphDataset.real``), held
against the JAX package's real graphs and the committed edge files."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from hcspmm_tpu.graphs.dataset import GraphDataset as JaxGraphDataset

from hcspmm_tpu_torch.graphs import real
from hcspmm_tpu_torch.graphs.dataset import GraphDataset
from hcspmm_tpu_torch.train import cli
from hcspmm_tpu_torch.utils import profiling

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


@pytest.mark.parametrize("name", ["karate", "lesmis", "digits-knn", "digits-knn:4"])
def test_real_graph_equals_jax(name):
    got = GraphDataset.real(name, 8, 3, seed=2)
    want = JaxGraphDataset.real(name, 8, 3, seed=2)
    assert got.num_nodes == want.num_nodes and got.num_edges == want.num_edges
    for f in ("row_pointers", "column_index", "x", "y"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    if name.startswith("digits"):
        assert got.x.shape == (1797, 64) and sorted(set(got.y.tolist())) == list(range(10))


@pytest.mark.parametrize("name", ["karate", "lesmis"])
def test_real_graph_equals_committed_file(name):
    """data/{name}_A.txt holds the networkx graph in the reference's text
    format (written by ``write_reference_txt``)."""
    got = GraphDataset.real(name, 8, 3)
    want = GraphDataset.from_txt(os.path.join(DATA, f"{name}_A.txt"), 8, 3)
    assert np.array_equal(got.row_pointers, want.row_pointers)
    assert np.array_equal(got.column_index, want.column_index)


def test_real_graph_names_the_missing_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "networkx", None)
    with pytest.raises(ImportError, match="'networkx'"):
        GraphDataset.real("karate", 8, 3)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    with pytest.raises(ImportError, match="'sklearn'"):
        GraphDataset.real("digits-knn", 8, 3)
    with pytest.raises(ValueError, match="unknown real graph"):
        real.networkx_edges("cora")


def test_write_reference_txt_round_trips(tmp_path):
    src, dst, n = real.networkx_edges("florentine")
    path = str(tmp_path / "g.txt")
    real.write_reference_txt(path, src, dst)
    ds = GraphDataset.from_txt(path, 4, 2)
    assert ds.num_nodes == n and ds.nnz == len(src)


def test_cli_trains_on_a_real_graph(capsys):
    assert cli.main(["--dataset", "karate", "--dim", "8", "--hidden", "8", "--classes", "2",
                     "--num_layers", "2", "--epochs", "2", "--device", "cpu"]) == 0
    recs = [json.loads(v) for v in capsys.readouterr().out.splitlines() if v.startswith("{")]
    prep = next(r for r in recs if r.get("event") == "preprocess")
    done = next(r for r in recs if r.get("event") == "done")
    assert prep["num_nodes"] == 34 and np.isfinite(done["final_loss"])


def test_roofline_names_the_bound():
    # 3.35 GB at 3.35 TB/s takes 1 ms; 67 GFLOP at 67 TFLOP/s takes 1 ms
    mem = profiling.roofline(2e-3, 3.35e9, 6.7e9)
    assert mem["bound"] == "memory"
    assert mem["speed_of_light_s"] == pytest.approx(1e-3)
    assert mem["hbm_efficiency"] == pytest.approx(0.5)
    ops = profiling.roofline(4e-3, 3.35e8, 6.7e10, nnz=10 ** 6)
    assert ops["bound"] == "compute" and ops["flops_efficiency"] == pytest.approx(0.25)
    assert ops["gnnz_per_s"] == pytest.approx(0.25)
    bf16 = profiling.roofline(1e-3, 0.0, 9.89e11, peak_tflops=profiling.H100_BF16_TFLOPS)
    assert bf16["speed_of_light_s"] == pytest.approx(1e-3)


def test_timer_time_fn_and_trace(tmp_path):
    """Spans and counters record only inside ``tracing()``; ``time_fn``
    averages calls; ``trace`` writes a Chrome trace with the program's spans
    on, each a host range beside the operations."""
    profiling.reset()
    with profiling.span("off"):
        profiling.count("n")
    with profiling.tracing():
        with profiling.span("a"):
            torch.ones(8).sum()
        with profiling.span("a"):
            profiling.count("n", 2)
    recs = [r for r in profiling.spans() if r["name"] != profiling.CLOCK]
    assert [r["name"] for r in recs] == ["a", "a"] and profiling.counters() == {"n": 2}
    assert all(r["end_ns"] >= r["start_ns"] for r in recs)
    calls = []
    assert profiling.time_fn(lambda v: calls.append(v), 1, rounds=3, warmup=2) > 0
    assert calls == [1] * 5
    path = str(tmp_path / "trace.json")
    with profiling.trace(path):
        with profiling.span("b"):
            torch.ones(64).cumsum(0)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"b", profiling.CLOCK} <= names
    profiling.reset()


def test_profiler_age_needs_a_card(monkeypatch):
    """``utils/profiler_age.py`` counts the card's kernel records: it
    refuses to run without a card rather than report a host run."""
    from hcspmm_tpu_torch.utils import profiler_age

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        profiler_age.main(["--probes", "1"])


def test_device_time_refuses_a_cpu_run():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: device_time measures it")
    with pytest.raises(RuntimeError, match="no device time without a CUDA card"):
        profiling.device_time(lambda: torch.ones(8).sum(), iters=2)
