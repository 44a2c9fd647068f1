"""Shared fixtures of the benchmark's tests: a throwaway checkout root
holding a copy of ``BENCHMARK.json`` and ``benchmark/``, with small cells
added by new files and entries only, for CPU rehearsals of a run."""

import json
import os
import shutil
import tempfile

import pytest

from benchmark import harness

#: a small clustered graph of the cells' kind (CPU-sized)
TINY_TRAFFIC = {"generator": "synthetic_dcsbm",
                "args": {"num_nodes": 1500, "avg_degree": 6.0, "mixing": 0.3, "seed": 3},
                "reorder": "cluster", "why": "CPU rehearsals"}
#: tiny cell -> the real cell whose configuration and limits it takes
TINY_CELLS = {"tiny.tband": "gcn6.gh", "tiny.wide": "gcn3.gh"}


def make_root(tmp: str, cells=TINY_CELLS, traffic=TINY_TRAFFIC) -> str:
    """A copy of the benchmark under ``tmp`` with ``cells`` (name -> the
    real cell whose configuration and limits it takes) on the traffic
    ``tiny``, added as new files and new entries of BENCHMARK.json;
    returns the root."""
    root = os.path.join(tmp, "root")
    shutil.copytree(harness.BENCH_DIR, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "traffic", "tiny.json"), "w") as f:
        json.dump(traffic, f)
    for name, real in cells.items():
        with open(os.path.join(bench, "workloads", f"{real}.json")) as f:
            real = json.load(f)
        conf = real["config"]
        spec["workloads"].append({"name": name, "config": conf, "traffic": "tiny", "chips": 1,
                                  "why": "CPU rehearsal"})
        with open(os.path.join(bench, "workloads", f"{name}.json"), "w") as f:
            json.dump({"config": conf, "traffic": "tiny", "limits": real["limits"]}, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


def rehearse(root: str, cell: str, seed: int = 5, seconds: float = 0.3, trace: bool = False):
    """One run of ``cell`` on the CPU from ``root``, the harness's look for
    a card skipped."""
    return harness.run_cell(cell, seed, seconds, trace, device_kind="cpu", root=root,
                            bench_dir=os.path.join(root, "benchmark"), log=lambda m: None)


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    # run_cell points the temp and cache directories into the root: undone here
    monkeypatch.setattr(tempfile, "tempdir", tempfile.tempdir)
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        monkeypatch.setenv(var, os.environ.get(var, ""))
    return make_root(str(tmp_path))
