"""The benchmark's frozen generators give, array for array, what the
port's ``graphs/io.py`` gives: at a small scale and at the cells' own
parameters."""

import json
import os

import numpy as np
import pytest

from benchmark import graphs
from benchmark.graphs import generators
from hcspmm_tpu_torch.graphs import io

TRAFFIC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "traffic")


def _same(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        if isinstance(u, np.ndarray):
            assert u.dtype == v.dtype and np.array_equal(u, v)
        else:
            assert u == v


@pytest.mark.parametrize("key", ["GH", "YS", "DD", "ARXIV"])
def test_standin_equal_small(key):
    _same(generators.reference_standin(key, seed=3, scale=0.01),
          io.reference_standin(key, seed=3, scale=0.01))
    _same(generators.reference_standin(key, seed=3, scale=0.01, kind="chunglu"),
          io.reference_standin(key, seed=3, scale=0.01, kind="chunglu"))


def test_generators_equal_small():
    _same(generators.synthetic_blocks(3000, 5.0, 300, seed=7),
          io.synthetic_blocks(3000, 5.0, 300, seed=7))
    _same(generators.synthetic_dcsbm(2000, 6.0, mixing=0.3, seed=3),
          io.synthetic_dcsbm(2000, 6.0, mixing=0.3, seed=3))
    _same(generators.synthetic_powerlaw(2000, 6.0, seed=3),
          io.synthetic_powerlaw(2000, 6.0, seed=3))
    src, dst, n = io.synthetic_dcsbm(2000, 6.0, seed=4)
    _same(generators.to_csr(src, dst, n), io.to_csr(src, dst, n))


@pytest.mark.parametrize("traffic", sorted(f[:-5] for f in os.listdir(TRAFFIC)))
def test_cell_graphs_equal(traffic):
    """Each traffic file's graph at full size, through the benchmark's
    loader, against the port's generator and CSR builder."""
    with open(os.path.join(TRAFFIC, f"{traffic}.json")) as f:
        spec = json.load(f)
    assert spec["generator"] == "reference_standin"
    rp, ci, n = graphs.build_csr(spec)
    src, dst, n_io, _ = io.reference_standin(**spec["args"])
    rp_io, ci_io = io.to_csr(src, dst, n_io)
    assert n == n_io
    _same((rp, ci), (rp_io, ci_io))


def test_cache_round_trip(tmp_path):
    spec = {"generator": "synthetic_dcsbm", "args": {"num_nodes": 800, "avg_degree": 5.0,
                                                     "seed": 2}}
    first = graphs.load_csr(spec, str(tmp_path))
    assert len(os.listdir(tmp_path)) == 1
    _same(first, graphs.load_csr(spec, str(tmp_path)))
    _same(first, graphs.build_csr(spec))
