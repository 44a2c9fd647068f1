"""hcspmm_tpu_torch/parallel/partition.py is a carried copy of the JAX
package's row-block partitioner; these tests hold it to the original: the
same CSR, shard count, PlanConfig and mode must give the same sharded plan,
array for array (the stacked arrays, the exchange tables and every shard's
plan)."""

import dataclasses

import numpy as np
import pytest

from hcspmm_tpu.config import PlanConfig as JaxPlanConfig
from hcspmm_tpu.format import reorder as jax_reorder
from hcspmm_tpu.graphs import io as jax_io
from hcspmm_tpu.parallel.partition import build_sharded_plan as jax_build_sharded_plan
from hcspmm_tpu.parallel.partition import pad_rows as jax_pad_rows

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.format.plan import build_plan
from hcspmm_tpu_torch.parallel.dist_spmm import shard_config
from hcspmm_tpu_torch.parallel.partition import ShardedPlan, build_sharded_plan, pad_rows

from conftest import small_graph
from test_torch_plan import assert_same

_BAND = dict(band_mode="always", band_h=64, band_widths=(128, 256), impl="pallas")


def blocks_rcm(n=1024, far=0):
    """Blocks of 64 nodes in rcm order, then ``far`` long-range edges (each
    node to the one half the graph away, both ways)."""
    src, dst, nn = jax_io.synthetic_blocks(n, 6, block_size=64, seed=5)
    rp, ci = jax_io.to_csr(src, dst, nn)
    perm = jax_reorder.rcm_reorder(rp, ci, nn)
    rp, ci = jax_reorder.apply_permutation(rp, ci, nn, perm)
    if far:
        fs = np.random.RandomState(3).randint(0, nn, far)
        fd = (fs + nn // 2) % nn
        src = np.concatenate([np.repeat(np.arange(nn), np.diff(rp)), fs, fd])
        rp, ci = jax_io.to_csr(src, np.concatenate([ci, fd, fs]), nn)
    return rp, ci, nn


# name: (graph, PlanConfig fields, mode)
CASES = {
    "allgather": (lambda: blocks_rcm(), _BAND, "allgather"),
    "allgather_rows": (lambda: small_graph(300, 6), dict(
        band_spill="never", band_h=64, band_widths=(128,), loi_mode="calibrated"), "allgather"),
    "halo": (lambda: small_graph(300, 6, span=40), dict(impl="pallas"), "halo"),
    "band_halo": (lambda: blocks_rcm(), _BAND, "band_halo"),
    "band_halo_far": (lambda: blocks_rcm(far=64), _BAND, "band_halo"),
    "uneven_halo": (lambda: small_graph(488, 4, span=488), dict(impl="pallas"), "halo"),
    "uneven_allgather": (lambda: small_graph(488, 4, span=488), {}, "allgather"),
}


def assert_same_sharded(got, want):
    assert isinstance(got, ShardedPlan)
    for f in dataclasses.fields(want):
        if f.name != "plans":
            assert_same(getattr(got, f.name), getattr(want, f.name), f.name)
    assert got.nnz == want.nnz
    assert len(got.plans) == len(want.plans)
    for i, (p, q) in enumerate(zip(got.plans, want.plans)):
        for f in dataclasses.fields(q):
            assert_same(getattr(p, f.name), getattr(q, f.name), f"plans[{i}].{f.name}")
        assert_same(p.device_arrays(), q.device_arrays(), f"plans[{i}].device_arrays")


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_plan_equals_jax(case, shards):
    graph, fields, mode = CASES[case]
    rp, ci, nn = graph()
    want = jax_build_sharded_plan(rp, ci, nn, shards, JaxPlanConfig(**fields), mode=mode)
    got = build_sharded_plan(rp, ci, nn, shards, PlanConfig(**fields), mode=mode)
    if case == "band_halo_far":
        assert got.far_pair > 0 and got.num_spill_rows > 0
    if case.startswith("uneven"):
        assert got.n_padded > nn
    assert_same_sharded(got, want)


@pytest.mark.parametrize("shards", [2, 4])
def test_band_spill_never_raises_as_jax(shards):
    src, dst, nn = jax_io.synthetic_graph(2048, 6, seed=0, span=2000)
    rp, ci = jax_io.to_csr(src, dst, nn)
    fields = dict(band_widths=(128,), band_h=64, band_spill="never")
    with pytest.raises(ValueError, match="halo window") as want:
        jax_build_sharded_plan(rp, ci, nn, shards, JaxPlanConfig(**fields), mode="band_halo")
    with pytest.raises(ValueError, match="halo window") as got:
        build_sharded_plan(rp, ci, nn, shards, PlanConfig(**fields), mode="band_halo")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fields", [{}, dict(band_impl="tband"), dict(loi_mode="calibrated"),
                                    _BAND], ids=["auto", "tband", "calibrated", "band"])
@pytest.mark.parametrize("mode", ["allgather", "halo"])
def test_shard_config_is_the_partitioners(mode, fields):
    """``dist_spmm.shard_config`` (the single-process yardstick's config)
    is the rewrite ``build_sharded_plan`` applies: at one shard the shard
    plan equals the single-process plan built with it."""
    rp, ci, nn = blocks_rcm()
    cfg = PlanConfig(**fields)
    got = build_sharded_plan(rp, ci, nn, 1, cfg, mode=mode).plans[0]
    want = build_plan(rp, ci, nn, shard_config(cfg, mode))
    for f in dataclasses.fields(want):
        assert_same(getattr(got, f.name), getattr(want, f.name), f.name)
    assert_same(got.device_arrays(), want.device_arrays(), "device_arrays")


@pytest.mark.parametrize("rows", [7, 16])
def test_pad_rows_equals_jax(rows):
    x = np.random.RandomState(0).randn(rows, 3).astype(np.float32)
    for n_padded in (16, 32):
        assert_same(pad_rows(x, n_padded), jax_pad_rows(x, n_padded), "pad_rows")


def test_partition_source_is_the_reference_with_port_imports():
    """The carried module differs from the JAX package's only in the
    package its imports name."""
    import hcspmm_tpu.parallel.partition as jax_partition

    import hcspmm_tpu_torch.parallel.partition as port_partition

    with open(jax_partition.__file__) as f:
        want = f.read().replace("from hcspmm_tpu.", "from hcspmm_tpu_torch.")
    with open(port_partition.__file__) as f:
        assert f.read() == want
