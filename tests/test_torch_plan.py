"""hcspmm_tpu_torch carries its own NumPy host side (format/, graphs/,
config.py); these tests hold it to the JAX package's: the same CSR and
PlanConfig must give the same plan, array for array, and the reorderings
the same permutations.  The package's C++ host passes (native/) are copies
of the JAX package's, byte for byte."""

import dataclasses
import os

import numpy as np
import pytest

from hcspmm_tpu.config import PlanConfig as JaxPlanConfig
from hcspmm_tpu.format import reorder as jax_reorder
from hcspmm_tpu.format.plan import build_plan as jax_build_plan
from hcspmm_tpu.graphs import io as jax_io

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.format import reorder
from hcspmm_tpu_torch.format.plan import ExecutionPlan, build_plan

from conftest import small_graph

_TBAND = dict(impl="pallas", band_impl="tband", band_h=128)
_TINY_CAPS = dict(band_widths=(128,), band_mode="auto", ts_table_mb=1e-3,
                  ts_span=256, ts_k=32, ts2_table_mb=48 * 64 / 1e6)

# (graph, PlanConfig fields): the populations and stream layouts each exercises
CASES = {
    "tband_band_only": ((300, 6, 16), dict(_TBAND, band_mode="always")),
    "tband_pack2": ((300, 6, 16), dict(_TBAND, band_mode="always", tband_pack=2)),
    "tband_pack8": ((300, 6, 16), dict(_TBAND, band_mode="always", tband_pack=8)),
    "tband_spill_segmented": ((1400, 9, 1300), dict(_TBAND, **_TINY_CAPS)),
    "tband_spill_hub": ((1400, 9, 1300), dict(
        _TBAND, **_TINY_CAPS, spill_hub_mb=64 * 64 / 1e6, spill_hub_min_cov=0.01,
        spill_hub_min_reuse=0.0)),
    "wide": ((300, 6, 16), dict()),
    "wide_ring": ((300, 6, 16), dict(band_impl="ring")),
    "wide_int4": ((300, 6, 16), dict(a_dtype="int4")),
    "wide_spill": ((500, 8, 400), dict(band_widths=(128,), band_mode="auto")),
    "rows_no_band": ((300, 6, 16), dict(band_mode="never")),
}


def assert_same(a, b, path):
    """Recursive equality of plan values: arrays by dtype and content."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            assert_same(u, v, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_equals_jax_plan(case):
    (n, deg, span), fields = CASES[case]
    rp, ci, nn = small_graph(n, deg, span=span)
    want = jax_build_plan(rp, ci, nn, JaxPlanConfig(**fields))
    got = build_plan(rp, ci, nn, PlanConfig(**fields))
    assert isinstance(got, ExecutionPlan)
    if case.startswith("tband_spill"):
        assert got.spill_nnz > 0 and got.ts_lo is not None
    if case == "tband_spill_hub":
        assert got.hub_lo is not None
    for f in dataclasses.fields(want):
        assert_same(getattr(got, f.name), getattr(want, f.name), f.name)
    for prop in ("has_spill", "padded_rows", "band_padded_ok", "num_band_supers"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert_same(got.device_arrays(), want.device_arrays(), "device_arrays")
    for s in range(len(want.band_widths)):
        assert_same(got.band_at_dense(s), want.band_at_dense(s), f"band_at_dense({s})")


@pytest.mark.parametrize("pack", [1, 2, 8])
def test_band_at_stored_is_the_uploaded_encoding(pack):
    """``ExecutionPlan.band_at_stored`` is the one rule for how ``band{s}_at``
    is stored: it equals the JAX plan's ``device_arrays()`` entry, the
    port's ``device_arrays()`` and the operator's upload (``_to_device``)
    both hold it, and it expands back to ``band_at_dense``."""
    import torch

    from hcspmm_tpu_torch.kernels.tband import expand_at
    from hcspmm_tpu_torch.ops.spmm import _to_device

    fields = dict(_TBAND, band_mode="always", tband_pack=pack)
    rp, ci, nn = small_graph(300, 6, span=16)
    got = build_plan(rp, ci, nn, PlanConfig(**fields))
    want = jax_build_plan(rp, ci, nn, JaxPlanConfig(**fields)).device_arrays()
    host, dev = got.device_arrays(), _to_device(got, "cpu")
    assert len(got.band_widths)
    for s in range(len(got.band_widths)):
        stored = got.band_at_stored(s)
        assert stored.dtype == (np.int8 if pack == 1 else np.uint8)
        assert_same(stored, want[f"band{s}_at"], f"band_at_stored({s})")
        assert_same(host[f"band{s}_at"], stored, f"device_arrays band{s}_at")
        assert np.array_equal(dev[f"band{s}_at"].numpy(), stored)
        assert np.array_equal(expand_at(torch.from_numpy(stored), pack).numpy(),
                              got.band_at_dense(s))


@pytest.mark.parametrize("mode", ["rcm", "loa", "cluster"])
def test_reorder_equals_jax_reorder(mode):
    src, dst, n = jax_io.synthetic_blocks(600, 6, 40, seed=3)
    rp, ci = jax_io.to_csr(src, dst, n)
    name = f"{mode}_reorder"
    want = getattr(jax_reorder, name)(rp, ci, n)
    got = getattr(reorder, name)(rp, ci, n)
    assert np.array_equal(got, want)
    assert_same(reorder.apply_permutation(rp, ci, n, got),
                jax_reorder.apply_permutation(rp, ci, n, want), "permuted csr")


@pytest.mark.parametrize("name", ["preprocess.cpp", "loa.cpp", "cluster.cpp"])
def test_native_sources_equal_jax_packages(name):
    """hcspmm_tpu_torch/native keeps its own copy of each C++ pass; a change
    to one package's copy must reach the other's."""
    import hcspmm_tpu
    import hcspmm_tpu_torch

    def read(pkg):
        with open(os.path.join(os.path.dirname(pkg.__file__), "native", name), "rb") as f:
            return f.read()

    assert read(hcspmm_tpu_torch) == read(hcspmm_tpu)
