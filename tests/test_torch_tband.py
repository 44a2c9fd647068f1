"""The port's transposed-band SpMM (hcspmm_tpu_torch/kernels/tband.py)
against the JAX package's Pallas kernels (interpret mode on the CPU) and a
scipy float64 oracle.

On the CPU the wrappers run their plain PyTorch versions; the CUDA kernel
they launch on a card is held against the same plain versions by
``test_cuda_kernel_matches_plain`` (marked ``cuda``) and by chip_smoke.py.
Tolerance: fp32 within 1e-5 of max|ref|, which only the order of the fp32
sums may use up.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hcspmm_tpu.config import PlanConfig as JaxPlanConfig
from hcspmm_tpu.format.plan import build_plan as jax_build_plan
from hcspmm_tpu.kernels import tband as jax_tband

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.graphs import io
from hcspmm_tpu_torch.kernels import tband
from hcspmm_tpu_torch.ops.spmm import HybridSpMM

from conftest import small_graph

RTOL = 1e-5


def rel_err(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


def band_inputs(dt, trash, sb=5, w=256, bh=128, m=1024, seed=0):
    """Random 0/1 A_t blocks, 128-aligned starts with st + W <= M, a
    permutation of the superwindows plus ``trash`` capacity-padded entries
    (sw == num_sw), and X^T, all as numpy."""
    rs = np.random.RandomState(seed)
    at = (rs.rand(sb + trash, w, bh) < 0.05).astype(np.int8)
    st = (rs.randint(0, (m - w) // 128 + 1, sb + trash) * 128).astype(np.int32)
    sw = np.concatenate([rs.permutation(sb), np.full(trash, sb)]).astype(np.int32)
    xt = rs.randn(dt, m).astype(np.float32)
    return sw, st, at, xt, sb


@pytest.mark.parametrize("trash", [0, 2])
@pytest.mark.parametrize("dt", [16, 32, 96])
def test_plain_direct_and_bucket_match_jax_kernels(dt, trash):
    sw, st, at, xt, num_sw = band_inputs(dt, trash, seed=dt + trash)
    want = np.asarray(jax_tband.tband_spmm_direct(
        jnp.asarray(sw), jnp.asarray(st), jnp.asarray(at), jnp.asarray(xt),
        num_sw, jnp.float32))
    t = [torch.from_numpy(v) for v in (sw, st, at, xt)]
    got = tband.tband_spmm_direct(*t, num_sw, torch.float32)
    assert got.shape == want.shape == (dt, num_sw * at.shape[2])
    assert rel_err(got, want) < RTOL
    want_b = np.asarray(jax_tband.tband_spmm_bucket(
        jnp.asarray(st), jnp.asarray(at), jnp.asarray(xt)))
    got_b = tband.tband_spmm_bucket(t[1], t[2], t[3])
    assert got_b.dtype == torch.float32 and got_b.shape == want_b.shape
    assert rel_err(got_b, want_b) < RTOL


def banded_graph(n, deg, near, far, seed=0):
    """Symmetric banded graph: rows of the first half reach +-near, of
    the second +-far; at band widths (128, 384) its tband plan fills two
    buckets and covers every superwindow (chip_smoke.py uses the same)."""
    rs = np.random.RandomState(seed)
    src = np.repeat(np.arange(n), deg)
    half = np.where(src < n // 2, near, far)
    dst = np.clip(src + rs.randint(0, 1 << 20, src.size) % (2 * half + 1) - half, 0, n - 1)
    s = np.concatenate([src, dst]).astype(np.int32)
    d = np.concatenate([dst, src]).astype(np.int32)
    return (*io.to_csr(s, d, n), n)


PLANS = {
    "single_bucket": (lambda: small_graph(300, 6),
                      dict(impl="pallas", band_impl="tband", band_h=128,
                           band_mode="always")),
    "two_buckets": (lambda: banded_graph(600, 4, 10, 100),
                    dict(impl="pallas", band_impl="tband", band_h=128,
                         band_widths=(128, 384), band_spill="never",
                         band_mode="always")),
}


@pytest.mark.parametrize("dt", [16, 32])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_spmm_tband_padded_matches_jax_and_scipy(name, dt):
    graph, fields = PLANS[name]
    rp, ci, n = graph()
    op = HybridSpMM(rp, ci, n, PlanConfig(**fields))
    plan = op.plan
    nonempty = [len(s) > 0 for s in plan.band_sw_ids]
    assert nonempty == ([True, True] if name == "two_buckets" else [True])
    m = plan.padded_rows
    xt = np.zeros((dt, m), np.float32)
    xt[:, :n] = np.random.RandomState(7).randn(dt, n)
    got = tband.spmm_tband_padded(op.arrays["f"], torch.from_numpy(xt), plan,
                                  torch.float32)
    jplan = jax_build_plan(rp, ci, n, JaxPlanConfig(**fields))
    jarrs = {k: jnp.asarray(v) for k, v in jplan.device_arrays().items()}
    want = np.asarray(jax_tband.spmm_tband_padded(jarrs, jnp.asarray(xt), jplan,
                                                  jnp.float32))
    assert got.shape == want.shape == (dt, m)
    assert rel_err(got, want) < RTOL
    a = sp.csr_matrix((np.ones(len(ci)), ci, rp), shape=(n, n))
    oracle = (a @ xt[:, :n].T.astype(np.float64)).T
    assert rel_err(got[:, :n], oracle) < RTOL
    assert not got[:, n:].any()  # padded lanes stay zero: the layout closes


def test_check_band_arrays_rejects_out_of_range_slices():
    st = np.array([0, 128], np.int32)
    sw = np.array([0, 1], np.int32)
    tband.check_band_arrays(st, sw, 256, 384, 2)
    with pytest.raises(ValueError):
        tband.check_band_arrays(st + 64, sw, 256, 1024, 2)   # not 128-aligned
    with pytest.raises(ValueError):
        tband.check_band_arrays(st, sw, 256, 256, 2)         # st + W > M
    with pytest.raises(ValueError):
        tband.check_band_arrays(st, sw + 2, 256, 384, 2)     # sw > num_sw


def test_wrapper_rejects_devices_it_has_no_kernel_for():
    sw, st, at, xt, num_sw = band_inputs(16, 0)
    t = [torch.from_numpy(v).to("meta") for v in (sw, st, at, xt)]
    with pytest.raises(ValueError):
        tband.tband_spmm_direct(*t, num_sw, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    sw, st, at, xt, num_sw = band_inputs(48, 2)
    t = [torch.from_numpy(v).cuda() for v in (sw, st, at, xt)]
    t[3] = t[3].to(dtype)
    before = tband.launches
    got = tband.tband_spmm_direct(*t, num_sw, dtype)
    got_b = tband.tband_spmm_bucket(t[1], t[2], t[3])
    torch.cuda.synchronize()
    assert tband.launches == before + 2
    ref = tband.tband_spmm_direct_plain(*t, num_sw, dtype)
    assert rel_err(got.float().cpu(), ref.float().cpu()) < tol
    assert rel_err(got_b.cpu(), tband.tband_spmm_bucket_plain(t[1], t[2], t[3]).cpu()) < tol
