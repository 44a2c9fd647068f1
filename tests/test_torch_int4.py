"""int4 band blocks (``PlanConfig(a_dtype='int4')``) in the port against the
JAX package on the CPU.

The JAX package stores the wide layout's band blocks ``band{s}_a`` and the
tiled pairs' ``tp_a`` as ``jnp.int4``; the port stores them as nibbles,
uint8 [.., Bb/2] with column 2j in the low nibble of byte j and 2j + 1 in
the high one (``format/streams.py:pack_a_int4``), and csrc/block_spmm.cu
reads them as stored.  Here: the packer against ``astype(jnp.int4)``; each
band kernel's plain version fed nibbles against the Pallas kernel fed int4
A in interpret mode and against the same plain version fed int8; the
operator at int4 against the JAX operator at int4, the port at int8 and the
dense oracle on wide, spilling, two-bucket, tiled, row-layout and
``impl='xla'`` plans; gradients; the fused layer cores; three Adam steps.

Tolerance: fp32 within 1e-5 of max|ref| (the order of fp32 sums only), bf16
within 1e-2 (one rounding of fp32 sums); the port at int4 equals the port at
int8 bit for bit (the same 0/1 values summed in the same order).  The tests
marked ``cuda`` hold the kernels' PACK 2 launches against their plain
versions and their PACK 1 launches; they skip without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hcspmm_tpu.config import PlanConfig as JaxPlanConfig
from hcspmm_tpu.kernels import block_spmm as jax_block_spmm
from hcspmm_tpu.models.net import Net as JaxNet
from hcspmm_tpu.models.net import init_net_params as jax_init_net_params
from hcspmm_tpu.ops.spmm import HybridSpMM as JaxHybridSpMM
from hcspmm_tpu.ops.spmm import make_fused_ops as jax_make_fused_ops
from hcspmm_tpu.train.loop import make_train_step as jax_make_train_step

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.format import reorder
from hcspmm_tpu_torch.format.streams import pack_a_int4, unpack_a_int4
from hcspmm_tpu_torch.graphs import io
from hcspmm_tpu_torch.kernels import block_spmm
from hcspmm_tpu_torch.models.net import Net, params_from_jax
from hcspmm_tpu_torch.ops.spmm import HybridSpMM, _to_device, spmm_reference_dense
from hcspmm_tpu_torch.train.loop import make_train_step

from conftest import small_graph
from torch_params import assert_params_match_jax

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def to_np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def rel_err(got, ref):
    got, ref = (np.asarray(to_np(v), dtype=np.float64) for v in (got, ref))
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


def jx(x, dtype):
    return jnp.asarray(x).astype(JDT[dtype])


def int4(a):
    """``a`` as the JAX package's int4 device array."""
    return jnp.asarray(a).astype(jnp.int4)


def nibbles(a):
    return torch.from_numpy(pack_a_int4(a))


# ---------------------------------------------------------------------------
# the encoding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,lo,hi", [((3, 8, 16), 0, 2), ((2, 5, 128), -8, 8),
                                         ((1, 1, 2), -8, 8)])
def test_pack_a_int4_round_trips_and_matches_jnp_int4(shape, lo, hi):
    """Packing and unpacking give the blocks back; the values are those of
    ``astype(jnp.int4)``; byte j holds column 2j low and 2j + 1 high; the
    torch unpacker (``expand_a``) agrees with the NumPy one."""
    a = np.random.RandomState(shape[-1]).randint(lo, hi, shape).astype(np.int8)
    p = pack_a_int4(a)
    assert p.dtype == np.uint8 and p.shape == shape[:-1] + (shape[-1] // 2,)
    np.testing.assert_array_equal(unpack_a_int4(p), a)
    np.testing.assert_array_equal(np.asarray(int4(a)).astype(np.int8), unpack_a_int4(p))
    np.testing.assert_array_equal(p & 15, a[..., 0::2].astype(np.uint8) & 15)
    np.testing.assert_array_equal(p >> 4, a[..., 1::2].astype(np.uint8) & 15)
    got = block_spmm.expand_a(torch.from_numpy(p))
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), a)
    t8 = torch.from_numpy(a)
    assert block_spmm.expand_a(t8) is t8
    with pytest.raises(ValueError, match="even"):
        pack_a_int4(np.zeros((1, 3), np.int8))


def test_a_pack_names_the_stored_form_and_refuses_others():
    assert block_spmm.a_pack(torch.zeros((2, 4, 8), dtype=torch.int8)) == 1
    assert block_spmm.a_pack(torch.zeros((2, 4, 4), dtype=torch.uint8)) == 2
    for bad in (torch.zeros((2, 4, 8), dtype=torch.int32), torch.zeros((4, 8), dtype=torch.int8)):
        with pytest.raises(ValueError, match="int4 nibbles"):
            block_spmm.a_pack(bad)


@pytest.mark.parametrize("cfg", [dict(), dict(band_impl="tiled", band_h=128, band_mode="always",
                                              band_widths=(512,))])
def test_stored_blocks_are_the_uploaded_encoding(cfg):
    """``band_a_stored`` / ``tiled_a_stored`` are the one rule for how A is
    stored: nibbles at int4 that expand to the dense int8 blocks, equal to
    the JAX package's int4 device arrays, and what ``_to_device`` uploads;
    int8 at the default, and ``device_arrays`` keeps int8 either way."""
    rp, ci, nn = blocks_graph() if cfg else small_graph(300, 6)
    op = HybridSpMM(rp, ci, nn, PlanConfig(a_dtype="int4", **cfg), device="cpu")
    jop = JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(a_dtype="int4", **cfg))
    p, dev = op.plan, _to_device(op.plan, "cpu")
    assert p.a_dtype == "int4"
    stored = ([("tp_a", p.tiled_a_stored(), p.tiled_a_dense())] if p.tiled else
              [(f"band{s}_a", p.band_a_stored(s), p.band_a_dense(s))
               for s in range(len(p.band_widths))])
    assert stored
    for key, st, dense in stored:
        assert st.dtype == np.uint8 and st.shape == dense.shape[:-1] + (dense.shape[-1] // 2,)
        np.testing.assert_array_equal(unpack_a_int4(st), dense)
        np.testing.assert_array_equal(dev[key].numpy(), st)
        assert jop.arrays["f"][key].dtype == jnp.int4
        np.testing.assert_array_equal(np.asarray(jop.arrays["f"][key]).astype(np.int8), dense)
        assert p.device_arrays()[key].dtype == np.int8
    p8 = HybridSpMM(rp, ci, nn, PlanConfig(**cfg), device="cpu").plan
    assert p8.a_dtype == "int8"
    assert (p8.tiled_a_stored() if p8.tiled else p8.band_a_stored(0)).dtype == np.int8


def test_tband_plans_and_unknown_a_dtypes():
    """A tband plan carries no band{s}_a (the JAX package casts none), so
    its a_dtype stays int8; an a_dtype that is neither raises."""
    rp, ci, nn = small_graph(300, 6)
    p = HybridSpMM(rp, ci, nn, PlanConfig(band_impl="tband", band_h=128, a_dtype="int4"),
                   device="cpu").plan
    assert p.tband and p.a_dtype == "int8"
    with pytest.raises(ValueError, match="a_dtype"):
        HybridSpMM(rp, ci, nn, PlanConfig(a_dtype="int2"), device="cpu")


# ---------------------------------------------------------------------------
# the plain versions fed nibbles against the Pallas kernels fed int4
# ---------------------------------------------------------------------------


def band_inputs(seed, sb=7, bh=64, bb=128, dp=128, m=512, trash=2):
    rng = np.random.RandomState(seed)
    a = (rng.rand(sb, bh, bb) < 0.08).astype(np.int8)
    st = (rng.randint(0, (m - bb) // 16 + 1, sb) * 16).astype(np.int32)
    sw = np.concatenate([rng.permutation(sb - trash), np.full(trash, sb - trash)]).astype(np.int32)
    x = rng.randn(m, dp).astype(np.float32)
    return a, st, sw, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bb,dp", [(128, 128), (256, 256)])
def test_band_direct_and_bucket_modes_match_jax_int4(bb, dp, dtype):
    """#14 (direct) and #12 (bucket order)."""
    a, st, sw, x = band_inputs(bb + dp, bb=bb, dp=dp)
    num_sw = len(sw) - 2
    xv = torch.from_numpy(x).to(dtype)
    args = (torch.from_numpy(sw), torch.from_numpy(st))
    got = block_spmm.band_bucket_spmm_direct(*args, nibbles(a), xv, num_sw, dtype)
    want = jax_block_spmm.band_bucket_spmm_direct(jnp.asarray(sw), jnp.asarray(st), int4(a),
                                                  jx(x, dtype), num_sw, JDT[dtype], trash=True)
    assert got.shape == want.shape and got.dtype == dtype
    assert rel_err(got, want.astype(jnp.float32)) < TOL[dtype]
    assert torch.equal(got, block_spmm.band_bucket_spmm_direct(*args, torch.from_numpy(a), xv,
                                                               num_sw, dtype))
    got = block_spmm.band_bucket_spmm(args[1], nibbles(a), xv)
    want = jax_block_spmm.band_bucket_spmm(jnp.asarray(st), int4(a), jx(x, dtype))
    assert got.dtype == torch.float32 and rel_err(got, want) < TOL[dtype]
    assert torch.equal(got, block_spmm.band_bucket_spmm(args[1], torch.from_numpy(a), xv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_grouped_matches_jax_int4(dtype):
    """#13, G 4."""
    a, st, _, x = band_inputs(3, sb=16, bb=256, m=1024)
    xv = torch.from_numpy(x).to(dtype)
    got = block_spmm.band_bucket_spmm_grouped(torch.from_numpy(st), nibbles(a), xv, 13, dtype, 4)
    want = jax_block_spmm.band_bucket_spmm_grouped(jnp.asarray(st), int4(a), jx(x, dtype), 13,
                                                   JDT[dtype], group=4)
    assert got.shape == want.shape == (13, 64, 128)
    assert rel_err(got, want.astype(jnp.float32)) < TOL[dtype]
    assert torch.equal(got, block_spmm.band_bucket_spmm_grouped(
        torch.from_numpy(st), torch.from_numpy(a), xv, 13, dtype, 4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dp,hp", [(128, 256), (256, 128)])
def test_band_fused_matches_jax_int4(dp, hp, dtype):
    """#16: the aggregate and the update."""
    a, st, sw, x = band_inputs(dp + hp, bb=256, dp=dp, m=1024)
    w = np.random.RandomState(hp).randn(dp, hp).astype(np.float32)
    num_sw = len(sw) - 2
    xv, wv = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    args = (torch.from_numpy(sw), torch.from_numpy(st))
    agg, out = block_spmm.band_fused_spmm_direct(*args, nibbles(a), xv, wv, num_sw, dtype)
    jagg, jout = jax_block_spmm.band_fused_spmm_direct(
        jnp.asarray(sw), jnp.asarray(st), int4(a), jx(x, dtype), jx(w, dtype), num_sw, JDT[dtype])
    assert rel_err(agg, jagg[:num_sw].astype(jnp.float32)) < TOL[dtype]
    assert rel_err(out, jout[:num_sw].astype(jnp.float32)) < TOL[dtype]
    agg8, out8 = block_spmm.band_fused_spmm_direct(*args, torch.from_numpy(a), xv, wv, num_sw,
                                                   dtype)
    assert torch.equal(agg, agg8) and torch.equal(out, out8)


def blocks_graph():
    """tests/test_pallas_kernels.py:201's graph (rcm order)."""
    src, dst, nn = io.synthetic_blocks(512, 4, 48, seed=5)
    rp, ci = io.to_csr(src, dst, nn)
    return (*reorder.apply_permutation(rp, ci, nn, reorder.rcm_reorder(rp, ci, nn)), nn)


TILED = dict(band_impl="tiled", band_h=128, band_mode="always", band_widths=(512,),
             band_tile_slots=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_tiled_matches_jax_int4(dtype):
    """#15 on a tiled plan's pair stream, tp_a as nibbles."""
    rp, ci, nn = blocks_graph()
    op = HybridSpMM(rp, ci, nn, PlanConfig(a_dtype="int4", **TILED), device="cpu")
    jop = JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(a_dtype="int4", **TILED))
    assert op.plan.tiled and op.arrays["f"]["tp_a"].shape[2] == 64
    m = op.plan.padded_rows
    x = np.random.RandomState(1).randn(m, 128).astype(np.float32)
    x[nn:] = 0
    xv = torch.from_numpy(x).to(dtype)
    got = block_spmm.band_tiled_spmm(op.arrays["f"], xv, op.plan, dtype)
    want = jax_block_spmm.band_tiled_spmm(jop.arrays["f"], jx(x, dtype), jop.plan, JDT[dtype])
    assert got.shape == want.shape and rel_err(got, want.astype(jnp.float32)) < TOL[dtype]
    arrs8 = dict(op.arrays["f"], tp_a=torch.from_numpy(op.plan.tiled_a_dense()))
    assert torch.equal(got, block_spmm.band_tiled_spmm(arrs8, xv, op.plan, dtype))


# ---------------------------------------------------------------------------
# the operator at int4
# ---------------------------------------------------------------------------


def spill_graph(n=4096, e=1024, seed=5120):
    """Random edges: superwindows with no band entry (zeroed) and spill."""
    rs = np.random.RandomState(seed)
    src, dst = rs.randint(0, n, e), rs.randint(0, n, e)
    rp, ci = io.to_csr(np.concatenate([src, dst]).astype(np.int32),
                       np.concatenate([dst, src]).astype(np.int32), n)
    return rp, ci, n


PLANS = {
    # name: (graph, PlanConfig fields, runs the wide padded path)
    "wide": (lambda: small_graph(300, 6), dict(), True),
    "wide_spill": (spill_graph, dict(band_h=128, band_widths=(128,), band_mode="auto"), True),
    "two_bucket": (lambda: small_graph(300, 6), dict(band_h=64, band_widths=(128, 256),
                                                     band_mode="always"), True),
    "tiled": (blocks_graph, TILED, True),
    "rows_mixed": (lambda: small_graph(300, 6), dict(band_spill="never", band_h=64,
                                                     band_widths=(128,),
                                                     loi_mode="calibrated"), False),
    "xla": (lambda: small_graph(300, 6), dict(impl="xla"), False),
}


def ops_at(name, a_dtype="int4", cd="float32", symmetric=True):
    graph, cfg, _ = PLANS[name]
    rp, ci, nn = graph()
    fields = dict(cfg, a_dtype=a_dtype, compute_dtype=cd)
    return (HybridSpMM(rp, ci, nn, PlanConfig(**fields), device="cpu", symmetric=symmetric),
            JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(**fields), symmetric=symmetric),
            spmm_reference_dense(rp, ci, nn, np.eye(nn)))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_operator_at_int4_matches_jax_int8_and_oracle(name):
    """Forward in the row layout (and the padded layout where the plan has
    it) against the JAX operator at int4, the port at int8 (bit for bit)
    and the dense oracle."""
    op, jop, a = ops_at(name)
    op8 = ops_at(name, "int8")[0]
    padded = PLANS[name][2]
    p = op.plan
    assert op.supports_padded == jop.supports_padded == padded
    if name == "rows_mixed":
        assert p.band_nnz and p.dense_nnz and p.sparse_nnz
    if name == "wide_spill":
        assert p.spill_nnz and len(p.band_missing_sw)
    if name == "two_bucket":
        assert [len(s) > 0 for s in p.band_sw_ids] == [True, True]
    keys = ["tp_a"] if p.tiled else [f"band{s}_a" for s in range(len(p.band_widths))]
    assert all(op.arrays["f"][k].dtype == torch.uint8 for k in keys)
    x = np.random.RandomState(2).randn(a.shape[0], 40).astype(np.float32)
    got = op(torch.from_numpy(x))
    assert torch.equal(got, op8(torch.from_numpy(x)))
    assert rel_err(got, jax.jit(jop.apply)(jop.arrays, jnp.asarray(x))) < TOL[torch.float32]
    assert rel_err(got, a @ x) < TOL[torch.float32]
    if padded:
        out = op.unpad_output(op.apply_padded(op.arrays, op.pad_input(x)), 40)
        out8 = op8.unpad_output(op8.apply_padded(op8.arrays, op8.pad_input(x)), 40)
        want = jop.unpad_output(jax.jit(jop.apply_padded)(jop.arrays, jop.pad_input(
            jnp.asarray(x))), 40)
        assert torch.equal(out, out8)
        assert rel_err(out, want) < TOL[torch.float32] and rel_err(out, a @ x) < TOL[torch.float32]


@pytest.mark.parametrize("name", ["wide", "tiled"])
def test_operator_at_int4_in_bf16(name):
    op, jop, a = ops_at(name, cd="bfloat16")
    x = np.random.RandomState(3).randn(a.shape[0], 24).astype(np.float32)
    got = op.unpad_output(op.apply_padded(op.arrays, op.pad_input(x)), 24, torch.float32)
    want = jop.unpad_output(jax.jit(jop.apply_padded)(jop.arrays, jop.pad_input(
        jnp.asarray(x))), 24).astype(jnp.float32)
    assert rel_err(got, want) < TOL[torch.bfloat16]
    assert rel_err(got, a @ x) < TOL[torch.bfloat16]


@pytest.mark.parametrize("symmetric", [True, False])
def test_gradients_at_int4_match_jax_and_oracle(symmetric):
    """d/dX of sum(A X * cot) in the padded layout: the symmetric plan
    reused, or the directed graph's plan over A^T."""
    if symmetric:
        rp, ci, nn = small_graph(300, 6)
    else:
        rp, ci, nn = small_graph(300, 6, symmetric=False)
    cfg = dict(a_dtype="int4")
    op = HybridSpMM(rp, ci, nn, PlanConfig(**cfg), device="cpu", symmetric=symmetric)
    jop = JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(**cfg), symmetric=symmetric)
    rs = np.random.RandomState(5)
    x = rs.randn(nn, 16).astype(np.float32)
    cot = rs.randn(nn, 16).astype(np.float32)
    xv = torch.from_numpy(x).requires_grad_(True)
    out = op.unpad_output(op.apply_padded(op.arrays, op.pad_input(xv)), 16)
    (out * torch.from_numpy(cot)).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jop.unpad_output(jop.apply_padded(
        jop.arrays, jop.pad_input(v)), 16) * cot))(jnp.asarray(x))
    a = spmm_reference_dense(rp, ci, nn, np.eye(nn))
    assert rel_err(xv.grad, want) < TOL[torch.float32]
    assert rel_err(xv.grad, a.T @ cot) < TOL[torch.float32]


@pytest.mark.parametrize("layout", ["padded", "rows"])
@pytest.mark.parametrize("core", ["gcn", "gin"])
def test_fused_layer_cores_at_int4_match_jax(core, layout):
    """The fused mode (``prefer_fused_kernel``): GCN's backward and GIN's
    forward are one fused launch reading nibbles; values and gradients
    against the JAX package's fused cores at int4."""
    rp, ci, nn = small_graph(300, 6)
    op = HybridSpMM(rp, ci, nn, PlanConfig(a_dtype="int4"), device="cpu")
    jop = JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(a_dtype="int4"))
    op.plan.prefer_fused_kernel = jop.plan.prefer_fused_kernel = True
    rs = np.random.RandomState(4)
    x = rs.randn(nn, 24).astype(np.float32)
    w = (rs.randn(24, 12) * 0.1).astype(np.float32)
    before = block_spmm.band_fused_spmm_direct_plain
    calls = []

    def counted(*args, **kw):
        calls.append(args[2].dtype)
        return before(*args, **kw)

    block_spmm.band_fused_spmm_direct_plain = counted
    try:
        xv = torch.from_numpy(x).requires_grad_(True)
        wv = torch.from_numpy(w).requires_grad_(True)
        if layout == "padded":
            out = op.unpad_output(getattr(op, f"{core}_apply_padded")(
                op.arrays, op.pad_input(xv), wv), 12)
        else:
            out = getattr(op, f"{core}_apply")(op.arrays, xv, wv)
        (out ** 2).sum().backward()
    finally:
        block_spmm.band_fused_spmm_direct_plain = before
    assert calls == [torch.uint8]
    if layout == "padded":
        japply = getattr(jop, f"{core}_apply_padded")

        def fn(xj, wj):
            return jop.unpad_output(japply(jop.arrays, jop.pad_input(xj), wj), 12)
    else:
        ops = jax_make_fused_ops(jop.plan, jop.plan_bwd, compute_dtype="float32", impl="pallas")

        def fn(xj, wj):
            return ops[core](jop.arrays["f"], jop.arrays["b"], xj, wj)

    gx, gw = jax.grad(lambda u, v: jnp.sum(fn(u, v) ** 2), argnums=(0, 1))(jnp.asarray(x),
                                                                          jnp.asarray(w))
    assert rel_err(out, fn(jnp.asarray(x), jnp.asarray(w))) < TOL[torch.float32]
    assert rel_err(xv.grad, gx) < TOL[torch.float32]
    assert rel_err(wv.grad, gw) < TOL[torch.float32]


DIMS = dict(num_features=24, hidden=16, num_classes=5, num_layers=3)


@pytest.mark.parametrize("model", ["gcn", "gin", "sage"])
def test_adam_steps_at_int4_match_jax_train_step(model):
    """Three Adam steps (lr 0.01, dropout 0) of the 3-layer model on a wide
    int4 plan, from the JAX weights
    (``params_from_jax``), against optax.adam through JAX's make_train_step
    at int4: losses and parameters within rtol 1e-4; the losses equal the
    port's at int8 bit for bit."""
    rp, ci, nn = small_graph(300, 6)
    jnet = JaxNet(model=model, dropout=0.0, **DIMS)
    jparams = jax_init_net_params(jnet, jax.random.PRNGKey(0), init="glorot")
    x = np.random.RandomState(0).randn(nn, DIMS["num_features"]).astype(np.float32)
    y = np.ones(nn, dtype=np.int64)
    losses = {}
    for a_dtype in ("int4", "int8"):
        op = HybridSpMM(rp, ci, nn, PlanConfig(a_dtype=a_dtype), device="cpu")
        net = Net(model=model, dropout=0.0, **DIMS)
        params = params_from_jax(jparams, device=op.device)
        step = make_train_step(net, op, torch.optim.Adam(
            [t for layer in params for t in layer.values()], lr=0.01))
        losses[a_dtype] = [float(step(params, torch.from_numpy(x), torch.from_numpy(y)))
                           for _ in range(3)]
        if a_dtype == "int4":
            params4 = params
    assert losses["int4"] == losses["int8"]
    jop = JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(a_dtype="int4"))
    opt = optax.adam(0.01)
    jstep = jax_make_train_step(jnet, jop, opt)
    jstate = opt.init(jparams)
    key = jax.random.PRNGKey(1)
    for loss in losses["int4"]:
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(x), jnp.asarray(y), key)
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
    assert_params_match_jax(params4, jparams)


# ---------------------------------------------------------------------------
# the launch sizing and the host checks at int4
# ---------------------------------------------------------------------------

H100 = (233472, 1024, 232448)


@pytest.mark.parametrize("bb", [128, 384, 640, 1024, 2560, 104])
def test_band_launch_sizes_the_ring_in_stored_bytes(bb):
    """At int4 a row of A is Bb / 2 bytes, and the wrappers size the rings
    by the stored rows (``a.shape[2]``): the boxes halve (Bb 128, 384, 640
    and 1024 take 64-, 64-, 64- and 256-byte boxes, one, three, five and two
    of them), every box a 16-byte multiple and the stage 16-byte aligned; a
    row whose bytes are no 16-byte multiple (Bb 104: 52 bytes) goes by
    cp.async."""
    a4 = nibbles(np.zeros((1, 4, bb), np.int8))
    ring = block_spmm.band_launch(a4.shape[2], *H100)
    assert ring["box_w"] % 16 == 0 and (ring["rows"] * ring["box_w"]) % 16 == 0
    assert ring["box_w"] * ring["nbox"] >= bb // 2
    assert ring["tma"] == (bb // 2 % 16 == 0)
    fused = block_spmm.fused_launch(a4.shape[2], 256, 256, *H100)
    assert (fused["box_w"], fused["nbox"]) == (ring["box_w"], ring["nbox"])
    want = {128: (64, 1), 384: (64, 3), 640: (64, 5), 1024: (256, 2)}.get(bb)
    if want:
        assert (ring["box_w"], ring["nbox"]) == want


def test_int4_band_widths_must_fill_whole_words():
    st = np.zeros(1, np.int32)
    block_spmm.check_band_arrays(st, st, 24, 64, 1, pack=2)
    with pytest.raises(ValueError, match="multiple of 8"):
        block_spmm.check_band_arrays(st, st, 20, 64, 1, pack=2)
    block_spmm.check_band_arrays(st, st, 20, 64, 1)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/block_spmm.cu has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bb", [104, 640, 1024, 2560])
def test_cuda_band_kernel_reads_nibbles(bb, dtype):
    """band_kernel at PACK 2 (direct, bucket and grouped modes) against its
    plain version and bit for bit the PACK 1 launch; Bb 104 by cp.async."""
    _need_cuda()
    a, st, sw, x = band_inputs(bb, sb=12, bh=128, bb=bb, dp=256, m=4096)
    a4, a8 = nibbles(a).cuda(), torch.from_numpy(a).cuda()
    st, sw = torch.from_numpy(st).cuda(), torch.from_numpy(sw).cuda()
    xv = torch.from_numpy(x).cuda().to(dtype)
    for fn, args in ((block_spmm.band_bucket_spmm_direct, (sw, st)),
                     (block_spmm.band_bucket_spmm, (st,)),
                     (block_spmm.band_bucket_spmm_grouped, (st,))):
        rest = () if fn is block_spmm.band_bucket_spmm else (10, dtype)
        got = fn(*args, a4, xv, *rest)
        same = fn(*args, a8, xv, *rest)
        ref = getattr(block_spmm, fn.__name__ + "_plain")(*args, a4, xv, *rest)
        torch.cuda.synchronize()
        # every block is owned: the ten real entries are a permutation
        assert torch.equal(got, same) and rel_err(got.cpu(), ref.cpu()) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tiled_and_fused_kernels_read_nibbles(dtype):
    """tiled_kernel and band_fused_kernel at PACK 2 against their plain
    versions and bit for bit their PACK 1 launches."""
    _need_cuda()
    rp, ci, nn = blocks_graph()
    op = HybridSpMM(rp, ci, nn, PlanConfig(a_dtype="int4", **TILED), device="cuda")
    xp = torch.randn((op.plan.padded_rows, 256), device="cuda").to(dtype)
    got = block_spmm.band_tiled_spmm(op.arrays["f"], xp, op.plan, dtype)
    arrs8 = dict(op.arrays["f"], tp_a=torch.from_numpy(op.plan.tiled_a_dense()).cuda())
    same = block_spmm.band_tiled_spmm(arrs8, xp, op.plan, dtype)
    ref = block_spmm.band_tiled_spmm_plain(op.arrays["f"], xp, op.plan, dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, same) and rel_err(got.cpu(), ref.cpu()) < TOL[dtype]
    a, st, sw, x = band_inputs(1, sb=12, bh=128, bb=640, dp=256, m=4096)
    w = torch.randn((256, 256), device="cuda").to(dtype)
    args = (torch.from_numpy(sw).cuda(), torch.from_numpy(st).cuda())
    xv = torch.from_numpy(x).cuda().to(dtype)
    agg, out = block_spmm.band_fused_spmm_direct(*args, nibbles(a).cuda(), xv, w, 10, dtype)
    agg8, out8 = block_spmm.band_fused_spmm_direct(*args, torch.from_numpy(a).cuda(), xv, w, 10,
                                                   dtype)
    ragg, rout = block_spmm.band_fused_spmm_direct_plain(*args, nibbles(a).cuda(), xv, w, 10,
                                                         dtype)
    torch.cuda.synchronize()
    assert torch.equal(agg, agg8) and torch.equal(out, out8)
    assert rel_err(agg.cpu(), ragg.cpu()) < TOL[dtype]
    assert rel_err(out.cpu(), rout.cpu()) < TOL[dtype]
