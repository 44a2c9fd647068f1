"""The port's models, training step and command line against the JAX
package (hcspmm_tpu_torch/models, train): forward passes with weights
carried across by ``params_from_jax``, Adam steps, the CLI on the CPU,
and the port's independence from JAX."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hcspmm_tpu.config import PlanConfig as JaxPlanConfig
from hcspmm_tpu.models.net import Net as JaxNet
from hcspmm_tpu.models.net import init_net_params as jax_init_net_params
from hcspmm_tpu.models.net import net_forward as jax_net_forward
from hcspmm_tpu.ops.spmm import HybridSpMM as JaxHybridSpMM
from hcspmm_tpu.train.loop import make_train_step as jax_make_train_step

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.graphs import io
from hcspmm_tpu_torch.models.net import Net, init_net_params, net_forward, params_from_jax
from hcspmm_tpu_torch.ops.spmm import HybridSpMM
from hcspmm_tpu_torch.train import cli
from hcspmm_tpu_torch.train.loop import make_train_step, train

from conftest import small_graph
from torch_params import assert_params_match_jax

TBAND = dict(impl="pallas", band_impl="tband", band_h=128, band_mode="always")
DIMS = dict(num_features=24, hidden=16, num_classes=5, num_layers=3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel_err(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)


def setup(model, dropout=0.5, graph=lambda: small_graph(300, 6), cfg=TBAND, dims=DIMS):
    rp, ci, nn = graph()
    op = HybridSpMM(rp, ci, nn, PlanConfig(**cfg), device="cpu")
    jop = JaxHybridSpMM(rp, ci, nn, JaxPlanConfig(**cfg))
    jnet = JaxNet(model=model, dropout=dropout, **dims)
    net = Net(model=model, dropout=dropout, **dims)
    jparams = jax_init_net_params(jnet, jax.random.PRNGKey(0), init="glorot")
    x = np.random.RandomState(0).randn(nn, dims["num_features"]).astype(np.float32)
    return op, jop, net, jnet, jparams, x


@pytest.mark.parametrize("model", ["gcn", "gin", "sage"])
def test_net_forward_matches_jax(model):
    """Log-probabilities of the port's padded-layout forward against the
    JAX package's, same weights (fp32, within 1e-5 of max|ref|)."""
    op, jop, net, jnet, jparams, x = setup(model)
    want = jax_net_forward(jnet, jparams, jop, jnp.asarray(x))
    with torch.no_grad():
        got = net_forward(net, params_from_jax(jparams, device=op.device), op.layout,
                          op.pad_input(x), out_slice=lambda h: op.unpad_output(h, net.num_classes))
    assert got.shape == want.shape == (x.shape[0], DIMS["num_classes"])
    assert rel_err(got, want) < 1e-5


@pytest.mark.parametrize("model", ["gcn", "gin", "sage"])
def test_net_forward_on_wide_plan_matches_jax(model):
    """The same forward pass in the wide padded layout [M, dp], hidden 130
    (two 128-column blocks)."""
    op, jop, net, jnet, jparams, x = setup(model, cfg=dict(impl="pallas", band_impl="wide"),
                                           dims=dict(DIMS, hidden=130))
    want = jax_net_forward(jnet, jparams, jop, jnp.asarray(x))
    with torch.no_grad():
        got = net_forward(net, params_from_jax(jparams, device=op.device), op.layout,
                          op.pad_input(x), out_slice=lambda h: op.unpad_output(h, net.num_classes))
    assert got.shape == want.shape == (x.shape[0], DIMS["num_classes"])
    assert rel_err(got, want) < 1e-5


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_adam_steps_match_jax_train_step(model):
    """Three Adam steps (lr 0.01, dropout 0): torch.optim.Adam against
    optax.adam through JAX's make_train_step; losses and parameters within
    rtol 1e-4."""
    _adam_steps_match(*setup(model, dropout=0.0))


def test_adam_steps_on_spill_plan_match_jax_train_step():
    """The same three Adam steps on a plan whose spill chain runs in every
    forward and backward SpMM."""
    case = setup("gcn", dropout=0.0, graph=lambda: small_graph(500, 8, span=400),
                 cfg=dict(TBAND, band_widths=(128,), band_mode="auto"))
    assert case[0].plan.spill_nnz > 0
    _adam_steps_match(*case)


def test_adam_steps_at_pack_8_match_pack_1_and_jax():
    """The GCN on a ``tband_pack=8`` plan (A_t uploaded as bits): three Adam
    steps match JAX's make_train_step on the same config and weights, and
    ``train.loop.train`` from those weights gives pack 1's losses exactly."""
    case = setup("gcn", dropout=0.0, cfg=dict(TBAND, tband_pack=8))
    assert case[0].arrays["f"]["band0_at"].dtype == torch.uint8
    _adam_steps_match(*case)

    class Losses:
        def __init__(self):
            self.v = []

        def log(self, **rec):
            self.v.append(rec["loss"])

    losses = {}
    for pack in (1, 8):
        op, _, net, _, jparams, x = setup("gcn", dropout=0.0, cfg=dict(TBAND, tband_pack=pack))
        rec = Losses()
        train(net, op, x, np.ones(x.shape[0], dtype=np.int64), epochs=3, warmup_epochs=1,
              logger=rec, init_params=params_from_jax(jparams, device=op.device))
        losses[pack] = rec.v
    assert len(losses[8]) == 3 and losses[8] == losses[1]


WIDE = dict(impl="pallas", band_impl="wide")


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_adam_steps_on_wide_plan_match_jax_train_step(model):
    """The same three Adam steps in the wide padded layout [M, dp]."""
    case = setup(model, dropout=0.0, cfg=WIDE)
    assert not case[0].transposed
    _adam_steps_match(*case)


def test_adam_steps_on_wide_spill_plan_match_jax_train_step():
    """Three Adam steps on a wide plan whose row merge runs in every
    forward and backward SpMM."""
    case = setup("gcn", dropout=0.0, graph=lambda: small_graph(500, 8, span=400),
                 cfg=dict(WIDE, band_h=128, band_widths=(128,), ds_kind="block"))
    assert case[0].plan.spill_nnz > 0 and case[0].plan.ds_kind == "block"
    _adam_steps_match(*case)


def test_train_step_takes_a_padded_wide_input():
    """make_train_step pads a raw [N, d] input and leaves an input already
    in the wide layout [M, dp] as it is (it once padded it again)."""
    op = HybridSpMM(*small_graph(300, 6), PlanConfig(**WIDE), device="cpu")
    net = Net(model="gcn", dropout=0.0, **DIMS)
    x = np.random.RandomState(0).randn(op.plan.num_nodes, DIMS["num_features"]).astype(np.float32)
    y = torch.ones(x.shape[0], dtype=torch.int64)
    losses = []
    for xin in (torch.from_numpy(x), op.pad_input(x)):
        params = init_net_params(net, torch.Generator().manual_seed(0), device=op.device)
        step = make_train_step(net, op, torch.optim.Adam(
            [t for layer in params for t in layer.values()], lr=0.01))
        losses.append(float(step(params, xin, y)))
    assert op.layout.is_padded(op.pad_input(x)) and not op.layout.is_padded(torch.from_numpy(x))
    assert losses[0] == losses[1]


def _adam_steps_match(op, jop, net, jnet, jparams, x):
    y = np.ones(x.shape[0], dtype=np.int64)
    opt = optax.adam(0.01)
    jstep = jax_make_train_step(jnet, jop, opt)
    jstate = opt.init(jparams)
    params = params_from_jax(jparams, device=op.device)
    step = make_train_step(net, op, torch.optim.Adam(
        [t for layer in params for t in layer.values()], lr=0.01))
    key = jax.random.PRNGKey(1)
    for _ in range(3):
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(x), jnp.asarray(y), key)
        loss = step(params, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert_params_match_jax(params, jparams)


def _npz_graph(tmp_path):
    src, dst, n = io.synthetic_blocks(1500, 5, 100, seed=7)
    path = str(tmp_path / "g.npz")
    io.save_edges_npz(path, src, dst, n)
    return path


def _records(out):
    return [json.loads(v) for v in out.splitlines() if v.startswith("{")]


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_cli_trains_on_cpu(tmp_path, capsys, model):
    path = _npz_graph(tmp_path)
    assert cli.main(["--dataset", path, "--reorder", "rcm", "--model", model,
                     "--dim", "24", "--hidden", "16", "--classes", "5",
                     "--num_layers", "3", "--epochs", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Prep. (ms):" in out
    done = [r for r in _records(out) if r.get("event") == "done"]
    assert len(done) == 1 and np.isfinite(done[0]["final_loss"])
    assert done[0]["device"] == "cpu"
    assert [r["epoch"] for r in _records(out) if "epoch" in r] == [0, 1]


def test_cli_default_example_trains_on_cpu(capsys):
    """The CLI's default synthetic graph: at 4096 nodes its tband plan
    spills (merge group 4, chunks of 512) and trains to a finite loss."""
    assert cli.main(["--synthetic-nodes", "4096", "--hidden", "16", "--classes", "5",
                     "--num_layers", "2", "--epochs", "2", "--device", "cpu"]) == 0
    recs = _records(capsys.readouterr().out)
    prep = [r for r in recs if r.get("event") == "preprocess"]
    assert len(prep) == 1 and prep[0]["spill_nnz"] > 0
    done = [r for r in recs if r.get("event") == "done"]
    assert len(done) == 1 and np.isfinite(done[0]["final_loss"])


@pytest.mark.parametrize("flags", [
    ["--band-impl", "wide", "--model", "gcn"],
    ["--hidden", "96", "--model", "gin"],
    ["--hidden", "96", "--model", "sage", "--reorder", "none"],
])
def test_cli_trains_wide_layout_on_cpu(tmp_path, capsys, flags):
    """The wide padded layout through the CLI: picked by ``--band-impl
    wide`` or by a hidden dim above 64, trained to a finite loss."""
    path = _npz_graph(tmp_path)
    assert cli.main(["--dataset", path, "--reorder", "rcm", "--dim", "24", "--classes", "5",
                     "--num_layers", "3", "--epochs", "2", "--device", "cpu", *flags]) == 0
    done = [r for r in _records(capsys.readouterr().out) if r.get("event") == "done"]
    assert len(done) == 1 and np.isfinite(done[0]["final_loss"])


def test_cli_single_kernel_on_cpu(tmp_path, capsys):
    path = _npz_graph(tmp_path)
    assert cli.main(["--dataset", path, "--reorder", "rcm", "--dim", "32",
                     "--single_kernel", "--device", "cpu"]) == 0
    sag = [r for r in _records(capsys.readouterr().out) if r.get("event") == "sag"]
    assert len(sag) == 1 and sag[0]["avg_ms"] > 0 and sag[0]["device"] == "cpu"


@pytest.mark.parametrize("model", ["gcn", "gin", "sage"])
def test_cli_impl_xla_trains_on_cpu(tmp_path, capsys, model):
    """``--impl xla``: the plain gather + segment-sum form on a wide plan in
    the row layout (the reference's CLI picks wide under xla)."""
    path = _npz_graph(tmp_path)
    assert cli.main(["--dataset", path, "--reorder", "rcm", "--dim", "24", "--classes", "5",
                     "--num_layers", "3", "--epochs", "2", "--device", "cpu", "--impl", "xla",
                     "--model", model]) == 0
    recs = _records(capsys.readouterr().out)
    prep = [r for r in recs if r.get("event") == "preprocess"]
    done = [r for r in recs if r.get("event") == "done"]
    assert prep[0]["layout"] == "rows" and "dense_windows" in prep[0]
    assert "sparse_rows" in prep[0]
    assert len(done) == 1 and np.isfinite(done[0]["final_loss"])


@pytest.mark.parametrize("flags", [
    ["--band-impl", "tiled"], ["--band-impl", "ring"],
    ["--checkpoint", "c.npz"], ["--resume", "c.npz"], ["--checkpoint-every", "1"],
    ["--fault-epoch", "1"], ["--dataset", "karate"],
])
def test_cli_unported_flags_raise(flags, tmp_path, monkeypatch, capsys):
    """The flags of the features ported after the first slices run:
    ``--band-impl tiled`` (A.11), ``--band-impl ring`` (a wide plan, as the
    JAX CLI builds for it) and the real graph ``karate`` train, the
    checkpoint flags (A.8) save and resume, and ``--fault-epoch`` fails
    training at its epoch."""
    from hcspmm_tpu_torch.utils.checkpoint import load_pytree

    monkeypatch.chdir(tmp_path)  # relative checkpoint paths land here
    argv = ["--synthetic-nodes", "500", "--epochs", "1", "--device", "cpu", *flags]
    if flags[0] == "--fault-epoch":
        with pytest.raises(RuntimeError, match="injected fault at epoch 1"):
            cli.main(argv)
        return
    if flags[0] == "--resume":
        assert cli.main(argv[:-2] + ["--checkpoint", "c.npz"]) == 0
    assert cli.main(argv) == 0
    if flags == ["--band-impl", "ring"]:
        prep = [r for r in _records(capsys.readouterr().out) if r.get("event") == "preprocess"]
        assert prep[0]["layout"] == "wide"
    if flags[0] in ("--checkpoint", "--resume"):
        assert load_pytree("c.npz")[1]["epoch"] == 1


def test_cli_device_auto_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--synthetic-nodes", "500", "--epochs", "1"])


def test_port_imports_no_jax():
    """A fresh interpreter that builds a plan and runs one forward pass, a
    training step in the fused mode and a tiled SpMM through the port has
    imported neither JAX, optax nor hcspmm_tpu."""
    code = """
import sys
import numpy as np
import torch
from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.graphs import io
from hcspmm_tpu_torch.models.net import Net, init_net_params, net_forward
from hcspmm_tpu_torch.ops.spmm import HybridSpMM
import hcspmm_tpu_torch.train.cli
src, dst, n = io.synthetic_blocks(400, 5, 50, seed=1)
rp, ci = io.to_csr(src, dst, n)
op = HybridSpMM(rp, ci, n, PlanConfig(band_impl="tband", band_h=128), device="cpu")
net = Net("gcn", 8, 16, 4, 2)
params = init_net_params(net, torch.Generator().manual_seed(0), device=op.device)
x = np.random.RandomState(0).randn(n, 8).astype(np.float32)
lp = net_forward(net, params, op.layout, op.pad_input(x),
                 out_slice=lambda h: op.unpad_output(h, 4))
assert lp.shape == (n, 4) and bool(torch.isfinite(lp).all())
from hcspmm_tpu_torch.train.loop import make_train_step
op.plan.prefer_fused_kernel = True
step = make_train_step(net, op, torch.optim.Adam([t for p in params for t in p.values()]))
assert bool(torch.isfinite(step(params, x, torch.ones(n, dtype=torch.int64), torch.Generator())))
tiled = HybridSpMM(rp, ci, n, PlanConfig(band_impl="tiled", band_h=128), device="cpu")
assert tiled.plan.tiled and bool(torch.isfinite(tiled(torch.from_numpy(x))).all())
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "optax", "hcspmm_tpu"))
print("BAD", bad)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
