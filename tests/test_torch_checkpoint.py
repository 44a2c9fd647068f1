"""The port's checkpoints (hcspmm_tpu_torch/utils/checkpoint.py): the JAX
package's npz format in both directions, the atomic write, and resuming
through ``train.loop.train`` and the CLI's ``--checkpoint``,
``--checkpoint-every``, ``--resume`` and ``--fault-epoch``."""

import json

import jax
import numpy as np
import pytest
import torch

from hcspmm_tpu.models.net import Net as JaxNet, init_net_params as jax_init_net_params
from hcspmm_tpu.utils.checkpoint import load_pytree as jax_load_pytree
from hcspmm_tpu.utils.checkpoint import save_pytree as jax_save_pytree

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.models.net import Net, params_from_jax
from hcspmm_tpu_torch.ops.spmm import HybridSpMM
from hcspmm_tpu_torch.train import cli
from hcspmm_tpu_torch.train.loop import train
from hcspmm_tpu_torch.utils.checkpoint import load_pytree, save_pytree

from conftest import small_graph


def jax_params(model):
    net = JaxNet(model=model, num_features=12, hidden=8, num_classes=5, num_layers=3)
    return jax_init_net_params(net, jax.random.PRNGKey(7))


def trees():
    """name -> (the port's tree, the same tree for the JAX package)."""
    out = {}
    for model in ("gcn", "sage"):
        p = jax_params(model)
        out[model] = (params_from_jax(p, device="cpu"), p)
    nested = {"b": [np.ones((2, 2), np.float32), {"c": np.float32(1.5)}],
              "a": np.arange(3), "t": (np.zeros(2), None), "s": 3}
    out["nested"] = (nested, nested)
    return out


def raw(path, key):
    with np.load(path, allow_pickle=False) as data:
        return str(data[key])


def leaves_equal(got, want):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["gcn", "sage", "nested"])
def test_port_checkpoint_loads_in_jax(tmp_path, name):
    port_tree, jax_tree = trees()[name]
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_pytree(ours, port_tree, {"epoch": 3, "loss": 0.5})
    jax_save_pytree(theirs, jax_tree, {"epoch": 3, "loss": 0.5})
    assert raw(ours, "__treedef__") == raw(theirs, "__treedef__")
    assert raw(ours, "__meta__") == raw(theirs, "__meta__")
    tree, meta = jax_load_pytree(ours)
    assert meta == {"epoch": 3, "loss": 0.5}
    leaves_equal(tree, jax_tree)
    assert jax.tree.structure(tree) == jax.tree.structure(jax_load_pytree(theirs)[0])


@pytest.mark.parametrize("name", ["gcn", "sage", "nested"])
def test_jax_checkpoint_loads_in_port(tmp_path, name):
    port_tree, jax_tree = trees()[name]
    path = str(tmp_path / "jax")  # the suffix-less name the CLI records
    jax_save_pytree(path, jax_tree, {"epoch": 9})
    tree, meta = load_pytree(path)
    assert meta == {"epoch": 9}
    want, _ = jax_load_pytree(path)
    leaves_equal(tree, want)
    assert json.dumps(jax.tree.map(lambda _: "__array__", tree)) == raw(path + ".npz",
                                                                        "__treedef__")
    if name != "nested":
        back = params_from_jax(tree, device="cpu")
        for a, b in zip(back, port_tree):
            assert sorted(a) == sorted(b)
            for k in a:
                assert torch.equal(a[k], b[k].detach())


def test_checkpoint_atomic_under_crash_mid_write(tmp_path, monkeypatch):
    """A crash inside the temp-file write leaves the last checkpoint intact."""
    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, {"w": np.arange(5)}, {"epoch": 1})

    def crashing_savez(file, *a, **kw):
        with open(file, "wb") as f:
            f.write(b"partial garbage")
        raise KeyboardInterrupt("killed mid-write")

    monkeypatch.setattr(np, "savez", crashing_savez)
    with pytest.raises(KeyboardInterrupt):
        save_pytree(path, {"w": np.arange(9)}, {"epoch": 2})
    monkeypatch.undo()
    loaded, meta = load_pytree(path)
    assert meta["epoch"] == 1
    np.testing.assert_array_equal(loaded["w"], np.arange(5))


def test_checkpoint_crash_between_write_and_replace(tmp_path, monkeypatch):
    import os

    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, {"w": np.zeros(3)}, {"epoch": 1})

    def crashing_replace(a, b):
        raise KeyboardInterrupt("killed before replace")

    monkeypatch.setattr(os, "replace", crashing_replace)
    with pytest.raises(KeyboardInterrupt):
        save_pytree(path, {"w": np.ones(3)}, {"epoch": 2})
    monkeypatch.undo()
    assert load_pytree(path)[1]["epoch"] == 1
    save_pytree(path, {"w": np.full(3, 7.0)}, {"epoch": 3})
    assert load_pytree(path)[1]["epoch"] == 3


def test_checkpoint_rejects_pickle_and_a_wrong_leaf_count(tmp_path):
    path = str(tmp_path / "evil.npz")
    np.savez(path, __treedef__=np.array({"x": 1}, dtype=object), __meta__="{}",
             leaf_0=np.arange(2))
    with pytest.raises(ValueError):
        load_pytree(path)
    for leaves in ({}, {"leaf_0": np.arange(2), "leaf_1": np.arange(2)}):
        np.savez(path, __treedef__='["__array__"]', __meta__="{}", **leaves)
        with pytest.raises(ValueError, match="leaves"):
            load_pytree(path)


def setup(n=120):
    rp, ci, nn = small_graph(n, 5)
    op = HybridSpMM(rp, ci, nn, PlanConfig(impl="pallas", band_mode="auto"), device="cpu")
    net = Net(model="gcn", num_features=8, hidden=8, num_classes=3, num_layers=2)
    x = np.random.RandomState(0).randn(nn, 8).astype(np.float32)
    y = np.ones(nn, dtype=np.int64)
    return net, op, x, y


def test_resume_equals_an_uninterrupted_run_with_a_fresh_adam(tmp_path):
    """Train 4 epochs saving every 2; resume from the file in a fresh
    operator for 2 more: the losses equal those of a run that continues
    from the same epoch with a fresh Adam (the optimizer state is not
    saved, as in the JAX package)."""
    net, op, x, y = setup()
    path = str(tmp_path / "resume.npz")
    first = train(net, op, x, y, epochs=4, warmup_epochs=0, seed=3, checkpoint_path=path,
                  checkpoint_every=2)
    params, meta = load_pytree(path)
    assert meta["epoch"] == 4 and meta["loss"] == pytest.approx(first["final_loss"])
    for a, b in zip(params, first["params"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k].detach().numpy())
    _, op2, _, _ = setup()
    resumed = train(net, op2, x, y, epochs=2, warmup_epochs=0, seed=3, init_params=params,
                    start_epoch=meta["epoch"], logger=None)
    straight = train(net, op, x, y, epochs=2, warmup_epochs=0, seed=3,
                     init_params=first["params"])
    assert resumed["final_loss"] == straight["final_loss"]
    for a, b in zip(resumed["params"], straight["params"]):
        for k in a:
            assert torch.equal(a[k], b[k])


CLI = ["--dataset", "example", "--synthetic-nodes", "64", "--synthetic-degree", "4",
       "--dim", "8", "--hidden", "8", "--classes", "4", "--num_layers", "2", "--device", "cpu"]


def test_cli_checkpoint_resume_and_fault_flags(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    assert cli.main(CLI + ["--epochs", "3", "--checkpoint", ck, "--checkpoint-every", "1"]) == 0
    params, meta = load_pytree(ck)
    assert meta == {"model": "gcn", "epoch": 3, "epochs": 3}
    assert jax_load_pytree(ck)[1] == meta  # the JAX package reads it too
    assert cli.main(CLI + ["--epochs", "2", "--resume", ck, "--checkpoint", ck]) == 0
    out = capsys.readouterr().out
    resume = [json.loads(v) for v in out.splitlines() if '"resume"' in v]
    assert resume and resume[0]["epoch"] == 3
    assert load_pytree(ck)[1]["epoch"] == 5
    with pytest.raises(RuntimeError, match="injected fault at epoch 7"):
        cli.main(CLI + ["--epochs", "4", "--resume", ck, "--checkpoint", ck,
                        "--checkpoint-every", "1", "--fault-epoch", "7"])
    assert load_pytree(ck)[1]["epoch"] == 7  # saved before the fault
