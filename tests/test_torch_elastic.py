"""The port's elastic supervisor (hcspmm_tpu_torch/train/elastic.py): fault
injection -> detection -> resume from the checkpoint, in process and by
relaunching the CLI, as tests/test_elastic.py holds the JAX package's."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from hcspmm_tpu_torch.models.net import Net
from hcspmm_tpu_torch.ops.spmm import HybridSpMM
from hcspmm_tpu_torch.train import cli, elastic
from hcspmm_tpu_torch.train.loop import train
from hcspmm_tpu_torch.utils.checkpoint import load_pytree

from conftest import small_graph


def setup(n=48, deg=4, dim=8, hidden=8, classes=4, layers=2):
    rp, ci, nn = small_graph(n, deg)
    op = HybridSpMM(rp, ci, nn, device="cpu")
    net = Net(model="gcn", num_features=dim, hidden=hidden, num_classes=classes,
              num_layers=layers)
    x = np.random.RandomState(0).randn(nn, dim).astype(np.float32)
    y = np.ones(nn, dtype=np.int64)
    return net, op, x, y


def test_fault_injection_raises(tmp_path):
    net, op, x, y = setup()
    ckpt = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected fault at epoch 3"):
        train(net, op, x, y, epochs=6, warmup_epochs=0, checkpoint_path=ckpt,
              checkpoint_every=2, fault_epoch=3)
    _, meta = load_pytree(ckpt)
    assert meta["epoch"] == 2


def test_run_with_recovery_resumes_and_completes(tmp_path):
    net, op, x, y = setup()
    ckpt = str(tmp_path / "ck")
    restarts = []
    res = elastic.run_with_recovery(
        net, op, x, y, epochs=6, checkpoint_path=ckpt, checkpoint_every=2, max_restarts=3,
        fault_epochs=[3], warmup_epochs=0, on_restart=lambda k, exc: restarts.append(k))
    assert res["restarts"] == 1 and restarts == [1]
    assert res["resumed_from"] == [0, 2]
    assert np.isfinite(res["final_loss"])
    params, meta = load_pytree(ckpt)
    assert meta["epoch"] == 6
    assert all(np.isfinite(v).all() for layer in params for v in layer.values())


def test_run_with_recovery_exhausts_restarts(tmp_path):
    net, op, x, y = setup()
    with pytest.raises(RuntimeError, match="exhausted"):
        elastic.run_with_recovery(
            net, op, x, y, epochs=6, checkpoint_path=str(tmp_path / "ck"),
            checkpoint_every=10, max_restarts=2, fault_epochs=[1, 1, 1], warmup_epochs=0)


def test_recovery_is_deterministic(tmp_path):
    """Two identical crash+resume runs give bit-identical parameters."""
    net, op, x, y = setup()

    def run(tag):
        return elastic.run_with_recovery(
            net, op, x, y, epochs=8, checkpoint_path=str(tmp_path / tag), checkpoint_every=2,
            max_restarts=2, fault_epochs=[4], warmup_epochs=0)

    a, b = run("a"), run("b")
    for la, lb in zip(a["params"], b["params"]):
        for k in la:
            assert torch.equal(la[k], lb[k])


def test_corrupt_checkpoint_treated_as_absent(tmp_path):
    path = str(tmp_path / "ck")
    with open(path + ".npz", "wb") as f:
        f.write(b"not a zipfile")
    params, epoch = elastic.checkpoint_state(path)
    assert params is None and epoch == 0


CLI = ["--dataset", "example", "--synthetic-nodes", "48", "--synthetic-degree", "4", "--dim",
       "8", "--hidden", "8", "--classes", "4", "--num_layers", "2", "--device", "cpu"]


def test_supervise_relaunches_cli(tmp_path):
    """The first launch faults at epoch 3 (checkpointing every 2); the
    relaunch resumes with --resume and runs only the remaining epochs."""
    ckpt = str(tmp_path / "ck")
    launches = []

    def runner(argv):
        launches.append(list(argv))
        try:
            return cli.main(argv)
        except RuntimeError:
            return 1

    res = elastic.supervise(CLI, checkpoint=ckpt, total_epochs=6, checkpoint_every=2,
                            max_restarts=2, fault_epoch=3, runner=runner)
    assert res["restarts"] == 1 and res["epochs"] == 6
    assert len(launches) == 2
    assert "--fault-epoch" in launches[0] and "--fault-epoch" not in launches[1]
    assert "--resume" in launches[1]
    i = launches[1].index("--epochs")
    assert launches[1][i + 1] == "4"
    assert load_pytree(ckpt)[1]["epoch"] == 6


def test_elastic_main_supervises_cli_processes(tmp_path):
    """``python -m hcspmm_tpu_torch.train.elastic`` relaunches the CLI as a
    process after the injected fault and finishes the epochs."""
    ckpt = str(tmp_path / "ck")
    out = subprocess.run([sys.executable, "-m", "hcspmm_tpu_torch.train.elastic", "--checkpoint",
                          ckpt, "--total-epochs", "4", "--checkpoint-every", "1",
                          "--fault-epoch", "2", "--", *CLI], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "elastic: done at epoch 4 after 1 restart(s)" in out.stdout
    assert out.stdout.count("injected fault") == 0  # the fault is the child's traceback
    assert "injected fault at epoch 2" in out.stderr
    assert load_pytree(ckpt)[1]["epoch"] == 4
