"""``correct`` comes out false when the timed path is broken underneath a
run (the harness's look for a card skipped, everything else as a run
drives it), and for the control: the program's own bfloat16 path, one
precision below the configurations' float32.  The tiny cells carry the
limits of the real cells of their layout.  (The cells run on one chip, so
there is no exchange between chips to leave out.)"""

import torch

import conftest
import pytest

from benchmark import harness
from hcspmm_tpu_torch.kernels import block_spmm, tband
from hcspmm_tpu_torch.train import loop

CELLS = ("tiny.tband", "tiny.wide")


def _run(root, cell):
    return conftest.rehearse(root, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    assert _run(tiny_root, cell)["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged(tiny_root, cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    res = _run(tiny_root, cell)
    assert res["correct"] is False
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out(tiny_root, cell, monkeypatch):
    def half(log_probs, labels):
        k = labels.shape[0] // 2
        return -log_probs[k:].gather(1, labels[k:, None]).mean()

    monkeypatch.setattr(loop, "nll_loss", half)
    assert _run(tiny_root, cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced(tiny_root, cell, monkeypatch):
    """One node's aggregate off by a little in every SpMM."""
    mod, name = ((tband, "spmm_tband_padded") if cell == "tiny.tband"
                 else (block_spmm, "spmm_wide_padded"))
    orig = getattr(mod, name)

    def altered(arrs, x, plan, cd):
        out = orig(arrs, x, plan, cd)
        if mod is tband:
            out[:, 7] *= 1.01
        else:
            out[7, :] *= 1.01
        return out

    monkeypatch.setattr(mod, name, altered)
    assert _run(tiny_root, cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_control_bfloat16_fails(tiny_root, cell, monkeypatch):
    orig = harness.plan_config
    monkeypatch.setattr(harness, "plan_config", lambda cfg, dtype=None: orig(cfg, "bfloat16"))
    res = _run(tiny_root, cell)
    assert res["correct"] is False


def test_calibrate_reads_sound_control_and_fault(tiny_root, capsys):
    """``calibrate.py`` on the CPU at the tiny size: the sound readings sit
    under the limits, the control's and the half-batch fault's above one."""
    import json

    from benchmark import calibrate

    root = tiny_root
    calibrate.main(["--workload", "tiny.tband", "--seeds", "1-2", "--control-seeds", "1",
                    "--fault-seeds", "2", "--device", "cpu", "--root", root])
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    limits = harness.load_cell("tiny.tband", root, f"{root}/benchmark")["limits"]
    by_kind = {r["kind"]: r for r in rows if "kind" in r}
    assert all(by_kind["sound"][k] <= v for k, v in limits.items())
    for kind in ("control", "half_batch"):
        assert any(by_kind[kind][k] > v for k, v in limits.items())
    assert rows[-1]["event"] == "calibrate"


@pytest.mark.parametrize("fault", ["rows_permuted", "sign_flipped"])
def test_wrong_direction_of_the_right_size_fails(fault):
    """A gradient and a change of the right norm but the wrong direction
    read far over every limit: the tensors are compared element by
    element, not by their norms."""
    from benchmark import check

    g = torch.Generator().manual_seed(0)
    w0 = [torch.randn(8, 4, generator=g) for _ in range(3)]
    grads = [torch.randn(8, 4, generator=g) for _ in range(3)]
    ref = {"losses": [1.0, 0.9], "first_grads": grads,
           "weights": [w - 0.01 * gr.sign() for w, gr in zip(w0, grads)]}
    bad = (lambda t: t.flip(0)) if fault == "rows_permuted" else (lambda t: -t)
    port = {"losses": [1.0, 0.9], "first_grads": [bad(t) for t in grads],
            "weights": [w - 0.01 * bad(gr.sign()) for w, gr in zip(w0, grads)]}
    vals = check.readings(port, ref, w0)
    assert vals["grad_gap"] > 0.5 and vals["change_gap"] > 0.5
    cells = [w["name"] for w in harness.load_spec()["workloads"]]
    loosest = max((harness.load_cell(c)["limits"] for c in cells),
                  key=lambda lim: lim["change_gap"])
    assert not check.judge(vals, loosest)
    assert check.readings(ref, ref, w0) == {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
