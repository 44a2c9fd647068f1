"""Elastic training: failure detection + restart-from-checkpoint; port of
hcspmm_tpu/train/elastic.py.

Device state is disposable: everything needed to continue training is
(params, absolute epoch), which ``train(checkpoint_every=...)`` persists
through utils.checkpoint's atomic writer.  Recovery is a host-side
supervisor loop: detect the worker's death, reload the newest intact
checkpoint, and relaunch for the remaining epochs.  Two entry points:

- ``run_with_recovery``: in-process; wraps ``train.loop.train`` in a retry
  loop.  Covers failures that surface as Python exceptions (CUDA errors,
  out of memory, the injected test faults).
- ``supervise``: out-of-process; relaunches the CLI
  (``python -m hcspmm_tpu_torch.train.cli``) as a subprocess, so it also
  covers hard crashes that take the whole interpreter down.
  ``python -m hcspmm_tpu_torch.train.elastic -- <cli args>``.

Fault injection: ``train(fault_epoch=N)`` / CLI ``--fault-epoch N`` kills
the worker at an exact absolute epoch, so the detection and resume path is
testable deterministically (tests/test_torch_elastic.py).
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Sequence

from hcspmm_tpu_torch.utils.checkpoint import load_pytree, save_pytree


def checkpoint_state(path: str):
    """(params, absolute_epoch) from the newest intact checkpoint, or
    (None, 0) when none exists.  A truncated/corrupt file (crash mid-write
    under a non-atomic writer, partial disk) counts as absent rather than
    fatal — the supervisor then restarts from scratch."""
    if not path:
        return None, 0
    try:
        params, meta = load_pytree(path)
    except (FileNotFoundError, ValueError, KeyError, OSError):
        return None, 0
    return params, int(meta.get("epoch", 0))


def run_with_recovery(
    net,
    spmm,
    x,
    y,
    *,
    epochs: int,
    checkpoint_path: str,
    checkpoint_every: int = 1,
    max_restarts: int = 5,
    fault_epochs: Sequence[int] = (),
    logger=None,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
    **train_kwargs,
) -> Dict:
    """Run ``train`` to ``epochs`` total epochs, restarting from the last
    checkpoint on failure (up to ``max_restarts`` times).

    ``fault_epochs`` injects one fault per attempt (first attempt gets
    ``fault_epochs[0]``, the first retry ``fault_epochs[1]``, ...) — test
    hook only.  Returns the final ``train`` result dict plus ``restarts``
    and ``resumed_from`` (the epoch each attempt continued at).
    """
    from hcspmm_tpu_torch.train.loop import train

    faults: List[int] = list(fault_epochs)
    restarts = 0
    resumed_from: List[int] = []
    while True:
        params, start = checkpoint_state(checkpoint_path)
        resumed_from.append(start)
        if start >= epochs:
            # a previous attempt finished right at its fault point; nothing
            # left to run — return the persisted state
            res = {"params": params, "final_loss": float("nan"),
                   "epoch_ms": 0.0, "total_s": 0.0}
            break
        try:
            res = train(
                net, spmm, x, y,
                epochs=epochs - start,
                init_params=params,
                start_epoch=start,
                checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every,
                fault_epoch=faults.pop(0) if faults else None,
                logger=logger,
                **train_kwargs,
            )
            break
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as exc:  # worker died: detect, log, resume
            restarts += 1
            if logger is not None:
                logger.log(event="worker_failure", restart=restarts,
                           error=repr(exc))
            if on_restart is not None:
                on_restart(restarts, exc)
            if restarts > max_restarts:
                raise RuntimeError(
                    f"elastic recovery exhausted after {max_restarts} "
                    f"restarts") from exc
    # completion marker: resume-after-done is a no-op
    save_pytree(checkpoint_path, res["params"],
                {"epoch": epochs, "loss": res.get("final_loss", float("nan"))})
    res["restarts"] = restarts
    res["resumed_from"] = resumed_from
    return res


def _subprocess_runner(argv: List[str]) -> int:
    return subprocess.call([sys.executable, "-m", "hcspmm_tpu_torch.train.cli"]
                           + argv)


def supervise(
    cli_argv: Sequence[str],
    *,
    checkpoint: str,
    total_epochs: int,
    checkpoint_every: int = 1,
    max_restarts: int = 5,
    fault_epoch: int = 0,
    runner: Callable[[List[str]], int] = _subprocess_runner,
) -> Dict:
    """Out-of-process supervisor: (re)launch the CLI until ``total_epochs``
    absolute epochs are checkpointed.

    ``cli_argv`` is the experiment spec WITHOUT --epochs/--checkpoint/
    --resume (the supervisor owns those).  ``fault_epoch`` > 0 is passed to
    the FIRST launch only (fault injection).  ``runner`` is the process
    launcher (argv -> exit code); injectable for tests.
    """
    base = [a for a in cli_argv]
    restarts = -1  # first launch is not a restart
    while True:
        _, done = checkpoint_state(checkpoint)
        if done >= total_epochs:
            return {"restarts": max(restarts, 0), "epochs": done,
                    "checkpoint": checkpoint}
        restarts += 1
        if restarts > max_restarts:
            raise RuntimeError(
                f"elastic recovery exhausted after {max_restarts} restarts "
                f"(reached epoch {done}/{total_epochs})")
        argv = base + [
            "--epochs", str(total_epochs - done),
            "--checkpoint", checkpoint,
            "--checkpoint-every", str(checkpoint_every),
        ]
        if os.path.exists(checkpoint) or os.path.exists(checkpoint + ".npz"):
            argv += ["--resume", checkpoint]
        if fault_epoch and restarts == 0:
            argv += ["--fault-epoch", str(fault_epoch)]
        rc = runner(argv)
        if rc == 0:
            _, done = checkpoint_state(checkpoint)
            return {"restarts": max(restarts, 0), "epochs": done,
                    "checkpoint": checkpoint}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="elastic supervisor for hcspmm_tpu_torch.train.cli",
        usage="python -m hcspmm_tpu_torch.train.elastic [options] -- <cli args>")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--total-epochs", type=int, required=True)
    p.add_argument("--checkpoint-every", type=int, default=1)
    p.add_argument("--max-restarts", type=int, default=5)
    p.add_argument("--fault-epoch", type=int, default=0,
                   help="inject a crash at this absolute epoch in the "
                        "first launch (fault-injection testing)")
    args, rest = p.parse_known_args(argv)
    if rest and rest[0] == "--":
        rest = rest[1:]
    res = supervise(
        rest,
        checkpoint=args.checkpoint,
        total_epochs=args.total_epochs,
        checkpoint_every=args.checkpoint_every,
        max_restarts=args.max_restarts,
        fault_epoch=args.fault_epoch,
    )
    print(f"elastic: done at epoch {res['epochs']} "
          f"after {res['restarts']} restart(s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
