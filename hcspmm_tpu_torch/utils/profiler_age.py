"""How many of a short profile's kernel records ``torch.profiler`` keeps as
a process ages on the card.

    python -m hcspmm_tpu_torch.utils.profiler_age --probes 14 --every 20

Each probe launches a small kernel 20 times under ``torch.profiler``
(CPU and CUDA activities; the calls, then a synchronise), once as is and
once with the window held open 20 ms before and after the calls, with a
synchronise at each end; then takes ``utils/profiling.py``'s Chrome trace
of one launch.  It counts the kernel records each kept.  Between probes
the card runs small kernels for ``--every`` seconds.  Prints the card's
name and power limit, one line a probe, then one JSON line.  (This is why
``chip_smoke.py`` phase 24 checks its trace in a fresh process.)"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import torch

from hcspmm_tpu_torch.utils import profiling


def _kernels(prof) -> int:
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def probe(x, launches: int = 20, margin_s: float = 0.02) -> dict:
    """Kernel records kept of ``launches`` launches, bare and with the held
    window, and of one launch in a Chrome trace."""
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as bare:
        for _ in range(launches):
            x.add_(1)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as held:
        time.sleep(margin_s)
        torch.cuda.synchronize()
        for _ in range(launches):
            x.add_(1)
        torch.cuda.synchronize()
        time.sleep(margin_s)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profiling.trace(path):
            x.add_(1)
        with open(path) as f:
            traced = sum(e.get("cat") == "kernel" for e in json.load(f)["traceEvents"])
    return dict(bare=_kernels(bare), held=_kernels(held), trace=traced)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="torch.profiler's kept kernel records by process age")
    p.add_argument("--probes", type=int, default=14)
    p.add_argument("--every", type=float, default=20.0, help="seconds between probes")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_age needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    x = torch.zeros(1 << 20, device="cuda")
    t_start, rows = time.perf_counter(), []
    for _ in range(args.probes):
        row = dict(t_s=round(time.perf_counter() - t_start, 1), **probe(x))
        rows.append(row)
        print(row, flush=True)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.every:
            for _ in range(200):
                x.mul_(1.0000001)
            torch.cuda.synchronize()
    print(json.dumps(dict(event="profiler_age", launches=20, probes=rows)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
