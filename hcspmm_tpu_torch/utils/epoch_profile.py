"""Where a training epoch's device time goes, on one CUDA card.

    python -m hcspmm_tpu_torch.utils.epoch_profile --dataset g.npz \\
        --reorder cluster --profile-epochs 5

Takes the command line's flags (``train.cli``), builds the dataset, plan
and model as it does, runs the 9 warm-up epochs, then traces
``--profile-epochs`` epochs with torch.profiler and the program's spans on
(``utils.profiling``).  Prints one JSON line: the wall milliseconds per
epoch (host clock, ended by a synchronise), the device-busy milliseconds
and launches per epoch by the program span that launched each operation
(``profiling.launched_by``; ``no span`` for one launched outside every
span), and the share of the wall in which the device ran no operation.
Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

from hcspmm_tpu_torch.models.net import Net, init_net_params
from hcspmm_tpu_torch.train import cli
from hcspmm_tpu_torch.train.loop import layout_input, make_train_step
from hcspmm_tpu_torch.utils import profiling
from hcspmm_tpu_torch.utils.logging import stdout_logger

NO_SPAN = "no span"


def profile_steps(step, epochs: int) -> dict:
    """Wall ms an epoch, and device ms and launches an epoch by launching
    span, of ``epochs`` calls of ``step()`` under torch.profiler with the
    program's spans on (a synchronise ends them)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    profiling.reset()
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.tracing():
            t0 = time.perf_counter()
            for _ in range(epochs):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    names = {r["name"] for r in profiling.spans()}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    busy, launches = {}, {}
    for _, _, dur, owner in profiling.launched_by(events, names):
        key = owner or NO_SPAN
        busy[key] = busy.get(key, 0.0) + dur / 1e3
        launches[key] = launches.get(key, 0) + 1
    return {"wall_ms": wall_ms / epochs,
            "ms": {k: v / epochs for k, v in sorted(busy.items(), key=lambda kv: -kv[1])},
            "launches": {k: v / epochs for k, v in launches.items()}}


def main(argv=None) -> int:
    parser = cli.build_parser()
    parser.add_argument("--profile-epochs", type=int, default=5)
    args = parser.parse_args(argv)
    device = cli.resolve_device(args)
    if device.type != "cuda":
        raise RuntimeError("epoch_profile measures a CUDA device")
    ds, op = cli.prepare(args, device, stdout_logger(dataset=args.dataset))
    net = Net(model=args.model, num_features=ds.num_features, hidden=args.hidden,
              num_classes=args.classes, num_layers=args.num_layers)
    params = init_net_params(net, torch.Generator().manual_seed(args.seed), device=device)
    step = make_train_step(net, op, torch.optim.Adam(
        [t for layer in params for t in layer.values()], lr=0.01))
    x = layout_input(op, ds.x)
    y = torch.as_tensor(ds.y).to(device=device, dtype=torch.int64)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    for _ in range(9):
        step(params, x, y, gen)
    torch.cuda.synchronize()
    n = args.profile_epochs
    losses = []
    res = profile_steps(lambda: losses.append(step(params, x, y, gen)), n)
    total = sum(res["ms"].values())
    print(json.dumps({
        "event": "epoch_profile", "dataset": args.dataset, "model": args.model,
        "compute_dtype": args.compute_dtype, "epochs": n, "final_loss": float(losses[-1]),
        "wall_ms_per_epoch": res["wall_ms"], "busy_ms_per_epoch": total,
        "idle_share": 1.0 - total / res["wall_ms"],
        "ms_per_epoch": res["ms"], "launches_per_epoch": res["launches"],
        "device": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
