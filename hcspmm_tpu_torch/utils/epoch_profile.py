"""Where a training epoch's device time goes, on one CUDA card.

    python -m hcspmm_tpu_torch.utils.epoch_profile --dataset g.npz \\
        --reorder cluster --profile-epochs 5

Takes the command line's flags (``train.cli``), builds the dataset, plan
and model as it does, runs the 9 warm-up epochs, then traces
``--profile-epochs`` epochs with torch.profiler.  Prints one JSON line:
the wall milliseconds per epoch (host clock, ended by a synchronise), the
device-busy milliseconds per epoch by kernel group, and the share of the
wall in which the device ran no kernel.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import time

import torch

from hcspmm_tpu_torch.models.net import Net, init_net_params
from hcspmm_tpu_torch.train import cli
from hcspmm_tpu_torch.train.loop import layout_input, make_train_step
from hcspmm_tpu_torch.utils.logging import stdout_logger

#: kernel-name fragments -> group, first match wins
GROUPS = (
    ("fused_kernel", "fused kernel"),
    ("tiled_kernel", "tiled band kernel"),
    ("band_kernel", "band kernel"),
    ("dense_window_kernel", "dense window kernel"),
    ("ell_row_kernel", "ELL kernel"),
    ("merge_kernel", "spill merge"),
    ("mxgather_kernel", "mxgather"),
    ("zero_kernel", "zero-fill"),
    ("zero_rows_kernel", "zero-fill"),
    ("index", "takes and scatters"),
    ("gather", "takes and scatters"),
    ("gemm", "dense products"),
    ("cutlass", "dense products"),
    ("Memcpy", "copies"),
    ("Memset", "copies"),
)


def group_of(name: str) -> str:
    return next((g for frag, g in GROUPS if frag in name), "other")


def main(argv=None) -> int:
    parser = cli.build_parser()
    parser.add_argument("--profile-epochs", type=int, default=5)
    args = parser.parse_args(argv)
    cli._check_ported(args)
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
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            loss = step(params, x, y, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, launches = {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        g = group_of(evt.name)
        busy[g] = busy.get(g, 0.0) + (evt.time_range.end - evt.time_range.start) / 1e3
        launches[g] = launches.get(g, 0) + 1
    total = sum(busy.values())
    print(json.dumps({
        "event": "epoch_profile", "dataset": args.dataset, "model": args.model,
        "compute_dtype": args.compute_dtype, "epochs": n, "final_loss": float(loss),
        "wall_ms_per_epoch": wall_ms / n, "busy_ms_per_epoch": total / n,
        "idle_share": 1.0 - total / wall_ms,
        "ms_per_epoch": {g: v / n for g, v in sorted(busy.items(), key=lambda kv: -kv[1])},
        "launches_per_epoch": {g: v / n for g, v in launches.items()},
        "device": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
