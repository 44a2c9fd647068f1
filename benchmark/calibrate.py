"""The readings that a cell's correctness limits are set from, on the
card at the cell's own size, in one process:

    python3 benchmark/calibrate.py --workload gcn6.gh --seeds 101-112 \\
        --control-seeds 101-103 --fault-seeds 101-103 [--out FILE]

For each seed, the cell's first training steps through the program (as a
run takes them) against the plain reference, as ``check.readings``
compares them.  The control is the program with its own lower-precision
path switched on (``PlanConfig(compute_dtype="bfloat16")``, the cell's
precision being float32).  The fault is the reference put in the
program's place with half of the nodes left out of the loss, the mean
taken over the rest.  (A step that returns its state unchanged reads 1 on
``grad_gap`` and ``change_gap`` by their measure and needs no run.)
Prints one JSON line a reading and a summary: per number the lower
reading (the largest over the sound seeds) and the smallest reading of
the control and of the fault.
"""

import contextlib
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def seeds_of(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    import argparse

    from benchmark import check, graphs, harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default="")
    p.add_argument("--root", default=harness.ROOT, help="the checkout holding BENCHMARK.json")
    args = p.parse_args(argv)

    import torch

    from hcspmm_tpu_torch.train import cli

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("calibrate needs a CUDA card")
    dirs = harness.cache_dirs(args.root)
    cell = harness.load_cell(args.workload, args.root, os.path.join(args.root, "benchmark"))
    device = cli.resolve_device(argparse.Namespace(
        device="auto" if args.device == "cuda" else "cpu"))
    harness.check_precision(cell["cfg"], device)
    rp, ci, n = graphs.load_csr(cell["traffic_spec"], dirs["graphs"])
    prog = harness.Program(cell, rp, ci, n, device, {})
    control = harness.Program(cell, rp, ci, n, device, {}, compute_dtype="bfloat16",
                              perm=prog.perm)
    ref_mod = cell["reference"]
    graph = ref_mod.prepare(rp, ci, n, cell["cfg"], device)
    layout = (prog.perm, prog.act_shape, prog.transposed)
    half = torch.arange(n // 2, n, device=device)  # the nodes a half-batch keeps
    sound_seeds = seeds_of(args.seeds)
    control_seeds = seeds_of(args.control_seeds) if args.control_seeds else []
    fault_seeds = seeds_of(args.fault_seeds) if args.fault_seeds else []
    rows = []

    def program_steps(p, seed):
        x, y = harness.make_inputs(cell["cfg"], n, seed, device)
        p.start(x, y, harness.make_weights(cell["cfg"], ref_mod.layer_shapes(cell["cfg"]),
                                           seed, device))
        gen = torch.Generator(device=device).manual_seed(harness.sub_seeds(seed)["dropout"])
        rec = harness.port_record(harness.checked_steps(p, gen))
        p.x = p.y = p.opt = p.step_fn = None
        return rec

    with (open(args.out, "w") if args.out else contextlib.nullcontext()) as out:

        def emit(row):
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()

        for seed in sorted(set(sound_seeds) | set(control_seeds) | set(fault_seeds)):
            ref, w0 = harness.reference_run(cell, rp, ci, n, seed, *layout, device,
                                             graph=graph)
            if seed in sound_seeds:
                emit({"kind": "sound", "seed": seed,
                      **check.readings(program_steps(prog, seed), ref, w0)})
            if seed in control_seeds:
                emit({"kind": "control", "seed": seed,
                      **check.readings(program_steps(control, seed), ref, w0)})
            if seed in fault_seeds:
                bad, _ = harness.reference_run(cell, rp, ci, n, seed, *layout, device,
                                               graph=graph, loss_rows=half)
                emit({"kind": "half_batch", "seed": seed, **check.readings(bad, ref, w0)})
        summary = {"event": "calibrate", "workload": args.workload, "nodes": n,
                   "nnz": len(ci),
                   "device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                   "seconds": time.perf_counter() - T_START}
        for k in check.NUMBERS:
            for kind, pick in (("sound", max), ("control", min), ("half_batch", min)):
                vals = [r[k] for r in rows if r["kind"] == kind]
                if vals:
                    summary[f"{k}.{kind}"] = pick(vals)
        emit(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
