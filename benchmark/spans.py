"""The spans profile: device time of traced epochs by the program span that
launched each operation, and what the program's spans and counters say of
set-up (``hcspmm_tpu_torch.utils.profiling``).  The per-layer metrics
``kernels.scale_ms``, ``kernels.band_ms``, ``kernels.spill_ms``,
``kernels.spill_gedges_per_s`` and ``format.upload_s`` read it.

    python -m benchmark.spans --workload gcn6.gh --seed 1

It runs in a process of its own, which the first of those metrics' readers
starts in a traced run (``measure``): the harness's traced pass takes its
two profiles with the program's tracing off, and torch.profiler keeps fewer
kernel records the older a process is (PERF.md §7), so this profile is
taken, as those are, about half a minute into a fresh process.  That
process builds the cell's program as the harness does with the program's
tracing on through set-up, runs the warm-up with it off, then profiles
``PROFILED_EPOCHS`` epochs with it on, one call and a synchronise before
the window (``traces.WINDOW``), held against the launch counters and taken
again after a loss as the harness's profiles are; last, a step's host time
onto an empty queue with tracing off and on, in turns.  It prints one JSON
line.

Each device operation belongs to the innermost program span that launched
it: the host call of the same correlation id, on that call's thread, or on
any thread where that one has no span open (autograd's engine thread
between the SpMM's spans belongs to the step's ``train.backward``).  Never
the overlap of the device's interval with a host span: in a closed loop the
device runs up to an epoch behind the host.  A run fails where one of the
program's own kernels (group ``spmm`` of ``kernels/*.json``) was launched
outside every ``spmm.*`` span.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark import traces

#: Chrome-trace categories of the device's operations and of their launches
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "no program span"
SPMM = "spmm."
TIMEOUT_S = 900
TOP = 10

Op = Tuple[str, float, float, Optional[str], bool]  # name, start us, dur us, span, launch seen


def parse(events: Sequence[Dict], names) -> Tuple[List[Tuple], Dict, Dict]:
    """(device operations ``(name, start, dur, correlation)``, the launches
    ``correlation -> (thread, time)``, the program's ranges ``thread ->
    [(start, end, name)]``) of a Chrome trace's events, in us; ranges are
    the host annotations named in ``names``."""
    ops, launches, ranges = [], {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        if cat in DEVICE_CATS:
            ops.append((e.get("name", ""), float(e["ts"]), float(e.get("dur", 0)),
                        args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), float(e["ts"]))
        elif cat == "user_annotation" and e.get("name") in names:
            t0 = float(e["ts"])
            ranges.setdefault(e.get("tid"), []).append((t0, t0 + float(e.get("dur", 0)), e["name"]))
    return ops, launches, ranges


def window_of(events: Sequence[Dict], name: str = traces.WINDOW) -> Tuple[float, float]:
    """(start, end) us of the host range ``name`` in a Chrome trace."""
    e = next(e for e in events if e.get("cat") == "user_annotation" and e.get("name") == name)
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))


def _innermost(rs, t) -> Optional[Tuple[float, str]]:
    best = None
    for r0, r1, name in rs:
        if r0 <= t <= r1 and (best is None or r0 >= best[0]):
            best = (r0, name)
    return best


def span_at(ranges: Dict, t: float, thread=None) -> Optional[str]:
    """The innermost range open at ``t`` on ``thread``, or, where none is
    open there, on any thread (the latest to start)."""
    best = _innermost(ranges.get(thread, ()), t) if thread is not None else None
    if best is None:
        cands = [b for rs in ranges.values() for b in [_innermost(rs, t)] if b]
        best = max(cands) if cands else None
    return best[1] if best else None


def attribute(ops, launches, ranges) -> List[Op]:
    """Each operation with the span open at its launch: ``(name, start,
    dur, span or None, launch seen)``."""
    out = []
    for name, t0, dur, corr in ops:
        if corr in launches:
            tid, t = launches[corr]
            out.append((name, t0, dur, span_at(ranges, t, tid), True))
        else:
            out.append((name, t0, dur, None, False))
    return out


def reduce(ops: Sequence[Op], ranges: Dict, window: Tuple[float, float], table,
           top: int = TOP) -> Dict:
    """Over the operations that start in ``window`` (us): device ms by
    launching span (``NO_SPAN`` outside every one), the program's kernels
    launched outside every ``spmm.*`` span and those whose launch the trace
    lost, the ``top`` other operations by ms inside each ``spmm.*`` span, the
    busy and wall seconds, and the ``top`` longest idle gaps, each named by
    the innermost program span open on the host at its middle."""
    w0, w1 = window
    ops = [o for o in ops if w0 <= o[1] < w1]
    ms: Dict[str, float] = {}
    others: Dict[str, Dict[str, float]] = {}  # spmm.* span -> other operations' ms by name
    outside, lost = [], []
    for name, _, dur, owner, seen in ops:
        key = owner or NO_SPAN
        ms[key] = ms.get(key, 0.0) + dur / 1e3
        if traces.group_of(name, table) == traces.PORT_GROUP:
            if not seen:
                lost.append(name[:200])
            elif not key.startswith(SPMM):
                outside.append([name[:200], key])
        elif key.startswith(SPMM):
            by_name = others.setdefault(key, {})
            by_name[name[:120]] = by_name.get(name[:120], 0.0) + dur / 1e3
    merged = traces.union([(n, s, s + d) for n, s, d, _, _ in ops])
    spans = [(s, min(e, w1)) for s, e in merged]
    edges = [w0] + [v for sp in spans for v in sp] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    return {"ms": ms, "total_ms": sum(ms.values()), "port_outside_spmm": outside,
            "other_ops_in_spmm": {k: sorted(v.items(), key=lambda kv: -kv[1])[:top]
                                  for k, v in others.items()},
            "port_launch_lost": lost, "busy_s": sum(e - s for s, e in spans) / 1e6,
            "wall_s": (w1 - w0) / 1e6,
            "idle_gaps_by_span": [[(span_at(ranges, t0 + g / 2) or NO_SPAN)[:200], g / 1e6]
                                  for g, t0 in gaps]}


def check(red: Dict) -> None:
    """Raises where one of the program's own kernels was launched outside
    every ``spmm.*`` span."""
    if red["port_outside_spmm"]:
        raise RuntimeError("the program's kernels launched outside every spmm.* span: "
                           f"{red['port_outside_spmm'][:5]}")


def span_ms(red: Dict, name: str) -> float:
    """Device ms launched inside spans named ``name`` or under it
    (``name.*``)."""
    return sum(v for k, v in red["ms"].items() if k == name or k.startswith(name + "."))


def setup_of(recs: Sequence[Dict]) -> Dict:
    """Host seconds of set-up's spans: the reorder (outermost
    ``format.reorder`` spans), the plan, its phases, the upload, and any
    library build."""
    by_id = {r["id"]: r for r in recs}
    out: Dict[str, float] = {}
    for r in recs:
        if r["end_ns"] is None or r["name"] == "profiling.clock":
            continue
        parent = by_id.get(r["parent"])
        if r["name"] == "format.reorder" and parent and parent["name"] == "format.reorder":
            continue
        out[r["name"]] = out.get(r["name"], 0.0) + (r["end_ns"] - r["start_ns"]) / 1e9
    return out


# ---------------------------------------------------------------------------
# the profile, in a process of its own
# ---------------------------------------------------------------------------

def _chrome_events(prof) -> List[Dict]:
    import tempfile

    path = os.path.join(tempfile.gettempdir(), f"spans_{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        if os.path.exists(path):
            os.remove(path)


def profile_cell(name: str, seed: int, log) -> Dict:
    """Set-up with the program's tracing on, warm-up with it off, the spans
    profile, and a step's host time with tracing off and on."""
    import torch

    from benchmark import graphs, harness
    from hcspmm_tpu_torch.train import cli
    from hcspmm_tpu_torch.utils import profiling

    cell = harness.load_cell(name)
    cfg = cell["cfg"]
    dirs = harness.cache_dirs()
    device = cli.resolve_device(argparse.Namespace(device="auto"))
    rp, ci, n = graphs.load_csr(cell["traffic_spec"], dirs["graphs"])
    profiling.reset()
    with profiling.tracing():
        prog = harness.Program(cell, rp, ci, n, device, {})
    setup = setup_of(profiling.spans())
    profiling.reset()
    x, y = harness.make_inputs(cfg, n, seed, device)
    prog.start(x, y, harness.make_weights(cfg, cell["reference"].layer_shapes(cfg), seed,
                                          device))
    del x, y
    gen = torch.Generator(device=device).manual_seed(harness.sub_seeds(seed)["dropout"])
    for _ in range(harness.WARMUP_STEPS):
        prog.step(gen)
    prog.sync()

    table, counters = traces.kernel_table(), traces.port_counters()
    count = harness.PROFILED_EPOCHS
    for _ in range(harness.PROFILE_ATTEMPTS):
        counts, edges = [], []

        def body():
            with profiling.tracing():
                prog.step(gen)
                prog.sync()
                counts.append(traces.read_counters(counters))
                edges.append(profiling.counters().get("spmm.spill_edges", 0))
                with torch.profiler.record_function(traces.WINDOW):
                    for _ in range(count):
                        prog.step(gen)
                    prog.sync()
                counts.append(traces.read_counters(counters))
                edges.append(profiling.counters().get("spmm.spill_edges", 0))
            time.sleep(harness.PROFILE_MARGIN_S)

        profiling.reset()
        prof = harness._profile(body, device)
        names = {r["name"] for r in profiling.spans()} - {profiling.CLOCK}
        events = _chrome_events(prof)
        dev, host = traces.split_events(prof)
        fe_window = traces.window_of(host)  # torch.profiler's events count from the trace's start
        kept = traces.reduce(dev, host, table, fe_window)["launches"].get(traces.PORT_GROUP, 0)
        ops, launches, ranges = parse(events, names)
        red = reduce(attribute(ops, launches, ranges), ranges, window_of(events), table)
        counted = counts[1] - counts[0]
        log(f"spans profile: {kept} of the program's kernels kept, {counted} counted, "
            f"{len(red['port_launch_lost'])} without their launch")
        del prof
        if kept >= counted and not red["port_launch_lost"]:
            break
    else:
        raise RuntimeError(f"the spans profile lost kernel or launch records "
                           f"{harness.PROFILE_ATTEMPTS} times")
    check(red)
    events_ms = sum(e - s for _, s, e in dev if fe_window[0] <= s < fe_window[1]) / 1e3

    host_ms = {"off": [], "on": []}
    profiling.reset()
    for i in range(2 * harness.ENQUEUE_EPOCHS):
        key = ("off", "on")[i % 2]
        prog.sync()
        with (profiling.tracing() if key == "on" else contextlib.nullcontext()):
            t0 = time.perf_counter()
            prog.step(gen)
            host_ms[key].append((time.perf_counter() - t0) * 1e3)
    prog.sync()
    step_ms = [(r["end_ns"] - r["start_ns"]) / 1e6 for r in profiling.spans()
               if r["name"] == "train.step"]
    return {"cell": name, "epochs": count, "setup": setup, "window": red,
            "spill_edges": edges[1] - edges[0], "events_ms": events_ms,
            "enqueue_ms": {k: statistics.median(v) for k, v in host_ms.items()},
            "step_span_ms": statistics.median(step_ms),
            "device": torch.cuda.get_device_name(device)}


def _run_seed(argv: Sequence[str]) -> int:
    """The ``--seed`` of the benchmark run that reads the metrics."""
    for i, a in enumerate(argv):
        if a == "--seed" and i + 1 < len(argv):
            return int(argv[i + 1])
        if a.startswith("--seed="):
            return int(a.split("=", 1)[1])
    return 0


def measure(rec: Dict) -> Optional[Dict]:
    """The spans profile of ``rec``'s cell, taken once a run (kept in
    ``rec``); None on a CPU run, or for a program without spans."""
    if "spans_profile" in rec:
        return rec["spans_profile"]
    rec["spans_profile"] = None
    if rec.get("device_kind", "cpu") == "cpu":
        return None
    from hcspmm_tpu_torch.utils import profiling

    if not hasattr(profiling, "tracing"):
        return None
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "benchmark.spans", "--workload", rec["cell"],
           "--seed", str(_run_seed(sys.argv))]
    res = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=TIMEOUT_S)
    sys.stderr.write(res.stderr[-20000:])
    if res.returncode != 0:
        raise RuntimeError(f"the spans profile failed (exit {res.returncode})")
    sp = json.loads(res.stdout.strip().splitlines()[-1])
    t = rec.get("traced") or {}
    if t.get("epochs"):
        ep = t["epochs"]
        sys.stderr.write(f"spans profile: wall {sp['window']['wall_s'] / sp['epochs'] * 1e3:.3f} "
                         f"ms an epoch with the program's tracing on, against "
                         f"{ep['wall_s'] / ep['calls'] * 1e3:.3f} off (the epochs profile)\n")
    rec["spans_profile"] = sp
    return sp


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the spans profile of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = profile_cell(args.workload, args.seed, log)
    red = out["window"]
    log(f"spans profile: device ms an epoch by launching span: "
        + ", ".join(f"{k} {v / out['epochs']:.4f}" for k, v in
                    sorted(red["ms"].items(), key=lambda kv: -kv[1])))
    log(f"spans profile: attributed {red['total_ms']:.4f} ms against {out['events_ms']:.4f} ms "
        f"of the profile's device operations; set-up "
        + ", ".join(f"{k} {v:.4f} s" for k, v in out["setup"].items()))
    log(f"spans profile: busy {red['busy_s']:.6f} s of {red['wall_s']:.6f} s; operations other "
        f"than the program's kernels inside its spmm.* spans, ms over the profile: "
        f"{red['other_ops_in_spmm']}")
    log(f"spans profile: idle gaps by span {red['idle_gaps_by_span']}; step host ms onto an "
        f"empty queue, tracing off {out['enqueue_ms']['off']:.3f}, on "
        f"{out['enqueue_ms']['on']:.3f} (its train.step span {out['step_span_ms']:.3f})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
