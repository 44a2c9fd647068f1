"""One run of one cell: set-up, the measured window of training epochs, an
optional traced pass, the check of the first steps against the plain
reference, and the result line.

Everything a cell is sits in files found by name: the cell in
``workloads/<cell>.json`` (its configuration, its traffic and its limits),
the configuration in the file ``BENCHMARK.json`` gives it, the traffic in
``traffic/<traffic>.json``, each metric in ``metrics/<metric>.py`` (a
``read(rec)`` that returns a number or None) and the kernel groups in
``kernels/*.json``, and the plain reference a configuration names in
``reference/<name>.py``.  ``BENCHMARK.json`` says which metrics a cell
reports.

The window drives the program's own training path, the one
``python -m hcspmm_tpu_torch.train.cli`` takes: the device from
``train.cli.resolve_device``, the port's reorder, ``HybridSpMM`` with the
CLI's layout rule, ``models.net.Net`` and the step of
``train.loop.make_train_step``, epoch after epoch with no synchronise
between them.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

#: top-level module names that must never be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "hcspmm_tpu")

CHECKED_STEPS = 3      # steps the reference follows
WARMUP_STEPS = 9       # train.loop.train's warm-up, the checked steps among them
PROFILED_EPOCHS = 5    # the traced pass
SPMM_CALLS = 10        # apply_padded calls profiled for the roofline
ENQUEUE_EPOCHS = 10    # epochs timed alone for the host's enqueue time
PROFILE_ATTEMPTS = 3   # profiles taken before a traced run gives up on lost records
PROFILE_MARGIN_S = 0.02  # held after a profile's window, before the profiler stops


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


# ---------------------------------------------------------------------------
# the cell's files
# ---------------------------------------------------------------------------

def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> Dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def load_cell(name: str, root: str = ROOT, bench_dir: str = BENCH_DIR) -> Dict:
    """The cell ``name``: its workload file with the configuration and the
    traffic it names read in, and its entry of ``BENCHMARK.json``."""
    spec = load_spec(root)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = _json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    for key in ("config", "traffic"):
        if cell[key] != entry[key]:
            raise ValueError(f"{name}: {key} {cell[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cell["name"] = name
    cell["chips"] = int(entry["chips"])
    cell["cfg"] = _json(os.path.join(root, conf["file"]))
    cell["traffic_spec"] = _json(os.path.join(bench_dir, "traffic", f"{cell['traffic']}.json"))
    cell["metrics"] = metrics_of(spec, name)
    cell["reference"] = reference_of(cell["cfg"], bench_dir)
    return cell


def reference_of(cfg: Dict, bench_dir: str = BENCH_DIR):
    """The plain reference module ``cfg`` names, checked to stand for its
    model, and its weight initialisation checked to be one the harness
    draws."""
    from benchmark import reference

    ref = reference.load(cfg["reference"], bench_dir)
    if cfg["model"] not in ref.MODELS:
        raise ValueError(f"{cfg['name']}: reference {cfg['reference']!r} stands for "
                         f"{ref.MODELS}, not the model {cfg['model']!r}")
    if cfg["init"] not in INITS:
        raise ValueError(f"{cfg['name']}: init {cfg['init']!r} is none of {sorted(INITS)}")
    return ref


def metrics_of(spec: Dict, cell: str) -> Dict[str, List[Dict]]:
    """The cell's end-to-end and per-layer metrics: those whose
    ``workloads`` list it, or that have no such list."""
    return {kind: [m for m in spec[kind] if cell in m.get("workloads", [cell])]
            for kind in ("end_to_end", "per_layer")}


def load_reader(name: str, bench_dir: str = BENCH_DIR):
    """``read(rec)`` of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs(root: str = ROOT) -> Dict[str, str]:
    """Fixed directories inside the checkout for what the run and the
    program cache, made and put to use: the graphs, the program's native
    host libraries (it builds them into ``tempfile.gettempdir()``) and any
    kernel cache."""
    base = os.path.join(root, ".benchcache")
    dirs = {k: os.path.join(base, k) for k in ("graphs", "tmp", "triton", "torch_extensions")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    tempfile.tempdir = dirs["tmp"]
    os.environ["TRITON_CACHE_DIR"] = dirs["triton"]
    os.environ["TORCH_EXTENSIONS_DIR"] = dirs["torch_extensions"]
    return dirs


# ---------------------------------------------------------------------------
# inputs from the seed
# ---------------------------------------------------------------------------

def sub_seeds(seed: int) -> Dict[str, int]:
    """Independent seeds for the features, labels, weights and dropout."""
    words = np.random.SeedSequence(int(seed)).generate_state(4, dtype=np.uint64)
    return {k: int(v) & ((1 << 63) - 1)
            for k, v in zip(("features", "labels", "weights", "dropout"), words)}


def make_inputs(cfg: Dict, n: int, seed: int, device):
    """Features [n, dim] and labels [n] in the generator's node order."""
    import torch

    s = sub_seeds(seed)
    g = torch.Generator(device=device).manual_seed(s["features"])
    x = torch.randn((n, cfg["dim"]), generator=g, device=device, dtype=torch.float32)
    if cfg["labels"] == "ones":
        y = torch.ones(n, dtype=torch.int64, device=device)
    elif cfg["labels"] == "uniform":
        g = torch.Generator(device=device).manual_seed(s["labels"])
        y = torch.randint(0, cfg["classes"], (n,), generator=g, device=device)
    else:
        raise ValueError(f"unknown labels {cfg['labels']!r}")
    return x, y


#: a configuration's ``init``: the scale of a standard normal [d_in, d_out] leaf
INITS = {"glorot": lambda din, dout: math.sqrt(2.0 / (din + dout))}


def make_weights(cfg: Dict, shapes, seed: int, device):
    """One leaf of each of ``shapes`` (the reference's ``layer_shapes``),
    drawn on the device by the configuration's ``init``."""
    import torch

    g = torch.Generator(device=device).manual_seed(sub_seeds(seed)["weights"])
    out = []
    for din, dout in shapes:
        w = torch.randn((din, dout), generator=g, device=device, dtype=torch.float32)
        out.append((w * INITS[cfg["init"]](din, dout)).requires_grad_(True))
    return out


def dropout_masks(cfg: Dict, seed: int, shape, transposed: bool, n: int, perm, device):
    """Callables giving each checked step's keep-mask [n, hidden] in the
    generator's node order, drawn as the training step draws its dropout
    (``torch.rand`` of the first layer's padded activation from the
    dropout generator): ``shape`` is that activation's shape, ``transposed``
    its layout (features by nodes), ``perm[i]`` the generator node at
    position i."""
    import torch

    keep = 1.0 - cfg["dropout"]
    g = torch.Generator(device=device).manual_seed(sub_seeds(seed)["dropout"])
    hidden = cfg["hidden"]

    def one():
        m = torch.rand(shape, generator=g, device=device) < keep
        nodes = m[:hidden, :n].T if transposed else m[:n, :hidden]
        out = torch.empty((n, hidden), dtype=torch.bool, device=device)
        out[perm] = nodes
        return out

    # drawn in step order: each callable draws when the reference calls it
    return [one for _ in range(CHECKED_STEPS)] if cfg["dropout"] > 0 else [None] * CHECKED_STEPS


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

def built_libraries() -> set:
    """The program's CUDA libraries built so far in this checkout.  The
    program builds those it loads on first use (``kernels/_build.py``);
    one that appears during a run was compiled by it, and that run's
    ``setup_s`` holds the compilation."""
    from hcspmm_tpu_torch.kernels import _build

    d = _build.BUILD_DIR
    return {f for f in os.listdir(d) if f.endswith(".so")} if os.path.isdir(d) else set()


def check_precision(cfg: Dict, device) -> None:
    """The device as ``train.cli.resolve_device`` left it computes in the
    configuration's precision: TF32 as its ``tf32`` says."""
    import torch

    tf32 = device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32
    if bool(tf32) != bool(cfg["tf32"]):
        raise ValueError(f"{cfg['name']}: tf32 {cfg['tf32']} in the configuration, "
                         f"{bool(tf32)} on the program's device")


def layout_of(cfg: Dict) -> str:
    """The CLI's layout rule (``train.cli.prepare``)."""
    return "tband" if max(cfg["hidden"], cfg["classes"]) <= 64 else "wide"


def plan_config(cfg: Dict, compute_dtype: Optional[str] = None):
    """The CLI's PlanConfig for ``cfg`` (its defaults for every flag)."""
    from hcspmm_tpu_torch.config import PlanConfig
    from hcspmm_tpu_torch.train import cli

    d = cli.build_parser().parse_args([])
    return PlanConfig(
        bucket_widths=tuple(int(v) for v in d.bucket_widths.split(",")),
        loi_mode=d.loi_mode, compute_dtype=compute_dtype or cfg["dtype"], impl=d.impl,
        band_impl=layout_of(cfg), spill_impl=d.spill_impl)


class Program:
    """The system under test for one cell: graph in the port's order,
    operator, model, optimizer and step, built as the CLI builds them."""

    def __init__(self, cell: Dict, rp, ci, n: int, device, spans: Dict[str, float],
                 compute_dtype: Optional[str] = None, perm=None):
        import torch

        from hcspmm_tpu_torch.format import reorder as _reorder
        from hcspmm_tpu_torch.ops.spmm import HybridSpMM

        self.cfg, self.n, self.device = cell["cfg"], n, device
        traffic = cell["traffic_spec"]
        t0 = time.perf_counter()
        if perm is None:
            fn = {"cluster": _reorder.cluster_reorder, "rcm": _reorder.rcm_reorder,
                  "loa": _reorder.loa_reorder}[traffic["reorder"]]
            perm = np.asarray(fn(rp, ci, n))
        rp_p, ci_p = _reorder.apply_permutation(rp, ci, n, perm)
        spans["format.reorder_s"] = time.perf_counter() - t0
        self.perm = perm
        t0 = time.perf_counter()
        self.op = HybridSpMM(rp_p, ci_p, n, plan_config(self.cfg, compute_dtype),
                             normalize=self.cfg["normalize"], device=device)
        self.sync()
        spans["format.plan_s"] = time.perf_counter() - t0
        probe = self.op.pad_input(torch.zeros((n, self.cfg["hidden"]), device=device))
        self.act_shape, self.transposed = tuple(probe.shape), bool(self.op.transposed)
        del probe

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self, x, y, weights):
        """Binds the inputs (generator order) and the weights, and builds
        the optimizer and the step the window calls."""
        import torch

        from hcspmm_tpu_torch.models.net import Net
        from hcspmm_tpu_torch.train.loop import layout_input, make_train_step

        cfg = self.cfg
        perm_t = torch.as_tensor(self.perm, device=self.device)
        self.x = layout_input(self.op, x[perm_t])
        self.y = y[perm_t]
        self.weights = weights
        self.params = [{"weights": w} for w in weights]
        self.net = Net(model=cfg["model"], num_features=cfg["dim"], hidden=cfg["hidden"],
                       num_classes=cfg["classes"], num_layers=cfg["num_layers"],
                       dropout=cfg["dropout"])
        self.opt = torch.optim.Adam(weights, lr=cfg["lr"], betas=tuple(cfg["betas"]),
                                    eps=cfg["eps"])
        self.step_fn = make_train_step(self.net, self.op, self.opt)

    def step(self, gen):
        return self.step_fn(self.params, self.x, self.y, gen)

    def first_grads(self):
        """The first step's gradients as the optimizer got them: Adam's
        first moment after one step over (1 - beta1); zeros for a leaf the
        optimizer holds no state for."""
        import torch

        b1 = self.cfg["betas"][0]
        st = self.opt.state
        return [st[w]["exp_avg"].detach().clone() / (1 - b1) if "exp_avg" in st.get(w, {})
                else torch.zeros_like(w) for w in self.weights]


def checked_steps(prog: Program, gen) -> Dict:
    """The first ``CHECKED_STEPS`` steps through the window's own call,
    with what the reference is held against (kept on the device)."""
    losses, grads = [], None
    for k in range(CHECKED_STEPS):
        losses.append(prog.step(gen))
        if k == 0:
            grads = prog.first_grads()
    return {"losses": losses, "first_grads": grads,
            "weights": [w.detach().clone() for w in prog.weights]}


def reference_run(cell: Dict, rp, ci, n: int, seed: int, perm, act_shape, transposed: bool,
                  device, graph=None, loss_rows=None):
    """The reference's checked steps from the seed's inputs, weights and
    dropout masks: (its record, the weights it started from).  ``graph``
    is the reference's ``prepare`` of the graph where the caller has it."""
    import torch

    cfg, ref_mod = cell["cfg"], cell["reference"]
    graph = graph or ref_mod.prepare(rp, ci, n, cfg, device)
    x, y = make_inputs(cfg, n, seed, device)
    w0 = [w.detach() for w in make_weights(cfg, ref_mod.layer_shapes(cfg), seed, device)]
    masks = dropout_masks(cfg, seed, act_shape, transposed, n,
                          torch.as_tensor(perm, device=device), device)
    ref = ref_mod.train_steps(cfg, graph, w0, x, y, masks, loss_rows=loss_rows)
    return ref, w0


def port_record(port: Dict) -> Dict:
    """The checked steps' record with the losses read back."""
    return dict(port, losses=[float(v) for v in port["losses"]])


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def _window(prog: Program, gen, seconds: float) -> Dict:
    """Closed loop of epochs for ``seconds`` of host time, then a
    synchronise: the wall over the epochs issued, and each epoch's time
    from stream events (host clock where there is no card)."""
    import torch

    cuda = prog.device.type == "cuda"
    marks, losses, host = [], [], []
    t0, t0_unix = time.perf_counter(), time.time()
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    else:
        marks.append(t0)
    while True:
        losses.append(prog.step(gen))
        host.append(time.perf_counter())
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())
        if time.perf_counter() - t0 >= seconds:
            break
    prog.sync()
    wall = time.perf_counter() - t0
    if cuda:
        times = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        times = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    return {"epochs": len(losses), "wall_s": wall, "epoch_ms": wall * 1e3 / len(losses),
            "epoch_times_ms": times, "failed": failed,
            "host_gaps_ms": np.diff(np.asarray([t0] + host) * 1e3).tolist(), "t0_unix": t0_unix}


def window_summary(win: Dict) -> str:
    """One line on the window's epoch times: quantiles, which epochs ran
    over 1% above the median, and the host's longest waits between two
    step calls returning (where the host stalls longer than the queue
    holds, the device idles)."""
    t = np.asarray(win["epoch_times_ms"])
    med = float(np.median(t))
    slow = np.flatnonzero(t > 1.01 * med)
    q = np.percentile(t, [0, 50, 90, 95, 99, 100])
    h = np.asarray(win["host_gaps_ms"])
    top = np.argsort(h)[::-1][:5]
    return (f"window: from unix {win['t0_unix']:.3f}, {win['epochs']} epochs in "
            f"{win['wall_s']:.3f} s; epoch ms min/p50/p90/"
            f"p95/p99/max {' '.join(f'{v:.4f}' for v in q)}; {len(slow)} over 1.01x the "
            f"median, at {slow[:60].tolist()}; host gaps ms p50 {np.median(h):.3f}, longest "
            f"{[(int(i), round(float(h[i]), 3)) for i in top]}")


def _profile(fn, device):
    import warnings

    import torch

    # one profile a call: its note on events cleared between cycles says nothing here
    warnings.filterwarnings("ignore", message="Warning: Profiler clears events")

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    return prof


def _traced_pass(prog: Program, gen, cell: Dict, seed: int, log) -> Dict:
    """Early in the process, right after warm-up: ``PROFILED_EPOCHS``
    epochs and ``SPMM_CALLS`` forward SpMMs at the hidden width under
    torch.profiler, each held against the program's launch counters; then
    the host's time to issue an epoch onto an empty queue.  Each profile
    runs one call and a synchronise before its window (the
    ``traces.WINDOW`` range), so the profiler's own start-up falls outside
    it.  torch.profiler can drop a kernel record: a profile that holds
    fewer of the program's kernels than its counters counted is taken
    again, and a traced run fails after ``PROFILE_ATTEMPTS`` such."""
    import torch

    from benchmark import traces as trace

    table, counters = trace.kernel_table(), trace.port_counters()
    out = {}
    for label, count, fn in (
            ("epochs", PROFILED_EPOCHS, lambda: prog.step(gen)),
            ("spmm", SPMM_CALLS, None)):
        if fn is None:
            g = torch.Generator(device=prog.device).manual_seed(sub_seeds(seed)["features"])
            xr = prog.op.pad_input(torch.randn((prog.n, cell["cfg"]["hidden"]), generator=g,
                                               device=prog.device))
            fn = lambda: prog.op.apply_padded(prog.op.arrays, xr)  # noqa: E731
        counts = []

        def body():
            fn()
            prog.sync()
            counts.append(trace.read_counters(counters))
            with torch.profiler.record_function(trace.WINDOW):
                for _ in range(count):
                    fn()
                prog.sync()
            counts.append(trace.read_counters(counters))
            time.sleep(PROFILE_MARGIN_S)

        for _ in range(PROFILE_ATTEMPTS):
            counts.clear()
            prof = _profile(body, prog.device)
            counted = counts[1] - counts[0]
            dev, host = trace.split_events(prof)
            red = trace.reduce(dev, host, table, trace.window_of(host))
            red.update(calls=count, counted_launches=counted)
            seen = red["launches"].get(trace.PORT_GROUP, 0)
            log(f"{label} profile: {seen} of the program's kernels kept, {counted} counted; "
                f"busy {red['busy_s']:.6f} s of {red['wall_s']:.6f} s")
            del prof, dev, host
            if seen >= counted:
                break
        else:
            raise RuntimeError(f"the {label} profile held fewer of the program's kernels than "
                               f"its counters counted, {PROFILE_ATTEMPTS} times: the trace "
                               "lost records")
        out[label] = red
    enqueue = []
    for _ in range(ENQUEUE_EPOCHS):
        prog.sync()
        t0 = time.perf_counter()
        prog.step(gen)
        enqueue.append((time.perf_counter() - t0) * 1e3)
    prog.sync()
    out["enqueue_ms"] = enqueue
    return out


def run_cell(name: str, seed: int, seconds: float, trace_on: bool, device_kind: str = "cuda",
             t_start: Optional[float] = None, root: str = ROOT, bench_dir: str = BENCH_DIR,
             log=None) -> Dict:
    """One run of cell ``name``; returns the result line's object.  Raises
    NoDevice where the machine lacks the cards the cell asks for."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = load_cell(name, root, bench_dir)
    cfg = cell["cfg"]

    import torch

    if device_kind == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < cell["chips"]):
        raise NoDevice(f"{name} needs {cell['chips']} CUDA card(s)")
    dirs = cache_dirs(root)

    from benchmark import check, graphs
    from hcspmm_tpu_torch.train import cli

    device = cli.resolve_device(argparse.Namespace(
        device="auto" if device_kind == "cuda" else "cpu"))
    check_precision(cfg, device)
    spans: Dict[str, float] = {}
    libs_before = built_libraries()
    rp, ci, n = graphs.load_csr(cell["traffic_spec"], dirs["graphs"])
    prog = Program(cell, rp, ci, n, device, spans)
    if not (len(prog.perm) == n and np.array_equal(np.bincount(prog.perm, minlength=n),
                                                   np.ones(n, dtype=np.int64))):
        raise RuntimeError("the port's reorder returned no permutation of the nodes")
    x, y = make_inputs(cfg, n, seed, device)
    prog.start(x, y, make_weights(cfg, cell["reference"].layer_shapes(cfg), seed, device))
    del x, y
    gen = torch.Generator(device=device).manual_seed(sub_seeds(seed)["dropout"])
    port = checked_steps(prog, gen)
    for _ in range(WARMUP_STEPS - CHECKED_STEPS):
        prog.step(gen)
    prog.sync()
    setup_s = time.perf_counter() - t_start
    built = sorted(built_libraries() - libs_before)
    log(f"{name}: set-up {setup_s:.3f} s (reorder {spans['format.reorder_s']:.3f} s, "
        f"plan {spans['format.plan_s']:.3f} s), {n} nodes, {len(ci)} nnz; "
        + (f"compiled in set-up: {', '.join(built)}" if built else "nothing compiled"))

    traced = _traced_pass(prog, gen, cell, seed, log) if trace_on else None
    win = _window(prog, gen, seconds)
    log(window_summary(win))
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0

    # the reference, once the program's state is freed
    perm, act_shape, transposed = prog.perm, prog.act_shape, prog.transposed
    port = port_record(port)
    del prog, gen
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref, w0 = reference_run(cell, rp, ci, n, seed, perm, act_shape, transposed, device)
    values = check.readings(port, ref, w0)
    del ref
    limits = cell["limits"]
    correct = check.judge(values, limits)
    log(f"{name}: reference check {time.perf_counter() - t0:.3f} s")

    rec = {"cell": name, "cfg": cfg, "reference": cell["reference"], "nodes": n,
           "nnz": int(len(ci)), "setup_s": setup_s, "spans": spans, "window": win,
           "peak_bytes": peak, "traced": traced,
           "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    kind = "per_layer" if trace_on else "end_to_end"
    metrics = {}
    for m in cell["metrics"][kind]:
        value = load_reader(m["name"], bench_dir)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": rec["device_kind"], "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": win["epochs"] + CHECKED_STEPS,
              "failed": win["failed"], "metrics": metrics, "device": dev}
    if traced:
        ep = traced["epochs"]
        dev["busy_s"], dev["window_s"] = ep["busy_s"], ep["wall_s"]
        result["breakdown"] = {"device_ops": ep["device_ops"], "idle_gaps": ep["idle_gaps"]}
    result["checks"] = {k: {"value": values[k] if math.isfinite(values[k]) else None,
                            "limit": limits[k]} for k in limits}
    return result


def report(result: Dict, out=sys.stdout, err=sys.stderr) -> None:
    """The numbers compared beside their limits as the last lines on
    standard error, then the result as the last line of standard output."""
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p
