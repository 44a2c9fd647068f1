"""Spans and counters inside the program, timing and roofline helpers;
port of hcspmm_tpu/utils/profiling.py for one NVIDIA H100.

Tracing is off by default.  ``tracing()`` turns it on for a block, and
``trace(path)`` writes a Chrome trace of a block with tracing on, so the
program's spans show as host ranges above the card's kernels.

- ``span(name)`` is a context manager around one piece of the program's
  work (``spanned(name)`` makes each call of a function one);
  ``phase(name)`` ends the current phase of the enclosing span and starts
  the next (for a long flat function: the enclosing span's end closes the
  last phase); ``count(name, n)`` adds to a counter.
- Off, a span site reads one module global and gets a shared no-op
  context: no clock, no allocation, no ``record_function``; ``count``
  returns at once.
- On, each span keeps a record (``spans()``): its name, start and end
  (``time.perf_counter_ns``), its id, its parent's id, the id of the
  training step it belongs to and the native id of its thread.  A span
  opened with ``step=True`` starts a new step; every span opened inside it
  shares its id.  Each thread keeps its own stack of open spans: a span
  opened on a thread with no open span (autograd's engine thread running a
  backward on the card) takes as parent the innermost span open on the
  step's thread, which during ``loss.backward()`` is the step's backward
  span, and the step's id.  Under an active ``torch.profiler`` each span
  also opens ``torch.profiler.record_function(name)``, so it is a host
  range on the profiler's clock (without one, no range: it would cost
  about 13 us a span and show nowhere).  Each ``tracing()`` block records
  one anchor span, ``profiling.clock``: its trace range and its record
  place any other record on the trace's timeline (``to_trace_us``).
  ``launched_by`` gives each device operation of a Chrome trace to the
  span that launched it.
- ``record_build(name)`` counts a library build under
  ``build.compiled.<name>`` whether tracing is on or off: it happens at most
  once a process, outside any step, and the CLI's ``done`` line reports it.

``time_fn`` averages a function's host time over many calls;
``device_time`` reads the card's own kernel time from ``torch.profiler``;
``roofline`` compares a time with the card's published peaks.  A time taken
on the CPU is a host time: ``device_time`` raises without a card rather
than report one.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

#: One H100 SXM, NVIDIA's data sheet (dense rates, at the 700 W limit): HBM3
#: bytes a second and peak operations a second, fp32 outside the tensor
#: cores and bf16 on them (the constants PERF.md's bounds use).
H100_HBM_GBPS = 3350.0
H100_FP32_TFLOPS = 67.0
H100_BF16_TFLOPS = 989.0

#: the anchor span each ``tracing()`` block records
CLOCK = "profiling.clock"

_on = False  # the one global every span site reads
_lock = threading.Lock()
_local = threading.local()  # .t: (the thread's open spans, innermost last; its native id)
_records: List["_Span"] = []
_counters: Dict[str, int] = {}
_ids = itertools.count(1)
_step_ids = itertools.count(1)
_step: Optional["_Span"] = None  # the open step span


class _Null:
    """The shared context of a span site while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _thread() -> tuple:
    """(open spans, native id) of this thread; the id is read once, since a
    system call can cost tens of us on some hosts."""
    t = getattr(_local, "t", None)
    if t is None:
        t = _local.t = ([], threading.get_native_id())
    return t


class _Span:
    """One span's record, and the context that opens and closes it."""

    __slots__ = ("id", "name", "parent", "step", "thread", "start_ns", "end_ns",
                 "is_phase", "is_step", "_stack", "_rf")

    def __init__(self, name: str, is_step: bool = False, is_phase: bool = False):
        self.name, self.is_step, self.is_phase = name, is_step, is_phase
        self.end_ns = None

    def __enter__(self):
        global _step
        stack, self.thread = _thread()
        owner = stack[-1] if stack else None
        if owner is None and _step is not None and _step._stack:
            owner = _step._stack[-1]  # another thread's work for the open step
        self.parent = owner.id if owner is not None else None
        self.step = owner.step if owner is not None else None
        self.id = next(_ids)
        if self.is_step:
            self.step = next(_step_ids)
            _step = self
        self._stack = stack
        self._rf = None
        if torch.autograd._profiler_enabled():  # a range costs about 13 us: only where seen
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        stack.append(self)
        _records.append(self)  # one bytecode under the GIL
        return self

    def __exit__(self, *exc):
        stack = self._stack
        while stack and stack[-1] is not self:  # phases left open inside it
            stack[-1]._close()
        self._close()
        return False

    def _close(self):
        global _step
        self.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        self._stack.pop()
        if _step is self:
            _step = None


def span(name: str, step: bool = False):
    """A span of ``name`` around a block (``step=True``: a new training
    step); the shared no-op context while tracing is off."""
    if not _on:
        return _NULL
    return _Span(name, is_step=step)


def spanned(name: str):
    """Decorator: each call of the function is a span of ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def phase(name: str) -> None:
    """Ends the phase this thread's innermost span is in, if any, and
    starts phase ``name`` under the same parent.  Nothing while tracing is
    off."""
    if not _on:
        return
    stack = _thread()[0]
    if stack and stack[-1].is_phase:
        stack[-1]._close()
    _Span(name, is_phase=True).__enter__()


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to counter ``name``; nothing while tracing is off."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def record_build(name: str) -> None:
    """Counts one build of library ``name`` (``build.compiled.<name>``),
    whether tracing is on or off."""
    with _lock:
        key = f"build.compiled.{name}"
        _counters[key] = _counters.get(key, 0) + 1


@contextlib.contextmanager
def tracing():
    """Spans and counters on for the block (restored after), with one
    ``profiling.clock`` anchor span at its start."""
    global _on
    prev, _on = _on, True
    try:
        with span(CLOCK):
            pass
        yield
    finally:
        _on = prev


def spans() -> List[Dict]:
    """Every span recorded since the last ``reset()``, in the order opened:
    ``id``, ``name``, ``parent`` and ``step`` (ids or None), ``thread``,
    ``start_ns`` and ``end_ns`` (None while open)."""
    recs = list(_records)
    return [dict(id=r.id, name=r.name, parent=r.parent, step=r.step, thread=r.thread,
                 start_ns=r.start_ns, end_ns=r.end_ns) for r in recs]


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Forgets every record and counter (call it outside any span)."""
    _records.clear()
    with _lock:
        _counters.clear()


def to_trace_us(t_ns: int, anchor: Dict, anchor_trace_us: float) -> float:
    """A ``perf_counter_ns`` reading of this process on a trace's timeline
    (us): ``anchor`` is a ``profiling.clock`` record of ``spans()`` and
    ``anchor_trace_us`` the start of its range in the trace."""
    return anchor_trace_us + (t_ns - anchor["start_ns"]) / 1e3


#: Chrome-trace categories of the device's operations, and of the host calls
#: that launch them (``torch.profiler``'s export; a launch and its operation
#: share ``args.correlation``)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def launched_by(events, names) -> List[tuple]:
    """Each device operation of a Chrome trace's ``events`` (torch.profiler's
    ``export_chrome_trace``) with the span that launched it: ``(name, start
    us, duration us, span)``.  The launch is the host call of the same
    correlation id; the span is the innermost host range named in ``names``
    open on the launching thread at that call or, where that thread has none
    open, on any thread (autograd's engine thread launching between the
    SpMM's spans belongs to the step's ``train.backward``); None where no
    such range is open or the launch is not in the trace.  A kernel that
    runs after its span has ended still belongs to it."""
    ranges: Dict[object, list] = {}
    launches, ops = {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        if cat == "user_annotation" and e.get("name") in names:
            t0 = float(e["ts"])
            ranges.setdefault(e.get("tid"), []).append((t0, t0 + float(e.get("dur", 0)), e["name"]))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), float(e["ts"]))
        elif cat in DEVICE_CATS:
            ops.append((e.get("name", ""), float(e["ts"]), float(e.get("dur", 0)),
                        args.get("correlation")))

    def innermost(rs, t):
        best = None
        for r0, r1, name in rs:
            if r0 <= t <= r1 and (best is None or r0 >= best[0]):
                best = (r0, name)
        return best

    out = []
    for name, t0, dur, corr in ops:
        owner = None
        if corr in launches:
            tid, t = launches[corr]
            best = innermost(ranges.get(tid, ()), t)
            if best is None:
                cands = [b for rs in ranges.values() for b in [innermost(rs, t)] if b]
                best = max(cands) if cands else None
            owner = best[1] if best else None
        out.append((name, t0, dur, owner))
    return out


def _sync(device=None) -> None:
    if torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda"):
        torch.cuda.synchronize(device)


def time_fn(fn, *args, rounds: int = 100, warmup: int = 5) -> float:
    """Average host seconds per call of ``fn(*args)`` over ``rounds`` calls
    after ``warmup``, the card synchronised before and after."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(rounds):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / rounds


def device_time(fn, *args, iters: int = 20) -> float:
    """Device seconds per call of ``fn(*args)``: the summed duration of the
    CUDA kernels ``torch.profiler`` records over ``iters`` calls
    (``utils.bench.device_ms``).  Raises RuntimeError on a machine without
    a CUDA card: a CPU run has no device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("no device time without a CUDA card: device_time measures its "
                           "kernels")
    from hcspmm_tpu_torch.utils.bench import device_ms

    return device_ms(lambda: fn(*args), iters, ()) / 1e3


def roofline(seconds: float, bytes_moved: float, flops: float, nnz: Optional[int] = None,
             hbm_gbps: float = H100_HBM_GBPS,
             peak_tflops: float = H100_FP32_TFLOPS) -> Dict:
    """Achieved against the card's peaks (``peak_tflops``: H100_FP32_TFLOPS
    or H100_BF16_TFLOPS by the inputs' type); ``bound`` names the resource
    that limits at full efficiency and ``speed_of_light_s`` is the least
    time the work could take."""
    t_mem = bytes_moved / (hbm_gbps * 1e9)
    t_ops = flops / (peak_tflops * 1e12)
    res = {
        "seconds": seconds,
        "gbytes_per_s": bytes_moved / seconds / 1e9,
        "hbm_efficiency": t_mem / seconds if seconds else 0.0,
        "tflops": flops / seconds / 1e12,
        "flops_efficiency": t_ops / seconds if seconds else 0.0,
        "bound": "memory" if t_mem >= t_ops else "compute",
        "speed_of_light_s": max(t_mem, t_ops),
    }
    if nnz:
        res["gnnz_per_s"] = nnz / seconds / 1e9
    return res


@contextlib.contextmanager
def trace(path: str = "hcspmm_trace.json"):
    """Chrome trace (``chrome://tracing``, Perfetto) of the enclosed block
    by ``torch.profiler``, the card's kernels included where there is one,
    with the program's spans on (``tracing()``) so they show as host ranges
    above the kernels; written to ``path``."""
    act = torch.profiler.ProfilerActivity
    acts = [act.CPU] + ([act.CUDA] if torch.cuda.is_available() else [])
    with torch.profiler.profile(activities=acts) as prof:
        with tracing():
            yield prof
            _sync()
    prof.export_chrome_trace(path)
