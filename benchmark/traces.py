"""Reduction of a torch.profiler trace to what the per-layer metrics read:
device time by kernel group, the device's busy time (the union of its
operations' intervals), the operations that took most time and the
longest idle gaps, each named by the host operation running during it.

Kernel groups come from ``kernels/*.json`` (read in file-name order, the
first pattern that matches a name wins; a name no pattern matches is
``other``).  A later change that adds a kernel adds a file there.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, List, Sequence, Tuple

_KERNELS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels")

#: the group holding the program's own CUDA kernels
PORT_GROUP = "spmm"

#: the host range that marks a profile's window
WINDOW = "benchmark.window"

Interval = Tuple[str, float, float]  # name, start us, end us


def kernel_table(kernels_dir: str = _KERNELS) -> List[Tuple[re.Pattern, str]]:
    table = []
    for path in sorted(glob.glob(os.path.join(kernels_dir, "*.json"))):
        with open(path) as f:
            for entry in json.load(f)["groups"]:
                table.append((re.compile(entry["pattern"]), entry["group"]))
    return table


def group_of(name: str, table) -> str:
    return next((g for pat, g in table if pat.search(name)), "other")


def port_counters(counters_dir: str = _KERNELS) -> List[Tuple[str, str, str]]:
    """(module, attribute, key or "") of every program counter that counts
    one launch of the program's own kernels (``kernels/*.json``,
    ``counters``)."""
    out = []
    for path in sorted(glob.glob(os.path.join(counters_dir, "*.json"))):
        with open(path) as f:
            out += [tuple(c) for c in json.load(f).get("counters", [])]
    return out


def read_counters(spec) -> int:
    """The launches the program has counted so far, summed over ``spec``."""
    import importlib

    total = 0
    for module, attr, key in spec:
        value = getattr(importlib.import_module(module), attr)
        total += int(value[key] if key else value)
    return total


def split_events(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device operations, host operations) of a profile, as intervals;
    host ranges mirrored onto the device's timeline are left out."""
    import torch

    dev, host = [], []
    for evt in prof.events():
        item = (evt.name, float(evt.time_range.start), float(evt.time_range.end))
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            # a host range shows on the device's timeline too, over its kernels
            if not (getattr(evt, "is_user_annotation", False) or evt.name == WINDOW):
                dev.append(item)
        elif evt.device_type == torch.autograd.DeviceType.CPU:
            host.append(item)
    return dev, host


def union(intervals: Sequence[Interval]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for _, s, e in sorted(intervals, key=lambda t: t[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def window_of(host: Sequence[Interval], name: str = WINDOW) -> Tuple[float, float]:
    """(start, end) us of the host range ``name``."""
    return next((s, e) for n, s, e in host if n == name)


def _host_op_at(t: float, host: Sequence[Interval]) -> str:
    """The innermost host operation running at time ``t``."""
    best = None
    for name, s, e in host:
        if s <= t <= e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else "no traced host operation"


def reduce(dev: Sequence[Interval], host: Sequence[Interval], table,
           window: Tuple[float, float], top: int = 10) -> Dict:
    """Over the device operations that start in ``window`` (us): device
    time by group (ms), launches by group, the seconds in which the device
    ran an operation (``busy_s``) of the window's (``wall_s``), the ``top``
    operations by time and the ``top`` longest idle gaps, each named by
    the innermost host operation running at its middle."""
    w0, w1 = window
    dev = [d for d in dev if w0 <= d[1] < w1]
    group_ms: Dict[str, float] = {}
    launches: Dict[str, int] = {}
    by_name: Dict[str, float] = {}
    for name, s, e in dev:
        g = group_of(name, table)
        group_ms[g] = group_ms.get(g, 0.0) + (e - s) / 1e3
        launches[g] = launches.get(g, 0) + 1
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    spans = [(s, min(e, w1)) for s, e in union(dev)]
    busy_s = sum(e - s for s, e in spans) / 1e6
    edges = [w0] + [v for span in spans for v in span] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    return {
        "group_ms": group_ms,
        "launches": launches,
        "busy_s": busy_s,
        "wall_s": (w1 - w0) / 1e6,
        "device_ops": [[n[:200], v] for n, v in sorted(by_name.items(),
                                                      key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[_host_op_at(t0 + g / 2, host)[:200], g / 1e6] for g, t0 in gaps],
    }


def group_ms_per_call(red, group: str):
    """Device milliseconds a call in ``group`` of a reduced profile of
    ``red["calls"]`` calls; None where the profile holds no device time."""
    if not red or not red["busy_s"]:
        return None
    return red["group_ms"].get(group, 0.0) / red["calls"]
