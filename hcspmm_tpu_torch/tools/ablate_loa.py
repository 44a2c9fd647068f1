"""LOA ablation on the card (port of tools/ablate_loa.py; reference Fig. 14,
report §VI-C3: LOA gains avg +8.4%, max +36.3% on its GPU).

LOA's objective (regroup rows so that windows have fewer unique columns,
LOI.cpp:660-805) targets the dense windows' gather cost, so the ablation
runs the reference-like two-population regime (``band_mode='never'``:
dense windows, ELL rows and residual rows, the calibrated selector, bf16)
with reorder in {none, loa, cluster} in ONE process, the three timed in
turns in each round.

Env: LOA_GRAPHS (default 'DD@1.0,AZ@0.5,RD@0.25'), LOA_DIM (32),
LOA_ROUNDS (3).  Emits JSONL (the JAX tool's keys, then each order's dense
windows and the row kernels' launches of one SpMM).

Usage:  python -m hcspmm_tpu_torch.tools.ablate_loa [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.format import reorder as ro
from hcspmm_tpu_torch.graphs import io
from hcspmm_tpu_torch.ops.spmm import HybridSpMM, default_device
from hcspmm_tpu_torch.tools import common

ORDERS = ("none", "loa", "cluster")


def variants(rp0, ci0, nn, device, cluster=None) -> dict:
    """{order: (operator, reorder seconds, perm)} for each of ``ORDERS``
    (``perm[new] = old``; None for 'none').  ``cluster`` (rp, ci, perm),
    the cluster order built earlier, is used where given (its reorder
    seconds then read 0)."""
    out = {}
    for name in ORDERS:
        t0 = time.perf_counter()
        if name == "none":
            rp, ci, perm = rp0, ci0, None
        elif name == "cluster" and cluster is not None:
            rp, ci, perm = cluster
        else:
            fn = ro.loa_reorder if name == "loa" else ro.cluster_reorder
            perm = fn(rp0, ci0, nn)
            rp, ci = ro.apply_permutation(rp0, ci0, nn, perm)
        reo_s = time.perf_counter() - t0
        # reference-like two-population regime: LOA's home turf
        op = HybridSpMM(rp, ci, nn, PlanConfig(compute_dtype="bfloat16", band_mode="never",
                                               loi_mode="calibrated"), device=device)
        out[name] = (op, reo_s, perm)
    return out


def round_record(ops, x, head: dict) -> dict:
    """One round: each order's row-layout SpMM of ``x`` timed in turns
    (``common.median_s``), with ``head``'s keys first, the gains over no
    reorder, and each order's dense windows."""
    device = next(iter(ops.values()))[0].device
    us = common.median_s({name: (lambda op=op: op(x)) for name, (op, _, _) in ops.items()},
                         device)
    row = dict(head, regime="dense_bucket")
    for name, (op, reo_s, _) in ops.items():
        row[name + "_us"] = round(us[name] * 1e6, 1)
        row[name + "_reorder_s"] = round(reo_s, 1)
    base = row["none_us"]
    for name in ("loa", "cluster"):
        row[name + "_gain_pct"] = round(100 * (1 - row[name + "_us"] / max(base, 1e-9)), 1)
    row["dense_windows"] = {name: op.plan.num_dense_windows for name, (op, _, _) in ops.items()}
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    common.add_device_arg(p)
    device = default_device(p.parse_args(argv).device)
    print(f"# device: {common.device_line(device)}", file=sys.stderr, flush=True)
    dim = int(os.environ.get("LOA_DIM", 32))
    rounds = int(os.environ.get("LOA_ROUNDS", 3))
    graphs = os.environ.get("LOA_GRAPHS", "DD@1.0,AZ@0.5,RD@0.25")

    for spec in graphs.split(","):
        key, _, sc = spec.partition("@")
        scale = float(sc) if sc else 1.0
        src, dst, nn, _ = io.reference_standin(key, seed=7, scale=scale)
        rp0, ci0 = io.to_csr(src, dst, nn)
        x = torch.from_numpy(np.random.RandomState(0).randn(nn, dim).astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
        ops = variants(rp0, ci0, nn, device)
        launches = {name: common.row_launches_of(lambda op=op: op(x))
                    for name, (op, _, _) in ops.items()}
        for rnd in range(rounds):
            row = round_record(ops, x, {"graph": key, "scale": scale, "nnz": int(rp0[-1]),
                                        "dim": dim, "round": rnd})
            print(json.dumps(dict(row, row_launches=launches)), flush=True)
        del ops
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
