"""LOI dense-window threshold ablation (port of tools/ablate_loi.py).

Sweeps the logistic selector's bias (the decision threshold of report
§IV-C) and measures how window routing and the row-layout SpMM's time
move.  Banding is disabled so that the LOI dense/sparse split is what is
ablated (the band path would otherwise take every window of a reordered
graph).

Emits one JSONL record per threshold, with the row kernels' launches of one
SpMM beside the JAX tool's keys.

Usage:  python -m hcspmm_tpu_torch.tools.ablate_loi [--nodes 65536] [--biases -3,0,3]
            [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from hcspmm_tpu_torch.config import LOICoefficients, PlanConfig
from hcspmm_tpu_torch.graphs import io
from hcspmm_tpu_torch.ops.spmm import HybridSpMM, default_device
from hcspmm_tpu_torch.tools import common


def locality_graph(args):
    """(rp, ci, n): the locality mix gives windows a density spectrum for
    the threshold to cut through (pure-random graphs route everything one
    way)."""
    src, dst, nn = io.synthetic_graph(args.nodes, args.degree, seed=7,
                                      span=args.span, locality=0.7)
    rp, ci = io.to_csr(src, dst, nn)
    return rp, ci, nn


def bias_ops(rp, ci, nn, biases, dtype, device):
    """(bias, operator, prep seconds) for each bias: the intended selector
    with the reference's coefficients, its size cap lifted to the widest
    dense bucket (with the reference's max_cols=32 every window here exceeds
    the cap and the sweep is flat), no band."""
    base = dataclasses.replace(LOICoefficients(), max_cols=256)
    for bias in biases:
        co = dataclasses.replace(base, bias=bias)
        cfg = PlanConfig(loi_mode="intended", loi=co, compute_dtype=dtype, band_mode="never")
        t0 = time.perf_counter()
        op = HybridSpMM(rp, ci, nn, cfg, device=device)
        yield bias, op, time.perf_counter() - t0


def record(bias, op, prep_s, x) -> dict:
    """The JAX tool's record of one bias: ``op``'s row-layout SpMM of ``x``
    timed (``common.median_s``), the plan's routing, and the row kernels'
    launches of one SpMM."""
    plan, nnz, nn = op.plan, op.plan.nnz, op.plan.num_nodes
    launches = common.row_launches_of(lambda: op(x))
    dur = common.median_s({"spmm": lambda: op(x)}, op.device)["spmm"]
    return {
        "bias": bias,
        "spmm_us": round(dur * 1e6, 2),
        "gnnz_per_s": round(nnz / dur / 1e9, 4),
        "dense_windows": plan.num_dense_windows,
        "dense_nnz_frac": round(plan.dense_nnz / max(nnz, 1), 4),
        "sparse_nnz_frac": round(plan.sparse_nnz / max(nnz, 1), 4),
        "prep_s": round(prep_s, 2),
        "nodes": nn, "nnz": nnz, "dim": x.shape[1],
        "row_launches": launches,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=65536)
    p.add_argument("--degree", type=float, default=8.0)
    p.add_argument("--dim", type=int, default=96)
    p.add_argument("--span", type=int, default=16)
    p.add_argument("--biases", type=str, default="-12,-6,-3.149,-1.5,0,3,1000")
    p.add_argument("--dtype", type=str, default="bfloat16")
    common.add_device_arg(p)
    args = p.parse_args(argv)
    device = default_device(args.device)
    print(f"# device: {common.device_line(device)}", file=sys.stderr, flush=True)

    rp, ci, nn = locality_graph(args)
    x = torch.from_numpy(np.random.RandomState(0).randn(nn, args.dim).astype(np.float32)).to(
        device=device, dtype=getattr(torch, args.dtype))
    for bias, op, prep_s in bias_ops(rp, ci, nn, (float(b) for b in args.biases.split(",")),
                                     args.dtype, device):
        print(json.dumps(record(bias, op, prep_s, x)), flush=True)
        del op
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
