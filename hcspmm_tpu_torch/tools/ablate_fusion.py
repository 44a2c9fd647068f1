"""Kernel-fusion ablation, the Table VI analog (port of
tools/ablate_fusion.py).

The reference's headline integration win is the FUSED single-layer
backward: one kernel computes (A dZ) W^T and A dZ (26.4-32.0%, avg 30.6%
over the unfused two-launch form; report Table VI, kernels
hybrid_all_kernel.cu:1639-2065).  The port's fused kernels
(``kernels/tband.py:spmm_tband_fused_padded``, ``tband_fused_direct``;
``kernels/block_spmm.py:spmm_fused_wide_padded``,
``band_fused_spmm_direct``) keep the aggregate on chip between the two
products, saving one round trip of the aggregate through device memory.

This tool measures, per graph and layout, the single-layer GCN backward
core two ways in one process, the two taking turns round by round:

  fused    : the fused kernel where the plan allows it (one band bucket
             owning every superwindow; tband: no spill), else the composed
             form, as the layer ops compose
  composed : the padded SpMM (``spmm_tband_padded`` / ``spmm_wide_padded``)
             then ``torch.matmul``

Spill plans compose by design (the fused tband kernel has no spill
correction, as in the reference), and their rows record that the composed
fallback costs nothing against itself.  Each graph's fused and composed
outputs are held equal first.

Usage:  python -m hcspmm_tpu_torch.tools.ablate_fusion [--scale 1.0] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.kernels import block_spmm, tband
from hcspmm_tpu_torch.ops.spmm import HybridSpMM, default_device
from hcspmm_tpu_torch.tools import common

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def fusion_op(rp, ci, nn, band_impl, device=None, dtype="bfloat16") -> HybridSpMM:
    """The operator the ablation times: ``band_impl``'s band plan, the
    calibrated selector."""
    return HybridSpMM(rp, ci, nn, PlanConfig(compute_dtype=dtype, band_impl=band_impl,
                                             loi_mode="calibrated"), device=device)


def cores(op: HybridSpMM, dim: int, hidden: int, seed: int = 0) -> tuple:
    """(fused, composed, fused_kernel_available, xp): the backward core
    dX = (A dZ) W^T with the aggregate A dZ kept (dW forms from it), in the
    plan's padded layout, on X [N, dim] and a square W of ``dim`` in its
    corner (``randn * 0.1``, drawn after X and the unused [dim, hidden] W,
    as the JAX tool draws them).  Each core returns (out, agg)."""
    plan, arrs = op.plan, op.arrays["f"]
    cd = getattr(torch, op.config.compute_dtype)
    rng = np.random.RandomState(seed)
    x = rng.randn(op.plan.num_nodes, dim).astype(np.float32)
    rng.randn(dim, hidden)
    w_core = torch.from_numpy(rng.randn(dim, dim).astype(np.float32) * 0.1).to(cd)
    xp = op.pad_input(x)
    if op.transposed:
        wf = torch.zeros((xp.shape[0], xp.shape[0]), dtype=cd, device=op.device)  # [ht, dt]
        wf[:dim, :dim] = w_core

        def composed(v):
            agg = tband.spmm_tband_padded(arrs, v, plan, cd)
            return torch.matmul(wf, agg), agg

        def fused_call(v):
            return tband.spmm_tband_fused_padded(arrs, v, wf, plan)
    else:
        wp = torch.zeros((xp.shape[1], xp.shape[1]), dtype=cd, device=op.device)  # [dp, hp]
        wp[:dim, :dim] = w_core

        def composed(v):
            agg = block_spmm.spmm_wide_padded(arrs, v, plan, cd)
            return torch.matmul(agg, wp), agg

        def fused_call(v):
            return block_spmm.spmm_fused_wide_padded(arrs, v, wp, plan)

    with torch.no_grad():
        available = fused_call(xp) is not None

    def fused(v):
        res = fused_call(v) if available else None
        return composed(v) if res is None else res

    return fused, composed, available, xp


def hold_equal(fused, composed, xp) -> float:
    """Relative error of the fused core's two outputs against the composed
    core's (over max |composed|); raises above the compute dtype's
    tolerance."""
    with torch.no_grad():
        rel = 0.0
        for got, ref in zip(fused(xp), composed(xp)):
            got, ref = got.double(), ref.double()
            top = float(ref.abs().max()) if ref.numel() else 0.0
            err = float((got - ref).abs().max()) if ref.numel() else 0.0
            rel = max(rel, err / max(top, 1e-30))
    if not rel <= TOL[xp.dtype]:
        raise AssertionError(f"fused and composed cores differ: rel err {rel:.3e}")
    return rel


def measure(key, scale, dim, hidden, band_impl, mode=None, device=None, op=None):
    """One graph's Table VI row: ``key`` at ``scale`` ('blocks': the rcm
    blocks stand-in at ``scale`` times its nodes; else the Table II stand-in
    in ``mode`` order), or ``op``, an operator from ``fusion_op`` on that
    graph built earlier.  Prints and returns the JAX tool's record."""
    if op is None:
        if key == "blocks":
            rp, ci, nn = common.blocks_standin(scale)
        else:
            rp, ci, nn, _, _ = common._graph(key, scale, mode=mode)
        op = fusion_op(rp, ci, nn, band_impl, default_device(device))
    plan = op.plan
    nnz = int(plan.nnz)
    fused, composed, available, xp = cores(op, dim, hidden)
    hold_equal(fused, composed, xp)
    # interleaved: fused, composed, composed, fused, ... six rounds, the
    # third of the six sorted samples each (the JAX tool's median)
    reps = int(min(20, max(2, 4_000_000 // max(nnz, 1))))
    t = common.interleaved_s({"fused": lambda: fused(xp), "composed": lambda: composed(xp)},
                             op.device, reps, rounds=6)
    f_med, c_med = t["fused"][2], t["composed"][2]
    rec = dict(
        table="VI-analog", graph=key, dim=dim, nnz=nnz,
        band_impl=band_impl, layout=("tband" if op.transposed else "padded"),
        fused_kernel_available=bool(available),
        spill_frac=round(getattr(plan, "spill_nnz", 0) / nnz, 3),
        fused_us=[round(v * 1e6, 1) for v in t["fused"]],
        composed_us=[round(v * 1e6, 1) for v in t["composed"]],
        fused_med_us=round(f_med * 1e6, 1),
        composed_med_us=round(c_med * 1e6, 1),
        gain_pct=round((c_med - f_med) / c_med * 100, 1),
    )
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scale", type=float, default=1.0,
                   help="every graph at this many times its size (the JAX tool's: 1.0)")
    common.add_device_arg(p)
    args = p.parse_args(argv)
    device = default_device(args.device)
    print(f"# device: {common.device_line(device)}", file=sys.stderr, flush=True)
    s = args.scale
    # the fused kernels' regime (zero spill, one bucket: the Table VI
    # shape), both layouts
    measure("blocks", s, 32, 32, "tband", device=device)
    measure("blocks", s, 96, 96, "wide", device=device)
    # spill-bearing graphs (composed by design; the row records that the
    # composed fallback costs nothing against itself)
    measure("DD", s, 32, 32, "tband", device=device)
    measure("YS", s, 32, 32, "tband", device=device)
    measure("RD", s, 32, 32, "tband", device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
