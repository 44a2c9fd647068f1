"""Refit the LOI selector's coefficients from timings of the two row paths
on this device (port of tools/calibrate_loi.py).

The reference trains its logistic selector on synthetic 16-row matrices
timed on its GPU (report §IV-C) and hard-codes the result
(hybrid_all_kernel.cu:261-262).  This tool repeats the procedure with the
port's row layout (``PlanConfig(band_mode='never')``: the dense-window
kernel against the ELL kernel, ``kernels/block_spmm.py:spmm_rows``):

1. sample (unique_cols, nnz) window shapes on a grid, or (``--mixed``) the
   bins of a graph's 2-D (unique, fill) window histogram;
2. for each shape, build a graph of many identical windows and time the
   all-dense plan against the all-sparse plan (``common.median_s``: CUDA
   events on the card);
3. logistic-fit (``format.loi.fit_logistic``) and print a PlanConfig
   snippet.

On the card each timed SpMM must give the device more work than the host's
two launches take: pass a ``--copies`` large enough that the faster path
takes at least 50 µs (a shorter one is flagged on stderr).  The grid mode
checks, at its first shape, that the CUDA-event time agrees with
torch.profiler's device time.  Each timed plan prints the row kernels'
launches of one SpMM.

Usage:  python -m hcspmm_tpu_torch.tools.calibrate_loi [--uniques 8,16] [--dim 96]
            [--copies 2048] [--mixed standin:DD] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from hcspmm_tpu_torch.config import BLK_H, BLK_W, LOICoefficients, PlanConfig
from hcspmm_tpu_torch.format.loi import decide_hybrid_type, fit_logistic
from hcspmm_tpu_torch.format.windows import analyze_windows
from hcspmm_tpu_torch.ops.spmm import HybridSpMM, default_device
from hcspmm_tpu_torch.tools import common
from hcspmm_tpu_torch.utils.bench import device_ms

#: least device time of the faster path for a CUDA-event time to be the device's
MIN_DEVICE_S = 50e-6


def window_graph(unique: int, nnz: int, copies: int, window_h: int = 16):
    """CSR of `copies` independent windows, each with `unique` distinct
    neighbour columns and `nnz` edges spread round-robin over rows.

    The JAX tool's arrays, built with NumPy: every copy but the last few
    repeats one row template shifted by its first row; the copies whose
    columns wrap past the last node are built one by one as in the loop
    form.  Each row's columns are a set, and row r takes edges e = r, r +
    window_h, ..., so it holds only columns congruent to r modulo
    gcd(unique, window_h): a window holds at most window_h * unique / gcd
    edges whatever ``nnz`` asks (``unique`` a multiple of 16: ``unique``
    edges, fill 1/16), as in the JAX tool."""
    rows_edges = [sorted({e % unique for e in range(r, nnz, window_h)})
                  for r in range(window_h)]
    n = copies * window_h
    tmpl = np.asarray([v for r in rows_edges for v in r], np.int64)
    lens = np.asarray([len(r) for r in rows_edges], np.int64)
    top = int(tmpl.max()) if tmpl.size else 0
    flat = min(copies, max(0, -(-(n - top) // window_h)))  # copies with base + top < n
    ci = [((np.arange(flat, dtype=np.int64) * window_h)[:, None] + tmpl[None, :]).ravel()]
    lengths = [np.tile(lens, flat)]
    for c in range(flat, copies):
        base = c * window_h
        for r in range(window_h):
            cols = sorted(set((base + v) % n for v in rows_edges[r]))
            ci.append(np.asarray(cols, np.int64))
            lengths.append(np.asarray([len(cols)], np.int64))
    rp = np.concatenate([[0], np.cumsum(np.concatenate(lengths))])
    return rp.astype(np.int32), np.concatenate(ci).astype(np.int32), n


def path_op(rp, ci, n, mode, dtype="bfloat16", coeffs=None, device=None) -> HybridSpMM:
    """The row-layout operator that ``time_path`` times: LOI ``mode``, no
    band (``coeffs`` replaces the mode's coefficients where given)."""
    extra = {"loi": coeffs} if coeffs is not None else {}
    cfg = PlanConfig(loi_mode=mode, compute_dtype=dtype, band_mode="never", **extra)
    return HybridSpMM(rp, ci, n, cfg, device=device)


def time_op(op: HybridSpMM, dim: int) -> float:
    """Seconds per row-layout SpMM ``op(x)`` of zeros [N, dim] in the
    operator's compute dtype; prints the plan's dense windows, sparse nnz
    and the row kernels' launches of one SpMM."""
    x = torch.zeros((op.plan.num_nodes, dim), dtype=getattr(torch, op.config.compute_dtype),
                    device=op.device)
    launches = common.row_launches_of(lambda: op(x))
    print(f"#   {op.config.loi_mode}: {op.plan.num_dense_windows} dense windows, "
          f"{op.plan.sparse_nnz} sparse nnz; row launches a SpMM {launches}",
          file=sys.stderr, flush=True)
    return common.median_s({"spmm": lambda: op(x)}, op.device)["spmm"]


def time_path(rp, ci, n, dim, mode, dtype="bfloat16", coeffs=None, device=None):
    return time_op(path_op(rp, ci, n, mode, dtype, coeffs, device), dim)


def _flag_short(label, td, ts, device) -> None:
    """On the card, name a shape whose faster path took under MIN_DEVICE_S."""
    if torch.device(device).type == "cuda" and min(td, ts) < MIN_DEVICE_S:
        print(f"# {label}: the faster path took {min(td, ts) * 1e6:.1f} us, under "
              f"{MIN_DEVICE_S * 1e6:.0f} us: the host's launches may set it; raise --copies",
              file=sys.stderr, flush=True)


def calibrate_mixed(args, graph=None) -> dict:
    """Mixture-matched calibration + selector-accuracy validation
    (reference procedure report §IV-C, >90% accuracy).

    Windows are NOT timed as a homogeneous universe: the 2-D
    (unique_cols, fill) histogram of the TARGET graph class picks the
    bins, each bin is timed both ways (dense-window kernel vs ELL kernel),
    the logistic fit is weighted by the bin's window count, and the fitted
    selector is scored per-window against the measured per-bin oracle.  A
    final end-to-end run on the real mixed graph (calibrated vs all_dense
    vs all_sparse, and today's calibrated plan with LOI_TPU_V5E beside
    them) captures the contention between co-scheduled paths that
    homogeneous timing misses.  ``graph`` (rp, ci, n) stands in for
    ``args.mixed``'s when given.  Returns the coefficients, the accuracy
    (of windows, of nnz) and the end-to-end seconds by plan."""
    rp, ci, n = graph if graph is not None else common._target_graph(args.mixed)
    wa = analyze_windows(rp, ci, n)
    ne = wa.edge_counts > 0
    u_all = wa.unique_counts[ne].astype(np.int64)
    e_all = wa.edge_counts[ne].astype(np.int64)
    blocks = (u_all + BLK_W - 1) // BLK_W
    fill_all = e_all / np.maximum(blocks * BLK_H * BLK_W, 1)

    # 2-D histogram bins: geometric in unique, linear in fill
    u_edges = np.unique(np.concatenate([
        [1], np.geomspace(2, max(int(u_all.max()), 2) + 1, 12).astype(int)]))
    f_edges = np.linspace(0.0, float(fill_all.max()) + 1e-9, 7)
    ub = np.clip(np.searchsorted(u_edges, u_all, "right") - 1, 0, len(u_edges) - 2)
    fb = np.clip(np.searchsorted(f_edges, fill_all, "right") - 1, 0, len(f_edges) - 2)
    bin_id = ub * (len(f_edges) - 1) + fb
    uniq_bins, counts = np.unique(bin_id, return_counts=True)
    order = np.argsort(-counts)
    keep, covered = [], 0
    for i in order[: args.max_bins]:
        keep.append(uniq_bins[i])
        covered += counts[i]
    cov_frac = covered / len(u_all)
    print(f"# mixture {args.mixed}: {len(u_all)} windows, "
          f"{len(uniq_bins)} bins, timing top {len(keep)} "
          f"({cov_frac:.1%} of windows)", file=sys.stderr, flush=True)

    feats, labels, weights, bin_oracle = [], [], [], {}
    for b in keep:
        sel = bin_id == b
        u_rep = max(int(np.median(u_all[sel])), 1)
        e_rep = max(int(np.median(e_all[sel])), u_rep)
        copies = max(64, min(args.copies, int(2_000_000 / max(e_rep, 1))))
        rpb, cib, nb = window_graph(u_rep, e_rep, copies)
        td = time_path(rpb, cib, nb, args.dim, "all_dense", args.dtype, device=args.device)
        ts = time_path(rpb, cib, nb, args.dim, "all_sparse", args.dtype, device=args.device)
        blocks_r = (u_rep + BLK_W - 1) // BLK_W
        dens = e_rep / (blocks_r * BLK_H * BLK_W)
        lab = 1.0 if ts < td else 0.0
        bin_oracle[b] = lab
        feats.append([u_rep, dens])
        labels.append(lab)
        weights.append(int(sel.sum()))
        print(f"bin u={u_rep:4d} nnz={e_rep:5d} w={int(sel.sum()):6d} "
              f"dense={td*1e6/copies:7.3f}us/w sparse={ts*1e6/copies:7.3f}"
              f"us/w -> {'sparse' if lab else 'dense'}",
              file=sys.stderr, flush=True)
        _flag_short(f"bin u={u_rep} nnz={e_rep} copies={copies}", td, ts, args.device)

    co = fit_logistic(np.asarray(feats), np.asarray(labels),
                      weights=np.asarray(weights, np.float64))

    # ---- selector accuracy vs the measured per-bin oracle ----
    in_kept = np.isin(bin_id, keep)
    dec = decide_hybrid_type(
        wa.unique_counts, wa.edge_counts, wa.block_partition,
        mode="calibrated", coeffs=co)[ne]
    oracle = np.array([bin_oracle.get(b, -1) for b in bin_id])
    # selector: 1=dense path; oracle label: 1=sparse faster
    sel_sparse = (dec == 0).astype(np.float64)
    ok = (sel_sparse == oracle) & in_kept
    acc_w = ok.sum() / max(in_kept.sum(), 1)
    acc_nnz = (e_all * ok).sum() / max((e_all * in_kept).sum(), 1)
    print(f"# selector accuracy vs measured oracle: {acc_w:.1%} of "
          f"windows ({acc_nnz:.1%} of nnz), on {cov_frac:.1%} "
          f"bin coverage  [reference: >90%, report §IV-C]")

    # ---- end-to-end mixed-graph contention check ----
    results = {}
    for nm, mode, cc in (("calibrated", "calibrated", co),
                         ("all_dense", "all_dense", None),
                         ("all_sparse", "all_sparse", None)):
        try:
            dur = time_path(rp, ci, n, args.dim, mode, args.dtype, coeffs=cc,
                            device=args.device)
            results[nm] = dur
            print(f"# mixed end-to-end {nm:11s}: {dur*1e6:9.1f} us",
                  file=sys.stderr, flush=True)
        except Exception as exc:  # noqa: BLE001 - report, keep going
            print(f"# mixed end-to-end {nm}: FAILED {exc!r}",
                  file=sys.stderr, flush=True)
    end_to_end = dict(results)
    try:  # today's loi_mode='calibrated' plan, beside the fit (not in the collapse rule)
        end_to_end["LOI_TPU_V5E"] = time_path(rp, ci, n, args.dim, "calibrated", args.dtype,
                                              device=args.device)
        print(f"# mixed end-to-end LOI_TPU_V5E (today's calibrated default): "
              f"{end_to_end['LOI_TPU_V5E']*1e6:9.1f} us", file=sys.stderr, flush=True)
    except Exception as exc:  # noqa: BLE001 - report, keep going
        print(f"# mixed end-to-end LOI_TPU_V5E: FAILED {exc!r}", file=sys.stderr, flush=True)
    # ---- single-path collapse ----
    # The per-bin fit cannot see cross-path contention (two live kernel
    # families share launches and cache); when the measured END-TO-END
    # mixture loses to a constant path on its own calibration graph, the
    # calibration emits that constant path as the selector (an extreme
    # bias routes every window one way; max_cols still caps capacity).
    # By construction `calibrated <= min(all_dense, all_sparse)` then
    # holds on the calibration graph.
    if ("calibrated" in results and len(results) == 3
            and results["calibrated"] > min(results.values()) * 1.0):
        best = min(results, key=results.get)
        if best == "all_dense":
            co = LOICoefficients(w_cols=0.0, w_density=0.0, bias=-1e9,
                                 max_cols=co.max_cols)
            print("# mixture lost to all_dense end-to-end -> selector "
                  "collapsed to the dense path (bias=-1e9)",
                  file=sys.stderr, flush=True)
        elif best == "all_sparse":
            co = LOICoefficients(w_cols=0.0, w_density=0.0, bias=1e9,
                                 max_cols=co.max_cols)
            print("# mixture lost to all_sparse end-to-end -> selector "
                  "collapsed to the sparse path (bias=+1e9)",
                  file=sys.stderr, flush=True)

    _print_coefficients(co)
    return {"coefficients": co, "accuracy": (float(acc_w), float(acc_nnz)),
            "end_to_end_s": end_to_end}


def _print_coefficients(co: LOICoefficients) -> None:
    print("# calibrated LOI coefficients (paste into PlanConfig(loi=...)):")
    print(f"LOICoefficients(w_cols={co.w_cols:.6f}, "
          f"w_density={co.w_density:.6f}, bias={co.bias:.6f}, "
          f"max_cols={co.max_cols})")


def _grid(args):
    for u in (int(v) for v in args.uniques.split(",")):
        for fill in (float(v) for v in args.fills.split(",")):
            yield u, fill, max(u, int(u * BLK_H * fill))


def timer_check(args) -> None:
    """At the grid's first shape, each path's CUDA-event time beside
    torch.profiler's device-busy time (on stderr): equal where the device,
    not the host's launches, sets the time.  Run early in a process:
    torch.profiler keeps fewer kernel records the older the process."""
    u, fill, nnz = next(_grid(args))
    rp, ci, n = window_graph(u, nnz, args.copies)
    for mode in ("all_dense", "all_sparse"):
        op = path_op(rp, ci, n, mode, args.dtype, device=args.device)
        x = torch.zeros((n, args.dim), dtype=getattr(torch, args.dtype), device=op.device)
        with torch.no_grad():
            ev = common.median_s({"spmm": lambda: op(x)}, op.device)["spmm"] * 1e6
            busy = device_ms(lambda: op(x), 10, "") * 1e3
        print(f"# timer check u={u} fill={fill:.1f} copies={args.copies} {mode}: CUDA events "
              f"{ev:.1f} us, torch.profiler device busy {busy:.1f} us ({ev / busy:.3f}x)",
              file=sys.stderr, flush=True)


def calibrate_grid(args) -> LOICoefficients:
    """The grid mode: every (unique, fill) of ``args`` timed both ways at
    ``args.copies`` windows, labelled with the faster path, fitted."""
    feats, labels = [], []
    for u, fill, nnz in _grid(args):
        rp, ci, n = window_graph(u, nnz, args.copies)
        td = time_path(rp, ci, n, args.dim, "all_dense", args.dtype, device=args.device)
        ts = time_path(rp, ci, n, args.dim, "all_sparse", args.dtype, device=args.device)
        blocks = (u + BLK_W - 1) // BLK_W
        density = nnz / (blocks * BLK_H * BLK_W)
        feats.append([u, density])
        labels.append(1.0 if ts < td else 0.0)
        print(f"u={u:4d} fill={fill:.1f} nnz={nnz:5d} "
              f"dense={td*1e6:8.1f}us sparse={ts*1e6:8.1f}us "
              f"-> {'sparse' if ts < td else 'dense'}",
              file=sys.stderr, flush=True)
        _flag_short(f"u={u} fill={fill:.1f}", td, ts, args.device)
    return fit_logistic(np.asarray(feats), np.asarray(labels))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dim", type=int, default=96)
    p.add_argument("--copies", type=int, default=2048)
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--uniques", type=str, default="8,16,32,64,128,256")
    p.add_argument("--fills", type=str, default="0.1,0.3,0.6,0.9")
    p.add_argument("--mixed", type=str, default="",
                   help="calibrate on a mixture matched to this graph "
                        "spec (standin:TT, standin:RD@0.5, powerlaw:65536)")
    p.add_argument("--max-bins", type=int, default=24)
    common.add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.device = default_device(args.device)
    print(f"# device: {common.device_line(args.device)}", file=sys.stderr, flush=True)
    if args.mixed:
        calibrate_mixed(args)
        return 0
    if args.device.type == "cuda":
        timer_check(args)
    _print_coefficients(calibrate_grid(args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
