"""Command line: trains a GNN or profiles one SpMM (reference:
HC-SpMM_main.py:18-64); port of hcspmm_tpu/train/cli.py with its flags.

    python -m hcspmm_tpu_torch.train.cli --dataset graph.npz --reorder rcm

``--device auto`` runs on the CUDA device and raises when there is none;
``--device cpu`` runs the kernels' plain PyTorch versions on the host.
``--impl xla`` runs the reference's plain gather + segment-sum form (torch
ops, no kernel) in the row layout [N, d].  ``--band-impl tiled`` builds the
tiled band (a plan's (superwindow, 128-row X tile) pairs) where the plan
builder admits it (full band cover, no spill, band_h a multiple of 128) and
a wide plan otherwise, as the JAX package does.  ``--checkpoint``,
``--checkpoint-every``, ``--resume`` and ``--fault-epoch`` save, resume and
fail training as the JAX CLI's do (train.elastic supervises them).

Dataset resolution: a path ending in .txt loads that file ("dst,src"
1-indexed text per dataset.py:52-53), another existing path goes through
``io.load_edges_any``, and any other name builds the deterministic
synthetic stand-in.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.graphs.dataset import GraphDataset
from hcspmm_tpu_torch.graphs.real import REAL_GRAPHS
from hcspmm_tpu_torch.models.net import Net
from hcspmm_tpu_torch.models.sag import SAG
from hcspmm_tpu_torch.ops.spmm import HybridSpMM
from hcspmm_tpu_torch.train.loop import train
from hcspmm_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from hcspmm_tpu_torch.utils.logging import stdout_logger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="hcspmm_tpu_torch training and SpMM profiling")
    p.add_argument("--dataset", type=str, default="example", help="dataset")
    p.add_argument("--dim", type=int, default=96, help="input embedding dimension")
    p.add_argument("--num_layers", type=int, default=6, help="num layers")
    p.add_argument("--hidden", type=int, default=32, help="hidden dimension")
    p.add_argument("--classes", type=int, default=22, help="number of output classes")
    p.add_argument("--epochs", type=int, default=200, help="number of epoches")
    p.add_argument("--model", type=str, default="gcn", choices=["gcn", "gin", "sage"])
    p.add_argument("--single_kernel", action="store_true",
                   help="whether to profile a single SAG kernel")
    p.add_argument("--loi-mode", type=str, default="intended",
                   choices=["intended", "degenerate", "calibrated",
                            "all_dense", "all_sparse"])
    p.add_argument("--impl", type=str, default="pallas", choices=["xla", "pallas"],
                   help="'pallas' = the hand-written kernels (here: CUDA); 'xla' = "
                        "the plain torch gather + segment-sum form")
    p.add_argument("--band-impl", type=str, default="auto",
                   choices=["auto", "wide", "tiled", "tband", "ring"],
                   help="band layout; 'auto' picks the transposed band when "
                        "hidden and classes are at most 64, else 'wide'; 'tiled' "
                        "falls back to 'wide' where the plan cannot tile")
    p.add_argument("--compute-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--spill-impl", type=str, default="dstream",
                   choices=["take", "dstream"],
                   help="spill formulation: 'dstream' builds the lane-path merge "
                        "streams (CUDA kernels), 'take' a gather + segment-sum")
    p.add_argument("--bucket-widths", type=str, default="32,64,96,128,192,256",
                   help="comma-separated dense window width buckets")
    p.add_argument("--reorder", type=str, default="none",
                   choices=["none", "loa", "rcm", "cluster"],
                   help="graph layout reordering")
    p.add_argument("--synthetic-nodes", type=int, default=65536)
    p.add_argument("--synthetic-degree", type=float, default=8.0)
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--fault-epoch", type=int, default=0)
    p.add_argument("--normalize", action="store_true",
                   help="symmetric-normalized aggregation D^-1/2 A D^-1/2 "
                        "(off = reference semantics)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="auto", choices=["auto", "cpu"],
                   help="auto = the CUDA device (raises without one); cpu = "
                        "the kernels' plain versions on the host")
    return p


def load_dataset(args) -> GraphDataset:
    name = args.dataset
    if name.endswith(".txt") and os.path.exists(name):
        return GraphDataset.from_txt(name, args.dim, args.classes, args.seed)
    if os.path.exists(name) and name not in (".",):
        return GraphDataset.from_file(name, args.dim, args.classes, args.seed)
    if name.startswith("digits-knn") or name in REAL_GRAPHS:
        return GraphDataset.real(name, args.dim, args.classes, args.seed)
    candidate = os.path.join("Dataset", name + ".txt")
    if os.path.exists(candidate):
        return GraphDataset.from_txt(candidate, args.dim, args.classes, args.seed)
    return GraphDataset.synthetic(
        args.synthetic_nodes, args.synthetic_degree,
        args.dim, args.classes, seed=args.seed,
    )


def resolve_device(args) -> torch.device:
    """``--device auto``: the CUDA device (raises without one), with
    float32 products in full float32 as the reference's HIGHEST."""
    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--device auto needs a CUDA device; pass "
                           "--device cpu to run the plain versions")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def prepare(args, device, logger):
    """Dataset, reorder and plan for ``args``: returns (dataset, operator)
    and logs the preprocessing record (with "Prep. (ms)")."""
    ds = load_dataset(args)
    band_impl = args.band_impl
    if args.impl == "xla":
        # the plain form: wide plans in the row layout [N, d], as the
        # reference's CLI builds them under xla
        band_impl = "wide"
    elif band_impl == "auto":
        # the transposed band when every dim the model touches fits the
        # dim <= 64 regime (the input dim may exceed it), else the wide
        # padded layout
        band_impl = "tband" if max(args.hidden, args.classes) <= 64 else "wide"
    if band_impl == "ring":
        raise NotImplementedError("band layout 'ring': the reference deleted its "
                                  "kernel and builds wide plans for it (ROADMAP A.12); "
                                  "pass --band-impl wide")
    cfg = PlanConfig(
        bucket_widths=tuple(int(v) for v in args.bucket_widths.split(",")),
        loi_mode=args.loi_mode,
        compute_dtype=args.compute_dtype,
        impl=args.impl,
        band_impl=band_impl,
        spill_impl=args.spill_impl,
    )

    start = time.perf_counter()
    if args.reorder != "none":
        from hcspmm_tpu_torch.format import reorder as _reorder

        fn = {"loa": _reorder.loa_reorder, "rcm": _reorder.rcm_reorder,
              "cluster": _reorder.cluster_reorder}[args.reorder]
        perm = fn(ds.row_pointers, ds.column_index, ds.num_nodes)
        ds = ds.permuted(perm)
        reorder_ms = (time.perf_counter() - start) * 1e3
        logger.log(event="reorder", mode=args.reorder, reorder_ms=reorder_ms)
        start = time.perf_counter()
    op = HybridSpMM(ds.row_pointers, ds.column_index, ds.num_nodes, cfg,
                    normalize=args.normalize, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prep_ms = (time.perf_counter() - start) * 1e3
    print("Prep. (ms):\t{:.3f}".format(prep_ms))
    logger.log(
        event="preprocess", prep_ms=prep_ms,
        num_nodes=ds.num_nodes, nnz=ds.nnz,
        dense_windows=op.plan.num_dense_windows,
        sparse_rows=op.plan.num_sparse_rows,
        spill_nnz=op.plan.spill_nnz,
        missing_supers=len(op.plan.band_missing_sw),
        layout=(("tband" if op.transposed else "tiled" if op.plan.tiled else "wide")
                if op.supports_padded else "rows"),
        device=str(device),
    )
    return ds, op


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print(args)
    device = resolve_device(args)
    logger = stdout_logger(dataset=args.dataset, model=args.model)
    ds, op = prepare(args, device, logger)

    if args.single_kernel:
        res = SAG(op).profile(ds.x)
        logger.log(event="sag", avg_ms=res["avg_ms"], device=res["device"],
                   gnnz_per_s=ds.nnz / (res["avg_ms"] * 1e-3) / 1e9)
        return 0

    net = Net(
        model=args.model,
        num_features=ds.num_features,
        hidden=args.hidden,
        num_classes=args.classes,
        num_layers=args.num_layers,
    )
    init_params = None
    start_epoch = 0
    if args.resume:
        init_params, meta = load_pytree(args.resume)
        start_epoch = int(meta.get("epoch", 0))
        logger.log(event="resume", path=args.resume, **meta)
    res = train(net, op, ds.x, ds.y, epochs=args.epochs, seed=args.seed,
                logger=logger, init_params=init_params,
                checkpoint_path=args.checkpoint or None,
                checkpoint_every=args.checkpoint_every, start_epoch=start_epoch,
                fault_epoch=args.fault_epoch or None)
    logger.log(event="done", epoch_ms=res["epoch_ms"], final_loss=res["final_loss"],
               warmup_s=res["warmup_s"], device=str(device))
    if args.checkpoint:
        # the absolute epoch counter: what the elastic supervisor reads to
        # decide whether the run is complete
        save_pytree(args.checkpoint, res["params"],
                    {"model": args.model, "epoch": start_epoch + args.epochs,
                     "epochs": args.epochs})
        print(f"checkpoint saved to {args.checkpoint}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
