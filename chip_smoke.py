"""Smoke run of hcspmm_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure, with its seconds printed:

1. versions of Python, PyTorch, CUDA and nvcc, and the card's name and
   power limit as nvidia-smi reports them;
2. builds csrc/tband.cu, csrc/tspill.cu, csrc/block_spmm.cu, csrc/rows.cu
   and csrc/dstream.cu with nvcc for sm_90a, one nvcc each, started
   together, and prints each nvcc's seconds, ptxas's register and
   shared-memory lines, those of each tband_kernel instantiation
   (registers, spill bytes, static shared memory; every A_t encoding) and
   the band kernel's launch configuration at packs 1, 2 and 8 (ring
   stages, dynamic shared memory, blocks an SM); the same of the two fused kernels
   (tband_kernel's fused forms and band_fused_kernel: ptxas's registers and
   spills, and the host's sizing; phases 3 and 17 log the blocks an SM the
   card gave each launch);
3. holds the band kernel against its plain PyTorch version: at the shape
   the DD-scale blocks stand-in's plan gives it (Sb 1312, W 768, bh 256,
   dt 32; two runs bitwise equal, and in fp32 equal bit for bit to the
   fused kernel's aggregate; timed beside torch.sparse.mm of the same
   product and of the graph's own CSR, and its bytes bound, fp32 and bf16),
   at small odd shapes (dt 16, 32, 48, 96; W 64 to 896; bh 32 to 512, each
   of the 32-, 64- and 128-column copy boxes; capacity-padded entries; the
   same two bitwise checks) and on two-bucket full-cover plans (tband and
   wide: the bucket modes' path); fp32 within 1e-5 and bf16 within 1e-2 of
   max|ref|; the tband fused kernel at the stand-in plan's arrays at dt 32
   / ht 32 (the Table VI analog), dt 96 / ht 32, dt 192 / ht 32 and dt 64 /
   ht 608, fp32 and bf16, against its plain version, bitwise repeatable and
   in fp32 its aggregate equal to the band kernel's output, each timed in 7
   interleaved rounds with the composed pair (the band kernel, then
   torch.matmul) and the band kernel alone; at dt 32 / ht 32 its three
   forms (ONE, the host's choice there, SLAB and WHOLE) held bit for bit
   against each other and timed in 7 interleaved rounds; the bucket mode
   timed;
4. holds the spill kernels (mxgather_lanes, tbstream_merge) and the
   zero-fill folded into the band kernel's direct launch (runs of eight,
   singles, both and neither, bh 128 and 256) against their plain versions
   at small odd shapes: dt 16/48/96, merge groups 4/8/16/32, chunk widths
   128-1024, a block run of many chunks, the merge with and without the
   gather folded in (``gidx``); the merge must be bitwise deterministic;
5. holds ``HybridSpMM.apply_padded`` on the blocks stand-in against scipy
   CSR @ X in float64, at fp32 and bf16;
6. on the paper's DD, YS and GH stand-ins at full size (seed 7, cluster
   reorder): prints each plan's spill edges, missing superwindows and
   which of hub/T1/T2 it builds; on DD and GH the band kernel at the
   plan's own arrays as in 3 (checked, timed beside torch.sparse.mm and
   its bound, fp32 and bf16); holds the folded zero-fill's columns equal
   to zero_lane_blocks_plain's (timed: the direct launch with the missing
   lists less the same launch without them) and each spill kernel against
   its plain version at the plan's own shapes (timed; the lane merge gathers
   through the plan's composed columns, checked against the reference's
   take, and prints its segment table's longest segment and length
   histogram; timed beside the take followed by the merge, and the take
   followed by index_add_; mxgather beside one index_select from X^T with a
   zero lane appended), and apply_padded at dim 32 against scipy;
7. trains the 6-layer GCN (dim 96, hidden 32, classes 22) for 3 epochs
   through ``cli.main`` on the blocks stand-in (rcm) and on DD and GH
   (cluster), and checks with the kernels' launch counters that every
   SpMM of each run went through the CUDA kernels; a small graph's
   forward pass on the card is held against the CPU's;
8. profiles one SpMM at dim 32 through ``cli.main --single_kernel`` on
   the blocks stand-in and on GH;
9. the wide padded layout [M, dp]: holds the row-layout band kernel
   (all three modes) against its plain versions at small odd shapes (dp
   128/256/384, bh 128/256, Bb 640 and 1024 by tensor copies and 100 by
   cp.async, 16-aligned starts, capacity-padded entries, G 1/2/4/8), fp32
   and bf16, bitwise repeatable and in fp32 equal to the fused kernel's
   aggregate; and at the DD and GH wide plans' main buckets (DD: Sb 1190,
   Bb 640, bh 256; dp 128 and 256), the same checks, timed beside
   torch.sparse.mm of the band blocks and of the graph's own CSR and the
   bound;
10. holds the row zero-fill and both row merges (block and tile form)
    against their plain versions at small odd shapes (dp 20-520); the
    merges must be bitwise deterministic;
11. on the wide plans of the blocks stand-in, DD, YS and GH: apply_padded
    at dims 128 and 256 against scipy, and the zero-fill and the merge at
    the plan's own arrays (dp 256, fp32 and bf16, timed beside
    torch.sparse.addmm, deterministic; the merge's segment table's longest
    segment and length histogram printed);
    on DD also a forced tile-form plan, a column-range stream built from
    its spill edges, and the legacy tband ``spill_lane='off'`` path (tile
    form), so that ``dstream_merge`` runs on the card;
12. trains GCN and GIN (dim 128, hidden 256, classes 40, 3 layers: the
    OGB ogbn-arxiv baseline's widths) for 3 epochs through ``cli.main`` on
    the blocks stand-in (rcm), DD and GH (cluster), counting launches as
    in 7, and profiles one SpMM with ``--single_kernel --hidden 256``;
13. the row layout's two kernels (the dense windows; the ELL rows, the
    residual rows and the empty rows) against their plain versions at
    small odd shapes through the one-bucket wrappers (Kb 32-256, De 4-256,
    D 1-256, fp32 and bf16, pad rows and columns, empty buckets), then as
    one launch a population on small plans (N no multiple of 16, empty
    rows, three dense buckets, residual rows, a partial-cover plan with
    band, dense and ELL rows, nine dense buckets, windows of 32 rows) into a
    NaN-filled result, every row written; bitwise repeatable, and each SpMM
    against scipy with exactly one ELL launch and one dense launch for each
    eight dense buckets;
14. the row layout on the full-size DD stand-in (cluster order,
    ``band_mode='never'``, intended and calibrated selectors): each kernel's
    one launch at the plan's arrays (D 32 and 256, fp32 and bf16, bitwise
    repeatable; timed at D 32 in fp32 and bf16 beside torch.sparse.mm of
    the population's own CSR and F.embedding_bag), ``apply`` against scipy
    (bitwise repeatable), the SpMM at dim 32 beside torch.sparse.mm, and the
    6-layer GCN and GIN trained 3 epochs through ``train.loop.train`` with
    exactly one ELL launch (the residual riding it) and one dense launch
    for each eight dense buckets counted per SpMM;
15. trains the 6-layer GCN 2 epochs through ``cli.main --impl xla`` (the
    plain form, row layout) on the blocks stand-in;
16. the fused kernels (tband and wide), the tiled band and the grouped band
    against their plain versions at small odd shapes (tband dt 16-512, ht
    16-608, every fused form; wide dp 128-3712, hp 22-384, Bb 640 and 100;
    capacity-padded entries, pair streams and tiled plans with empty
    superwindows at ring slots 2/4/16, G 1/2/4/8), fp32 and bf16, bitwise
    repeatable, the fused aggregates in fp32 equal to the band kernels';
17. at the blocks stand-in's wide plan: the wide fused kernel at (dp, hp)
    (128, 256), (256, 256), (128, 128) (the Table VI analog at dim 96) and
    (3712, 256) (held against the composed pair there), fp32 and bf16,
    bitwise repeatable, its fp32 aggregate equal to the band kernel's
    output, each timed in 7 interleaved rounds with the composed pair and
    the band kernel alone; the bucket mode, the grouped band and the
    grouped A/B (direct vs G = 1, 2, 4, 8 and torch.sparse.mm, the port of
    tools/ab_grouped.py); at its tiled plan, the tiled band at dp 128 and
    256;
18. the kernel-fusion mode (``op.plan.prefer_fused_kernel = True``): the
    6-layer GCN and GIN on the tband plan and the 3-layer GCN and GIN at
    hidden 256 on the wide plan, trained through ``train.loop.train`` beside
    the composed runs, with the fused launches counted and logged by (dt,
    ht) or (dp, hp);
19. ``cli.main --band-impl tiled``: GCN and GIN at hidden 256 and
    ``--single_kernel`` on the blocks stand-in, every SpMM through the
    tiled kernel, and ``apply_padded`` on the tiled plan against scipy;
20. the layout switch: the 6-layer GCN at hidden 32 through ``cli.main``
    with ``--band-impl tband``, ``wide`` and ``tiled`` on the blocks
    stand-in and DD, each twice (tband, wide, tiled, tiled, wide, tband),
    each run's epoch_ms and layout;
21. where GH's GCN epochs go: ``utils/epoch_profile.py`` on the tband GCN
    (hidden 32) and the wide GCN (hidden 256), device-busy ms by kernel
    group;
22. the packed A_t encodings (``tband_pack`` 2: nibbles, 8: bits), which
    tband_kernel reads as stored: at small odd shapes (bh 32-512, W 64-896,
    W/8 below 64, a multiple of 64 and neither, capacity-padded entries,
    zero items) the direct and bucket modes and the fused forms ONE, SLAB
    and WHOLE at packs 2 and 8, fp32 and bf16, bit for bit pack 1's and
    bitwise repeatable; at the blocks stand-in's and GH's plans built at
    each pack (the upload's device bytes of ``band{s}_at`` printed, each
    packed upload expanding to pack 1's blocks) the direct mode, and on the
    blocks stand-in the bucket mode and the fused kernel at dt 32 / ht 32,
    bit for bit pack 1's, timed in 7 interleaved rounds beside pack 1 and
    torch.sparse.mm with each pack's plain version and bytes bound, and
    apply_padded against scipy; and the 6-layer GCN trained 3 epochs through
    ``train.loop.train`` at pack 1 and pack 8, composed and in the fused
    mode, every tband_kernel launch of a pack 8 run counted as reading
    pack 8 and its losses equal to pack 1's bit for bit;
23. the distributed SpMM (``parallel.dist_spmm.DistHybridSpMM``): 4 gloo
    ranks sharing the card (spawned by ``parallel.dryrun.run_ranks``; they
    load the libraries phase 2 built) on the full-size DD stand-in in
    halo (intended and calibrated selectors), band_halo and allgather
    mode, and 2 ranks on the blocks stand-in in band_halo mode; each mode's
    SpMM at D 32 against scipy and against the single-process port, 3
    Adam steps of the 6-layer GCN (and, in band_halo on DD, of the 6-layer
    GIN, whose exchange runs at the input width) against the
    single-process port's from the same weights, each rank's launches of
    the dense, ELL, band-bucket and band-direct kernels at its shard
    plan's arrays against their plain versions (bitwise repeatable), and
    each rank's launches of those four in the SpMM and in each model's
    steps, exactly what its shard plan implies (each of the four launched
    in some mode); rank 0's distributed SpMM and step times, the
    exchange's bytes and the single-process SpMM's time are printed;
24. checkpoint and elastic restart: a GCN trained through
    ``train.loop.train`` with a checkpoint every 2 epochs, resumed in a
    fresh operator, equal bit for bit to a run that continues with a fresh
    Adam; one SpMM timed and traced by ``utils/profiling.py`` (the trace
    must hold its kernels); then
    ``train.elastic.supervise`` over ``cli.main`` with ``--fault-epoch 2``:
    one failed launch, one resumed launch, 4 epochs.

The second-to-last line is a JSON object with the kernel table (all
sixteen TPU kernels' counterparts): for each kernel its launches on the
main paths run here, its time, its plain version's, one library call's
where PyTorch has one (torch.sparse.mm, torch.sparse.addmm, index_fill_,
index_add_, index_select, F.embedding_bag) or, for the fused kernels, the
composed pair they replace, and its bound (the tband kernels' rows also
each pack's time, plain version and bound from phase 22): the larger of the bytes it must move (each
input read once, each output written once) at 3.35 TB/s and its
operations at the card's peak rate for their type (fp32 67 TFLOP/s, bf16
989 TFLOP/s), computed from this run's arrays; beside it the
Table VI analog, the grouped A/B, the fused training runs and phases
23-24's results (the launch counts of the distributed runs, summed over
their ranks, count among the kernels' launches).  The last
line is ``{"ok": true,
"device": {...}}``.  Without a CUDA device, or outside a checkout of the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

from hcspmm_tpu_torch.utils.bench import block_csr, cuda_time_ms, device_ms, interleaved_ms

STANDIN = dict(num_nodes=334_928, avg_degree=5.03, block_size=300, seed=7)
REAL = ("DD", "YS", "GH")  # io.reference_standin keys: Table II graphs
REAL_SEED = 7
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
WARMUP_EPOCHS = 9  # train.loop.train's dry-run epochs
GCN = ["--model", "gcn", "--dim", "96", "--hidden", "32", "--classes", "22",
       "--num_layers", "6"]
SPMMS_PER_STEP = 12  # a 6-layer GCN step: 6 forward and 6 backward SpMMs
WIDE = ["--dim", "128", "--hidden", "256", "--classes", "40", "--num_layers", "3"]
WIDE_SPMMS = {"gcn": 6, "gin": 5}  # per step: GIN's first layer needs no input gradient
WIDE_DIMS = (128, 256)
ROW_DIMS = (32, 256)
ROW_SELECTORS = ("intended", "calibrated")  # LOI selectors of the row-layout plans
ROW_KERNEL = {"dense_bucket_spmm": "dense_window_kernel", "ell_bucket_spmm": "ell_row_kernel"}
H100_BYTES_PER_S = 3.35e12     # HBM3, NVIDIA's data sheet (SXM)
# Peak operations a second by the inputs' type (NVIDIA's data sheet, SXM,
# dense): fp32 outside the tensor cores, bf16 on them
H100_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
DEV = "cuda"  # the kernels' checks run here (a CPU rehearsal may point it elsewhere)
PROCESS_START = time.time()  # this process's (or a spawned rank's) import of this file
WIDE_DESIGN = ("persistent, two blocks an SM; a ring of A tiles [32, Bb] filled by Tensor Memory "
               "Accelerator copies (cp.async where Bb is no 16-byte multiple) under full/empty "
               "mbarriers; eight consumer warps, a row each: its non-zeros found by ballots, "
               "added in increasing k in batches whose X loads precede the FMAs")
TBAND_FUSED_DESIGN = ("tband_kernel's ring in its fused forms: an entry is a block's unit of "
                      "work and its feature slabs are walked in order; SLAB (ht <= 32, two blocks "
                      "an SM): after each slab a warp stores agg^T for its columns and adds "
                      "W^T[:, slab] round_as(agg^T) into an out^T tile kept in registers (ONE: "
                      "one slab, the tile live only at its end); WHOLE "
                      "(wider ht): the entry's whole aggregate stays in shared memory and, after "
                      "a barrier of the consumer warps, each warp multiplies 8-row tiles of W^T "
                      "by it; fp32 FMAs in increasing d")
WIDE_FUSED_DESIGN = ("band_kernel's machinery with the update fused in: persistent, one block "
                     "an SM of eight warps; units of 128 rows of an entry from the work counter; "
                     "the unit's A tile by tensor copies (cp.async where Bb is no 16-byte "
                     "multiple) under an mbarrier, the next unit's requested before this one's "
                     "update; band_row's ballot walk writes the aggregate rows; then agg^T "
                     "(re-read from L2, rounded to W's type) and W staged 8 rows of k at a time "
                     "in shared memory, double-buffered, into an 8 x 16 register tile of out a "
                     "thread (8 x 8 where hp <= 128); fp32 FMAs in increasing k")
TBAND_DESIGN = ("persistent, two blocks an SM; a ring of Tensor Memory Accelerator copies "
                "(swizzled A_t and X^T slabs) issued by one producer lane under full/empty "
                "mbarriers; warps of 16 columns (32 above bh 256) with 64-row masks of "
                "non-zero rows; lane = feature row, sums in shared memory")


ROWS_DESIGN = {
    "dense": ("one launch over every dense bucket; persistent blocks of 4 warps take (window, "
              "32-column slab) units in a fixed stride, stage the gathered X rows by 16-byte "
              "cp.async (one unit a block, about ten blocks an SM) and walk each row's mask bits "
              "(built at upload) in increasing k, lane = column; rows written at their node ids"),
    "ell": ("one launch over a table of the ELL rows, the residual rows and the empty rows "
            "(node, start, real length), sorted at upload into hub rows (a block of 4 warps), "
            "middle rows (a warp) and short rows (a group of lanes sized to D, 16-byte loads); "
            "rows written at their node ids"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """``with Phase("name"):`` prints the phase's name and its seconds."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        log(f"   ({self.name.split('.')[0]}: {time.perf_counter() - self.t0:.1f} s)")


def rel_err(got, ref) -> tuple:
    """(max |got - ref|, that over max |ref|), in float64 on the host."""
    import numpy as np

    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    return err, err / max(float(np.abs(ref).max()) if ref.size else 0.0, 1e-30)


def check(name: str, got, ref, dtype: str) -> float:
    import torch

    if isinstance(got, torch.Tensor):
        got = got.float().cpu()
    if isinstance(ref, torch.Tensor):
        ref = ref.float().cpu()
    err, rel = rel_err(got, ref)
    log(f"  {name}: max_abs_err {err:.3e} rel {rel:.3e} (tol {TOL[dtype]:g})")
    if not rel <= TOL[dtype]:
        raise AssertionError(f"{name}: rel err {rel:.3e} > {TOL[dtype]:g}")
    return err


def banded_graph(n, deg, near, far, seed=0):
    """Symmetric banded graph whose first half reaches +-near and second
    half +-far: its tband plan at widths (128, 384) needs both buckets."""
    import numpy as np

    from hcspmm_tpu_torch.graphs import io as gio

    rng = np.random.RandomState(seed)
    src = np.repeat(np.arange(n), deg)
    half = np.where(src < n // 2, near, far)
    dst = np.clip(src + rng.randint(0, 1 << 20, src.size) % (2 * half + 1) - half, 0, n - 1)
    s = np.concatenate([src, dst]).astype(np.int32)
    d = np.concatenate([dst, src]).astype(np.int32)
    return (*gio.to_csr(s, d, n), n)


def csr_matmul(rp, ci, n, x):
    import numpy as np
    import scipy.sparse as sp

    a = sp.csr_matrix((np.ones(len(ci)), ci, rp), shape=(n, n))
    return a @ np.asarray(x, dtype=np.float64)


def run_cli(argv) -> list:
    """cli.main(argv) with its standard output echoed; returns its lines."""
    from hcspmm_tpu_torch.train import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    sys.stdout.write(out)
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    return out.splitlines()


def records(lines, event):
    recs = [json.loads(v) for v in lines if v.startswith("{")]
    found = [r for r in recs if r.get("event") == event]
    if not found:
        raise RuntimeError(f"cli.main logged no {event!r} record")
    return found[-1]


def zero_counts():
    from hcspmm_tpu_torch.kernels import block_spmm, dstream, tband, tspill

    tband.launches = 0
    block_spmm.launches = 0
    for counts in (tspill.launches, dstream.launches, block_spmm.row_launches,
                   tband.kernel_launches, block_spmm.kernel_launches):
        for k in counts:
            counts[k] = 0
    tband.fused_shapes.clear()
    tband.pack_launches.clear()
    block_spmm.fused_shapes.clear()


def read_counts() -> dict:
    from hcspmm_tpu_torch.kernels import block_spmm, dstream, tband, tspill

    return dict(tband_spmm=tband.launches, band_spmm=block_spmm.launches, **tspill.launches,
                **dstream.launches, **block_spmm.row_launches, **tband.kernel_launches,
                **block_spmm.kernel_launches,
                **{f"tband_pack{p}": tband.pack_launches[p] for p in (1, 2, 8)})


def check_counts(counts, need, spmms, exact=False) -> None:
    """Each kernel of ``need`` launched at least (``exact``: exactly) its
    count per SpMM times ``spmms``."""
    for k, per in need.items():
        if counts[k] < per * spmms or (exact and counts[k] != per * spmms):
            raise AssertionError(f"{k}: {counts[k]} launches, {'' if exact else 'at least '}"
                                 f"{per} per SpMM x {spmms} expected")


def train_and_count(path, reorder, need, model_args=GCN, per_step=SPMMS_PER_STEP) -> tuple:
    """Train a model (the 6-layer GCN by default) 3 epochs through
    cli.main with every launch count set to 0 just before and read just
    after; ``need`` maps a kernel to its least launches per SpMM."""
    epochs = 3
    zero_counts()
    lines = run_cli(["--dataset", path, "--reorder", reorder, *model_args,
                     "--epochs", str(epochs)])
    counts = read_counts()
    done = records(lines, "done")
    prep = records(lines, "preprocess")
    spmms = per_step * (WARMUP_EPOCHS + epochs)
    log(f"  epoch_ms {done['epoch_ms']:.3f}; warm-up {done['warmup_s']:.2f} s; "
        f"prep {prep['prep_ms']:.0f} ms; spill {prep['spill_nnz']}; final_loss "
        f"{done['final_loss']}; launches {counts} over {spmms} SpMMs")
    if not math.isfinite(done["final_loss"]):
        raise AssertionError(f"loss is not finite: {done['final_loss']}")
    check_counts(counts, need, spmms)
    return counts, done


def real_graph(key):
    """(src, dst, rp, ci, n): the Table II stand-in, cluster-reordered."""
    from hcspmm_tpu_torch.format import reorder
    from hcspmm_tpu_torch.graphs import io as gio

    src, dst, n, _ = gio.reference_standin(key, seed=REAL_SEED)
    rp, ci = gio.to_csr(src, dst, n)
    rp, ci = reorder.apply_permutation(rp, ci, n, reorder.cluster_reorder(rp, ci, n))
    return src, dst, rp, ci, n


def spill_kernels_vs_plain(key, arrs, plan, dtype, cd, gen, out) -> None:
    """Each spill kernel against its plain version at this plan's shapes,
    on a seeded X^T [32, M]; times both; results go into ``out``."""
    import torch

    from hcspmm_tpu_torch.kernels import tband, tspill

    dev = torch.device(DEV)
    m, bh = plan.padded_rows, plan.band_h
    xt = torch.randn((32, m), generator=gen).to(dev, dtype)
    base = torch.randn((32, m), generator=gen).to(dev, dtype)

    elt = xt.element_size()

    def record(name, label, err, fn_k, fn_p, nbytes, ops=0, fn_lib=None, reps=20):
        k_ms = cuda_time_ms(fn_k, reps)
        p_ms = cuda_time_ms(fn_p, max(reps // 4, 2))
        lib_ms = None if fn_lib is None else cuda_time_ms(fn_lib, max(reps // 4, 2))
        b_ms, b_by = bound(nbytes, ops, cd)
        log(f"    {key} {label} {cd}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
            f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, bound {b_ms:.4f} ms by {b_by}")
        out.setdefault((name, cd), []).append(dict(graph=key, shape=label, err=err, ms=k_ms,
                                                   plain_ms=p_ms, library_ms=lib_ms,
                                                   bound_ms=b_ms, bound_by=b_by))

    # the zero-fill, folded into the main bucket's direct launch: the missing
    # superwindows' columns against zero_lane_blocks_plain's; its time is the
    # launch with the missing lists less the same launch without them
    # (medians of 7 interleaved rounds)
    m8, m1 = arrs["band_missing_sw8"], arrs["band_missing_sw"]
    s_main = max(range(len(plan.band_widths)), key=lambda i: len(plan.band_sw_ids[i]))
    sw, st, at = (arrs[f"band{s_main}_{k}"] for k in ("sw", "start", "at"))
    num_sw = m // bh
    label = f"zero {m8.shape[0]} x [32, {8 * bh}] + {m1.shape[0]} x [32, {bh}]"
    if m8.shape[0] or m1.shape[0]:
        got = tband.tband_spmm_direct(sw, st, at, xt, num_sw, dtype, m8, m1)
        zero = torch.zeros(num_sw, dtype=torch.bool, device=dev)
        zero[(m8.long()[:, None] * 8 + torch.arange(8, device=dev)).flatten()] = True
        zero[m1.long()] = True
        cols = zero.repeat_interleave(bh)
        ref = tspill.zero_lane_blocks_plain(tspill.zero_lane_blocks_plain(
            base.clone(), m8, 8 * bh), m1, bh)
        if not torch.equal(got[:, cols], ref[:, cols]):
            raise AssertionError(f"{key} {label}: the folded zero-fill and "
                                 "zero_lane_blocks_plain differ")
        log(f"  {key} {label} {cd}: the direct launch's zeroed columns equal "
            "zero_lane_blocks_plain's")
        ab = interleaved_ms({
            "with": lambda: tband.tband_spmm_direct(sw, st, at, xt, num_sw, dtype, m8, m1),
            "without": lambda: tband.tband_spmm_direct(sw, st, at, xt, num_sw, dtype)}, 20)
        buf = base.clone()
        lanes = cols.nonzero().flatten()
        p_ms = cuda_time_ms(lambda: tspill.zero_lane_blocks_plain(tspill.zero_lane_blocks_plain(
            buf, m8, 8 * bh), m1, bh), 5)
        lib_ms = cuda_time_ms(lambda: buf.index_fill_(1, lanes, 0), 5)
        b_ms, b_by = bound(lanes.numel() * 32 * elt + 4 * (m8.numel() + m1.numel()), 0)
        k_ms = ab["with"] - ab["without"]
        log(f"    {key} {label} {cd}: direct launch with the zero items {ab['with']:.4f} ms, "
            f"without {ab['without']:.4f} ms: the fold costs {k_ms:.4f} ms; plain "
            f"{p_ms:.4f} ms, index_fill_ {lib_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}")
        out.setdefault(("zero_lane_blocks", cd), []).append(dict(
            graph=key, shape=label, err=0.0, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by, direct_with_ms=ab["with"],
            direct_without_ms=ab["without"]))
        del got, ref, buf

    tables = {}
    for lo_key, rel_key, what in (("hub_lo", "hub_rel", "hub"), ("ts_lo", "ts_rel", "T1")):
        if lo_key not in arrs:
            continue
        lo, rel = arrs[lo_key], arrs[rel_key]
        label = f"{what} mxgather {lo.shape[0]} chunks x k {rel.shape[2]}, span {plan.ts_span}"
        got = tspill.mxgather_lanes(xt, lo, rel, span=plan.ts_span)
        ref = tspill.mxgather_lanes_plain(xt, lo, rel)
        if not torch.equal(got, ref):
            raise AssertionError(f"{key} {label}: kernel and plain version differ")
        log(f"  {key} {label} {cd}: equal")
        tables[what] = got
        real = int((rel >= 0).sum())
        # the yardstick: one index_select from X^T with a zero lane appended,
        # through columns lo[c] + rel[c, j] (the -1 slots and the tail chunks
        # pointing at the zero lane), both built before timing
        r = rel.reshape(rel.shape[0], -1).long()
        cols = torch.full((got.shape[1],), m, dtype=torch.long, device=dev)
        cols[: r.numel()] = torch.where(r >= 0, lo.long()[:, None] + r, m).reshape(-1)
        xt_z = torch.cat([xt, xt.new_zeros((xt.shape[0], 1))], dim=1)
        if not torch.equal(torch.index_select(xt_z, 1, cols), got):
            raise AssertionError(f"{key} {label}: the index_select yardstick computes another "
                                 "function")
        record("mxgather_lanes", label, 0.0,
               lambda: tspill.mxgather_lanes(xt, lo, rel, span=plan.ts_span),
               lambda: tspill.mxgather_lanes_plain(xt, lo, rel),
               real * 32 * elt + got.numel() * elt + rel.numel() * 4 + lo.numel() * 4,
               fn_lib=lambda: torch.index_select(xt_z, 1, cols))

    # each merge stream: its source table, the per-slot columns it gathers
    # through, and the reference's take (segmented_gather on T2 plans)
    src = tables.get("T1", xt)
    streams = []
    if "hub_lo" in arrs:
        streams.append(("hot", tables["hub"], arrs["ds_h_laneg"],
                        lambda: tables["hub"].index_select(1, arrs["ds_h_laneg"]),
                        arrs["ds_h_tlocal"], arrs["ds_h_lblk"], "ds_h_lseg", plan.ds_hgroup))
    if "ts2_ranks" in arrs and plan.ts2_segs:
        def take():
            return tspill.segmented_gather(src, arrs["ts2_ranks"], arrs["ds_laneg"],
                                           plan.ts2_segs, plan.ts2_pieces,
                                           bw=arrs["ds_tlocal"].shape[1])
    else:
        def take():
            return src.index_select(1, arrs["ds_laneg"])
    streams.append(("cold" if "hub_lo" in arrs else "lane", src, arrs["ds_lsrc"], take,
                    arrs["ds_tlocal"], arrs["ds_lblk"], "ds_lseg", plan.ds_lgroup))
    for what, tbl, gidx, take, local, blk, seg_key, group in streams:
        segs = tspill.segments_of(arrs, seg_key)
        log(f"  {key} {what} stream segments: {segment_stats(segs)}")
        label = (f"{what} merge {blk.shape[0]} chunks x bw {local.shape[1]}, group {group}, "
                 f"{segs[0].shape[0]} segments, gather folded in")
        g = take()
        if not torch.equal(tbl.index_select(1, gidx[: g.shape[1]]), g):
            raise AssertionError(f"{key} {what}: the composed columns differ from the take")

        def merge(buf):
            return tspill.tbstream_merge(tbl, local, blk, buf, group=group, gidx=gidx, segs=segs)

        got, again = merge(base.clone()), merge(base.clone())
        ref = tspill.tbstream_merge_plain(tbl, local, blk, base.clone(), group=group, gidx=gidx)
        if not torch.equal(got, again):
            raise AssertionError(f"{key} {label}: two kernel runs differ")
        err = check(f"{key} {label} {cd} (bitwise repeatable)", got, ref, cd)
        unfolded = tspill.tbstream_merge(g, local, blk, base.clone(), group=group, segs=segs)
        check(f"{key} {what} merge of the taken stream {cd}", unfolded, ref, cd)
        buf = base.clone()
        span = group * 128
        loc = local[: blk.shape[0]].long()
        keep = loc < span
        lanes = (blk.long()[:, None] * span + loc)[keep]
        real = int(keep.sum())
        touched = int((segs[0] >= 0).sum())
        # each source column read once, however many slots gather it
        sources = int(torch.unique(gidx[: keep.numel()][keep.reshape(-1)]).numel())
        record("tbstream_merge", label, err, lambda: merge(buf),
               lambda: tspill.tbstream_merge_plain(tbl, local, blk, buf, group=group, gidx=gidx),
               sources * 32 * elt + real * 4 + 2 * touched * 32 * elt + segs[1].numel() * 4
               + segs[0].numel() * 4, ops=real * 32,
               fn_lib=lambda: buf.index_add_(1, lanes, take()[:, keep.reshape(-1)]))
        row = out[("tbstream_merge", cd)][-1]
        row["take_merge_ms"] = cuda_time_ms(
            lambda: tspill.tbstream_merge(take(), local, blk, buf, group=group, segs=segs), 20)
        g_real = g[:, keep.reshape(-1)]
        row["index_add_ms"] = cuda_time_ms(lambda: buf.index_add_(1, lanes, g_real), 5)
        log(f"    {key} {what} {cd}: the take, then the merge of the taken stream "
            f"{row['take_merge_ms']:.4f} ms; index_add_ of the taken stream alone "
            f"{row['index_add_ms']:.4f} ms")
        del g, g_real


def segment_stats(segs) -> str:
    """Segments, real ones, the longest, the long list's length and a
    histogram of segment lengths (powers of two) of a merge's segment table."""
    import numpy as np

    dst, ptr, long = (v.cpu().numpy() for v in segs)
    lens = np.diff(ptr)[dst >= 0]
    if not len(lens):
        return "none"
    edges = [1, 2, 4, 8, 16, 32, 64, 128, 256, 1024, 4096, 1 << 30]
    hist = np.histogram(lens, bins=edges)[0]
    return (f"{len(dst)} ({len(lens)} real), longest {int(lens.max())}, {len(long)} long; "
            "lengths " + ", ".join(f"[{a},{b}): {int(h)}" for a, b, h in zip(edges, edges[1:], hist)
                                   if h))


def small_spill_checks(gen) -> None:
    """The spill kernels against their plain versions at small odd shapes."""
    import numpy as np
    import torch

    from hcspmm_tpu_torch.format.streams import build_bstream, build_mx_chunks
    from hcspmm_tpu_torch.kernels import tband, tspill

    dev = torch.device(DEV)
    rng = np.random.RandomState(11)
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    for cd, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for dt in (16, 48, 96):
            m = 16384
            xt = torch.randn((dt, m), generator=gen).to(dev, dtype)
            for bh in (128, 256):
                # the zero-fill folded into the band kernel's direct launch: a
                # third of the superwindows owned, the rest missing as runs of
                # eight and singles (both lists, either, or none)
                num_sw = m // bh
                runs = rng.choice(num_sw // 8, 2, replace=False)
                in8 = np.zeros(num_sw, bool)
                for r in runs:
                    in8[8 * r:8 * r + 8] = True
                free = np.flatnonzero(~in8)
                owned = rng.permutation(free)[: num_sw // 3]
                single = np.setdiff1d(free, owned)
                sb = len(owned) + 2
                at = (torch.rand((sb, 128, bh), generator=gen) < 0.05).to(torch.int8).to(dev)
                st = (torch.randint(0, (m - 128) // 128 + 1, (sb,), generator=gen) * 128).to(
                    dev, torch.int32)
                sw = torch.from_numpy(np.r_[owned, num_sw, num_sw].astype(np.int32)).to(dev)
                m8 = torch.from_numpy(runs.astype(np.int32)).to(dev)
                m1 = torch.from_numpy(single.astype(np.int32)).to(dev)
                for ids8, ids1 in ((m8, m1), (m8, empty), (empty, m1), (empty, empty)):
                    zero_before = tband.kernel_launches["zero_lane_blocks"]
                    got = tband.tband_spmm_direct(sw, st, at, xt, num_sw, dtype, ids8, ids1)
                    ref = tband.tband_spmm_direct_plain(sw, st, at, xt, num_sw, dtype, ids8,
                                                        ids1)
                    cols = torch.zeros(num_sw, dtype=torch.bool)
                    cols[torch.from_numpy(owned)] = True
                    if ids8.numel():
                        cols[torch.from_numpy(in8)] = True
                    if ids1.numel():
                        cols[torch.from_numpy(single)] = True
                    c = cols.repeat_interleave(bh).to(dev)
                    err, rel = rel_err(got[:, c].float().cpu(), ref[:, c].float().cpu())
                    if not rel <= TOL[cd]:
                        raise AssertionError(f"folded zero-fill dt {dt} bh {bh} {cd}: rel err "
                                             f"{rel:.3e}")
                    zc = torch.from_numpy(~np.isin(np.arange(num_sw), owned)) & cols
                    if got[:, zc.repeat_interleave(bh).to(dev)].any():
                        raise AssertionError(f"folded zero-fill dt {dt} bh {bh} {cd}: a "
                                             "missing superwindow's block is not zero")
                    if dev.type == "cuda" and tband.kernel_launches["zero_lane_blocks"] != (
                            zero_before + int(bool(ids8.numel() or ids1.numel()))):
                        raise AssertionError("only a direct launch with missing ids counts as "
                                             "a zero-fill")
            for span, k, ncols in ((512, 32, 37), (2048, 128, 3000), (2048, 256, 900)):
                lo, rel, _ = build_mx_chunks(np.unique(rng.randint(0, m, ncols)), span, k, m)
                lo, rel = torch.from_numpy(lo).to(dev), torch.from_numpy(rel).to(dev)
                if not torch.equal(tspill.mxgather_lanes(xt, lo, rel, span=span),
                                   tspill.mxgather_lanes_plain(xt, lo, rel)):
                    raise AssertionError(f"mxgather_lanes dt {dt} span {span} k {k} {cd} "
                                         "differs")
            for group in (4, 8, 16, 32):
                for bw in (128, 256, 512, 1024):
                    e = int(rng.randint(1, 6000))
                    rows = np.sort(rng.randint(0, m, e))
                    if group == 32 and bw == 128:
                        rows = np.sort(rng.randint(0, 4096, e))  # one block, many chunks
                    gcols, local, blk, grp = build_bstream(rows, np.arange(e), m, pad_col=e,
                                                           group=group, chunk_edges=bw)
                    g = torch.randn((dt, len(gcols)), generator=gen).to(dev, dtype)
                    t = [torch.from_numpy(v.astype(np.int32)).to(dev) for v in (local, blk)]
                    xb = xt.clone()
                    got = tspill.tbstream_merge(g, *t, xt.clone(), group=grp)
                    again = tspill.tbstream_merge(g, *t, xt.clone(), group=grp)
                    if not torch.equal(got, again):
                        raise AssertionError(f"merge dt {dt} group {group} bw {bw} {cd}: "
                                             "two runs differ")
                    ref = tspill.tbstream_merge_plain(g, *t, xb, group=grp)
                    err, rel = rel_err(got.float().cpu(), ref.float().cpu())
                    if not rel <= TOL[cd]:
                        raise AssertionError(f"merge dt {dt} group {group} bw {bw} {cd}: "
                                             f"rel err {rel:.3e}")
                    # the gather folded in: columns of a narrower table
                    gidx = torch.randint(0, 3001, (len(gcols),), generator=gen).to(
                        dev, torch.int32)
                    tbl = xt[:, :3001].contiguous()
                    got = tspill.tbstream_merge(tbl, *t, xt.clone(), group=grp, gidx=gidx)
                    if not torch.equal(got, tspill.tbstream_merge(tbl, *t, xt.clone(), group=grp,
                                                                  gidx=gidx)):
                        raise AssertionError(f"gidx merge dt {dt} group {group} bw {bw} {cd}: "
                                             "two runs differ")
                    ref = tspill.tbstream_merge_plain(tbl, *t, xt.clone(), group=grp, gidx=gidx)
                    err, rel = rel_err(got.float().cpu(), ref.float().cpu())
                    if not rel <= TOL[cd]:
                        raise AssertionError(f"gidx merge dt {dt} group {group} bw {bw} {cd}: "
                                             f"rel err {rel:.3e}")
        log(f"  {cd}: the zero-fill folded into the direct launch (bh 128 and 256, runs of "
            "eight and singles), mxgather (exact) and merge, with and without the gather "
            f"folded in (within {TOL[cd]:g}, bitwise repeatable) at dt 16/48/96, groups 4-32, "
            "bw 128-1024: pass")


def wide_band_checks(key, op, gen, out, graph) -> None:
    """The row-layout band kernel (csrc/block_spmm.cu band_kernel, direct
    mode) at the main bucket of ``op``'s wide plan, dp 128 and 256, fp32 and
    bf16: against its plain version, two runs bitwise equal, and in fp32
    equal bit for bit to band_fused_spmm_direct's aggregate; timed (median of
    7) beside its plain version, torch.sparse.mm of the band blocks as one
    CSR matrix and of the graph's own CSR (``graph`` = (rp, ci, n), spill
    edges included, times the same X's first n rows), and its bound.  Rows go
    into ``out[(key, dp, cd)]``."""
    import numpy as np
    import torch

    from hcspmm_tpu_torch.kernels import block_spmm

    dev = torch.device(DEV)
    p = op.plan
    arrs = op.arrays["f"]
    s = max(range(len(p.band_widths)), key=lambda i: len(p.band_sw_ids[i]))
    st, sw, a = arrs[f"band{s}_start"], arrs[f"band{s}_sw"], arrs[f"band{s}_a"]
    m, num_sw = p.padded_rows, p.padded_rows // p.band_h
    owned = sw[sw < num_sw].long()  # the blocks of missing superwindows stay unset
    band_csr = block_csr(a, st, sw, num_sw, m)
    nnz = int(band_csr.values().numel())
    rp, ci, n = graph
    g_rows = torch.sparse_csr_tensor(torch.from_numpy(rp.astype(np.int64)),
                                     torch.from_numpy(ci.astype(np.int64)),
                                     torch.ones(len(ci)), size=(n, n)).to(dev)
    ring = (block_spmm.band_launch(a.shape[2], *block_spmm.band_device(dev.index or 0)[1:])
            if dev.type == "cuda" else None)
    log(f"  {key} wide plan: Sb {a.shape[0]}, Bb {a.shape[2]}, bh {a.shape[1]}, {num_sw} "
        f"superwindows, {nnz} band nnz; the band kernel's ring {ring}")
    for dp in WIDE_DIMS:
        for cd, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            shape = f"Sb {a.shape[0]}, Bb {a.shape[2]}, bh {a.shape[1]}, dp {dp}"
            xp = torch.randn((m, dp), generator=gen).to(dev, dtype)

            def direct():
                return block_spmm.band_bucket_spmm_direct(sw, st, a, xp, num_sw, dtype)

            got = direct()
            if not torch.equal(got[owned], direct()[owned]):
                raise AssertionError(f"{key} wide direct {cd} dp {dp}: two runs differ")
            ref = block_spmm.band_bucket_spmm_direct_plain(sw, st, a, xp, num_sw, dtype)
            err = check(f"{key} wide direct {cd} at {shape} ({len(owned)} owned blocks, "
                        "bitwise repeatable)", got[owned], ref[owned], cd)
            del ref
            if cd == "float32":
                wp = (torch.randn((dp, 128), generator=gen) * 0.1).to(dev)
                agg, _ = block_spmm.band_fused_spmm_direct(sw, st, a, xp, wp, num_sw, dtype)
                if not torch.equal(agg[owned], got[owned]):
                    raise AssertionError(f"{key} dp {dp}: band_fused_spmm_direct's aggregate "
                                         "differs from the band kernel's output")
                log(f"  {key} dp {dp}: band_fused_spmm_direct's aggregate equals the band "
                    "kernel's output bit for bit")
                del agg
            del got
            k_ms = median_ms(direct, 20)[0]
            p_ms = cuda_time_ms(lambda: block_spmm.band_bucket_spmm_direct_plain(
                sw, st, a, xp, num_sw, dtype), 2)
            b_ms, b_by = bound(a.numel() + m * dp * xp.element_size()
                               + len(owned) * a.shape[1] * dp * xp.element_size()
                               + 8 * a.shape[0], 2 * nnz * dp, cd)
            a_cd, g_cd = band_csr.to(dtype), g_rows.to(dtype)
            lib_ms = median_ms(lambda: torch.sparse.mm(a_cd, xp), 10)[0]
            x_g = xp[:n]
            graph_ms = median_ms(lambda: torch.sparse.mm(g_cd, x_g), 10)[0]
            log(f"    {key} wide direct {cd} dp {dp}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                f"torch.sparse.mm of the band blocks {lib_ms:.4f} ms, of the graph's own CSR "
                f"({len(ci)} nnz) {graph_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}; "
                f"{k_ms / b_ms:.2f}x the bound, {k_ms / graph_ms:.2f}x the graph's call")
            out[(key, dp, cd)] = dict(err=err, ms=k_ms, plain_ms=p_ms, shape=shape,
                                      bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                                      graph_library_ms=graph_ms)
            del xp, x_g, a_cd, g_cd
            torch.cuda.empty_cache()
    del band_csr, g_rows


def wide_band_small_shapes(gen) -> None:
    """band_kernel against its plain versions at small odd shapes, all three
    modes, fp32 and bf16, every output bitwise repeatable: bh 128 and 256,
    dp 128/256/384, Bb 640 and 1024 (tensor copies) and 100 (no 16-byte
    multiple: cp.async), 16-aligned starts, capacity-padded entries; in fp32
    the direct output equals band_fused_spmm_direct's aggregate bit for bit;
    the grouped mode at G 1/2/4/8 on 16 entries and on 12 (G halves until it
    divides), 3 past num_sw."""
    import torch

    from hcspmm_tpu_torch.kernels import block_spmm

    dev = torch.device(DEV)
    dtypes = (("float32", torch.float32), ("bfloat16", torch.bfloat16))
    mm, sb, trash = 2048, 7, 2
    for bh in (128, 256):
        for bb in (640, 100, 1024):
            a_s = (torch.rand((sb, bh, bb), generator=gen) < 0.05).to(torch.int8).to(dev)
            st_s = (torch.randint(0, (mm - bb) // 16 + 1, (sb,), generator=gen) * 16).to(
                dev, torch.int32)
            sw_s = torch.cat([torch.randperm(sb - trash, generator=gen),
                              torch.full((trash,), sb - trash)]).to(dev, torch.int32)
            for dp in (128, 256, 384):
                for cd, dtype in dtypes:
                    xp = torch.randn((mm, dp), generator=gen).to(dev, dtype)
                    hold_repeatable(
                        f"wide direct {cd} bh {bh} Bb {bb} dp {dp} +{trash} padded entries",
                        lambda: block_spmm.band_bucket_spmm_direct(sw_s, st_s, a_s, xp,
                                                                   sb - trash, dtype),
                        lambda: block_spmm.band_bucket_spmm_direct_plain(sw_s, st_s, a_s, xp,
                                                                         sb - trash, dtype),
                        cd)
                    hold_repeatable(f"wide bucket {cd} bh {bh} Bb {bb} dp {dp}",
                                    lambda: block_spmm.band_bucket_spmm(st_s, a_s, xp),
                                    lambda: block_spmm.band_bucket_spmm_plain(st_s, a_s, xp),
                                    "float32")
                    if cd == "float32":
                        wp = torch.randn((dp, 128), generator=gen).to(dev)
                        agg, _ = block_spmm.band_fused_spmm_direct(sw_s, st_s, a_s, xp, wp,
                                                                   sb - trash, dtype)
                        if not torch.equal(agg, block_spmm.band_bucket_spmm_direct(
                                sw_s, st_s, a_s, xp, sb - trash, dtype)):
                            raise AssertionError(f"bh {bh} Bb {bb} dp {dp}: the fused "
                                                 "aggregate differs from the band kernel's")
            for sb_g in (16, 12):
                a_g = (torch.rand((sb_g, bh, bb), generator=gen) < 0.05).to(torch.int8).to(dev)
                st_g = (torch.randint(0, (mm - bb) // 16 + 1, (sb_g,), generator=gen) * 16).to(
                    dev, torch.int32)
                for group in (1, 2, 4, 8):
                    for cd, dtype in dtypes:
                        xp = torch.randn((mm, 256), generator=gen).to(dev, dtype)
                        hold_repeatable(
                            f"wide grouped {cd} G {group} Sb {sb_g} bh {bh} Bb {bb}",
                            lambda: block_spmm.band_bucket_spmm_grouped(st_g, a_g, xp, sb_g - 3,
                                                                        dtype, group),
                            lambda: block_spmm.band_bucket_spmm_grouped_plain(
                                st_g, a_g, xp, sb_g - 3, dtype, group), cd)
    log("  band kernel, direct/bucket/grouped, bh 128/256, Bb 640/100/1024, dp 128-384, "
        "G 1-8, fp32 and bf16: within tolerance of the plain versions, bitwise repeatable, "
        "fp32 equal to the fused aggregate: pass")


def merge_pair(kind):
    from hcspmm_tpu_torch.kernels import dstream

    if kind == "block":
        return dstream.bstream_merge, dstream.bstream_merge_plain
    return dstream.dstream_merge, dstream.dstream_merge_plain


def small_row_checks(gen) -> None:
    """The row zero-fill and both row merges against their plain versions
    at small odd shapes: dp 20/32/48/128/256/520 (20: no 16-byte rows; 520:
    three column slabs), groups 1-8, 5 to 20000 edges with a third on a few
    hub rows (multi-chunk blocks and tiles, segments on the long path), pad
    columns past the table (clip mode)."""
    import numpy as np
    import torch

    from hcspmm_tpu_torch.format.streams import build_bstream, build_dstream
    from hcspmm_tpu_torch.kernels import tspill

    dev = torch.device(DEV)
    rng = np.random.RandomState(12)
    before = dict(tspill.launches)
    probe = torch.randn((1024, 128), device=dev)
    if (tspill.zero_row_blocks(probe, torch.zeros(0, dtype=torch.int32, device=dev), 128)
            is not probe or tspill.launches != before):
        raise AssertionError("an empty id list must launch nothing")
    m = 8192
    for cd, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for dp in (20, 32, 48, 128, 256, 520):
            x = torch.randn((m, dp), generator=gen).to(dev, dtype)
            base = torch.randn((m, dp), generator=gen).to(dev, dtype)
            for w in (128, 256, 1024):
                ids = torch.from_numpy(rng.choice(m // w, 3, replace=False).astype(np.int32))
                if dp * w * x.element_size() % 16 == 0 and not torch.equal(
                        tspill.zero_row_blocks(base.clone(), ids.to(dev), w),
                        tspill.zero_row_blocks_plain(base.clone(), ids.to(dev), w)):
                    raise AssertionError(f"zero_row_blocks dp {dp} w {w} {cd} differs")
            for e in (5, 3000, 20000):
                rows = rng.randint(0, m, e)
                rows[: e // 3] = rng.randint(0, 300, e // 3)
                rows, cols = np.sort(rows), rng.randint(0, m, e)
                for group in (1, 2, 4, 8):
                    for kind, built in (
                            ("block", build_bstream(rows, cols, m, pad_col=m, group=group)[:3]),
                            ("tile", build_dstream(rows, cols, m, pad_col=m, group=group)[:4])):
                        t = [torch.from_numpy(v.astype(np.int32)).to(dev) for v in built]
                        fn, plain = merge_pair(kind)
                        got = fn(*t, x, base.clone(), group=group)
                        again = fn(*t, x, base.clone(), group=group)
                        if not torch.equal(got, again):
                            raise AssertionError(f"{kind} merge dp {dp} e {e} group {group} "
                                                 f"{cd}: two runs differ")
                        err, rel = rel_err(got.float().cpu(),
                                           plain(*t, x, base.clone(), group=group).float().cpu())
                        if not rel <= TOL[cd]:
                            raise AssertionError(f"{kind} merge dp {dp} e {e} group {group} "
                                                 f"{cd}: rel err {rel:.3e}")
        log(f"  {cd}: row zero-fill (exact) and block/tile merges (within {TOL[cd]:g}, "
            "bitwise repeatable) at dp 20-520, groups 1-8: pass")


def row_kernels_vs_plain(key, op, gen, out, dp=256) -> None:
    """The row zero-fill and the plan's merge against their plain versions
    at the wide plan's own arrays, on a seeded [M, dp] table, fp32 and
    bf16, timed; results go into ``out``."""
    import torch

    from hcspmm_tpu_torch.kernels import tspill

    dev = torch.device(DEV)
    p = op.plan
    arrs = op.arrays["f"]
    m, bh = p.padded_rows, p.band_h

    def record(name, cd, label, err, fn_k, fn_p, nbytes, ops=0, fn_lib=None, reps=10):
        k_ms = cuda_time_ms(fn_k, reps)
        p_ms = cuda_time_ms(fn_p, 2)
        lib_ms = None if fn_lib is None else cuda_time_ms(fn_lib, 3)
        b_ms, b_by = bound(nbytes, ops, cd)
        log(f"    {key} {label} {cd}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
            f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, bound {b_ms:.4f} ms by {b_by}")
        out.setdefault((name, cd), []).append(dict(graph=key, shape=label, err=err, ms=k_ms,
                                                   plain_ms=p_ms, library_ms=lib_ms,
                                                   bound_ms=b_ms, bound_by=b_by))

    for cd, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        x = torch.randn((m, dp), generator=gen).to(dev, dtype)
        base = torch.randn((m, dp), generator=gen).to(dev, dtype)
        for ids_key, w in (("band_missing_sw8", 8 * bh), ("band_missing_sw", bh)):
            ids = arrs.get(ids_key)
            if ids is None or not ids.shape[0]:
                continue
            label = f"zero {ids.shape[0]} x [{w}, {dp}]"
            if not torch.equal(tspill.zero_row_blocks(base.clone(), ids, w),
                               tspill.zero_row_blocks_plain(base.clone(), ids, w)):
                raise AssertionError(f"{key} {label} {cd}: kernel and plain version differ")
            buf = base.clone()
            rows = (ids.long()[:, None] * w + torch.arange(w, device=dev)).reshape(-1)
            record("zero_row_blocks", cd, label, 0.0,
                   lambda: tspill.zero_row_blocks(buf, ids, w),
                   lambda: tspill.zero_row_blocks_plain(buf, ids, w),
                   ids.shape[0] * w * dp * x.element_size(),
                   fn_lib=lambda: buf.index_fill_(0, rows, 0))
        if p.ds_blk is None or p.ds_meta is not None:
            continue
        kind = p.ds_kind
        fn, plain = merge_pair(kind)
        t = [arrs["ds_gcols"], arrs["ds_local"], arrs["ds_blk"]]
        if kind != "block":
            t.append(arrs["ds_lt"])
        src = x.index_select(0, arrs["ds_ucols"]) if "ds_ucols" in arrs else x
        segs = tspill.segments_of(arrs, "ds_seg")
        name = "bstream_merge" if kind == "block" else "dstream_merge"
        if cd == "float32":
            log(f"  {key} row merge segments: {segment_stats(segs)}")
        label = (f"{kind} merge {arrs['ds_gcols'].shape[0] // 128} chunks, group "
                 f"{p.ds_group}, {segs[0].shape[0]} segments, dp {dp}"
                 f"{f', ucols {src.shape[0]}' if 'ds_ucols' in arrs else ''}")
        got = fn(*t, src, base.clone(), group=p.ds_group, segs=segs)
        again = fn(*t, src, base.clone(), group=p.ds_group, segs=segs)
        if not torch.equal(got, again):
            raise AssertionError(f"{key} {label} {cd}: two kernel runs differ")
        err = check(f"{key} {label} {cd} (bitwise repeatable)", got,
                    plain(*t, src, base.clone(), group=p.ds_group), cd)
        del got, again
        buf = base.clone()
        dest, gc = merge_slots(kind, *t, p.ds_group)
        elt = x.element_size()
        touched = int((segs[0] >= 0).sum())
        # each source row read once (clip mode: past-the-end columns read
        # the last row), each slot's index, each touched row read and written
        sources = int(torch.unique(gc.clamp(max=src.shape[0] - 1)).numel())
        nbytes = (sources * dp * elt + gc.numel() * 4 + 2 * touched * dp * elt
                  + (segs[0].numel() + segs[1].numel()) * 4)
        fn_lib = None
        if cd == "float32":
            s_csr = torch.sparse_coo_tensor(torch.stack([dest, gc]), torch.ones(
                dest.numel(), device=dev), (m, src.shape[0])).coalesce().to_sparse_csr()
            fn_lib = lambda: torch.sparse.addmm(buf, s_csr, src)  # noqa: E731
        record(name, cd, label, err,
               lambda: fn(*t, src, buf, group=p.ds_group, segs=segs),
               lambda: plain(*t, src, buf, group=p.ds_group), nbytes,
               ops=gc.numel() * dp, fn_lib=fn_lib)
        del x, base, buf, src


def merge_slots(kind, gcols, local, blk, *rest):
    """(destination row, source row) of every real slot of a row merge
    stream (block or tile form; sentinel slots dropped), for the library
    yardstick ``torch.sparse.addmm``."""
    import torch

    group = rest[-1]
    span = group * 128
    chunks = blk.shape[0] if kind == "block" else rest[0].shape[0]
    loc = local.reshape(-1)[: chunks * 128].long().view(chunks, 128)
    if kind == "block":
        keep = loc < span
        dest = blk.long()[:, None] * span + loc
    else:
        lt = rest[0].long()
        keep = loc < 128
        step = torch.arange(chunks, device=blk.device) // group
        dest = (blk.long()[step] * span + lt * 128)[:, None] + loc
    return dest[keep], gcols[: chunks * 128].long().view(chunks, 128)[keep]


def ranges_plan(plan, num_ranges=3):
    """``plan`` with its spill re-chunked as a column-range tile stream
    (the reference's build_dstream_ranges, as format/plan.py builds it when
    the table outgrows ``ds_table_mb``)."""
    import dataclasses

    import numpy as np

    from hcspmm_tpu_torch.format.streams import build_dstream_ranges

    m = plan.padded_rows
    rows = np.asarray(plan.spill_rows, dtype=np.int64)
    seg = np.asarray(plan.spill_edge_seg, dtype=np.int64)
    real = seg < int(np.count_nonzero(rows < m))
    g, local, blk, lt, grp, meta = build_dstream_ranges(
        rows[seg[real]], np.asarray(plan.spill_edge_col)[real], m, pad_col=plan.num_cols,
        num_ranges=num_ranges, range_rows=-(-m // (128 * num_ranges)) * 128)
    return dataclasses.replace(plan, ds_gcols=g, ds_local=local, ds_blk=blk, ds_lt=lt,
                               ds_group=grp, ds_meta=meta, ds_kind="tile", ds_ucols=None)


def median_ms(fn, reps: int, trials: int = 7) -> tuple:
    """(median, 2nd, 6th) of ``trials`` CUDA-event timings of ``reps`` calls."""
    v = sorted(cuda_time_ms(fn, reps) for _ in range(trials))
    return v[len(v) // 2], v[1], v[-2]


def bound(nbytes: float, ops: float, cd: str = "float32") -> tuple:
    """(least ms, what bounds it) for moving ``nbytes`` at the H100's
    3.35 TB/s and doing ``ops`` operations at its peak rate for inputs of
    type ``cd``: 67 TFLOP/s in fp32 (outside the tensor cores), 989 TFLOP/s
    in bf16 (on them).  The bf16 rate holds whether or not the kernel uses
    the tensor cores: the bound is what the card can do."""
    t_b, t_o = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_OPS_PER_S[cd] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def ptxas_report(log_text: str, pattern: str, label) -> list:
    """ptxas's registers, spill bytes and static shared memory of each kernel
    whose mangled name matches ``pattern``, from a build's log; ``label``
    names a match."""
    import re

    lines = log_text.splitlines()
    out = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        k = m and re.search(pattern, m.group(1))
        if not k:
            continue
        props = " ".join(v.strip() for v in lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", props)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", props)
        smem = re.search(r"(\d+) bytes smem", props)
        out.append(f"{label(k)}: {regs.group(1) if regs else '?'} registers, spill stores/loads "
                   f"{'/'.join(spill.groups()) if spill else '?'} bytes, static shared memory "
                   f"{smem.group(1) if smem else 0} bytes")
    if not out:
        raise AssertionError(f"the build log names no kernel matching {pattern}")
    return out


def types_of(mangled: str) -> str:
    """'x in, y out' of a kernel's mangled (X, out) template types."""
    bf = "13__nv_bfloat16"
    x = "bf16" if mangled.startswith(bf) else "fp32"
    rest = mangled[len(bf) if x == "bf16" else 1:]
    return f"{x} in, {'fp32' if rest.startswith('f') else 'bf16'} out"


FORMS = {"0": "band", "1": "fused SLAB", "2": "fused WHOLE", "3": "fused ONE"}


def tband_kernel_report(log_text: str) -> list:
    """ptxas's lines of each instantiation of csrc/tband.cu's tband_kernel."""
    return ptxas_report(log_text, r"tband_kernelI(\w+?)Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
                        lambda k: f"tband_kernel<{types_of(k.group(1))}, DT {k.group(2)}, COLS "
                                  f"{k.group(3)}, {FORMS[k.group(4)]}, PACK {k.group(5)}>")


def band_kernel_report(log_text: str) -> list:
    """ptxas's lines of each instantiation of csrc/block_spmm.cu's
    band_kernel and band_fused_kernel."""
    return ptxas_report(log_text, r"\d(band_kernel|band_fused_kernel)I(\w+?)Li(\d+)E",
                        lambda k: f"{k.group(1)}<{types_of(k.group(2))}, NG {k.group(3)}>")


def band_kernel_at_plan(key, op, gen, out, graph) -> None:
    """The band kernel at a tband plan's main bucket (dt 32), fp32 and bf16:
    direct mode against its plain version, two runs bitwise equal, and in
    fp32 equal bit for bit to tband_fused_direct's aggregate; the bucket
    mode against its plain version; the direct mode timed (median of 7)
    beside its plain version, torch.sparse.mm of the same product (the
    bucket's blocks as one CSR matrix, times X in rows), torch.sparse.mm of
    the whole ``graph`` (rp, ci, n: its own CSR, spill edges included, times
    the same X's first n rows) and its bytes bound.  Rows go into
    ``out[(key, cd)]``."""
    import numpy as np
    import torch

    from hcspmm_tpu_torch.kernels import tband

    rp, ci, n = graph
    g_rows = torch.sparse_csr_tensor(torch.from_numpy(rp.astype(np.int64)),
                                     torch.from_numpy(ci.astype(np.int64)),
                                     torch.ones(len(ci)), size=(n, n)).to(DEV)
    p, arrs = op.plan, op.arrays["f"]
    s = max(range(len(p.band_widths)), key=lambda i: len(p.band_sw_ids[i]))
    st, sw, at = arrs[f"band{s}_start"], arrs[f"band{s}_sw"], arrs[f"band{s}_at"]
    m, bh = p.padded_rows, p.band_h
    num_sw = m // bh
    nnz = int(at.count_nonzero())
    a_rows = block_csr(at.transpose(1, 2), st, sw, num_sw, m)
    shape = f"Sb {at.shape[0]}, W {at.shape[1]}, bh {bh}, dt 32"
    # the direct write leaves the blocks no entry of this bucket owns unset
    owned = torch.zeros(num_sw, dtype=torch.bool, device=DEV)
    owned[sw[sw < num_sw].long()] = True
    cols = owned.repeat_interleave(bh)
    for cd, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        xt = torch.randn((32, m), generator=gen).to(DEV, dtype)

        def direct():
            return tband.tband_spmm_direct(sw, st, at, xt, num_sw, dtype)

        got = direct()
        if not torch.equal(got[:, cols], direct()[:, cols]):
            raise AssertionError(f"{key} band kernel {cd}: two runs differ")
        ref = tband.tband_spmm_direct_plain(sw, st, at, xt, num_sw, dtype)
        err = check(f"{key} direct {cd} at {shape} (bitwise repeatable)", got[:, cols],
                    ref[:, cols], cd)
        if cd == "float32":
            wt = (torch.randn((32, 32), generator=gen) * 0.1).to(DEV)
            agg, _ = tband.tband_fused_direct(sw, st, at, xt, wt, num_sw, dtype)
            if not torch.equal(agg[:, cols], got[:, cols]):
                raise AssertionError(f"{key}: tband_fused_direct's aggregate differs from "
                                     "tband_spmm_direct's output")
            log(f"  {key}: tband_fused_direct's aggregate equals tband_spmm_direct's output "
                "bit for bit")
        check(f"{key} bucket {cd} at {shape}", tband.tband_spmm_bucket(st, at, xt),
              tband.tband_spmm_bucket_plain(st, at, xt), cd)
        x_rows = xt.T.contiguous()
        a_cd = a_rows.to(dtype)
        elt = xt.element_size()
        k_ms = median_ms(direct, 20)[0]
        p_ms = cuda_time_ms(lambda: tband.tband_spmm_direct_plain(sw, st, at, xt, num_sw, dtype),
                            5)
        lib_ms = median_ms(lambda: torch.sparse.mm(a_cd, x_rows), 10)[0]
        g_cd, x_g = g_rows.to(dtype), x_rows[:n]
        graph_ms = median_ms(lambda: torch.sparse.mm(g_cd, x_g), 10)[0]
        b_ms, b_by = bound(at.numel() + xt.numel() * elt + 32 * m * elt + 8 * at.shape[0],
                           2 * nnz * 32, cd)
        log(f"    {key} band kernel {cd} at {shape}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"torch.sparse.mm {lib_ms:.4f} ms ({a_rows._nnz()} nnz, longest row "
            f"{int(a_rows.crow_indices().diff().max())}; of the graph's own CSR, "
            f"{len(ci)} nnz: {graph_ms:.4f} ms), bound {b_ms:.4f} ms by {b_by}; "
            f"{k_ms / b_ms:.2f}x the bound, {k_ms / lib_ms:.2f}x torch.sparse.mm")
        out[(key, cd)] = dict(err=err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
                              bound_by=b_by, shape=shape, graph_library_ms=graph_ms)
        del xt, x_rows, a_cd, g_cd, x_g, got, ref
    del a_rows, g_rows


def band_kernel_small_shapes(gen) -> None:
    """The band kernel against its plain version at small shapes, both modes,
    fp32 and bf16, with capacity-padded entries: two runs bitwise equal, and
    in fp32 equal bit for bit to tband_fused_direct's aggregate."""
    import torch

    from hcspmm_tpu_torch.kernels import tband

    # (dt, W, bh, M): dt 16/48/96 at bh 128 and 256, then one 64-row stage,
    # GH's W 896, bh 32, 96 and 512, dt 48; then the 64-byte swizzle's
    # 64-column boxes: bh 64 (one), 192 (three) and 320 (five, warps of 32)
    small = [(dt, 256, bh, 1024) for dt in (16, 48, 96) for bh in (128, 256)] + [
        (16, 64, 128, 1024), (32, 896, 256, 2048), (48, 256, 32, 512), (32, 192, 96, 768),
        (48, 128, 512, 1024), (16, 896, 512, 1024), (16, 256, 64, 512), (32, 384, 192, 1024),
        (48, 192, 320, 768)]
    for dt, w, bh, mm in small:
        sb, trash = 7, 2
        at_s = (torch.rand((sb, w, bh), generator=gen) < 0.05).to(torch.int8).to(DEV)
        st_s = (torch.randint(0, (mm - w) // 128 + 1, (sb,), generator=gen) * 128)
        sw_s = torch.cat([torch.randperm(sb - trash, generator=gen),
                          torch.full((trash,), sb - trash)])
        st_s, sw_s = st_s.to(DEV, torch.int32), sw_s.to(DEV, torch.int32)
        for cd, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            xt = torch.randn((dt, mm), generator=gen).to(DEV, dtype)
            got = tband.tband_spmm_direct(sw_s, st_s, at_s, xt, sb - trash, dtype)
            if not torch.equal(got, tband.tband_spmm_direct(sw_s, st_s, at_s, xt, sb - trash,
                                                            dtype)):
                raise AssertionError(f"direct {cd} dt {dt} W {w} bh {bh}: two runs differ")
            check(f"direct {cd} dt {dt} W {w} bh {bh} +{trash} padded entries", got,
                  tband.tband_spmm_direct_plain(sw_s, st_s, at_s, xt, sb - trash, dtype), cd)
            check(f"bucket {cd} dt {dt} W {w} bh {bh}",
                  tband.tband_spmm_bucket(st_s, at_s, xt),
                  tband.tband_spmm_bucket_plain(st_s, at_s, xt), cd)
            if cd == "float32":
                wt = torch.randn((16, dt), generator=gen).to(DEV)
                agg, _ = tband.tband_fused_direct(sw_s, st_s, at_s, xt, wt, sb - trash, dtype)
                if not torch.equal(agg, got):
                    raise AssertionError(f"dt {dt} W {w} bh {bh}: the fused aggregate "
                                         "differs from the band kernel's output")
    log("  band kernel at the small shapes: bitwise repeatable, and in fp32 equal to the "
        "fused kernel's aggregate bit for bit")


def small_row_kernel_checks(gen) -> None:
    """The dense and ELL kernels through their one-bucket wrappers (and the
    residual's) against their plain versions at small odd shapes: Kb
    32/64/96/256, De 4-256, D 1/20/32/96/256, fp32 and bf16 tables, pad
    columns past the table, pad rows and all-pad windows, empty buckets, a
    residual with an empty row and a 5000-edge hub row; every result
    bitwise repeatable.  Then ``small_population_checks``."""
    import numpy as np
    import torch

    from hcspmm_tpu_torch.kernels import block_spmm

    dev = torch.device(DEV)
    rng = np.random.RandomState(13)
    before = dict(block_spmm.row_launches)
    x0 = torch.randn((100, 32), device=dev)
    none = torch.zeros((0, 32), dtype=torch.int32, device=dev)
    if (block_spmm.dense_bucket_spmm(none, torch.zeros((0, 16, 32), dtype=torch.int8, device=dev),
                                     x0).shape != (0, 16, 32)
            or block_spmm.ell_bucket_spmm(none, x0).shape != (0, 32)
            or block_spmm.row_launches != before):
        raise AssertionError("an empty bucket must launch nothing")
    n = 3000

    def pads(shape, frac):
        c = rng.randint(0, n, shape)
        c[rng.rand(*shape) < frac] = n  # past the table: the reference's zero row
        return c

    def same(name, fn, plain):
        got, again = fn(), fn()
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two kernel runs differ")
        err, rel = rel_err(got.cpu(), plain().cpu())
        if not rel <= TOL["float32"]:
            raise AssertionError(f"{name}: rel err {rel:.3e} > {TOL['float32']:g}")

    for cd, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for d in (1, 20, 32, 96, 256):
            x = torch.randn((n, d), generator=gen).to(dev, dtype)
            for kb in (32, 64, 96, 256):
                wb = 19
                cols = pads((wb, kb), 0.2)
                cols[wb - 1] = n  # an all-pad window (capacity padding)
                a = (rng.rand(wb, 16, kb) < 0.1).astype(np.int8)
                a[np.broadcast_to(cols[:, None, :] == n, a.shape)] = 0
                c_t = torch.from_numpy(cols.astype(np.int32)).to(dev)
                a_t = torch.from_numpy(a).to(dev)
                same(f"dense Kb {kb} D {d} {cd}", lambda: block_spmm.dense_bucket_spmm(c_t, a_t, x),
                     lambda: block_spmm.dense_bucket_spmm_plain(c_t, a_t, x))
            for de in (4, 8, 16, 32, 64, 128, 256):
                rb = 53
                cols = rng.randint(0, n, (rb, de))
                cols[np.arange(de)[None, :] >= rng.randint(1, de + 1, rb)[:, None]] = n
                cols[rb - 3:] = n  # pad rows
                c_t = torch.from_numpy(cols.astype(np.int32)).to(dev)
                same(f"ELL De {de} D {d} {cd}", lambda: block_spmm.ell_bucket_spmm(c_t, x),
                     lambda: block_spmm.ell_bucket_spmm_plain(c_t, x))
            lens = np.array([3, 0, 5000, 1, 600, 17])
            ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)).to(dev)
            cols = torch.from_numpy(pads((int(lens.sum()) + 9,), 0.05).astype(np.int32)).to(dev)
            same(f"residual D {d} {cd}", lambda: block_spmm.ell_residual_spmm(ptr, cols, x),
                 lambda: block_spmm.ell_residual_spmm_plain(ptr, cols, x))
        log(f"  {cd} tables: dense (Kb 32-256), ELL (De 4-256) and residual rows at D "
            f"1/20/32/96/256 within {TOL['float32']:g} of their plain versions, bitwise "
            "repeatable: pass")
    small_population_checks(gen)


def small_plans():
    """(name, operator on the card, (rp, ci, n)) of small row-layout plans of
    one graph: N no multiple of 16 with empty rows, dense windows in three
    buckets, ELL rows and residual hub rows; a partial-cover plan mixing
    band, dense and ELL rows; dense windows in nine buckets (two launches of
    the dense kernel's table of eight); and windows of 32 rows."""
    import numpy as np

    from hcspmm_tpu_torch.config import PlanConfig
    from hcspmm_tpu_torch.graphs import io as gio
    from hcspmm_tpu_torch.ops.spmm import HybridSpMM

    rng = np.random.RandomState(29)
    parts = []  # (rows, neighbour span, degree): narrow to wide regions
    for lo, hi, span, deg in ((0, 600, 16, 3), (600, 1200, 10, 12), (1200, 1800, 24, 14),
                              (1800, 2400, 40, 16), (2400, 2960, 200, 3)):
        src = np.repeat(np.arange(lo, hi), deg)
        parts.append((src, np.clip(src + rng.randint(-span, span + 1, src.size), lo, hi - 1)))
    hubs = np.repeat([2500, 2700, 2900], [900, 600, 400])  # residual rows above De 256
    parts.append((hubs, rng.randint(2400, 2960, hubs.size)))
    src, dst = (np.concatenate(v) for v in zip(*parts))
    n = 3001  # the last 41 nodes have no edges
    rp, ci = gio.to_csr(np.concatenate([src, dst]).astype(np.int32),
                        np.concatenate([dst, src]).astype(np.int32), n)
    cfgs = {"calibrated": dict(band_mode="never", loi_mode="calibrated"),
            "intended": dict(band_mode="never"),
            "mixed": dict(band_spill="never", band_h=64, band_widths=(128,),
                          loi_mode="calibrated"),
            "nine buckets": dict(band_mode="never", loi_mode="all_dense", bucket_widths=(
                16, 20, 24, 28, 32, 36, 40, 48, 56, 64, 96, 128, 256)),
            "window 32": dict(band_mode="never", loi_mode="calibrated", window_h=32)}
    return [(name, HybridSpMM(rp, ci, n, PlanConfig(**cfg), device=DEV), (rp, ci, n))
            for name, cfg in cfgs.items()]


def small_population_checks(gen) -> None:
    """The whole-population launches (``dense_rows``: every dense bucket in
    one launch for each eight; ``ell_rows``: the ELL rows, the residual rows
    riding them and the empty rows) against their plain versions on small
    plans, D 1/20/32/96/256, fp32 and bf16 tables, into a NaN-filled result
    (a row written by neither stays NaN and fails the check), bitwise
    repeatable; each SpMM against scipy with one ELL launch and one dense
    launch for each group of ``dense_launch_groups``."""
    import torch

    from hcspmm_tpu_torch.kernels import block_spmm

    for name, op, (rp, ci, n) in small_plans():
        p, arrs = op.plan, op.arrays["f"]
        owned = torch.zeros(n, dtype=torch.bool, device=DEV)
        for s in range(len(p.band_widths)):
            owned[arrs[f"band{s}_rnode"]] = True
        groups = block_spmm.dense_launch_groups(arrs, p)
        log(f"  small {name} plan ({n} nodes, window_h {p.window_h}): {row_population(p)}; "
            f"dense launches of buckets {groups}")
        if name == "nine buckets" and sum(map(len, groups)) < 9:
            raise AssertionError(f"the nine-bucket plan fills the dense buckets {groups}")
        if name == "window 32" and not (p.window_h == 32 and p.num_dense_windows):
            raise AssertionError("the window 32 plan must have dense windows of 32 rows")
        for cd, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            for d in (1, 20, 32, 96, 256):
                x = torch.randn((n, d), generator=gen).to(DEV, dtype)

                def pop(kernel):
                    out = torch.full((n, d), float("nan"), device=DEV)
                    out[owned] = 0  # the band rows: neither launch writes them
                    if kernel:
                        block_spmm.dense_rows(arrs, p, x, out)
                        return block_spmm.ell_rows(arrs, x, out)
                    block_spmm.dense_rows_plain(arrs, p, x, out)
                    return block_spmm.ell_rows_plain(arrs["rw_node"], arrs["rw_ptr"],
                                                     arrs["rw_cols"], x, out)

                got = pop(True)
                if not torch.equal(got, pop(True)):
                    raise AssertionError(f"small {name} D {d} {cd}: two runs differ")
                _, rel = rel_err(got.cpu(), pop(False).cpu())
                if not rel <= TOL["float32"]:
                    raise AssertionError(f"small {name} D {d} {cd}: rel err {rel:.3e}")
        x = torch.randn((n, 24), generator=gen).to(DEV)
        zero_counts()
        with torch.no_grad():
            got = op(x)
        counts = read_counts()
        check(f"small {name} plan: SpMM vs scipy", got, csr_matmul(rp, ci, n, x.cpu().numpy()),
              "float32")
        check_counts(counts, {"dense_bucket_spmm": len(groups),
                              "ell_bucket_spmm": int(arrs["rw_node"].shape[0] > 0)}, 1,
                     exact=True)
    log("  whole-population launches at D 1/20/32/96/256, fp32 and bf16: every row written, "
        f"within {TOL['float32']:g} of the plain versions, bitwise repeatable: pass")


def row_population(plan) -> str:
    """The dense and ELL buckets and the residual of a row-layout plan."""
    import numpy as np

    dense = ", ".join(f"Kb {kb}: {len(w)}/{c.shape[0]}" for kb, w, c in zip(
        plan.bucket_widths, plan.bucket_window_ids, plan.bucket_cols) if c.shape[0])
    ell = ", ".join(f"De {de}: {len(r)}/{c.shape[0]}" for de, r, c in zip(
        plan.ell_widths, plan.ell_row_ids, plan.ell_cols) if c.shape[0])
    seg = plan.sparse_edge_seg[plan.sparse_edge_seg < plan.num_sparse_rows]
    return (f"dense windows {plan.num_dense_windows} ({dense}; real/capacity), "
            f"{plan.dense_nnz} nnz; ELL rows ({ell}); residual {len(np.unique(seg))} rows / "
            f"{len(seg)} edges; sparse nnz {plan.sparse_nnz}")


def population_csr(op, which: str):
    """(int64 crow, int64 col, rows) on the card of one row population's own
    CSR: the real dense windows' rows below N (``which`` "dense") or the ELL
    kernel's row table (the ELL rows, the residual rows, the empty rows)."""
    import numpy as np
    import torch

    p, arrs = op.plan, op.arrays["f"]
    if which == "ell":
        return arrs["rw_ptr"].long(), arrs["rw_cols"].long(), arrs["rw_node"].shape[0]
    n, wh, lens, cols = p.num_nodes, p.window_h, [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for b, kb in enumerate(p.bucket_widths):
        wids = p.bucket_window_ids[b]
        keep = (wids[:, None] * wh + np.arange(wh)) < n  # [windows, wh]
        a = (p.bucket_a[b][: len(wids)] != 0)[keep]  # [rows, Kb]
        c = np.broadcast_to(p.bucket_cols[b][: len(wids), None, :], (len(wids), wh, kb))[keep]
        lens.append(a.sum(1))
        cols.append(c[a])
    lens = np.concatenate(lens)
    crow = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return (torch.from_numpy(crow).to(DEV),
            torch.from_numpy(np.concatenate(cols).astype(np.int64)).to(DEV), len(lens))


def row_kernels_at_plan(key, op, gen, out) -> None:
    """The dense kernel (every dense bucket in one launch, ``dense_rows``)
    and the ELL kernel (the ELL rows, the residual rows riding them and the
    empty rows in one launch, ``ell_rows``) against their plain versions at
    ``op``'s own plan arrays, at D 32 and 256, fp32 and bf16 tables, bitwise
    repeatable; at D 32 in fp32 and bf16 each launch is timed (device time,
    torch.profiler) beside its plain version and two one-call yardsticks:
    torch.sparse.mm of the population's own CSR and F.embedding_bag over
    its buckets' padded slots, with the bound computed from these arrays.
    Results go into ``out``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from hcspmm_tpu_torch.kernels import block_spmm

    p, arrs = op.plan, op.arrays["f"]
    n, wh = p.num_nodes, p.window_h
    nb, ne = len(p.bucket_widths), len(p.ell_widths)
    csr = {name: population_csr(op, which) for name, which in (("dense_bucket_spmm", "dense"),
                                                               ("ell_bucket_spmm", "ell"))}
    for d in ROW_DIMS:
        for cd, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            x = torch.randn((n, d), generator=gen).to(DEV, dtype)
            res = torch.zeros((n, d), device=DEV)
            fns = {"dense_bucket_spmm": (lambda o: block_spmm.dense_rows(arrs, p, x, o),
                                         lambda o: block_spmm.dense_rows_plain(arrs, p, x, o)),
                   "ell_bucket_spmm": (lambda o: block_spmm.ell_rows(arrs, x, o),
                                       lambda o: block_spmm.ell_rows_plain(
                                           arrs["rw_node"], arrs["rw_ptr"], arrs["rw_cols"], x, o))}
            errs = {}
            for name, (fn, plain) in fns.items():
                got = fn(torch.zeros((n, d), device=DEV))
                if not torch.equal(got, fn(torch.zeros((n, d), device=DEV))):
                    raise AssertionError(f"{key} {name} D {d} {cd}: two kernel runs differ")
                errs[name] = check(f"{key} {name} D {d} {cd}", got,
                                   plain(torch.zeros((n, d), device=DEV)), "float32")
            if d != 32:
                continue
            xz = torch.cat([x, torch.zeros((1, d), device=DEV, dtype=dtype)])
            elt = x.element_size()

            def uniq(cols):
                v = np.unique(np.concatenate([np.asarray(c).ravel() for c in cols] + [[n]]))
                return int(np.count_nonzero(v < n))

            windows = [len(p.bucket_window_ids[b]) for b in range(nb)]
            dense_bags = [(arrs[f"b{b}_cols"][:w].long()[:, None, :].expand(-1, wh, -1)
                           .reshape(-1, p.bucket_widths[b]),
                           arrs[f"b{b}_a"][:w].to(dtype).reshape(-1, p.bucket_widths[b]))
                          for b, w in enumerate(windows) if w]
            ell_bags = [(arrs[f"e{e}_cols"].long(), None) for e in range(ne)
                        if arrs[f"e{e}_cols"].shape[0]]
            rw = arrs["rw_node"].shape[0]
            shapes = {
                "dense_bucket_spmm": dict(
                    bags=dense_bags, rows=csr["dense_bucket_spmm"][2],
                    nbytes=uniq([p.bucket_cols[b][:w] for b, w in enumerate(windows)]) * d * elt
                    + sum(w * (4 + p.bucket_widths[b] * 4 + wh * 4 * -(-p.bucket_widths[b] // 32))
                          for b, w in enumerate(windows))
                    + csr["dense_bucket_spmm"][2] * d * 4,
                    ops=p.dense_nnz * d,
                    shape="; ".join(f"{w} windows x Kb {p.bucket_widths[b]}"
                                    for b, w in enumerate(windows) if w) + " (1 launch)"),
                "ell_bucket_spmm": dict(
                    bags=ell_bags, rows=rw,
                    nbytes=uniq([arrs["rw_cols"].cpu().numpy()]) * d * elt
                    + (arrs["rw_cols"].shape[0] + 2 * rw + 1) * 4 + rw * d * 4,
                    ops=arrs["rw_cols"].shape[0] * d,
                    shape=f"{rw} rows ({'/'.join(map(str, arrs['rows_meta'].tolist()[:3]))} "
                          f"hub/middle/short, {arrs['rows_meta'].tolist()[3]} residual), "
                          f"{arrs['rw_cols'].shape[0]} entries (1 launch)"),
            }
            for name, s_ in shapes.items():
                fn, plain = fns[name]
                crow, col, rows = csr[name]
                a_csr = torch.sparse_csr_tensor(crow, col, torch.ones(col.shape[0], device=DEV,
                                                                      dtype=dtype),
                                                size=(rows, n))
                wall, lo, hi = median_ms(lambda: fn(res), 20)
                ms = device_ms(lambda: fn(res), 20, ROW_KERNEL[name])
                p_ms = cuda_time_ms(lambda: plain(res), 3)
                bag_ms = cuda_time_ms(lambda: [F.embedding_bag(i, xz, per_sample_weights=w,
                                                               mode="sum")
                                               for i, w in s_["bags"]], 10)
                try:  # a bf16 CSR product where PyTorch's build has one
                    sp_ms = cuda_time_ms(lambda: torch.sparse.mm(a_csr, x), 10)
                except (NotImplementedError, RuntimeError) as e:
                    log(f"    torch.sparse.mm {cd}: {str(e).splitlines()[0]}")
                    sp_ms = None
                b_ms, b_by = bound(s_["nbytes"], s_["ops"], cd)
                log(f"    {key} {name} D 32 {cd} ({s_['shape']}): kernel {ms:.4f} ms of device "
                    f"time ({wall:.4f} ms [{lo:.4f}-{hi:.4f}] with the host's launch), plain "
                    f"{p_ms:.4f}, torch.sparse.mm of its own CSR ({rows} rows) "
                    f"{'none' if sp_ms is None else f'{sp_ms:.4f}'}, "
                    f"embedding_bag {bag_ms:.4f}, bound {b_ms:.4f} ms by {b_by} "
                    f"({s_['nbytes'] / 1e6:.2f} MB)")
                out[(key, name, cd)] = dict(
                    err=errs[name], ms=ms, wall_ms=wall, plain_ms=p_ms,
                    library_ms=bag_ms if sp_ms is None else min(sp_ms, bag_ms),
                    sparse_mm_ms=sp_ms, embedding_bag_ms=bag_ms,
                    bound_ms=b_ms, bound_by=b_by, shape=s_["shape"])
            del x, xz, res


def profile_epochs(net, op, x, y, params, epochs: int = 5) -> tuple:
    """(wall ms, device-busy ms, busy ms by kernel group) per epoch of
    ``epochs`` training steps under torch.profiler, grouped as
    ``utils/epoch_profile.py`` groups them."""
    import torch

    from hcspmm_tpu_torch.train.loop import layout_input, make_train_step
    from hcspmm_tpu_torch.utils.epoch_profile import group_of

    step = make_train_step(net, op, torch.optim.Adam(
        [t for layer in params for t in layer.values()], lr=0.01))
    x = layout_input(op, x)
    y = torch.as_tensor(y).to(op.device)
    gen = torch.Generator(device=op.device).manual_seed(0)
    step(params, x, y, gen)
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(epochs):
            step(params, x, y, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / epochs
    groups = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            g = group_of(e.name)
            groups[g] = groups.get(g, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / epochs
    groups = dict(sorted(groups.items(), key=lambda kv: -kv[1]))
    return wall, sum(groups.values()), groups


def row_layout_phase(rp, ci, n, gen, out, launch_runs) -> None:
    """The row layout on a full-size graph (``band_mode='never'``, the
    intended and the calibrated selector): plan populations, ``apply``
    against scipy in fp32 and bf16 (bitwise repeatable), the SpMM's time at
    dim 32 beside torch.sparse.mm, the 6-layer GCN and GIN trained 3 epochs
    through ``train.loop.train`` with the launch counters zeroed before and
    read after; then, once every host-clock time is taken, the profiled
    parts: each kernel at the plan's arrays, the SpMM's device-busy time,
    an epoch's breakdown, and the SpMM's time again."""
    import numpy as np
    import torch

    from hcspmm_tpu_torch.config import PlanConfig
    from hcspmm_tpu_torch.kernels import block_spmm
    from hcspmm_tpu_torch.models.net import Net
    from hcspmm_tpu_torch.ops.spmm import HybridSpMM
    from hcspmm_tpu_torch.train.loop import train

    dev = torch.device(DEV)
    xd = torch.from_numpy(np.random.RandomState(0).randn(n, 32).astype(np.float32)).to(dev)
    ref = csr_matmul(rp, ci, n, xd.cpu().numpy())
    a_csr = torch.sparse_csr_tensor(torch.from_numpy(rp.astype(np.int64)),
                                    torch.from_numpy(ci.astype(np.int64)),
                                    torch.ones(len(ci)), size=(n, n)).to(dev)
    xin = torch.from_numpy(np.random.RandomState(1).randn(n, 96).astype(np.float32))
    y = np.ones(n, dtype=np.int64)
    ops, gcn_params = {}, {}
    for sel in ROW_SELECTORS:
        for cd in ("bfloat16", "float32"):
            t0 = time.perf_counter()
            op = HybridSpMM(rp, ci, n, PlanConfig(band_mode="never", loi_mode=sel,
                                                  compute_dtype=cd), device=dev)
            if op.supports_padded:
                raise AssertionError("a band_mode='never' plan has no padded path")
            log(f"  DD {sel} {cd}: {row_population(op.plan)}; plan and upload "
                f"{time.perf_counter() - t0:.1f} s")
            with torch.no_grad():
                got = op(xd)
                if not torch.equal(got, op(xd)):
                    raise AssertionError(f"DD {sel} {cd}: two row SpMMs differ")
            check(f"DD {sel} {cd} apply vs scipy (bitwise repeatable)", got, ref, cd)
        ops[sel] = op  # the float32 operator

    def spmm_time(sel):
        op = ops[sel]
        with torch.no_grad():
            ms, lo, hi = median_ms(lambda: op(xd), 10)
        log(f"  DD {sel}: row SpMM {ms:.4f} ms [{lo:.4f}-{hi:.4f}] at dim 32 fp32 "
            f"({op.plan.nnz / ms / 1e6:.3f} Gnnz/s)")
        return ms

    for sel, op in ops.items():
        sp_ms, _, _ = median_ms(lambda: torch.sparse.mm(a_csr, xd), 10)
        log(f"  torch.sparse.mm {sp_ms:.4f} ms ({op.plan.nnz / sp_ms / 1e6:.3f} Gnnz/s)")
        out[("spmm", sel)] = dict(ms=spmm_time(sel), sparse_mm_ms=sp_ms)
        for model, per_step in (("gcn", 12), ("gin", 11)):
            net = Net(model, 96, 32, 22, 6)
            zero_counts()
            res = train(net, op, xin, y, epochs=3)
            counts = read_counts()
            spmms = per_step * (WARMUP_EPOCHS + 3)
            log(f"  DD {sel} {model}: epoch_ms {res['epoch_ms']:.3f}, final_loss "
                f"{res['final_loss']}; launches {counts} over {spmms} SpMMs")
            if not math.isfinite(res["final_loss"]):
                raise AssertionError(f"DD {sel} {model}: loss is not finite")
            groups = len(block_spmm.dense_launch_groups(op.arrays["f"], op.plan))
            check_counts(counts, {"dense_bucket_spmm": groups, "ell_bucket_spmm": 1,
                                  "ell_residual": 1}, spmms, exact=True)
            launch_runs[f"DD rows {sel} {model}"] = counts
            if model == "gcn":
                gcn_params[sel] = (net, res["params"])

    for sel, op in ops.items():  # torch.profiler from here on
        row_kernels_at_plan(f"DD {sel}", op, gen, out)
        with torch.no_grad():
            busy = device_ms(lambda: op(xd), 10, "")
        log(f"  DD {sel}: row SpMM device busy {busy:.4f} ms")
        out[("spmm", sel)]["busy_ms"] = busy
        net, params = gcn_params[sel]
        wall, busy, groups = profile_epochs(net, op, xin, y, params)
        log(f"  DD {sel} gcn, 5 profiled epochs: wall {wall:.3f} ms, device busy "
            f"{busy:.3f} ms ({1 - busy / wall:.1%} idle); busy ms per epoch "
            + ", ".join(f"{g} {v:.3f}" for g, v in groups.items()))
        out[("epoch", sel)] = dict(wall_ms=wall, busy_ms=busy, groups=groups)
        log(f"  DD {sel}, after the profiler sessions:")
        out[("spmm", sel)]["after_profiler_ms"] = spmm_time(sel)
    del ops, gcn_params
    torch.cuda.empty_cache()


def hold(name: str, got, ref, cd: str) -> float:
    """rel_err of ``got`` against ``ref`` on the host; raises above TOL[cd]."""
    import torch

    err, rel = rel_err(got.float().cpu() if isinstance(got, torch.Tensor) else got,
                       ref.float().cpu() if isinstance(ref, torch.Tensor) else ref)
    if not rel <= TOL[cd]:
        raise AssertionError(f"{name}: rel err {rel:.3e} > {TOL[cd]:g}")
    return err


def hold_repeatable(name: str, fn, plain, cd: str) -> float:
    """Runs ``fn`` twice (the results must be bitwise equal) and holds each
    of its outputs against ``plain()``'s; returns the largest max_abs_err."""
    import torch

    got, again, ref = fn(), fn(), plain()
    got, again, ref = ((v,) if isinstance(v, torch.Tensor) else v for v in (got, again, ref))
    err = 0.0
    for i, (g, a, r) in enumerate(zip(got, again, ref)):
        if not torch.equal(g, a):
            raise AssertionError(f"{name} (output {i}): two kernel runs differ")
        err = max(err, hold(f"{name} (output {i})", g, r, cd))
    return err


def timed(label, fn_k, fn_p, nbytes, ops, fn_lib=None, reps=20, err=0.0) -> dict:
    """The kernel's, the plain version's and the yardstick's CUDA-event
    times and the bound, logged and returned as a kernel-table row."""
    k_ms = cuda_time_ms(fn_k, reps)
    p_ms = cuda_time_ms(fn_p, max(reps // 5, 2))
    lib_ms = None if fn_lib is None else cuda_time_ms(fn_lib, max(reps // 4, 2))
    b_ms, b_by = bound(nbytes, ops)
    log(f"    {label}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, yardstick "
        f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, bound {b_ms:.4f} ms by {b_by}")
    return dict(err=err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, shape=label)


def fused_vs_composed(label, cd, fns, fn_p, nbytes, ops, reps, err) -> dict:
    """A fused kernel's kernel-table row: ``fns`` (fused, composed: the
    band kernel then torch.matmul, band: the band kernel alone) timed in 7
    interleaved rounds (medians), the plain version once, and the bound,
    whose operations are counted at the card's peak rate for ``cd`` (bf16:
    the tensor cores' 989 TFLOP/s, though the update runs on the CUDA
    cores)."""
    ab = interleaved_ms(fns, reps)
    p_ms = cuda_time_ms(fn_p, 2) if fn_p is not None else None
    b_ms, b_by = bound(nbytes, ops, cd)
    rate = f"{cd} {H100_OPS_PER_S[cd] / 1e12:.0f} TFLOP/s"
    log(f"    {label}: fused {ab['fused']:.4f} ms, composed pair {ab['composed']:.4f} ms, band "
        f"kernel alone {ab['band']:.4f} ms (medians of 7 interleaved rounds), plain "
        f"{'not run' if p_ms is None else f'{p_ms:.4f} ms'}, bound {b_ms:.4f} ms by {b_by} "
        f"(operations at {rate}); fused is "
        f"{(ab['composed'] - ab['fused']) / ab['composed']:+.1%} faster than the pair, "
        f"{ab['fused'] / b_ms:.2f}x the bound")
    return dict(err=err, ms=ab["fused"], plain_ms=p_ms, library_ms=ab["composed"],
                band_ms=ab["band"], bound_ms=b_ms, bound_by=b_by, ops_rate=rate,
                shape=label, table6=dict(fused=ab["fused"], composed=ab["composed"]))


def tiled_arrays(counts, bh, tiles, gen):
    """A tiled pair stream on the card: superwindow s owns ``counts[s]``
    pairs of consecutive 128-row tiles from a random first tile, or, where
    the count is 0, one zero-A pair that reuses the previous pair's tile (as
    format/plan.py pads an empty superwindow); the scalar arrays carry the
    plan's 8 pad entries."""
    import torch

    from hcspmm_tpu_torch.config import TILED_SCALAR_PAD

    tile, blocks, ptr = [], [], [0]
    for c in counts:
        if c == 0:
            tile.append(tile[-1] if tile else 0)
            blocks.append(torch.zeros((1, bh, 128), dtype=torch.int8))
        else:
            t0 = int(torch.randint(0, tiles - c + 1, (1,), generator=gen))
            tile.extend(range(t0, t0 + c))
            blocks.append((torch.rand((c, bh, 128), generator=gen) < 0.05).to(torch.int8))
        ptr.append(len(tile))
    tile += [tile[-1]] * TILED_SCALAR_PAD
    return {"tp_ptr": torch.tensor(ptr, dtype=torch.int32, device=DEV),
            "tp_tile": torch.tensor(tile, dtype=torch.int32, device=DEV),
            "tp_a": torch.cat(blocks).to(DEV)}


def small_new_kernel_checks(gen) -> None:
    """The two fused kernels, the tiled band and the grouped band against
    their plain versions at small odd shapes, fp32 and bf16, every output
    bitwise repeatable: tband fused at dt 16-512 and ht 16-608, each of its
    forms (ONE, SLAB with W^T staged or read through L1 over two out^T
    tiles, WHOLE); wide fused at dp 128-3712 (CiteSeer's 3703 features) and
    hp 22-384 (two of them no 4-multiple), with A by tensor copies (Bb 640)
    and by cp.async (Bb 100); both at bh 128 and 256 with capacity-padded
    entries, and in fp32 their aggregates equal to the band kernels'
    outputs bit for bit; the
    tiled band at dp 128/256/384 on a pair stream with empty superwindows,
    and on the tiled plans of a small graph at ring slots 2 and 16 and of a
    graph with empty superwindows (apply_padded vs scipy); the grouped band
    at G 1/2/4/8 on 16 entries and on 12 (G halves until it divides), with
    entries past num_sw."""
    import types

    import numpy as np
    import torch

    from hcspmm_tpu_torch.config import PlanConfig
    from hcspmm_tpu_torch.format import reorder
    from hcspmm_tpu_torch.graphs import io as gio
    from hcspmm_tpu_torch.kernels import block_spmm, tband
    from hcspmm_tpu_torch.ops.spmm import HybridSpMM

    dev = torch.device(DEV)
    dtypes = (("float32", torch.float32), ("bfloat16", torch.bfloat16))
    for bh in (128, 256):
        sb, trash = 7, 2
        sw_s = torch.cat([torch.randperm(sb - trash, generator=gen),
                          torch.full((trash,), sb - trash)]).to(dev, torch.int32)
        w, mm = 256, 1024
        at_s = (torch.rand((sb, w, bh), generator=gen) < 0.05).to(torch.int8).to(dev)
        st_s = (torch.randint(0, (mm - w) // 128 + 1, (sb,), generator=gen) * 128).to(
            dev, torch.int32)
        # every form of the fused tband kernel: ONE (32/32, 16/16), SLAB with
        # W^T staged (48/16, 96/32, 192/32) or read through L1 in two out^T
        # tiles (512/64), WHOLE (16/48, 32/96, 64/608)
        for dt, ht in ((16, 48), (32, 96), (48, 16), (96, 32), (192, 32), (64, 608), (32, 32),
                       (16, 16), (512, 64)):
            for cd, dtype in dtypes:
                xt = torch.randn((dt, mm), generator=gen).to(dev, dtype)
                wt = torch.randn((ht, dt), generator=gen).to(dev, dtype)
                hold_repeatable(
                    f"tband fused {cd} dt {dt} ht {ht} bh {bh} +{trash} padded entries",
                    lambda: tband.tband_fused_direct(sw_s, st_s, at_s, xt, wt, sb - trash, dtype),
                    lambda: tband.tband_fused_direct_plain(sw_s, st_s, at_s, xt, wt, sb - trash,
                                                           dtype), cd)
                if cd == "float32" and not torch.equal(
                        tband.tband_fused_direct(sw_s, st_s, at_s, xt, wt, sb - trash, dtype)[0],
                        tband.tband_spmm_direct(sw_s, st_s, at_s, xt, sb - trash, dtype)):
                    raise AssertionError(f"tband fused dt {dt} ht {ht}: the aggregate differs "
                                         "from tband_spmm_direct's output")
        bb, mm = 640, 2048
        a_s = (torch.rand((sb, bh, bb), generator=gen) < 0.05).to(torch.int8).to(dev)
        st_s = (torch.randint(0, (mm - bb) // 16 + 1, (sb,), generator=gen) * 16).to(
            dev, torch.int32)
        a_odd = (torch.rand((sb, bh, 100), generator=gen) < 0.05).to(torch.int8).to(dev)
        # hp 22 and 200: no 4-multiple; Bb 100: A staged by cp.async
        for dp, hp, a_w in ((128, 256, a_s), (256, 256, a_s), (256, 128, a_s), (384, 128, a_s),
                            (256, 200, a_s), (3712, 256, a_s), (128, 22, a_s), (256, 384, a_s),
                            (256, 256, a_odd)):
            for cd, dtype in dtypes:
                xp = torch.randn((mm, dp), generator=gen).to(dev, dtype)
                wp = torch.randn((dp, hp), generator=gen).to(dev, dtype)
                hold_repeatable(
                    f"wide fused {cd} dp {dp} hp {hp} Bb {a_w.shape[2]} bh {bh} +{trash} "
                    "padded entries",
                    lambda: block_spmm.band_fused_spmm_direct(sw_s, st_s, a_w, xp, wp,
                                                              sb - trash, dtype),
                    lambda: block_spmm.band_fused_spmm_direct_plain(sw_s, st_s, a_w, xp, wp,
                                                                    sb - trash, dtype), cd)
                if cd == "float32" and not torch.equal(
                        block_spmm.band_fused_spmm_direct(sw_s, st_s, a_w, xp, wp, sb - trash,
                                                          dtype)[0],
                        block_spmm.band_bucket_spmm_direct(sw_s, st_s, a_w, xp, sb - trash,
                                                           dtype)):
                    raise AssertionError(f"wide fused dp {dp} Bb {a_w.shape[2]}: the aggregate "
                                         "differs from band_bucket_spmm_direct's output")
        counts = [0, 3, 1, 6, 2, 0, 4, 5, 1]
        m = len(counts) * bh
        arrs = tiled_arrays(counts, bh, m // 128, gen)
        plan = types.SimpleNamespace(band_h=bh)
        for dp in (128, 256, 384):
            for cd, dtype in dtypes:
                xp = torch.randn((m, dp), generator=gen).to(dev, dtype)
                hold_repeatable(f"tiled {cd} dp {dp} bh {bh}, {len(counts)} superwindows",
                                lambda: block_spmm.band_tiled_spmm(arrs, xp, plan, dtype),
                                lambda: block_spmm.band_tiled_spmm_plain(arrs, xp, plan, dtype),
                                cd)
        for sb_g in (16, 12):
            a_g = (torch.rand((sb_g, bh, bb), generator=gen) < 0.05).to(torch.int8).to(dev)
            st_g = (torch.randint(0, (mm - bb) // 16 + 1, (sb_g,), generator=gen) * 16).to(
                dev, torch.int32)
            for group in (1, 2, 4, 8):
                for cd, dtype in dtypes:
                    xp = torch.randn((mm, 256), generator=gen).to(dev, dtype)
                    hold_repeatable(
                        f"grouped {cd} G {group} Sb {sb_g} bh {bh}, 3 past num_sw",
                        lambda: block_spmm.band_bucket_spmm_grouped(st_g, a_g, xp, sb_g - 3,
                                                                    dtype, group),
                        lambda: block_spmm.band_bucket_spmm_grouped_plain(
                            st_g, a_g, xp, sb_g - 3, dtype, group), cd)
    log("  tband fused (dt 16-512, ht 16-608: forms ONE, SLAB, WHOLE), wide fused (dp 128-3712, "
        "hp 22-384, Bb 640 and 100), tiled (dp 128-384, empty superwindows) and grouped (G 1-8) "
        "at bh 128 and 256, fp32 and bf16, within tolerance of their plain versions and bitwise "
        "repeatable, the fused aggregates in fp32 equal to the band kernels' outputs: pass")

    src, dst, nn = gio.synthetic_blocks(512, 4, 48, seed=5)
    rp, ci = gio.to_csr(src, dst, nn)
    rp, ci = reorder.apply_permutation(rp, ci, nn, reorder.rcm_reorder(rp, ci, nn))
    rp_e = np.zeros(401, np.int32)  # rows 199.. empty: empty superwindows
    rp_e[1:200] = np.arange(1, 200)
    rp_e[200:] = 199
    ci_e = (np.arange(199) % 150).astype(np.int32)
    for name, (rpk, cik, nk), slots in (("blocks-512", (rp, ci, nn), 2),
                                        ("blocks-512", (rp, ci, nn), 16),
                                        ("empty superwindows", (rp_e, ci_e, 400), 4)):
        op = HybridSpMM(rpk, cik, nk, PlanConfig(band_mode="always", band_h=128,
                                                 band_widths=(512,) if nk == nn else (256,),
                                                 band_impl="tiled", band_tile_slots=slots),
                        device=dev)
        if not op.plan.tiled:
            raise AssertionError(f"{name}: the plan must be tiled")
        x = np.random.RandomState(1).randn(nk, 24).astype(np.float32)
        with torch.no_grad():
            out = op.apply_padded(op.arrays, op.pad_input(x))
        if (out[nk:] != 0).any():
            raise AssertionError(f"{name}: padded rows must stay zero")
        hold(f"tiled plan {name} slots {slots}", op.unpad_output(out, 24),
             csr_matmul(rpk, cik, nk, x), "float32")
    log("  tiled plans (slots 2 and 16; empty superwindows) apply_padded vs scipy: pass")


def tband_fused_at_plan(op, gen, out) -> None:
    """At the blocks stand-in's tband plan: tband_fused_direct at (dt, ht)
    (32, 32) (the Table VI analog's tband shape), (96, 32) (the GIN
    forward's first layer), (192, 32) and (64, 608) (past one block's
    shared memory for the first fused kernel), fp32 and bf16, and (32, 96)
    (the GCN backward's first layer), fp32, against its plain
    version, bitwise repeatable, and in fp32 its aggregate equal bit for bit
    to tband_spmm_direct's output; each timed interleaved with the composed
    pair it replaces (tband_spmm_direct, then torch.matmul of W^T by the
    aggregate) and the band kernel alone, beside its bound; and the band
    kernel's bucket mode timed at the same arrays.  Results go into
    ``out``."""
    import torch

    from hcspmm_tpu_torch.kernels import tband
    from hcspmm_tpu_torch.ops.spmm import _dot

    p, arrs = op.plan, op.arrays["f"]
    st, sw, at = arrs["band0_start"], arrs["band0_sw"], arrs["band0_at"]
    m, num_sw, bh = p.padded_rows, p.padded_rows // p.band_h, p.band_h
    nnz = int(at.count_nonzero())
    for dt, ht in ((32, 32), (96, 32), (192, 32), (64, 608), (32, 96)):
        for cd, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            if (dt, ht) == (32, 96) and cd == "bfloat16":
                continue  # the GCN backward's first layer: timed in fp32 only
            xt = torch.randn((dt, m), generator=gen).to(DEV, dtype)
            wt = (torch.randn((ht, dt), generator=gen) * 0.1).to(DEV, dtype)

            def fused():
                return tband.tband_fused_direct(sw, st, at, xt, wt, num_sw, dtype)

            def band():
                return tband.tband_spmm_direct(sw, st, at, xt, num_sw, dtype)

            def composed():
                agg = band()
                return _dot(wt, agg), agg

            def plain():
                return tband.tband_fused_direct_plain(sw, st, at, xt, wt, num_sw, dtype)

            shape = f"Sb {at.shape[0]}, W {at.shape[1]}, bh {bh}, dt {dt}, ht {ht}"
            err = hold_repeatable(f"tband fused {cd} at {shape}", fused, plain, cd)
            if cd == "float32":
                if not torch.equal(fused()[0], band()):
                    raise AssertionError(f"tband fused at {shape}: the aggregate differs from "
                                         "tband_spmm_direct's output")
                log(f"  tband fused fp32 at {shape}: the aggregate equals tband_spmm_direct's "
                    "output bit for bit")
            elt = xt.element_size()
            row = fused_vs_composed(
                f"tband fused {cd} at {shape}", cd,
                {"fused": fused, "composed": composed, "band": band}, plain,
                at.numel() + (xt.numel() + wt.numel() + (dt + ht) * m) * elt + 8 * at.shape[0],
                2 * nnz * dt + 2 * ht * dt * m, 10 if dt * ht <= 96 * 32 else 3, err)
            fused()
            row["launch"] = dict(tband.last_fused_launch)
            log(f"    its launch: {row['launch']} (resident: the blocks an SM the card gave it)")
            if (dt, ht) == (32, 32):
                row["forms_ab"] = tband_forms_ab(fused, cd, shape)
                out[("tband_fused_direct", cd)] = row
                log(f"    Table VI analog, tband dim 32 {cd}: fused {row['ms']:.4f} ms, composed "
                    f"{row['library_ms']:.4f} ms")
            out[("tband_fused_shapes", (dt, ht), cd)] = row
            del xt, wt
    xt = torch.randn((32, m), generator=gen).to(DEV)
    err = hold("tband bucket fp32", tband.tband_spmm_bucket(st, at, xt),
               tband.tband_spmm_bucket_plain(st, at, xt), "float32")
    sb = at.shape[0]
    bucket_csr = block_csr(at.transpose(1, 2), st, torch.arange(sb, device=DEV), sb, m)
    x_rows = xt.T.contiguous()
    out[("tband_spmm_bucket", "float32")] = timed(
        f"tband bucket mode fp32 at Sb {sb}, W {at.shape[1]}, bh {bh}, dt 32 "
        "(yardstick: torch.sparse.mm)",
        lambda: tband.tband_spmm_bucket(st, at, xt),
        lambda: tband.tband_spmm_bucket_plain(st, at, xt),
        at.numel() + xt.numel() * 4 + 32 * sb * bh * 4 + 4 * sb, 2 * nnz * 32,
        fn_lib=lambda: torch.sparse.mm(bucket_csr, x_rows), err=err)
    del bucket_csr, x_rows, xt


def tband_forms_ab(fused, cd, shape) -> dict:
    """``fused`` (a tband_fused_direct call at ht <= 32, one slab of dt)
    launched in each fused form the kernel takes there, fused_launch's
    choice overridden for the call, timed in 7 interleaved rounds
    (medians)."""
    import torch

    from hcspmm_tpu_torch.kernels import tband

    real = tband.fused_launch
    forms = {"ONE": {"form": tband.FUSE_ONE}, "SLAB": {"form": tband.FUSE_SLAB},
             "WHOLE": {"form": tband.FUSE_WHOLE, "wsm": 0}}

    def in_form(over):
        def call():
            tband.fused_launch = lambda *a, **k: dict(real(*a, **k), **over)
            try:
                return fused()
            finally:
                tband.fused_launch = real
        return call

    calls = {k: in_form(v) for k, v in forms.items()}
    ref = fused()
    for k, call in calls.items():
        if not all(torch.equal(g, r) for g, r in zip(call(), ref)):
            raise AssertionError(f"tband fused {cd} at {shape}: form {k} differs from "
                                 "fused_launch's choice")
    ab = interleaved_ms(calls, 10)
    log(f"    tband fused {cd} at {shape}, its forms (medians of 7 interleaved rounds): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in ab.items()))
    return ab


def wide_new_kernels_at_plan(op_w, op_t, gen, out, launch_runs) -> None:
    """At the blocks stand-in's wide plan (one full-cover bucket): the wide
    fused kernel at (dp, hp) (128, 256) and (256, 256) against its plain
    version, fp32 and bf16, timed beside the composed pair (the direct band
    kernel, then torch.matmul) and its bound, and the Table VI analog at
    dim 96 (dp 128, W [128, 128]: fused and composed interleaved, medians);
    the band kernel's bucket mode timed at dp 256; the grouped band against
    its plain version at G 1/2/4/8 and the grouped A/B (direct vs G = 1, 2,
    4, 8 at dim 96, interleaved, medians; the launch counters zeroed just
    before and read just after).  At the tiled plan: the tiled band at dp
    128 and 256 against its plain version, timed beside torch.sparse.mm of
    its pairs as one CSR matrix.  Results go into ``out``."""
    import torch

    from hcspmm_tpu_torch.kernels import block_spmm
    from hcspmm_tpu_torch.ops.spmm import _dot

    p, arrs = op_w.plan, op_w.arrays["f"]
    m, bh = p.padded_rows, p.band_h
    num_sw = m // bh
    s = block_spmm.single_full_bucket(arrs, p, num_sw)
    if s is None or p.has_spill:
        raise AssertionError("the blocks stand-in's wide plan must have one full-cover "
                             "bucket and no spill")
    st, sw, a = arrs[f"band{s}_start"], arrs[f"band{s}_sw"], arrs[f"band{s}_a"]
    band_csr = block_csr(a, st, sw, num_sw, m)
    nnz = int(band_csr.values().numel())
    label = f"Sb {a.shape[0]}, Bb {a.shape[2]}, bh {bh}"
    log(f"  blocks wide plan: {label}, {num_sw} superwindows, {nnz} band nnz")
    # (dp, hp): the GCN/GIN layers at hidden 256, the Table VI analog at dim
    # 96 (dp 128, W [128, 128]) and CiteSeer's 3703 features (dp 3712, past
    # one block's shared memory for the first fused kernel)
    for dp, hp in ((128, 256), (256, 256), (128, 128), (3712, 256)):
        for cd, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            dgen = torch.Generator(device=DEV).manual_seed(dp + hp)  # up to 1.2 G values
            xp = torch.randn((m, dp), generator=dgen, device=DEV).to(dtype)
            wp = (torch.randn((dp, hp), generator=dgen, device=DEV) * 0.1).to(dtype)

            def fused():
                return block_spmm.band_fused_spmm_direct(sw, st, a, xp, wp, num_sw, dtype)

            def band():
                return block_spmm.band_bucket_spmm_direct(sw, st, a, xp, num_sw, dtype)

            def composed():
                agg = band()
                return agg, _dot(agg.view(m, dp), wp).view(num_sw, -1, hp)

            def plain():
                return block_spmm.band_fused_spmm_direct_plain(sw, st, a, xp, wp, num_sw, dtype)

            shape = f"{label}, dp {dp}, hp {hp}"
            # the plain version gathers [Sb, Bb, dp] at once: at dp 3712 the
            # kernel is held against the composed pair instead
            ref = plain if dp < 1024 else composed
            err = hold_repeatable(f"wide fused {cd} at {shape} vs the "
                                  f"{'plain version' if dp < 1024 else 'composed pair'}",
                                  fused, ref, cd)
            if cd == "float32":
                if not torch.equal(fused()[0], band()):
                    raise AssertionError(f"wide fused at {shape}: the aggregate differs from "
                                         "band_bucket_spmm_direct's output")
                log(f"  wide fused fp32 at {shape}: the aggregate equals "
                    "band_bucket_spmm_direct's output bit for bit")
            elt = xp.element_size()
            row = fused_vs_composed(
                f"wide fused {cd} at {shape}", cd, {"fused": fused, "composed": composed,
                                                "band": band},
                plain if dp < 1024 else None,
                a.numel() + (m * dp + dp * hp + m * (dp + hp)) * elt + 8 * a.shape[0],
                2 * nnz * dp + 2 * m * dp * hp, 10 if dp < 1024 else 2, err)
            fused()
            row["launch"] = dict(block_spmm.last_fused_launch)
            log(f"    its launch: {row['launch']} (resident: the blocks an SM the card gave it)")
            out[("wide_fused_shapes", (dp, hp), cd)] = row
            if (dp, hp) == (256, 256) and cd == "float32":
                out[("band_fused_spmm_direct", 256)] = row
            if (dp, hp) == (128, 128):
                out[("table6 wide", cd)] = row["table6"]
                log(f"    Table VI analog, wide dim 96 (dp 128, W [128, 128]) {cd}: fused "
                    f"{row['ms']:.4f} ms, composed {row['library_ms']:.4f} ms")
            del xp, wp
            torch.cuda.empty_cache()

    xp = torch.randn((m, 256), generator=gen).to(DEV, torch.float32)
    err = hold("wide bucket fp32 dp 256", block_spmm.band_bucket_spmm(st, a, xp),
               block_spmm.band_bucket_spmm_plain(st, a, xp), "float32")
    out[("band_bucket_spmm", 256)] = timed(
        f"wide bucket mode fp32 at {label}, dp 256 (yardstick: torch.sparse.mm)",
        lambda: block_spmm.band_bucket_spmm(st, a, xp),
        lambda: block_spmm.band_bucket_spmm_plain(st, a, xp),
        a.numel() + m * 256 * 4 + a.shape[0] * bh * 256 * 4 + 4 * a.shape[0], 2 * nnz * 256,
        fn_lib=lambda: torch.sparse.mm(band_csr, xp), reps=10, err=err)

    xp = torch.randn((m, 128), generator=gen).to(DEV, torch.float32)
    err = 0.0
    for group in (1, 2, 4, 8):
        err = max(err, hold_repeatable(
            f"grouped fp32 G {group} at {label}, dp 128",
            lambda: block_spmm.band_bucket_spmm_grouped(st, a, xp, num_sw, torch.float32, group),
            lambda: block_spmm.band_bucket_spmm_grouped_plain(st, a, xp, num_sw, torch.float32,
                                                              group), "float32"))
    xb = xp.to(torch.bfloat16)
    hold_repeatable(f"grouped bf16 G 4 at {label}, dp 128",
                    lambda: block_spmm.band_bucket_spmm_grouped(st, a, xb, num_sw, xb.dtype),
                    lambda: block_spmm.band_bucket_spmm_grouped_plain(st, a, xb, num_sw,
                                                                      xb.dtype), "bfloat16")
    del xb
    variants = {"direct": lambda: block_spmm.band_bucket_spmm_direct(sw, st, a, xp, num_sw,
                                                                     xp.dtype)}
    for group in (1, 2, 4, 8):
        variants[f"G{group}"] = (lambda g=group: block_spmm.band_bucket_spmm_grouped(
            st, a, xp, num_sw, xp.dtype, g))
    # the yardstick in the same rounds (the blocks stand-in has no spill: its
    # band blocks are the graph's own CSR)
    variants["torch.sparse.mm"] = lambda: torch.sparse.mm(band_csr, xp)
    zero_counts()
    ab = interleaved_ms(variants, 10)
    launch_runs["grouped A/B"] = read_counts()
    check_counts(launch_runs["grouped A/B"], {"band_bucket_spmm_grouped": 4}, 1)
    log("    grouped A/B at dim 96 (dp 128) fp32, medians of 7 interleaved rounds: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in ab.items()))
    row = timed(f"grouped G 4 fp32 at {label}, dp 128 (yardstick: torch.sparse.mm)",
                variants["G4"],
                lambda: block_spmm.band_bucket_spmm_grouped_plain(st, a, xp, num_sw,
                                                                  torch.float32, 4),
                a.numel() + m * 128 * 4 + min(a.shape[0], num_sw) * bh * 128 * 4
                + 4 * a.shape[0], 2 * nnz * 128, fn_lib=lambda: torch.sparse.mm(band_csr, xp),
                reps=10, err=err)
    row["ab"] = ab
    out[("band_bucket_spmm_grouped", 128)] = row
    del xp, band_csr

    p, arrs = op_t.plan, op_t.arrays["f"]
    ptr, tile, ta = arrs["tp_ptr"], arrs["tp_tile"], arrs["tp_a"]
    pairs = ta.shape[0]
    i, r, k = ta.nonzero(as_tuple=True)
    owner = torch.repeat_interleave(torch.arange(num_sw, device=DEV), (ptr[1:] - ptr[:-1]).long())
    t_csr = torch.sparse_coo_tensor(
        torch.stack([owner[i] * bh + r, tile.long()[i] * 128 + k]),
        torch.ones(i.numel(), device=DEV), (m, m)).coalesce().to_sparse_csr()
    t_nnz = int(i.numel())
    del i, r, k, owner
    runs = (ptr[1:] - ptr[:-1]).long()
    log(f"  blocks tiled plan: {pairs} pairs, at most {int(runs.max())} a superwindow, "
        f"{int((runs == 1).sum())} superwindows of one pair, {t_nnz} nnz, slots {p.tile_slots}")
    for dp in WIDE_DIMS:
        for cd, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            xp = torch.randn((m, dp), generator=gen).to(DEV, dtype)
            err = hold_repeatable(
                f"tiled {cd} at {pairs} pairs, bh {bh}, dp {dp}",
                lambda: block_spmm.band_tiled_spmm(arrs, xp, p, dtype),
                lambda: block_spmm.band_tiled_spmm_plain(arrs, xp, p, dtype), cd)
            if cd == "float32":
                out[("band_tiled_spmm", dp)] = timed(
                    f"tiled fp32 at {pairs} pairs, bh {bh}, dp {dp} (yardstick: "
                    "torch.sparse.mm)",
                    lambda: block_spmm.band_tiled_spmm(arrs, xp, p, dtype),
                    lambda: block_spmm.band_tiled_spmm_plain(arrs, xp, p, dtype),
                    ta.numel() + m * dp * 4 + m * dp * 4 + 4 * (pairs + num_sw + 1),
                    2 * t_nnz * dp, fn_lib=lambda: torch.sparse.mm(t_csr, xp), reps=10,
                    err=err)
            del xp
    del t_csr


def train_fused_mode(rp, ci, n, gen, launch_runs, fused_res) -> None:
    """The kernel-fusion mode trained through ``train.loop.train`` on the
    blocks stand-in: the 6-layer GCN and GIN on the tband plan (dim 96,
    hidden 32, classes 22) and the 3-layer GCN and GIN on the wide plan (dim
    128, hidden 256, classes 40), 3 epochs each with no warm-up, composed,
    then twice with ``op.plan.prefer_fused_kernel = True``, then composed
    again, from the same weights; the launch counters are zeroed just before
    each run and
    read just after: one fused launch per GCN layer's backward and per GIN
    layer's forward; the first epoch's loss equals the composed run's within
    1e-5 relative.  One untimed epoch in each mode first keeps first-call
    costs out of the epoch times."""
    import numpy as np
    import torch

    from hcspmm_tpu_torch.config import PlanConfig
    from hcspmm_tpu_torch.kernels import block_spmm, tband
    from hcspmm_tpu_torch.models.net import Net
    from hcspmm_tpu_torch.ops.spmm import HybridSpMM
    from hcspmm_tpu_torch.train.loop import train

    class Losses:
        def __init__(self):
            self.v = []

        def log(self, **rec):
            self.v.append(rec["loss"])

    y = np.ones(n, dtype=np.int64)
    for layout, dims, kernel in (("tband", (96, 32, 22, 6), "tband_fused_direct"),
                                 ("wide", (128, 256, 40, 3), "band_fused_spmm_direct")):
        op = HybridSpMM(rp, ci, n, PlanConfig(band_impl=layout), device=DEV)
        xin = torch.from_numpy(np.random.RandomState(1).randn(n, dims[0]).astype(np.float32))
        for model in ("gcn", "gin"):
            net = Net(model, *dims)
            for fused in (False, True):  # first-call costs out of the timed runs
                op.plan.prefer_fused_kernel = fused
                train(net, op, xin, y, epochs=1, warmup_epochs=0, seed=3)
            runs = {False: [], True: []}
            # composed, fused, fused, composed: these epochs are host-bound and
            # drift within a call
            for fused in (False, True, True, False):
                op.plan.prefer_fused_kernel = fused
                losses = Losses()
                zero_counts()
                res = train(net, op, xin, y, epochs=3, warmup_epochs=0, seed=3, logger=losses)
                counts = read_counts()
                shapes = (tband if layout == "tband" else block_spmm).fused_shapes
                runs[fused].append((losses.v, res["epoch_ms"], counts,
                                    {f"{a}x{b}": v for (a, b), v in sorted(shapes.items())}))
            op.plan.prefer_fused_kernel = False
            (lc, _, _, _), (lf, _, counts, shapes) = runs[False][0], runs[True][0]
            ms_c = [r[1] for r in runs[False]]
            ms_f = [r[1] for r in runs[True]]
            rel0 = abs(lf[0] - lc[0]) / abs(lc[0])
            rel_last = abs(lf[-1] - lc[-1]) / abs(lc[-1])
            log(f"  blocks {layout} {model} {dims}: composed losses {lc}, epoch_ms "
                f"{ms_c[0]:.3f} and {ms_c[1]:.3f}; fused losses {lf}, epoch_ms {ms_f[0]:.3f} "
                f"and {ms_f[1]:.3f}; first-epoch rel diff "
                f"{rel0:.2e}, last {rel_last:.2e}; fused launches by "
                f"({'dt, ht' if layout == 'tband' else 'dp, hp'}) {shapes}; fused run's "
                f"launches {counts}")
            if not all(math.isfinite(v) for v in lf) or rel0 > 1e-5 or rel_last > 1e-3:
                raise AssertionError(f"{layout} {model}: the fused run's losses {lf} differ "
                                     f"from the composed run's {lc}")
            check_counts(counts, {kernel: 1}, dims[3] * 3)
            launch_runs[f"blocks {layout} {model} fused"] = counts
            fused_res[(layout, model)] = dict(composed_ms=ms_c, fused_ms=ms_f, rel0=rel0,
                                              launches=counts[kernel], shapes=shapes)
        del op
        torch.cuda.empty_cache()


def packed_forms(at):
    """{pack: the int8 0/1 blocks ``at`` [Sb, W, bh] on the card in that
    encoding}: pack 1 itself, 2 and 8 packed by the port's own packers
    (format/streams.py, as a plan's upload packs them)."""
    import torch

    from hcspmm_tpu_torch.format.streams import pack_a_bits, pack_a_nibble

    host = at.cpu().numpy()
    return {1: at, 2: torch.from_numpy(pack_a_nibble(host)).to(DEV),
            8: torch.from_numpy(pack_a_bits(host)).to(DEV)}


def packed_small_shapes(gen) -> None:
    """The band kernel and its fused forms at packs 2 and 8 against pack 1
    at small odd shapes (bh 32-512, W 64-896: W/8 below 64, a multiple of
    64 and neither; nibble rows of 16 to 256 bytes, some in 16-byte boxes;
    capacity-padded entries), fp32 and bf16: BAND direct with zero items
    (a run of eight and singles) and bucket mode, and the fused forms ONE,
    SLAB and WHOLE, every output bit for bit pack 1's and bitwise
    repeatable; pack 1 against its plain version."""
    import torch

    from hcspmm_tpu_torch.kernels import tband

    # (dt, W, bh, M)
    small = [(16, 64, 128, 1024),   # W/8 = 8: a stage holds all eight planes
             (32, 192, 32, 768),    # nibble rows of 16 bytes: unswizzled boxes
             (48, 256, 96, 768),    # nibble rows of 48 bytes; three feature slabs
             (32, 448, 256, 1024),  # W/8 = 56
             (16, 768, 256, 2048),  # W/8 = 96: every other stage spans two planes
             (32, 896, 256, 2048),  # GH's W: W/8 = 112
             (96, 512, 160, 1024),  # nibble rows of 80 bytes; W/8 = 64
             (16, 320, 320, 1024),  # warps of 32 columns, nibble rows of 160 bytes
             (32, 640, 512, 1024),  # bh 512, W/8 = 80
             (16, 128, 288, 512)]   # a warp's 32 columns across both nibble halves
    forms = {p: set() for p in (1, 2, 8)}
    names = {tband.FUSE_ONE: "ONE", tband.FUSE_SLAB: "SLAB", tband.FUSE_WHOLE: "WHOLE"}
    for dt, w, bh, mm in small:
        real, trash, num_sw = 5, 2, 24  # superwindows 16-23: a run of eight missing
        perm = torch.randperm(16, generator=gen)
        sw_d = torch.cat([perm[:real], torch.full((trash,), num_sw)]).to(DEV, torch.int32)
        miss8 = torch.tensor([2], dtype=torch.int32, device=DEV)
        miss1 = perm[real:].sort().values.to(DEV, torch.int32)
        sw_f = torch.cat([torch.randperm(real, generator=gen),
                          torch.full((trash,), real)]).to(DEV, torch.int32)
        st = (torch.randint(0, (mm - w) // 128 + 1, (real + trash,), generator=gen) * 128).to(
            DEV, torch.int32)
        at = packed_forms((torch.rand((real + trash, w, bh), generator=gen) < 0.05).to(
            torch.int8).to(DEV))
        for cd, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            xt = torch.randn((dt, mm), generator=gen).to(DEV, dtype)
            label = f"dt {dt} W {w} bh {bh} {cd}"

            def runs(p, hts=(32, 96)):
                outs = [tband.tband_spmm_direct(sw_d, st, at[p], xt, num_sw, dtype, miss8, miss1,
                                                pack=p),
                        tband.tband_spmm_bucket(st, at[p], xt, pack=p)]
                for ht in hts:
                    wt = (torch.randn((ht, dt), generator=torch.Generator().manual_seed(ht))
                          * 0.1).to(DEV, dtype)
                    outs += tband.tband_fused_direct(sw_f, st, at[p], xt, wt, real, dtype, pack=p)
                    forms[p].add(names[tband.last_fused_launch["form"]])
                return outs

            ref = runs(1)
            check(f"packed small shapes: pack 1 direct {label} vs plain", ref[0],
                  tband.tband_spmm_direct_plain(sw_d, st, at[1], xt, num_sw, dtype, miss8, miss1),
                  cd)
            for p in (2, 8):
                got, again = runs(p), runs(p)
                for i, (g, a, r) in enumerate(zip(got, again, ref)):
                    if not torch.equal(g, a):
                        raise AssertionError(f"pack {p} {label} output {i}: two runs differ")
                    if not torch.equal(g, r):
                        raise AssertionError(f"pack {p} {label} output {i} (direct, bucket, "
                                             "then each fused agg and out): differs from pack 1")
    for p in (2, 8):
        if forms[p] != {"ONE", "SLAB", "WHOLE"}:
            raise AssertionError(f"pack {p} ran the fused forms {sorted(forms[p])}, not all three")
    log(f"  packs 2 and 8 at {len(small)} small shapes, fp32 and bf16: direct (with zero items), "
        f"bucket and fused ({', '.join(sorted(forms[8]))}) outputs equal pack 1's bit for bit, "
        "bitwise repeatable")


def packed_at_plan(key, graph, gen, out) -> None:
    """The band kernel at packs 1, 2 and 8 at a graph's own tband plans
    (``PlanConfig(band_impl='tband', tband_pack=p)``, uploaded by the
    operator: ``band{s}_at`` int8, then uint8 nibbles and bits): each packed
    upload expands to pack 1's blocks exactly; direct mode at dt 32, fp32 and
    bf16, bit for bit pack 1's on the owned blocks and bitwise repeatable,
    each pack held against its plain version (its row's ``err``), the three
    packs and torch.sparse.mm of the blocks timed in 7 interleaved rounds
    (medians) beside each pack's plain version and bytes bound; on the
    blocks stand-in also the bucket mode (beside torch.sparse.mm of the
    blocks' CSR in entry order) and the fused kernel at dt 32 / ht 32 (beside
    the composed pair at the same pack: the band kernel, then torch.matmul),
    fp32, the same way; apply_padded at each pack against scipy.  Rows go
    into ``out[(kernel, key, cd)]`` as {pack: row}."""
    import numpy as np
    import torch

    from hcspmm_tpu_torch.config import PlanConfig
    from hcspmm_tpu_torch.kernels import tband
    from hcspmm_tpu_torch.ops.spmm import HybridSpMM, _dot

    rp, ci, n = graph
    t0 = time.perf_counter()
    ops = {p: HybridSpMM(rp, ci, n, PlanConfig(band_impl="tband", tband_pack=p), device=DEV)
           for p in (1, 2, 8)}
    p1 = ops[1].plan
    s = max(range(len(p1.band_widths)), key=lambda i: len(p1.band_sw_ids[i]))
    arrs = {p: op.arrays["f"] for p, op in ops.items()}
    st, sw = arrs[1][f"band{s}_start"], arrs[1][f"band{s}_sw"]
    at = {p: a[f"band{s}_at"] for p, a in arrs.items()}
    m, bh = p1.padded_rows, p1.band_h
    num_sw = m // bh
    for p in (2, 8):
        if not (torch.equal(arrs[p][f"band{s}_start"], st) and torch.equal(arrs[p][f"band{s}_sw"],
                                                                           sw)):
            raise AssertionError(f"{key}: the pack {p} plan's entries differ from pack 1's")
        if at[p].dtype != torch.uint8 or not torch.equal(tband.expand_at(at[p], p), at[1]):
            raise AssertionError(f"{key}: the pack {p} upload does not expand to pack 1's blocks")
    nnz = int(at[1].count_nonzero())
    shape = f"Sb {at[1].shape[0]}, W {at[1].shape[1]}, bh {bh}, dt 32"
    log(f"  {key}: plans at packs 1, 2, 8 ({time.perf_counter() - t0:.1f} s with upload); "
        + "; ".join(f"band{s}_at pack {p}: {a.dtype} {tuple(a.shape)}, {a.numel()} device bytes"
                    for p, a in at.items()))
    a_rows = block_csr(at[1].transpose(1, 2), st, sw, num_sw, m)
    owned = torch.zeros(num_sw, dtype=torch.bool, device=DEV)
    owned[sw[sw < num_sw].long()] = True
    cols = owned.repeat_interleave(bh)

    def packs_row(kernel, cd, fns, plains, nbytes_of, ops_n, view, lib=None, reps=20):
        """Hold each pack's ``fns[p]`` against its plain version ``plains[p]``
        on the compared part ``view`` of each output, then time the packs'
        ``fns`` (and ``lib``: one callable, or one a pack) in 7 interleaved
        rounds; one row a pack with its error, its plain version's time and
        its bound."""
        errs = {}
        for p in fns:
            got, want = fns[p](), plains[p]()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            errs[p] = max(check(f"{key} {kernel} pack {p} {cd} output {i} vs plain", view(g),
                                view(w), cd) for i, (g, w) in enumerate(zip(got, want)))
        timed_fns = {f"pack {p}": f for p, f in fns.items()}
        if callable(lib):
            timed_fns["library"] = lib
        elif lib:
            timed_fns.update({f"library {p}": f for p, f in lib.items()})
        ab = interleaved_ms(timed_fns, reps)
        rows = {}
        for p in fns:
            b_ms, b_by = bound(nbytes_of(p), ops_n, cd)
            rows[p] = dict(ms=ab[f"pack {p}"], plain_ms=cuda_time_ms(plains[p], 2),
                           library_ms=ab.get(f"library {p}", ab.get("library")), bound_ms=b_ms,
                           bound_by=b_by, at_bytes=at[p].numel(), err=errs[p], shape=shape)
        log(f"    {key} {kernel} {cd} at {shape}: " + "; ".join(
            f"pack {p} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
            f"{'none' if r['library_ms'] is None else round(r['library_ms'], 4)}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}, A_t {r['at_bytes']} bytes)"
            for p, r in rows.items()) + " (medians of 7 interleaved rounds)")
        out[(kernel, key, cd)] = rows

    for cd, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        xt = torch.randn((32, m), generator=gen).to(DEV, dtype)
        elt = xt.element_size()

        def direct(p):
            return lambda: tband.tband_spmm_direct(sw, st, at[p], xt, num_sw, dtype, pack=p)

        ref = direct(1)()
        for p in (2, 8):
            got = direct(p)()
            if not torch.equal(got[:, cols], direct(p)()[:, cols]):
                raise AssertionError(f"{key} pack {p} direct {cd}: two runs differ")
            if not torch.equal(got[:, cols], ref[:, cols]):
                raise AssertionError(f"{key} pack {p} direct {cd}: differs from pack 1")
        log(f"  {key} direct {cd}: packs 2 and 8 equal pack 1 bit for bit, bitwise repeatable")
        x_rows = xt.T.contiguous()
        a_cd = a_rows.to(dtype)
        packs_row("tband_spmm", cd, {p: direct(p) for p in (1, 2, 8)},
                  {p: (lambda p=p: tband.tband_spmm_direct_plain(sw, st, at[p], xt, num_sw, dtype,
                                                                 pack=p)) for p in (1, 2, 8)},
                  lambda p: at[p].numel() + xt.numel() * elt + 32 * m * elt + 8 * at[p].shape[0],
                  2 * nnz * 32, lambda o: o[:, cols], lib=lambda: torch.sparse.mm(a_cd, x_rows))
        del a_cd
        if key == "blocks" and cd == "float32":
            sb = at[1].shape[0]
            refs = tband.tband_spmm_bucket(st, at[1], xt)
            bucket_csr = block_csr(at[1].transpose(1, 2), st, torch.arange(sb, device=DEV), sb, m)
            for p in (2, 8):
                if not torch.equal(tband.tband_spmm_bucket(st, at[p], xt, pack=p), refs):
                    raise AssertionError(f"{key} pack {p} bucket: differs from pack 1")
            packs_row("tband_spmm_bucket", cd,
                      {p: (lambda p=p: tband.tband_spmm_bucket(st, at[p], xt, pack=p))
                       for p in (1, 2, 8)},
                      {p: (lambda p=p: tband.tband_spmm_bucket_plain(st, at[p], xt, pack=p))
                       for p in (1, 2, 8)},
                      lambda p: at[p].numel() + xt.numel() * 4 + 32 * sb * bh * 4 + 4 * sb,
                      2 * nnz * 32, lambda o: o, lib=lambda: torch.sparse.mm(bucket_csr, x_rows))
            del bucket_csr
            wt = (torch.randn((32, 32), generator=gen) * 0.1).to(DEV)
            refs = tband.tband_fused_direct(sw, st, at[1], xt, wt, num_sw, dtype)
            for p in (2, 8):
                got = tband.tband_fused_direct(sw, st, at[p], xt, wt, num_sw, dtype, pack=p)
                if not all(torch.equal(g[:, cols], r[:, cols]) for g, r in zip(got, refs)):
                    raise AssertionError(f"{key} pack {p} fused: differs from pack 1")
            log(f"  {key} bucket and fused (dt 32 / ht 32) fp32: packs 2 and 8 equal pack 1 "
                "bit for bit")
            packs_row("tband_fused_direct", cd,
                      {p: (lambda p=p: tband.tband_fused_direct(sw, st, at[p], xt, wt, num_sw,
                                                                dtype, pack=p))
                       for p in (1, 2, 8)},
                      {p: (lambda p=p: tband.tband_fused_direct_plain(sw, st, at[p], xt, wt,
                                                                      num_sw, dtype, pack=p))
                       for p in (1, 2, 8)},
                      lambda p: at[p].numel() + (xt.numel() + wt.numel() + 64 * m) * 4
                      + 8 * at[p].shape[0], 2 * nnz * 32 + 2 * 32 * 32 * m,
                      lambda o: o[:, cols], reps=10,
                      lib={p: (lambda p=p: _dot(wt, direct(p)())) for p in (1, 2, 8)})
        del xt, ref, x_rows
    x = np.random.RandomState(0).randn(n, 32).astype(np.float32)
    want = csr_matmul(rp, ci, n, x)
    for p, op in ops.items():
        with torch.no_grad():
            got = op.unpad_output(op.apply_padded(op.arrays, op.pad_input(x)), 32)
        check(f"{key} pack {p} apply_padded vs scipy", got, want, "float32")
    del ops, arrs, at, a_rows
    torch.cuda.empty_cache()


def train_packed(rp, ci, n, launch_runs, out) -> None:
    """The 6-layer GCN (dim 96, hidden 32, classes 22) trained 3 epochs
    through ``train.loop.train`` on the blocks stand-in's tband plans at
    pack 1 and pack 8 from the same weights, composed and in the fused mode
    (``op.plan.prefer_fused_kernel = True``), the launch counters zeroed
    just before each run and read just after: every launch of tband_kernel
    in a pack 8 run reads pack 8 (at least the 12 SpMMs of each step), and
    its losses equal pack 1's bit for bit."""
    import numpy as np
    import torch

    from hcspmm_tpu_torch.config import PlanConfig
    from hcspmm_tpu_torch.models.net import Net
    from hcspmm_tpu_torch.ops.spmm import HybridSpMM
    from hcspmm_tpu_torch.train.loop import train

    class Losses:
        def __init__(self):
            self.v = []

        def log(self, **rec):
            self.v.append(rec["loss"])

    net = Net("gcn", 96, 32, 22, 6)
    xin = torch.from_numpy(np.random.RandomState(1).randn(n, 96).astype(np.float32))
    y = np.ones(n, dtype=np.int64)
    for fused in (False, True):
        losses = {}
        for p in (1, 8):
            op = HybridSpMM(rp, ci, n, PlanConfig(band_impl="tband", tband_pack=p), device=DEV)
            op.plan.prefer_fused_kernel = fused
            train(net, op, xin, y, epochs=1, warmup_epochs=0, seed=3)  # first-call costs
            rec = Losses()
            zero_counts()
            res = train(net, op, xin, y, epochs=3, warmup_epochs=0, seed=3, logger=rec)
            counts = read_counts()
            losses[p] = rec.v
            mode = "fused" if fused else "composed"
            log(f"  blocks GCN at pack {p}, {mode}: losses {rec.v}, epoch_ms "
                f"{res['epoch_ms']:.3f}; launches {counts}")
            total = counts["tband_spmm"] + counts["tband_fused_direct"]
            if counts[f"tband_pack{p}"] != total or total < SPMMS_PER_STEP * 3:
                raise AssertionError(f"pack {p} {mode}: {counts[f'tband_pack{p}']} of {total} "
                                     f"tband_kernel launches read pack {p}; at least "
                                     f"{SPMMS_PER_STEP * 3} expected")
            if fused:
                check_counts(counts, {"tband_fused_direct": 1}, 6 * 3)
            launch_runs[f"blocks gcn tband pack {p} {mode}"] = counts
            out[(p, mode)] = dict(losses=rec.v, epoch_ms=res["epoch_ms"])
            del op
        if losses[8] != losses[1] or not all(math.isfinite(v) for v in losses[8]):
            raise AssertionError(f"pack 8 losses {losses[8]} differ from pack 1's {losses[1]}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 23-24: the distributed SpMM over gloo ranks on the card; checkpoint
# and elastic restart
# ---------------------------------------------------------------------------

DIST_NET = dict(num_features=96, hidden=32, num_classes=22, num_layers=6)
DIST_DIM = 32  # the SpMM checks' width: the 6-layer GCN's hidden width
DIST_STEPS = 3
#: SpMMs of one training step: GIN's first layer needs no input gradient
DIST_SPMMS = {"gcn": 12, "gin": 11}
DIST_KERNELS = ("dense_bucket_spmm", "ell_bucket_spmm", "band_bucket_spmm",
                "band_bucket_spmm_direct")


def dist_inputs(n) -> tuple:
    """The distributed phase's inputs, made from seeds where they are used
    (a spawned rank gets only the graph): X [n, 32] for the SpMM and the
    GCN's features [n, 96], float32."""
    import numpy as np

    return (np.random.RandomState(0).randn(n, DIST_DIM).astype(np.float32),
            np.random.RandomState(1).randn(n, DIST_NET["num_features"]).astype(np.float32))


def shard_kernels_vs_plain(op, xv) -> dict:
    """Each row-layout kernel that ``spmm_rows`` runs on this rank's shard
    plan, launched by its wrapper at the plan's own arrays and the rank's
    exchanged view ``xv`` [num_cols, D] fp32 and held against its plain
    version, two runs bitwise equal: the band kernel's direct mode (#14,
    the main bucket of a full-cover plan; owned blocks compared) and bucket
    mode (#12, every other bucket with entries), the dense kernel (#10) and
    the ELL kernel (#11) into zero-filled [N, D] results.  Returns
    {kernel: max_abs_err}."""
    import torch

    from hcspmm_tpu_torch.kernels import block_spmm as bs

    p, arrs, n, d = op.plan, op.arrays, op.plan.num_nodes, xv.shape[1]
    errs = {}
    real = [s for s in range(len(p.band_widths)) if len(p.band_sw_ids[s])]
    if real:
        xb = bs._band_table(xv, p)
        num_sw = max(p.band_num_sw, -(-n // p.band_h))
        main = max(real, key=lambda s: len(p.band_sw_ids[s])) if bs.band_covers_all(p) else None
        for s in real:
            st, a, sw = arrs[f"band{s}_start"], arrs[f"band{s}_a"], arrs[f"band{s}_sw"]
            if s == main:
                own = sw[: len(p.band_sw_ids[s])].long()
                errs["band_bucket_spmm_direct"] = hold_repeatable(
                    f"rank {op.rank} band{s} direct", lambda: bs.band_bucket_spmm_direct(
                        sw, st, a, xb, num_sw, torch.float32)[own],
                    lambda: bs.band_bucket_spmm_direct_plain(sw, st, a, xb, num_sw,
                                                             torch.float32)[own], "float32")
            else:
                errs["band_bucket_spmm"] = max(errs.get("band_bucket_spmm", 0.0), hold_repeatable(
                    f"rank {op.rank} band{s} bucket", lambda: bs.band_bucket_spmm(st, a, xb),
                    lambda: bs.band_bucket_spmm_plain(st, a, xb), "float32"))
    if any(arrs[f"b{b}_wid"].shape[0] for b in range(len(p.bucket_widths))
           if f"b{b}_wid" in arrs):
        errs["dense_bucket_spmm"] = hold_repeatable(
            f"rank {op.rank} dense rows", lambda: bs.dense_rows(
                arrs, p, xv, torch.zeros((n, d), device=xv.device)),
            lambda: bs.dense_rows_plain(arrs, p, xv, torch.zeros((n, d), device=xv.device)),
            "float32")
    if "rw_node" in arrs:
        errs["ell_bucket_spmm"] = hold_repeatable(
            f"rank {op.rank} ELL rows", lambda: bs.ell_rows(
                arrs, xv, torch.zeros((n, d), device=xv.device)),
            lambda: bs.ell_rows_plain(arrs["rw_node"], arrs["rw_ptr"], arrs["rw_cols"], xv,
                                      torch.zeros((n, d), device=xv.device)), "float32")
    return errs


def shard_launches(op) -> dict:
    """The launches of #10, #11, #12 and #14 that one SpMM must make on
    this rank's shard plan, from the plan's populations: on a full band
    cover, the direct mode once (the most populated bucket) and the bucket
    mode once for each other bucket with entries; otherwise the bucket mode
    once for each bucket owning rows, the dense kernel once for each eight
    dense buckets with windows and the ELL kernel once where the row table
    has rows."""
    from hcspmm_tpu_torch.kernels import block_spmm as bs

    p, arrs = op.plan, op.arrays
    if bs.band_covers_all(p):
        real = sum(1 for v in p.band_sw_ids if len(v))
        return dict(band_bucket_spmm_direct=1, band_bucket_spmm=real - 1, dense_bucket_spmm=0,
                    ell_bucket_spmm=0)
    dense = sum(1 for b in range(len(p.bucket_widths))
                if f"b{b}_wid" in arrs and arrs[f"b{b}_wid"].shape[0])
    return dict(band_bucket_spmm_direct=0,
                band_bucket_spmm=sum(1 for s in range(len(p.band_widths))
                                     if arrs[f"band{s}_rq"].shape[0]),
                dense_bucket_spmm=-(-dense // bs._MAX_BUCKETS),
                ell_bucket_spmm=int("rw_node" in arrs and arrs["rw_node"].shape[0] > 0))


def dist_rank(rank, world, device, cases, params_np, spawned) -> list:
    """One rank of phase 23 (``parallel.dryrun.run_ranks`` spawns it): for
    each case, the DistHybridSpMM of its mode over the case's graph; one
    SpMM at D 32, then for each of the case's models ``DIST_STEPS`` Adam
    steps of the 6-layer net (``dryrun.train_step`` from ``params_np``),
    the launch counters zeroed just before each of these runs and read
    just after; then the SpMM's rows against scipy, timings (rank 0's are
    printed) and each kernel of the shard plan against its plain version.
    Returns per case this rank's rows of the SpMM, the launches its plan
    must make a SpMM (``shard_launches``), the counts, each model's losses
    and trained parameters (rank 0) and the times, and the seconds from
    ``spawned`` (the parent's clock before the spawn) to this function's
    start."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    import torch.distributed as dist

    from hcspmm_tpu_torch.models.net import Net, params_from_jax
    from hcspmm_tpu_torch.parallel import dryrun
    from hcspmm_tpu_torch.parallel.dist_spmm import DistHybridSpMM

    startup_s = time.time() - spawned
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def wall_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    def step(net, params, op, opt, xin, y, times):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        loss = float(dryrun.train_step(net, params, op, opt, xin, y))  # waits for the card
        times.append((time.perf_counter() - t0) * 1e3)
        return loss

    results = []
    for case in cases:
        t0 = time.perf_counter()
        op = DistHybridSpMM(case["rp"], case["ci"], case["n"], config=case["config"],
                            mode=case["mode"], device=device)
        torch.cuda.synchronize()
        p = op.plan
        res = dict(startup_s=startup_s, build_s=time.perf_counter() - t0, rows=p.num_nodes,
                   cols=p.num_cols,
                   n_padded=op.n_padded, halo_pair=op.sharded.halo_pair,
                   far_pair=op.sharded.far_pair, full_cover=bool(p.band_full_cover),
                   band_entries=[len(v) for v in p.band_sw_ids],
                   band_capacity=[int(s.shape[0]) for s in p.band_starts],
                   dense_windows=p.num_dense_windows,
                   ell_rows=[len(r) for r in p.ell_row_ids], spill_edges=int(p.spill_nnz),
                   exchange_rows=op.exchange_rows(), expect=shard_launches(op))
        xg, feat = dist_inputs(case["n"])
        x, xin = op.local_rows(xg), op.local_rows(feat)
        y = torch.ones(op.rows_per_shard, dtype=torch.int64, device=op.device)
        dist.barrier()
        t0 = time.perf_counter()
        zero_counts()
        with torch.no_grad():
            z = op(x)
        torch.cuda.synchronize()
        res["spmm_counts"] = read_counts()
        res.update(counts={}, losses={}, step_ms={}, params={})
        for model in case["models"]:
            net = Net(model=model, **DIST_NET)
            params = params_from_jax(params_np[model], device=op.device)
            opt = dryrun.adam(params)
            step_ms = []
            zero_counts()
            losses = [step(net, params, op, opt, xin, y, step_ms) for _ in range(DIST_STEPS)]
            res["counts"][model] = read_counts()
            res["step_ms"][model] = step_ms
            res["losses"][model] = losses
            if rank == 0:
                res["params"][model] = [{k: v.detach().cpu().numpy().copy()
                                         for k, v in layer.items()} for layer in params]
        res["run_s"] = time.perf_counter() - t0
        res["z"] = z.cpu().numpy()
        lo = op.rank * op.rows_per_shard
        a = sp.csr_matrix((np.ones(len(case["ci"])), case["ci"], case["rp"]),
                          shape=(case["n"], case["n"]))
        ref = np.zeros((op.rows_per_shard, DIST_DIM))
        hi = min(lo + op.rows_per_shard, case["n"])
        if hi > lo:
            ref[: hi - lo] = a[lo:hi] @ xg.astype(np.float64)
        res["scipy_err"] = hold(f"rank {rank} {case['name']} SpMM vs scipy", z, ref, "float32")
        t0 = time.perf_counter()
        with torch.no_grad():
            res["spmm_ms"] = wall_ms(lambda: op(x), 5)
            res["exchange_ms"] = wall_ms(lambda: op.exchange(x), 5)
            xv = op.exchange(x)
            res["local_ms"] = cuda_time_ms(lambda: op.local_spmm(xv), 10)
        res["time_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["kernel_errs"] = shard_kernels_vs_plain(op, xv)
        res["check_s"] = time.perf_counter() - t0
        results.append(res)
        del op, xv
        torch.cuda.empty_cache()
    return results


def dist_reference(case, model, params_np, ref_ops) -> dict:
    """The single-process port on the same graph padded to ``n_padded``
    rows (``dist_spmm.shard_config``'s plan, row layout): the SpMM at D 32,
    its time, and ``DIST_STEPS`` Adam steps of the 6-layer ``model`` from
    ``params_np`` with the distributed step's loss (NLL over the padded
    rows, all-ones labels)."""
    import numpy as np
    import torch

    from hcspmm_tpu_torch.models.net import Net, net_forward, params_from_jax
    from hcspmm_tpu_torch.ops.spmm import HybridSpMM
    from hcspmm_tpu_torch.parallel import dryrun
    from hcspmm_tpu_torch.parallel.dist_spmm import shard_config
    from hcspmm_tpu_torch.train.loop import Bound

    n, m = case["n"], case["n_padded"]
    cfg = shard_config(case["config"], case["mode"])
    key = (case["graph"], cfg)
    if key not in ref_ops:
        rp = np.concatenate([case["rp"], np.full(m - n, case["rp"][-1], case["rp"].dtype)])
        ref_ops.clear()
        ref_ops[key] = HybridSpMM(rp, case["ci"], m, cfg, device=DEV)
    op = ref_ops[key]
    pad = lambda v: torch.from_numpy(np.concatenate([v, np.zeros((m - n, v.shape[1]),
                                                                 np.float32)])).to(DEV)
    x, xin = (pad(v) for v in dist_inputs(n))
    with torch.no_grad():
        z = op(x)
        ms = cuda_time_ms(lambda: op(x), 10)
    bound = Bound(op)
    bound.padded_layout = False  # the row layout, as every rank runs it
    net = Net(model=model, **DIST_NET)
    params = params_from_jax(params_np, device=DEV)
    opt = dryrun.adam(params)
    y = torch.ones(m, dtype=torch.int64, device=DEV)
    losses = []
    for _ in range(DIST_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = dryrun.nll_sum(net_forward(net, params, bound, xin), y) / m
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return dict(z=z.cpu().numpy(), ms=ms, losses=losses,
                params=[{k: v.detach().cpu().numpy() for k, v in layer.items()}
                        for layer in params])


def dist_phase(graphs, launch_runs, out) -> None:
    """Phase 23: ``DistHybridSpMM`` over gloo ranks sharing the card.  On
    the full-size DD stand-in (cluster order) at 4 ranks: halo (intended
    and calibrated selectors), band_halo and allgather; on the blocks
    stand-in (rcm) band_halo at 2 ranks.  For each: the SpMM against scipy
    (each rank) and against the single-process port on the same graph, the
    6-layer GCN's (and in band_halo on DD also GIN's) losses and updated
    parameters after 3 Adam steps against the single-process port's from
    the same parameters (losses within 1e-5 relative, parameters within
    1e-4 of each tensor's max|p|), each rank's kernels of its shard plan
    against their plain versions, and each rank's launches of #10, #11,
    #12 and #14 in the SpMM and in each model's steps, exactly what its
    shard plan implies (``shard_launches``); each of the four must be
    launched in some mode.  Logs rank 0's distributed SpMM and step times,
    the exchange's bytes and the single-process SpMM's time."""
    import numpy as np
    import torch

    from hcspmm_tpu_torch.config import PlanConfig
    from hcspmm_tpu_torch.models.net import Net, init_net_params
    from hcspmm_tpu_torch.parallel import dryrun

    params_np = {}
    for model in DIST_SPMMS:
        params = init_net_params(Net(model=model, **DIST_NET), torch.Generator().manual_seed(0),
                                 init="glorot", device="cpu")
        params_np[model] = [{k: v.detach().numpy() for k, v in layer.items()}
                            for layer in params]
    gcn, both = ("gcn",), ("gcn", "gin")
    worlds = {4: [("DD halo intended", "DD", "halo", PlanConfig(loi_mode="intended"), gcn),
                  ("DD halo calibrated", "DD", "halo", PlanConfig(loi_mode="calibrated"), gcn),
                  ("DD band_halo", "DD", "band_halo", PlanConfig(), both),
                  ("DD allgather", "DD", "allgather", PlanConfig(), gcn)],
              2: [("blocks band_halo", "blocks", "band_halo", PlanConfig(), gcn)]}
    ref_ops = {}
    for world, specs in worlds.items():
        cases = []
        for name, g, mode, cfg, models in specs:
            rp, ci, n = graphs[g]
            cases.append(dict(name=name, graph=g, rp=rp, ci=ci, n=n, mode=mode, config=cfg,
                              models=models))
        t0 = time.perf_counter()
        ranks = dryrun.run_ranks(dist_rank, world, DEV, (cases, params_np, time.time()))
        world_s = dict(world_s=time.perf_counter() - t0,
                       startup_s=max(r[0]["startup_s"] for r in ranks))
        log(f"  {world} ranks: {world_s['world_s']:.1f} s spawned, run and joined; "
            f"{world_s['startup_s']:.1f} s of it before the ranks' first case")
        for i, case in enumerate(cases):
            per = [r[i] for r in ranks]
            r0 = per[0]
            name = case["name"]
            case["n_padded"] = r0["n_padded"]
            for rank, r in enumerate(per):
                expect = {k: r["expect"][k] for k in DIST_KERNELS}
                check_counts(r["spmm_counts"], expect, 1, exact=True)
                for model in case["models"]:
                    check_counts(r["counts"][model], expect, DIST_SPMMS[model] * DIST_STEPS,
                                 exact=True)
            spmm_counts = {k: sum(r["spmm_counts"][k] for r in per) for k in DIST_KERNELS}
            launch_runs[f"dist {name} spmm"] = {k: sum(r["spmm_counts"][k] for r in per)
                                                 for k in r0["spmm_counts"]}
            res = dict(ranks=world, spmm_ms=r0["spmm_ms"], exchange_ms=r0["exchange_ms"],
                       local_ms=r0["local_ms"], exchange_bytes_per_rank=r0["exchange_rows"]
                       * DIST_DIM * 4, launches_per_spmm=spmm_counts,
                       expected_per_spmm=[r["expect"] for r in per], models={})
            t0 = time.perf_counter()
            for model in case["models"]:
                ref = dist_reference(case, model, params_np[model], ref_ops)
                for r in per:
                    if r["losses"][model] != r0["losses"][model]:
                        raise AssertionError(f"{name} {model}: the ranks' losses differ")
                np.testing.assert_allclose(r0["losses"][model], ref["losses"], rtol=1e-5,
                                           err_msg=f"{name} {model} losses")
                for got, want in zip(r0["params"][model], ref["params"]):
                    for k in got:
                        dp = float(np.abs(got[k] - want[k]).max())
                        if not dp <= 1e-4 * float(np.abs(want[k]).max()):
                            raise AssertionError(f"{name} {model}: parameter {k} differs by "
                                                 f"{dp:.3e}")
                counts = {k: sum(r["counts"][model][k] for r in per)
                          for k in r0["counts"][model]}
                launch_runs[f"dist {name} {model}"] = counts
                res["models"][model] = dict(
                    step_ms=r0["step_ms"][model], losses=r0["losses"][model],
                    single_losses=ref["losses"],
                    launches_per_step={k: counts[k] / DIST_STEPS for k in DIST_KERNELS})
            z = np.concatenate([r["z"] for r in per])
            res["err_vs_single"] = hold(f"{name} SpMM vs the single-process port", z, ref["z"],
                                        "float32")
            res["single_spmm_ms"] = ref["ms"]
            res["kernel_errs"] = {}
            for r in per:
                for k, v in r["kernel_errs"].items():
                    res["kernel_errs"][k] = max(res["kernel_errs"].get(k, 0.0), v)
            res["seconds"] = {k: max(r[k] for r in per) for k in (
                "build_s", "run_s", "time_s", "check_s")} | world_s | {
                "reference_s": time.perf_counter() - t0}
            res["shards"] = [{k: r[k] for k in (
                "rows", "cols", "full_cover", "band_entries", "band_capacity", "dense_windows",
                "ell_rows", "spill_edges", "halo_pair", "far_pair")} for r in per]
            out[name] = res
            trained = "; ".join(
                f"{m} steps {[round(v, 1) for v in d['step_ms']]} ms, losses {d['losses']} vs "
                f"{d['single_losses']}, launches a step {d['launches_per_step']}"
                for m, d in res["models"].items())
            log(f"  {name} ({world} ranks): SpMM {r0['spmm_ms']:.3f} ms (exchange "
                f"{r0['exchange_ms']:.3f}, local kernels {r0['local_ms']:.4f}), exchange "
                f"{res['exchange_bytes_per_rank']} bytes a rank a SpMM (D {DIST_DIM}, fp32); "
                f"single-process SpMM {ref['ms']:.4f} ms; launches a SpMM {spmm_counts} "
                f"(each rank exactly its plan's {[r['expect'] for r in per]}); {trained}; "
                f"kernels vs plain {res['kernel_errs']}; seconds {res['seconds']}")
            log(f"    shards: {res['shards']}")
    ref_ops.clear()
    torch.cuda.empty_cache()
    missing = [k for k in DIST_KERNELS
               if not sum(v[k] for run, v in launch_runs.items() if run.startswith("dist "))]
    if missing:
        raise AssertionError(f"the distributed runs launched none of {missing}")


def checkpoint_graph() -> tuple:
    """Phase 24's graph: rp, ci, n and its features [n, 96] float32."""
    import numpy as np

    from hcspmm_tpu_torch.graphs import io as gio

    src, dst, n = gio.synthetic_graph(20_000, 8.0, seed=3)
    rp, ci = gio.to_csr(src, dst, n)
    return rp, ci, n, np.random.RandomState(1).randn(n, 96).astype(np.float32)


def checkpoint_op(rp, ci, n, device):
    """Phase 24's operator: the CLI's layout at hidden 32, normalized
    (unnormalized sums saturate the 6-layer GCN in one step)."""
    from hcspmm_tpu_torch.config import PlanConfig
    from hcspmm_tpu_torch.ops.spmm import HybridSpMM

    return HybridSpMM(rp, ci, n, PlanConfig(band_impl="tband"), normalize=True, device=device)


def profiled_spmm(op, x, path) -> dict:
    """``utils/profiling.py``'s device time of one SpMM ``op(x)`` and its
    Chrome trace into ``path``: the device seconds, the trace's kernel
    events and this process's age when the trace began."""
    import torch

    from hcspmm_tpu_torch.utils import profiling

    with torch.no_grad():
        secs = profiling.device_time(op, x, iters=10)
        age = time.time() - PROCESS_START
        with profiling.trace(path):
            op(x)
    with open(path) as f:
        kernels = sum(e.get("cat") == "kernel" for e in json.load(f)["traceEvents"])
    return dict(device_s=secs, kernels=kernels, age_s=age)


def trace_rank(rank, world, device, path) -> dict:
    """``profiled_spmm`` of phase 24's operator in a fresh process
    (``parallel.dryrun.run_ranks`` spawns it, a world of one)."""
    import torch

    rp, ci, n, x = checkpoint_graph()
    op = checkpoint_op(rp, ci, n, device)
    return profiled_spmm(op, torch.from_numpy(x[:, :32].copy()).to(device), path)


def checkpoint_phase(out) -> None:
    """Phase 24: the 6-layer GCN trained 4 epochs from glorot weights
    through ``train.loop.train`` on a synthetic graph of 20,000 nodes
    (normalized aggregation), saving every 2; resumed from the file in a
    fresh operator for 3 more epochs, its per-epoch losses and parameters
    equal bit for bit to a run continuing from the same epoch with a fresh
    Adam; ``utils/profiling.py``'s device time, roofline and Chrome trace of
    one SpMM in a freshly spawned process (the phase fails if that trace
    holds no kernel event) and in this one (logged: torch.profiler lost
    kernel records in processes minutes old); then
    ``train.elastic.supervise`` over ``cli.main`` with ``--fault-epoch 2``
    (the first launch fails at epoch 2, the relaunch resumes and finishes
    4)."""
    import numpy as np
    import torch

    from hcspmm_tpu_torch.models.net import Net, init_net_params
    from hcspmm_tpu_torch.parallel import dryrun
    from hcspmm_tpu_torch.train import elastic
    from hcspmm_tpu_torch.train.loop import train
    from hcspmm_tpu_torch.utils import profiling
    from hcspmm_tpu_torch.utils.checkpoint import load_pytree

    class Losses:
        def __init__(self):
            self.v = []

        def log(self, **rec):
            self.v.append(rec["loss"])

    rp, ci, n, x = checkpoint_graph()
    y = np.ones(n, dtype=np.int64)
    net = Net(model="gcn", **DIST_NET)

    def fresh_op():
        return checkpoint_op(rp, ci, n, DEV)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ck.npz")
        op = fresh_op()
        start = init_net_params(net, torch.Generator().manual_seed(3), init="glorot",
                                device=op.device)
        first = train(net, op, x, y, epochs=4, warmup_epochs=0, seed=3, checkpoint_path=path,
                      checkpoint_every=2, init_params=start)
        params, meta = load_pytree(path)
        if meta["epoch"] != 4:
            raise AssertionError(f"the checkpoint holds epoch {meta['epoch']}, not 4")
        resumed, straight = Losses(), Losses()
        res_r = train(net, fresh_op(), x, y, epochs=3,
                      warmup_epochs=0, seed=3, init_params=params, start_epoch=4, logger=resumed)
        res_s = train(net, op, x, y, epochs=3, warmup_epochs=0, seed=3,
                      init_params=first["params"], logger=straight)
        same = all(torch.equal(a[k], b[k]) for a, b in zip(res_r["params"], res_s["params"])
                   for k in a)
        log(f"  resumed losses {resumed.v}, uninterrupted {straight.v}; parameters equal {same}")
        if resumed.v != straight.v or not same:
            raise AssertionError("the resumed run differs from the uninterrupted one")
        # in a fresh process, and in this one: torch.profiler lost kernel
        # records in processes minutes old (PERF.md section 7)
        fresh = dryrun.run_ranks(trace_rank, 1, DEV, (os.path.join(tmp, "fresh.json"),))[0]
        here = profiled_spmm(op, torch.from_numpy(x[:, :32].copy()).to(DEV),
                             os.path.join(tmp, "trace.json"))
        # bytes: the CSR's column indices and row starts, X read and Z written once
        roof = profiling.roofline(fresh["device_s"], 4 * (int(rp[-1]) + n + 1) + 2 * n * 32 * 4,
                                  2 * int(rp[-1]) * 32)
        log(f"  utils/profiling.py: the normalized tband SpMM at D 32 "
            f"{fresh['device_s'] * 1e3:.4f} ms of device time, {roof['gbytes_per_s']:.1f} GB/s, "
            f"{roof['bound']} bound at {roof['speed_of_light_s'] * 1e3:.4f} ms; its Chrome trace "
            f"holds {fresh['kernels']} kernel events (traced {fresh['age_s']:.1f} s after a fresh "
            f"process imported this script); in this process ({here['age_s']:.1f} s after) "
            f"{here['device_s'] * 1e3:.4f} ms and {here['kernels']} kernel events")
        if not fresh["kernels"]:
            raise AssertionError("utils/profiling.trace wrote no kernel event of the traced SpMM")
        out["profiling"] = dict(fresh=fresh, here=here)
        launches = []

        def runner(argv):
            launches.append(list(argv))
            try:
                run_cli(argv)
                return 0
            except RuntimeError as exc:
                log(f"  launch {len(launches)} failed: {exc}")
                return 1

        ck = os.path.join(tmp, "elastic")
        t0 = time.perf_counter()
        sup = elastic.supervise(["--dataset", "example", "--synthetic-nodes", "4096", *GCN],
                                checkpoint=ck, total_epochs=4, checkpoint_every=1,
                                max_restarts=2, fault_epoch=2, runner=runner)
        log(f"  supervise: {sup} in {time.perf_counter() - t0:.1f} s, launches {launches}")
        if (sup["restarts"], sup["epochs"], len(launches)) != (1, 4, 2) or "--resume" not in \
                launches[1]:
            raise AssertionError(f"supervise: {sup}, launches {launches}")
        out.update(resumed_losses=resumed.v, uninterrupted_losses=straight.v,
                   supervise=dict(restarts=sup["restarts"], epochs=sup["epochs"]))
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device "
                         "(torch.cuda.is_available() is False)")
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from hcspmm_tpu_torch.config import PlanConfig
    from hcspmm_tpu_torch.format import reorder
    from hcspmm_tpu_torch.graphs import io as gio
    from hcspmm_tpu_torch.kernels import _build, block_spmm, dstream, tband, tspill
    from hcspmm_tpu_torch.models.net import Net, init_net_params, net_forward
    from hcspmm_tpu_torch.ops.spmm import HybridSpMM, _to_device
    from hcspmm_tpu_torch.train.loop import Bound

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    with Phase("1. versions"):
        nvcc = _build.nvcc_path()
        nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                                  check=True).stdout.strip().splitlines()[-1]
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
            f"cuda {torch.version.cuda}  nvcc {nvcc_ver}")
        log(smi)

    with Phase("2. build the five CUDA sources"):
        libs = (tband._lib, tspill._lib, block_spmm._lib, block_spmm._rows_lib, dstream._lib)
        names = ("tband", "tspill", "block_spmm", "rows", "dstream")

        def seconds(load):
            t0 = time.perf_counter()
            load()
            return time.perf_counter() - t0

        with ThreadPoolExecutor(len(libs)) as pool:
            secs = [f.result() for f in [pool.submit(seconds, load) for load in libs]]
        log("  nvcc seconds, the five started together: "
            + ", ".join(f"csrc/{name}.cu {t:.1f}" for name, t in zip(names, secs)))
        for name in names:
            with open(_build.library_path(name) + ".log") as f:
                for line in f:
                    if any(w in line for w in ("Compiling", "registers", "spill")):
                        log(f"  {name}: " + line.strip())
        with open(_build.library_path("tband") + ".log") as f:
            for line in tband_kernel_report(f.read()):
                log("  " + line)
        with open(_build.library_path("block_spmm") + ".log") as f:
            for line in band_kernel_report(f.read()):
                log("  " + line)
        for bh, dtype in ((256, torch.float32), (256, torch.bfloat16), (512, torch.float32)):
            for pack in (1, 2, 8):
                log(f"  tband_kernel at bh {bh}, dt 32, {dtype}, pack {pack}: "
                    f"{tband.launch_config(bh, 32, dtype, dtype, pack)} (dynamic shared memory "
                    "bytes)")
        device = block_spmm.band_device(0)
        for dt, ht in ((32, 32), (96, 32), (192, 32), (64, 608), (32, 96)):
            for dtype in (torch.float32, torch.bfloat16):
                log(f"  tband_kernel fused at bh 256, dt {dt}, ht {ht}, {dtype}: "
                    f"{tband.fused_launch(256, dt, ht, dtype.itemsize, *device[1:])}")
        for bb in (384, 640, 1024):
            log(f"  band_kernel's ring at Bb {bb}: "
                f"{block_spmm.band_launch(bb, *device[1:])}")
        for dp in (128, 256, 3712):
            log(f"  band_kernel fused at Bb 640, dp {dp}, hp 256: "
                f"{block_spmm.fused_launch(640, dp, 256, *device[1:])}")

    gen = torch.Generator().manual_seed(0)
    with Phase("3. band kernel vs plain version"):
        t0 = time.perf_counter()
        src, dst, n = gio.synthetic_blocks(STANDIN["num_nodes"], STANDIN["avg_degree"],
                                           STANDIN["block_size"], seed=STANDIN["seed"])
        rp, ci = gio.to_csr(src, dst, n)
        rp, ci = reorder.apply_permutation(rp, ci, n, reorder.rcm_reorder(rp, ci, n))
        ops = {cd: HybridSpMM(rp, ci, n, PlanConfig(band_impl="tband", compute_dtype=cd),
                              device=dev) for cd in ("float32", "bfloat16")}
        plan = ops["float32"].plan
        m = plan.padded_rows
        log(f"blocks stand-in: {n} nodes, {int(rp[-1])} nnz, widths {plan.band_widths}, "
            f"band_h {plan.band_h}, {len(plan.band_sw_ids[0])} superwindows, M {m}, "
            f"spill {plan.spill_nnz} ({time.perf_counter() - t0:.1f} s with upload)")
        band_res = {}
        band_kernel_at_plan("blocks", ops["float32"], gen, band_res, (rp, ci, n))
        band_kernel_small_shapes(gen)

        new_res = {}
        tband_fused_at_plan(ops["float32"], gen, new_res)

        rp2, ci2, n2 = banded_graph(600, 4, 10, 100)
        cfg2 = PlanConfig(band_impl="tband", band_h=128, band_widths=(128, 384),
                          band_spill="never", band_mode="always")
        x2 = np.random.RandomState(1).randn(n2, 48).astype(np.float32)
        launch_runs = {}
        for layout, cfg in (("tband", cfg2), ("wide", dataclasses.replace(cfg2,
                                                                          band_impl="wide"))):
            op2 = HybridSpMM(rp2, ci2, n2, cfg, device=dev)
            if [len(s) > 0 for s in op2.plan.band_sw_ids] != [True, True]:
                raise AssertionError(f"the two-bucket {layout} plan must fill both buckets")
            zero_counts()
            with torch.no_grad():
                out2 = op2.unpad_output(op2.apply_padded(op2.arrays, op2.pad_input(
                    torch.from_numpy(x2))), 48)
            launch_runs[f"two-bucket {layout}"] = read_counts()
            check(f"two-bucket {layout} plan apply_padded vs scipy", out2,
                  csr_matmul(rp2, ci2, n2, x2), "float32")
            check_counts(launch_runs[f"two-bucket {layout}"],
                         {"tband_spmm_bucket" if layout == "tband" else "band_bucket_spmm": 1}, 1)
        op2 = HybridSpMM(rp2, ci2, n2, cfg2, device=dev)

    with Phase("4. spill kernels vs plain versions, small odd shapes"):
        small_spill_checks(gen)

    with Phase("5. apply_padded on the blocks stand-in vs scipy float64"):
        x = np.random.RandomState(0).randn(n, 32).astype(np.float32)
        ref = csr_matmul(rp, ci, n, x)
        for cd, op in ops.items():
            with torch.no_grad():
                out = op.unpad_output(op.apply_padded(op.arrays, op.pad_input(
                    torch.from_numpy(x))), 32)
            check(f"apply_padded {cd}", out, ref, cd)
        del ops
        torch.cuda.empty_cache()

    spill_res = {}
    real_edges, real_csr = {}, {}
    with Phase("6. the DD, YS and GH stand-ins: spill kernels and apply_padded vs scipy"):
        for key in REAL:
            t0 = time.perf_counter()
            s_e, d_e, rpk, cik, nk = real_graph(key)
            real_edges[key] = (s_e, d_e, nk)
            real_csr[key] = (rpk, cik, nk)  # cluster order, reused by the wide phases
            t_graph = time.perf_counter() - t0
            x = np.random.RandomState(0).randn(nk, 32).astype(np.float32)
            ref = csr_matmul(rpk, cik, nk, x)
            for cd, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                t0 = time.perf_counter()
                op = HybridSpMM(rpk, cik, nk, PlanConfig(band_impl="tband", compute_dtype=cd),
                                device=dev)
                p = op.plan
                arrs = op.arrays["f"]
                hub, t1, t2 = p.hub_lo is not None, p.ts_lo is not None, bool(p.ts2_segs)
                log(f"  {key} {cd}: {nk} nodes, {int(rpk[-1])} nnz; W {p.band_widths}, "
                    f"bh {p.band_h}, {sum(len(v) for v in p.band_sw_ids)} of "
                    f"{p.padded_rows // p.band_h} superwindows covered, "
                    f"{len(p.band_missing_sw)} missing "
                    f"({len(arrs['band_missing_sw8'])} runs of 8 + "
                    f"{len(arrs['band_missing_sw'])}); spill {p.spill_nnz} edges, merge "
                    f"group {p.ds_lgroup} bw {p.ds_tlocal.shape[1]}; hub {hub} "
                    f"(group {p.ds_hgroup}), T1 {t1}, T2 {t2}"
                    f"{f' ({len(p.ts2_segs)} segments, {len(p.ts2_pieces)} pieces)' if t2 else ''}"
                    f"; graph {t_graph:.1f} s, plan and upload {time.perf_counter() - t0:.1f} s")
                if key == "YS" and not t1:
                    raise AssertionError("the YS plan must build the mxgather T1 table")
                if key == "GH" and not (hub and t1 and t2):
                    raise AssertionError("the GH plan must build hub, T1 and T2")
                if key in ("DD", "GH") and cd == "float32":
                    band_kernel_at_plan(key, op, gen, band_res, (rpk, cik, nk))
                spill_kernels_vs_plain(key, arrs, p, dtype, cd, gen, spill_res)
                with torch.no_grad():
                    xp = op.pad_input(torch.from_numpy(x))
                    out = op.unpad_output(op.apply_padded(op.arrays, xp), 32)
                    check(f"{key} apply_padded {cd} vs scipy", out, ref, cd)
                    ms = cuda_time_ms(lambda: op.apply_padded(op.arrays, xp), 10)
                log(f"  {key} {cd}: apply_padded {ms:.4f} ms (dim 32)")
                del op, arrs, xp
                torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        with Phase("7. GCN training through cli.main"):
            path = os.path.join(tmp, "blocks_standin.npz")
            gio.save_edges_npz(path, src, dst, n)
            log("  blocks stand-in, rcm:")
            epochs = {}
            launch_runs["blocks"], done = train_and_count(path, "rcm", {"tband_spmm": 1})
            epochs["blocks tband gcn"] = done["epoch_ms"]
            paths = {}
            for key, need in (("DD", {"tband_spmm": 1, "zero_lane_blocks": 1,
                                      "tbstream_merge": 1}),
                              ("GH", {"tband_spmm": 1, "zero_lane_blocks": 1,
                                      "mxgather_lanes": 2, "tbstream_merge": 2})):
                paths[key] = os.path.join(tmp, f"{key}_standin.npz")
                gio.save_edges_npz(paths[key], *real_edges[key])
                log(f"  {key} stand-in, cluster:")
                launch_runs[key], done = train_and_count(paths[key], "cluster", need)
                epochs[f"{key} tband gcn"] = done["epoch_ms"]

            net = Net("gcn", 48, 32, 22, 6)
            params = init_net_params(net, torch.Generator().manual_seed(0), init="glorot",
                                     device="cpu")
            op2c = HybridSpMM(rp2, ci2, n2, cfg2, device="cpu")
            with torch.no_grad():
                lp_cpu = net_forward(net, params, Bound(op2c), op2c.pad_input(x2),
                                     out_slice=lambda h: op2c.unpad_output(h, 22))
                params_dev = [{k: v.to(dev) for k, v in p.items()} for p in params]
                lp_dev = net_forward(net, params_dev, Bound(op2), op2.pad_input(x2),
                                     out_slice=lambda h: op2.unpad_output(h, 22))
            check("6-layer GCN log-probs, card vs CPU, small graph", lp_dev, lp_cpu,
                  "float32")

        with Phase("8. --single_kernel at dim 32"):
            sag = {}
            for name, pth, ro in (("blocks", path, "rcm"), ("GH", paths["GH"], "cluster")):
                sag[name] = records(run_cli(["--dataset", pth, "--reorder", ro, "--dim", "32",
                                             "--single_kernel"]), "sag")
                log(f"  {name}: avg_ms {sag[name]['avg_ms']:.4f}, "
                    f"{sag[name]['gnnz_per_s']:.3f} Gnnz/s")

        with Phase("9. wide band kernel vs plain version"):
            wide_band_small_shapes(gen)
            wide_res = {}
            wide_ops = {}  # DD's and GH's wide operators, reused by phase 11
            for key in ("DD", "GH"):
                t0 = time.perf_counter()
                rpk, cik, nk = real_csr[key]
                op = HybridSpMM(rpk, cik, nk, PlanConfig(band_impl="wide"), device=dev)
                log(f"  {key} wide plan ({time.perf_counter() - t0:.1f} s)")
                wide_band_checks(key, op, gen, wide_res, (rpk, cik, nk))
                wide_ops[key] = op
                del op
                torch.cuda.empty_cache()

        with Phase("10. row zero-fill and merges vs plain versions, small odd shapes"):
            small_row_checks(gen)

        row_res = {}
        with Phase("11. wide plans: apply_padded vs scipy, row kernels at the plans' arrays"):
            graphs = {"blocks": (rp, ci, n), **real_csr}
            cases = [(key, {}) for key in graphs] + [("DD", dict(ds_kind="tile"))]
            for key, extra in cases:
                rpk, cik, nk = graphs[key]
                t0 = time.perf_counter()
                op = (wide_ops.pop(key) if key in wide_ops and not extra else
                      HybridSpMM(rpk, cik, nk, PlanConfig(band_impl="wide", **extra), device=dev))
                p = op.plan
                arrs = op.arrays["f"]
                name = key + (" tile" if extra else "")
                log(f"  {name}: W {p.band_widths}, bh {p.band_h}, "
                    f"{sum(len(v) for v in p.band_sw_ids)} of {p.padded_rows // p.band_h} "
                    f"superwindows, {len(p.band_missing_sw)} missing "
                    f"({len(arrs['band_missing_sw8'])} runs of 8 + "
                    f"{len(arrs['band_missing_sw'])}); spill {p.spill_nnz} edges, "
                    f"kind {p.ds_kind if p.ds_blk is not None else 'take'}, group "
                    f"{p.ds_group}, chunks {len(p.ds_gcols) // 128 if p.ds_blk is not None else 0}"
                    f", ucols {None if p.ds_ucols is None else len(p.ds_ucols)}; plan and "
                    f"upload {time.perf_counter() - t0:.1f} s")
                if key in ("DD", "YS", "GH") and not (p.spill_nnz and len(p.band_missing_sw)):
                    raise AssertionError(f"the {key} wide plan must spill and miss superwindows")
                if extra and p.ds_kind != "tile":
                    raise AssertionError("the forced plan must take the tile form")
                if key != "blocks":
                    row_kernels_vs_plain(name, op, gen, row_res)
                for d in WIDE_DIMS if not extra else (128,):
                    x = np.random.RandomState(0).randn(nk, d).astype(np.float32)
                    zero_counts()
                    with torch.no_grad():
                        xp = op.pad_input(torch.from_numpy(x))
                        out = op.unpad_output(op.apply_padded(op.arrays, xp), d)
                    counts = read_counts()
                    check(f"{name} wide apply_padded dim {d} vs scipy", out,
                          csr_matmul(rpk, cik, nk, x), "float32")
                    if extra:
                        check_counts(counts, {"band_spmm": 1, "dstream_merge": 1}, 1)
                        launch_runs["DD tile"] = counts
                    del out
                    ms = cuda_time_ms(lambda: op.apply_padded(op.arrays, xp), 5)
                    log(f"  {name}: apply_padded {ms:.4f} ms (dim {d}, fp32)")
                    del xp
                if key == "DD" and not extra:
                    pr = ranges_plan(p)
                    arrs_r = _to_device(pr, dev)
                    x = np.random.RandomState(0).randn(nk, 128).astype(np.float32)
                    zero_counts()
                    with torch.no_grad():
                        out = block_spmm.spmm_wide_padded(arrs_r, op.pad_input(x), pr,
                                                          torch.float32)[:nk]
                    launch_runs["DD ranges"] = read_counts()
                    check_counts(launch_runs["DD ranges"], {"dstream_merge": 1}, 1)
                    check(f"DD column-range stream ({len(pr.ds_meta['r0'])} ranges, "
                          f"{len(pr.ds_gcols) // 128} chunks) vs scipy", out,
                          csr_matmul(rpk, cik, nk, x), "float32")
                    del arrs_r, out
                del op, arrs
                torch.cuda.empty_cache()
            rpk, cik, nk = graphs["DD"]
            op = HybridSpMM(rpk, cik, nk, PlanConfig(band_impl="tband", spill_lane="off",
                                                     ds_kind="tile"), device=dev)
            x = np.random.RandomState(0).randn(nk, 32).astype(np.float32)
            zero_counts()
            with torch.no_grad():
                out = op.unpad_output(op.apply_padded(op.arrays, op.pad_input(x)), 32)
            launch_runs["DD tband legacy"] = read_counts()
            log(f"  DD tband spill_lane='off', ds_kind 'tile': launches "
                f"{launch_runs['DD tband legacy']}")
            check("DD tband legacy row-merge spill vs scipy", out,
                  csr_matmul(rpk, cik, nk, x), "float32")
            check_counts(launch_runs["DD tband legacy"],
                         {"tband_spmm": 1, "zero_lane_blocks": 1, "dstream_merge": 1}, 1)
            del op, out, graphs
            torch.cuda.empty_cache()

        with Phase("12. GCN and GIN at hidden 256 (wide layout) through cli.main"):
            for key, pth, ro, need in (
                    ("blocks", path, "rcm", {"band_spmm": 1}),
                    ("DD", paths["DD"], "cluster", {"band_spmm": 1, "zero_row_blocks": 2,
                                                    "bstream_merge": 1}),
                    ("GH", paths["GH"], "cluster", {"band_spmm": 1, "zero_row_blocks": 1,
                                                    "bstream_merge": 1})):
                for model in ("gcn", "gin"):
                    log(f"  {key} {model}, hidden 256:")
                    launch_runs[f"{key} {model} wide"], done = train_and_count(
                        pth, ro, need, ["--model", model, *WIDE], WIDE_SPMMS[model])
                    epochs[f"{key} wide {model} hidden 256"] = done["epoch_ms"]
            zero_counts()
            rec = records(run_cli(["--dataset", path, "--reorder", "rcm", "--dim", "32",
                                   "--hidden", "256", "--single_kernel"]), "sag")
            launch_runs["blocks sag wide"] = read_counts()
            check_counts(launch_runs["blocks sag wide"], {"band_spmm": 1}, 210)
            log(f"  blocks --single_kernel --hidden 256: avg_ms {rec['avg_ms']:.4f}, "
                f"{rec['gnnz_per_s']:.3f} Gnnz/s")

        with Phase("13. row kernels (dense, ELL, residual) vs plain versions, small odd shapes"):
            small_row_kernel_checks(gen)

        rows_res = {}
        with Phase("14. the row layout on DD (band_mode='never'): kernels, apply, training"):
            row_layout_phase(*real_csr["DD"], gen, rows_res, launch_runs)

        with Phase("15. --impl xla through cli.main on the blocks stand-in"):
            zero_counts()
            lines = run_cli(["--dataset", path, "--reorder", "rcm", *GCN, "--epochs", "2",
                             "--impl", "xla"])
            done, prep = records(lines, "done"), records(lines, "preprocess")
            if prep["layout"] != "rows" or not math.isfinite(done["final_loss"]):
                raise AssertionError(f"--impl xla: layout {prep['layout']}, final_loss "
                                     f"{done['final_loss']}")
            log(f"  epoch_ms {done['epoch_ms']:.3f}, final_loss {done['final_loss']}; "
                f"launches {read_counts()} (the plain form launches none)")

        with Phase("16. fused, tiled and grouped kernels vs plain versions, small odd shapes"):
            small_new_kernel_checks(gen)

        with Phase("17. fused, bucket, grouped and tiled kernels at the blocks stand-in's "
                   "wide and tiled plans; the grouped A/B"):
            t0 = time.perf_counter()
            op_w = HybridSpMM(rp, ci, n, PlanConfig(band_impl="wide"), device=dev)
            op_t = HybridSpMM(rp, ci, n, PlanConfig(band_impl="tiled"), device=dev)
            if not op_t.plan.tiled or "band0_a" in op_t.arrays["f"]:
                raise AssertionError("the blocks stand-in's tiled plan must be tiled and "
                                     "upload no dense band blocks")
            log(f"  wide and tiled plans ({time.perf_counter() - t0:.1f} s with upload)")
            wide_new_kernels_at_plan(op_w, op_t, gen, new_res, launch_runs)
            del op_w, op_t
            torch.cuda.empty_cache()

        fused_res = {}
        with Phase("18. the kernel-fusion mode trained through train.loop.train"):
            train_fused_mode(rp, ci, n, gen, launch_runs, fused_res)

        with Phase("19. the tiled band through cli.main --band-impl tiled"):
            for model in ("gcn", "gin"):
                log(f"  blocks {model}, hidden 256, --band-impl tiled:")
                zero_counts()
                lines = run_cli(["--dataset", path, "--reorder", "rcm", "--model", model, *WIDE,
                                 "--epochs", "3", "--band-impl", "tiled"])
                counts = read_counts()
                prep, done = records(lines, "preprocess"), records(lines, "done")
                spmms = WIDE_SPMMS[model] * (WARMUP_EPOCHS + 3)
                log(f"  epoch_ms {done['epoch_ms']:.3f}; layout {prep['layout']}; final_loss "
                    f"{done['final_loss']}; launches {counts} over {spmms} SpMMs")
                if prep["layout"] != "tiled" or not math.isfinite(done["final_loss"]):
                    raise AssertionError(f"--band-impl tiled: layout {prep['layout']}, "
                                         f"final_loss {done['final_loss']}")
                check_counts(counts, {"band_tiled_spmm": 1}, spmms)
                if counts["band_spmm"]:
                    raise AssertionError("a tiled plan must launch no band kernel")
                launch_runs[f"blocks {model} tiled"] = counts
            zero_counts()
            rec = records(run_cli(["--dataset", path, "--reorder", "rcm", "--dim", "32",
                                   "--hidden", "256", "--single_kernel", "--band-impl", "tiled"]),
                          "sag")
            launch_runs["blocks sag tiled"] = read_counts()
            check_counts(launch_runs["blocks sag tiled"], {"band_tiled_spmm": 1}, 210)
            log(f"  blocks --single_kernel --band-impl tiled: avg_ms {rec['avg_ms']:.4f}, "
                f"{rec['gnnz_per_s']:.3f} Gnnz/s")
            op_t = HybridSpMM(rp, ci, n, PlanConfig(band_impl="tiled"), device=dev)
            for d in WIDE_DIMS:
                x = np.random.RandomState(0).randn(n, d).astype(np.float32)
                with torch.no_grad():
                    out = op_t.unpad_output(op_t.apply_padded(op_t.arrays, op_t.pad_input(x)), d)
                check(f"blocks tiled apply_padded dim {d} vs scipy", out,
                      csr_matmul(rp, ci, n, x), "float32")
            del op_t, out
            torch.cuda.empty_cache()

        layout_res = {}
        with Phase("20. the layout switch: the 6-layer GCN at hidden 32 through cli.main "
                   "--band-impl tband, wide and tiled"):
            # each layout twice, in the order tband wide tiled tiled wide tband: the
            # host clock of these epochs drifts within a call
            impls = ("tband", "wide", "tiled")
            for key, pth, ro in (("blocks", path, "rcm"), ("DD", paths["DD"], "cluster")):
                for impl in impls + impls[::-1]:
                    zero_counts()
                    lines = run_cli(["--dataset", pth, "--reorder", ro, *GCN, "--epochs", "3",
                                     "--band-impl", impl])
                    counts = read_counts()
                    prep, done = records(lines, "preprocess"), records(lines, "done")
                    if not math.isfinite(done["final_loss"]):
                        raise AssertionError(f"{key} --band-impl {impl}: final_loss "
                                             f"{done['final_loss']}")
                    res = layout_res.setdefault(f"{key} {impl}", dict(layout=prep["layout"],
                                                                      epoch_ms=[]))
                    res["epoch_ms"].append(done["epoch_ms"])
                    launch_runs[f"{key} gcn hidden 32 {impl}"] = counts
                    log(f"  {key} --band-impl {impl}: layout {prep['layout']}, epoch_ms "
                        f"{done['epoch_ms']:.3f}, final_loss {done['final_loss']}")

        profiles = {}
        with Phase("21. where GH's GCN epochs go (utils/epoch_profile.py)"):
            from hcspmm_tpu_torch.utils import epoch_profile

            for name, argv in (("tband, hidden 32", GCN), ("wide, hidden 256",
                                                          ["--model", "gcn", *WIDE])):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    epoch_profile.main(["--dataset", paths["GH"], "--reorder", "cluster", *argv,
                                        "--profile-epochs", "5"])
                rec = records(buf.getvalue().splitlines(), "epoch_profile")
                profiles[f"GH {name}"] = rec
                log(f"  GH {name}: wall {rec['wall_ms_per_epoch']:.3f} ms, busy "
                    f"{rec['busy_ms_per_epoch']:.3f} ms ({rec['idle_share']:.1%} idle); "
                    + ", ".join(f"{g} {v:.3f}" for g, v in rec["ms_per_epoch"].items()))

    packed_res, packed_train = {}, {}
    with Phase("22. the packed A_t encodings (tband_pack 2 and 8)"):
        packed_small_shapes(gen)
        packed_at_plan("blocks", (rp, ci, n), gen, packed_res)
        packed_at_plan("GH", real_csr["GH"], gen, packed_res)
        train_packed(rp, ci, n, launch_runs, packed_train)

    dist_res, ckpt_res = {}, {}
    with Phase("23. the distributed SpMM: gloo ranks sharing the card"):
        dist_phase({"DD": real_csr["DD"], "blocks": (rp, ci, n)}, launch_runs, dist_res)

    with Phase("24. checkpoint, resume and elastic restart"):
        checkpoint_phase(ckpt_res)

    def launches(name):
        return sum(run[name] for run in launch_runs.values())

    def at(name, graph, label):
        return next(r for r in spill_res[(name, "float32")]
                    if r["graph"] == graph and label in r["shape"])

    def row_at(name, graph):
        return next(r for r in row_res[(name, "float32")] if r["graph"] == graph)

    def entry(name, source, replaces, r, shape, err=None, counter=None, **extra):
        return dict(name=name, route="cuda", source=source, replaces=replaces, **extra,
                    launches=launches(counter or name),
                    max_abs_err=r["err"] if err is None else err,
                    ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"], shape=shape)

    zero, mxg, merge = (at("zero_lane_blocks", "DD", "x [32, 2048]"),
                        at("mxgather_lanes", "GH", "T1"), at("tbstream_merge", "GH", "cold"))
    wide = wide_res[("DD", 256, "float32")]
    dense, ell = (rows_res[("DD calibrated", "dense_bucket_spmm", "float32")],
                  rows_res[("DD intended", "ell_bucket_spmm", "float32")])

    def row_plans(name):
        """Every row plan's numbers of one row kernel, and its errors' max."""
        plans = {f"{k[0]} {k[2]}": v for k, v in rows_res.items() if k[1] == name}
        return dict(err=max(v["err"] for v in plans.values()), plans=plans)

    csrc = "hcspmm_tpu_torch/csrc/"
    tpu = "hcspmm_tpu/kernels/"
    band_blocks = band_res[("blocks", "float32")]
    tb_bucket, tb_fused = new_res[("tband_spmm_bucket", "float32")], new_res[(
        "tband_fused_direct", "float32")]
    wide_bucket, wide_fused = new_res[("band_bucket_spmm", 256)], new_res[(
        "band_fused_spmm_direct", 256)]
    grouped, tiled = new_res[("band_bucket_spmm_grouped", 128)], new_res[("band_tiled_spmm", 256)]
    def packs(kernel):
        """Each pack's row of ``kernel`` at each plan and type phase 22 ran."""
        return {f"{k[1]} {k[2]} pack {p}": row for k, rows in packed_res.items()
                if k[0] == kernel for p, row in rows.items()}

    kernels = [
        entry("tband_spmm", csrc + "tband.cu", tpu + "tband.py:217", band_blocks,
              f"blocks {band_blocks['shape']}, float32, direct write",
              err=max([v["err"] for (_, cd), v in band_res.items() if cd == "float32"]
                      + [v["err"] for k, v in packs("tband_spmm").items() if "float32" in k]),
              design=TBAND_DESIGN, plans={f"{k} {cd}": v for (k, cd), v in band_res.items()},
              packs=packs("tband_spmm")),
        entry("tband_spmm_bucket", csrc + "tband.cu", tpu + "tband.py:246", tb_bucket,
              tb_bucket["shape"], err=max([tb_bucket["err"]] + [
                  v["err"] for v in packs("tband_spmm_bucket").values()]),
              design=TBAND_DESIGN, packs=packs("tband_spmm_bucket")),
        entry("tband_fused_direct", csrc + "tband.cu", tpu + "tband.py:309", tb_fused,
              tb_fused["shape"], err=max([v["err"] for k, v in new_res.items()
                                          if k[0] == "tband_fused_shapes"] + [
                  v["err"] for v in packs("tband_fused_direct").values()]),
              design=TBAND_FUSED_DESIGN, band_ms=tb_fused["band_ms"],
              ops_rate=tb_fused["ops_rate"], launch=tb_fused["launch"],
              packs=packs("tband_fused_direct")),
        entry("band_bucket_spmm", csrc + "block_spmm.cu", tpu + "block_spmm.py:317",
              wide_bucket, wide_bucket["shape"]),
        entry("band_bucket_spmm_grouped", csrc + "block_spmm.cu", tpu + "block_spmm.py:414",
              grouped, grouped["shape"]),
        entry("band_tiled_spmm", csrc + "block_spmm.cu", tpu + "block_spmm.py:597", tiled,
              tiled["shape"], err=max(v["err"] for k, v in new_res.items()
                                      if k[0] == "band_tiled_spmm")),
        entry("band_fused_spmm_direct", csrc + "block_spmm.cu", tpu + "block_spmm.py:666",
              wide_fused, wide_fused["shape"], err=max(
                  v["err"] for k, v in new_res.items() if k[0] == "wide_fused_shapes"),
              design=WIDE_FUSED_DESIGN, band_ms=wide_fused["band_ms"],
              ops_rate=wide_fused["ops_rate"], launch=wide_fused["launch"]),
        *[entry(name, csrc + source, tpu + replaces, r,
                f"{r['graph']} {r['shape']}, dt 32, float32",
                err=max(v["err"] for v in spill_res[(name, "float32")]), **extra)
          for name, source, replaces, r, extra in (
              ("zero_lane_blocks", "tband.cu", "tspill.py:75", zero, dict(
                  design="folded into tband_kernel's direct launch: zero items written by the "
                         "consumer warps before the first stage lands; ms is that launch with "
                         "the missing lists less the same launch without them",
                  direct_with_ms=zero["direct_with_ms"],
                  direct_without_ms=zero["direct_without_ms"])),
              ("mxgather_lanes", "tspill.cu", "tspill.py:351", mxg, {}),
              ("tbstream_merge", "tspill.cu", "tspill.py:189", merge, {}))],
        entry("band_spmm", csrc + "block_spmm.cu", tpu + "block_spmm.py:459", wide,
              f"DD wide plan {wide['shape']}, float32, direct write",
              counter="band_bucket_spmm_direct",
              err=max(v["err"] for (_, _, cd), v in wide_res.items() if cd == "float32"),
              design=WIDE_DESIGN, graph_library_ms=wide["graph_library_ms"],
              plans={f"{k} dp {dp} {cd}": v for (k, dp, cd), v in wide_res.items()}),
        *[entry(name, csrc + source, tpu + replaces, r,
                f"{r['graph']} wide plan {r['shape']}, float32",
                err=max(v["err"] for v in row_res[(name, "float32")]))
          for name, source, replaces, r in (
              ("zero_row_blocks", "tspill.cu", "tspill.py:101", row_at("zero_row_blocks", "GH")),
              ("bstream_merge", "dstream.cu", "dstream.py:283", row_at("bstream_merge", "GH")),
              ("dstream_merge", "dstream.cu", "dstream.py:457",
               row_at("dstream_merge", "DD tile")))],
        entry("dense_bucket_spmm", csrc + "rows.cu", tpu + "block_spmm.py:127", dense,
              f"DD calibrated row plan, {dense['shape']}, D 32, float32",
              design=ROWS_DESIGN["dense"], **row_plans("dense_bucket_spmm")),
        entry("ell_bucket_spmm", csrc + "rows.cu", tpu + "block_spmm.py:178", ell,
              f"DD intended row plan, {ell['shape']}, D 32, float32",
              design=ROWS_DESIGN["ell"], **row_plans("ell_bucket_spmm")),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    if len(kernels) != 16:
        raise AssertionError(f"the kernel table has {len(kernels)} entries, not 16")
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"no path run here launched {idle}")
    table6 = {"tband dim 32 " + cd: new_res[("tband_fused_direct", cd)]["table6"]
              for cd in ("float32", "bfloat16")}
    table6.update({"wide dim 96 " + cd: new_res[("table6 wide", cd)]
                   for cd in ("float32", "bfloat16")})
    fused_shapes = {f"tband dt {k[1][0]} ht {k[1][1]} {k[2]}": v for k, v in new_res.items()
                    if k[0] == "tband_fused_shapes"}
    fused_shapes.update({f"wide dp {k[1][0]} hp {k[1][1]} {k[2]}": v
                         for k, v in new_res.items() if k[0] == "wide_fused_shapes"})
    log(json.dumps({"kernels": kernels, "launches_by_run": launch_runs, "table6": table6,
                    "grouped_ab": grouped["ab"],
                    "fused_training": {f"{k[0]} {k[1]}": v for k, v in fused_res.items()},
                    "fused_shapes": fused_shapes, "epochs": epochs, "layout_switch": layout_res,
                    "lane_merge_yardsticks_ms": {
                        f"{r['graph']} {r['shape'].split(' merge')[0]} {cd}": dict(
                            merge=r["ms"], take_then_merge=r["take_merge_ms"],
                            take_then_index_add=r["library_ms"], index_add=r["index_add_ms"])
                        for cd in ("float32", "bfloat16")
                        for r in spill_res[("tbstream_merge", cd)]},
                    "epoch_profiles": profiles,
                    "packed_training": {f"pack {k[0]} {k[1]}": v
                                        for k, v in packed_train.items()},
                    "distributed": dist_res, "checkpoint": ckpt_res}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
