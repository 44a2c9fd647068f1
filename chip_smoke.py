"""Smoke run of hcspmm_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. versions of Python, PyTorch, CUDA and nvcc, and the card's name and
   power limit as nvidia-smi reports them;
2. builds csrc/tband.cu with nvcc for sm_90a;
3. holds the band kernel against its plain PyTorch version: at the shape
   the DD-scale stand-in's plan gives it (Sb 1312, W 768, bh 256, dt 32),
   at small odd shapes (dt 16, 48, 96; capacity-padded entries) and on a
   two-bucket full-cover plan; fp32 within 1e-5 and bf16 within 1e-2 of
   max|ref|; both timed with CUDA events;
4. holds ``HybridSpMM.apply_padded`` on the stand-in against scipy CSR @ X
   in float64, at fp32 and bf16;
5. trains the 6-layer GCN (dim 96, hidden 32, classes 22) for 3 epochs on
   the stand-in through ``cli.main`` and checks, with the kernel's launch
   counter, that every SpMM of the run went through the CUDA kernel; a
   small graph's forward pass on the card is held against the CPU's;
6. profiles one SpMM at dim 32 through ``cli.main --single_kernel``.

The second-to-last line is a JSON object with the kernel table; the last
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside
a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

STANDIN = dict(num_nodes=334_928, avg_degree=5.03, block_size=300, seed=7)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
WARMUP_EPOCHS = 9  # train.loop.train's dry-run epochs


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, ref) -> tuple:
    """(max |got - ref|, that over max |ref|), in float64 on the host."""
    import numpy as np

    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    err = float(np.abs(got - ref).max())
    return err, err / max(float(np.abs(ref).max()), 1e-30)


def check(name: str, got, ref, dtype: str) -> float:
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device "
                         "(torch.cuda.is_available() is False)")
    import numpy as np

    from hcspmm_tpu_torch.config import PlanConfig
    from hcspmm_tpu_torch.format import reorder
    from hcspmm_tpu_torch.graphs import io as gio
    from hcspmm_tpu_torch.kernels import _build, tband
    from hcspmm_tpu_torch.models.net import Net, init_net_params, net_forward
    from hcspmm_tpu_torch.ops.spmm import HybridSpMM
    from hcspmm_tpu_torch.train.loop import Bound

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. versions and the card ----
    log("== 1. versions")
    nvcc = _build.nvcc_path()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[-1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  nvcc {nvcc_ver}")
    log(smi)

    # ---- 2. build ----
    log("== 2. build csrc/tband.cu")
    t0 = time.perf_counter()
    tband._lib()
    log(f"  built and loaded in {time.perf_counter() - t0:.2f} s")
    with open(_build.library_path("tband") + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("  " + line.strip())

    # ---- the stand-in graph and its operators ----
    t0 = time.perf_counter()
    src, dst, n = gio.synthetic_blocks(STANDIN["num_nodes"], STANDIN["avg_degree"],
                                       STANDIN["block_size"], seed=STANDIN["seed"])
    rp, ci = gio.to_csr(src, dst, n)
    rp, ci = reorder.apply_permutation(rp, ci, n, reorder.rcm_reorder(rp, ci, n))
    ops = {cd: HybridSpMM(rp, ci, n, PlanConfig(band_impl="tband", compute_dtype=cd),
                          device=dev) for cd in ("float32", "bfloat16")}
    plan = ops["float32"].plan
    m = plan.padded_rows
    log(f"stand-in: {n} nodes, {int(rp[-1])} nnz, widths {plan.band_widths}, "
        f"band_h {plan.band_h}, {len(plan.band_sw_ids[0])} superwindows, M {m}, "
        f"spill {plan.spill_nnz} ({time.perf_counter() - t0:.1f} s with upload)")

    # ---- 3. kernel vs plain ----
    log("== 3. kernel vs plain version")
    gen = torch.Generator().manual_seed(0)
    arrs = ops["float32"].arrays["f"]
    st, sw, at = arrs["band0_start"], arrs["band0_sw"], arrs["band0_at"]
    num_sw = m // plan.band_h
    shape = f"Sb {at.shape[0]}, W {at.shape[1]}, bh {at.shape[2]}, dt 32"
    slice_res = {}
    for cd, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        xt = torch.randn((32, m), generator=gen).to(dev, dtype)
        got = tband.tband_spmm_direct(sw, st, at, xt, num_sw, dtype)
        ref = tband.tband_spmm_direct_plain(sw, st, at, xt, num_sw, dtype)
        err = check(f"direct {cd} at {shape}", got.float().cpu(), ref.float().cpu(), cd)
        check(f"bucket {cd} at {shape}", tband.tband_spmm_bucket(st, at, xt).cpu(),
              tband.tband_spmm_bucket_plain(st, at, xt).cpu(), cd)
        k_ms = cuda_time_ms(lambda: tband.tband_spmm_direct(sw, st, at, xt, num_sw, dtype), 50)
        p_ms = cuda_time_ms(lambda: tband.tband_spmm_direct_plain(sw, st, at, xt, num_sw,
                                                                  dtype), 10)
        kb_ms = cuda_time_ms(lambda: tband.tband_spmm_bucket(st, at, xt), 50)
        pb_ms = cuda_time_ms(lambda: tband.tband_spmm_bucket_plain(st, at, xt), 10)
        log(f"  {cd}: direct kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; "
            f"bucket kernel {kb_ms:.4f} ms, plain {pb_ms:.4f} ms")
        slice_res[cd] = dict(err=err, ms=k_ms, plain_ms=p_ms, bucket_ms=kb_ms,
                             bucket_plain_ms=pb_ms)

    for dt in (16, 48, 96):
        for bh in (128, 256):
            sb, w, mm, trash = 7, 256, 1024, 2
            at_s = (torch.rand((sb, w, bh), generator=gen) < 0.05).to(torch.int8).to(dev)
            st_s = (torch.randint(0, (mm - w) // 128 + 1, (sb,), generator=gen) * 128)
            sw_s = torch.cat([torch.randperm(sb - trash, generator=gen),
                              torch.full((trash,), sb - trash)])
            st_s, sw_s = st_s.to(dev, torch.int32), sw_s.to(dev, torch.int32)
            for cd, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                xt = torch.randn((dt, mm), generator=gen).to(dev, dtype)
                check(f"direct {cd} dt {dt} bh {bh} +{trash} padded entries",
                      tband.tband_spmm_direct(sw_s, st_s, at_s, xt, sb - trash, dtype)
                      .float().cpu(),
                      tband.tband_spmm_direct_plain(sw_s, st_s, at_s, xt, sb - trash, dtype)
                      .float().cpu(), cd)
                check(f"bucket {cd} dt {dt} bh {bh}",
                      tband.tband_spmm_bucket(st_s, at_s, xt).cpu(),
                      tband.tband_spmm_bucket_plain(st_s, at_s, xt).cpu(), cd)

    rp2, ci2, n2 = banded_graph(600, 4, 10, 100)
    cfg2 = PlanConfig(band_impl="tband", band_h=128, band_widths=(128, 384),
                      band_spill="never", band_mode="always")
    op2 = HybridSpMM(rp2, ci2, n2, cfg2, device=dev)
    if [len(s) > 0 for s in op2.plan.band_sw_ids] != [True, True]:
        raise AssertionError("the two-bucket plan must fill both buckets")
    x2 = np.random.RandomState(1).randn(n2, 48).astype(np.float32)
    with torch.no_grad():
        out2 = op2.unpad_output(op2.apply_padded(op2.arrays, op2.pad_input(
            torch.from_numpy(x2))), 48).cpu()
    check("two-bucket plan apply_padded vs scipy", out2, csr_matmul(rp2, ci2, n2, x2),
          "float32")

    # ---- 4. HybridSpMM vs scipy on the stand-in ----
    log("== 4. apply_padded on the stand-in vs scipy float64")
    x = np.random.RandomState(0).randn(n, 32).astype(np.float32)
    ref = csr_matmul(rp, ci, n, x)
    for cd, op in ops.items():
        with torch.no_grad():
            out = op.unpad_output(op.apply_padded(op.arrays, op.pad_input(
                torch.from_numpy(x))), 32).float().cpu()
        check(f"apply_padded {cd}", out, ref, cd)
    del ops, arrs, st, sw, at
    torch.cuda.empty_cache()

    # ---- 5. training through the command line ----
    log("== 5. GCN training through cli.main")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dd_standin.npz")
        gio.save_edges_npz(path, src, dst, n)
        epochs = 3
        tband.launches = 0
        lines = run_cli(["--dataset", path, "--reorder", "rcm", "--model", "gcn",
                         "--dim", "96", "--hidden", "32", "--classes", "22",
                         "--num_layers", "6", "--epochs", str(epochs)])
        launches = tband.launches
        done = records(lines, "done")
        prep = [v for v in lines if v.startswith("Prep. (ms)")]
        steps = WARMUP_EPOCHS + epochs
        log(f"  {prep[-1] if prep else 'no Prep. line'}; epoch_ms {done['epoch_ms']:.3f}; "
            f"warm-up {done['warmup_s']:.2f} s; final_loss {done['final_loss']}; "
            f"kernel launches {launches} in {steps} steps")
        if not math.isfinite(done["final_loss"]):
            raise AssertionError(f"loss is not finite: {done['final_loss']}")
        if launches < 12 * steps:
            raise AssertionError(f"{launches} kernel launches < 12 per step x {steps}")

        net = Net("gcn", 48, 32, 22, 6)
        params = init_net_params(net, torch.Generator().manual_seed(0), init="glorot")
        op2c = HybridSpMM(rp2, ci2, n2, cfg2, device="cpu")
        with torch.no_grad():
            lp_cpu = net_forward(net, params, Bound(op2c), op2c.pad_input(x2),
                                 out_slice=lambda h: op2c.unpad_output(h, 22))
            params_dev = [{k: v.to(dev) for k, v in p.items()} for p in params]
            lp_dev = net_forward(net, params_dev, Bound(op2), op2.pad_input(x2),
                                 out_slice=lambda h: op2.unpad_output(h, 22)).cpu()
        check("6-layer GCN log-probs, card vs CPU, small graph", lp_dev, lp_cpu, "float32")

        # ---- 6. one SpMM profiled ----
        log("== 6. --single_kernel at dim 32")
        sag = records(run_cli(["--dataset", path, "--reorder", "rcm", "--dim", "32",
                               "--single_kernel"]), "sag")
        log(f"  avg_ms {sag['avg_ms']:.4f}, {sag['gnnz_per_s']:.3f} Gnnz/s")

    kernels = [{
        "name": "tband_spmm",
        "route": "cuda",
        "source": "hcspmm_tpu_torch/csrc/tband.cu",
        "replaces": "hcspmm_tpu/kernels/tband.py:217",
        "also_replaces": "hcspmm_tpu/kernels/tband.py:246",
        "launches": launches,
        "max_abs_err": slice_res["float32"]["err"],
        "ms": slice_res["float32"]["ms"],
        "plain_ms": slice_res["float32"]["plain_ms"],
        "shape": shape + ", float32, direct write",
        "bucket_ms": slice_res["float32"]["bucket_ms"],
        "bucket_plain_ms": slice_res["float32"]["bucket_plain_ms"],
        "bf16_ms": slice_res["bfloat16"]["ms"],
        "bf16_plain_ms": slice_res["bfloat16"]["plain_ms"],
    }]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
