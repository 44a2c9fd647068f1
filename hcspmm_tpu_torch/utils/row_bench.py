"""The row layout's kernels, SpMM and GCN epoch on DD, on one CUDA card.

    python -m hcspmm_tpu_torch.utils.row_bench

Builds the DD stand-in (``io.reference_standin("DD", seed=7)``, cluster
order) and its two row-layout plans (``band_mode='never'``, the intended
and the calibrated LOI selector, fp32), then measures at dim 32:

- each row population's launches of one SpMM, and their device time
  (torch.profiler, kernels named ``dense_*`` or ``ell_row*``) in fp32 and
  bf16: the dense windows, and the ELL and residual rows;
- the row SpMM (CUDA events, median of 7 trials of 10 calls; and its
  device-busy time) beside ``torch.sparse.mm`` of the graph's CSR;
- the 6-layer GCN (dim 96, hidden 32, classes 22): ``epoch_ms`` of 3 epochs
  through ``train.loop.train`` and, over 5 profiled epochs, the wall,
  device-busy time and idle share.

It calls only the wrappers that every version of the port's row layout
has (``dense_bucket_spmm``, ``ell_bucket_spmm``, ``ell_residual_spmm``), or
the whole-population launches (``dense_rows``, ``ell_rows``) where the
package has them, so the same file times an older checkout too: copy it
and ``utils/bench.py`` to the same paths there and run the module from
each checkout's root, in turns, on one card.  Prints the card's name and
power limit, then one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from hcspmm_tpu_torch.utils.bench import device_ms


def median_ms(fn, reps: int = 10, trials: int = 7) -> float:
    """Median over ``trials`` of the CUDA-event ms per call of ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[trials // 2]


def populations(op, x):
    """(dense, ELL) callables that run one SpMM's launches of each row
    kernel on ``x``."""
    from hcspmm_tpu_torch.kernels import block_spmm

    p, arrs = op.plan, op.arrays["f"]
    if hasattr(block_spmm, "dense_rows"):
        out = torch.empty((p.num_nodes, x.shape[1]), device=x.device)
        return (lambda: block_spmm.dense_rows(arrs, p, x, out),
                lambda: block_spmm.ell_rows(arrs, x, out))
    dense = [b for b in range(len(p.bucket_widths)) if p.bucket_cols[b].shape[0]]
    ell = [e for e in range(len(p.ell_widths)) if p.ell_cols[e].shape[0]]
    return (lambda: [block_spmm.dense_bucket_spmm(arrs[f"b{b}_cols"], arrs[f"b{b}_a"], x)
                     for b in dense],
            lambda: [block_spmm.ell_bucket_spmm(arrs[f"e{e}_cols"], x) for e in ell]
            + [block_spmm.ell_residual_spmm(arrs["sparse_seg_ptr"], arrs["sparse_edge_col"], x)])


def epoch_profile(op, x, y, epochs: int = 5) -> dict:
    """The 6-layer GCN: ``epoch_ms`` of 3 epochs, then the wall, device-busy
    ms and idle share per epoch over ``epochs`` profiled ones."""
    from hcspmm_tpu_torch.models.net import Net
    from hcspmm_tpu_torch.train.loop import layout_input, make_train_step, train

    net = Net("gcn", 96, 32, 22, 6)
    res = train(net, op, x, y, epochs=3)
    params = res["params"]
    step = make_train_step(net, op, torch.optim.Adam(
        [t for layer in params for t in layer.values()], lr=0.01))
    xd, yd = layout_input(op, x), torch.as_tensor(y).to(op.device)
    gen = torch.Generator(device=op.device).manual_seed(0)
    step(params, xd, yd, gen)
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(epochs):
            step(params, xd, yd, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / epochs
    busy = sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / epochs
    return dict(epoch_ms=res["epoch_ms"], final_loss=res["final_loss"], wall_ms=wall,
                busy_ms=busy, idle_share=1 - busy / wall)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("row_bench.py measures a CUDA device")
    from hcspmm_tpu_torch.config import PlanConfig
    from hcspmm_tpu_torch.format import reorder
    from hcspmm_tpu_torch.graphs import io
    from hcspmm_tpu_torch.kernels import block_spmm
    from hcspmm_tpu_torch.ops.spmm import HybridSpMM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    src, dst, n, _ = io.reference_standin("DD", seed=7)
    rp, ci = io.to_csr(src, dst, n)
    rp, ci = reorder.apply_permutation(rp, ci, n, reorder.cluster_reorder(rp, ci, n))
    a_csr = torch.sparse_csr_tensor(torch.from_numpy(rp.astype(np.int64)),
                                    torch.from_numpy(ci.astype(np.int64)),
                                    torch.ones(len(ci)), size=(n, n)).to(dev)
    rng = np.random.RandomState(0)
    x32 = torch.from_numpy(rng.randn(n, 32).astype(np.float32)).to(dev)
    xin = torch.from_numpy(rng.randn(n, 96).astype(np.float32))
    y = np.ones(n, dtype=np.int64)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "package": block_spmm.__file__}
    for sel in ("intended", "calibrated"):
        op = HybridSpMM(rp, ci, n, PlanConfig(band_mode="never", loi_mode=sel), device=dev)
        rec = {}
        for k in block_spmm.row_launches:
            block_spmm.row_launches[k] = 0
        with torch.no_grad():
            op(x32)
        torch.cuda.synchronize()
        rec["launches_per_spmm"] = dict(block_spmm.row_launches)
        for cd, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            dense, ell = populations(op, x32.to(dtype))
            rec[f"dense_ms_{cd}"] = device_ms(dense, 20, ("dense_",))
            rec[f"ell_ms_{cd}"] = device_ms(ell, 20, ("ell_row",))
        with torch.no_grad():
            rec["spmm_ms"] = median_ms(lambda: op(x32))
            rec["spmm_busy_ms"] = device_ms(lambda: op(x32), 10, ())
        rec["sparse_mm_ms"] = median_ms(lambda: torch.sparse.mm(a_csr, x32))
        rec["gcn"] = epoch_profile(op, xin, y)
        result[sel] = rec
        print(f"{sel}: {rec}", flush=True)
        del op
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
