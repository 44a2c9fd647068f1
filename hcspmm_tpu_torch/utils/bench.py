"""Timing and yardstick helpers for measurements on one CUDA card, and the
transposed band kernel timed at its A_t encodings.

``chip_smoke.py`` and the row layout's benches (``row_bench.py``,
``row_variants.py``) time with these helpers.  Run as a module,

    python -m hcspmm_tpu_torch.utils.bench

it builds the DD-scale blocks stand-in (``io.synthetic_blocks(334928, 5.03,
300, seed=7)``, rcm order) and the DD stand-in (``io.reference_standin("DD",
seed=7)``, cluster order), their tband plans (fp32), and times, at dt 32 in
fp32, the band kernel's direct mode at the plan's main bucket in 7 rounds
of 20 launches each, the variants taking turns (CUDA events, medians): pack 1
(the plan's int8 ``A_t``), packs 2 and 8 (the same blocks packed on the host
with ``format/streams.py``'s packers, where the package reads packed
blocks), and ``torch.sparse.mm`` of the blocks as one CSR matrix, a check on
the card's speed.  It calls only ``tband_spmm_direct(sw, st, at, xt, num_sw,
dtype)``, with ``pack=`` where the package has ``kernels.tband.expand_at``,
and needs nothing else of this file's package, so it times an older checkout
too: copy it to the same path there and run the module from each
checkout's root, in turns, on one card in one call.  Prints the card's name
and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch


def cuda_time_ms(fn, reps: int) -> float:
    """CUDA-event ms per call of ``reps`` calls of ``fn``, after one warm call."""
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


def interleaved_ms(fns: dict, reps: int, trials: int = 7) -> dict:
    """Median CUDA-event ms per call of each of ``fns`` over ``trials``
    rounds in which the functions take turns (forwards, then backwards):
    one process, interleaved, medians."""
    times = {k: [] for k in fns}
    for t in range(trials):
        for k in (list(fns) if t % 2 == 0 else list(reversed(fns))):
            times[k].append(cuda_time_ms(fns[k], reps))
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def device_ms(fn, reps: int, frags) -> float:
    """Device-busy ms per call of ``fn`` in the kernels whose names hold
    ``frags`` (one string, or any of a sequence; every kernel when empty),
    by torch.profiler: without the host's launch overhead that a CUDA-event
    time of back-to-back small launches includes.  Raises if the profile
    holds device records but none of a kernel so named.  A profile can end
    with no device record delivered at all (seen once in a long run on an
    H100, not when the same calls ran alone): it is taken again, and after
    three such profiles the CUDA-event time stands in, with a warning on
    stderr."""
    frags = (frags,) if isinstance(frags, str) else tuple(frags)
    act = torch.profiler.ProfilerActivity
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if not device:
            continue
        busy = sum(e.time_range.end - e.time_range.start for e in device
                   if not any(frags) or any(f in e.name for f in frags))
        if not busy:
            raise AssertionError(f"torch.profiler saw no device time in kernels named {frags}")
        return busy / 1e3 / reps
    print(f"device_ms: three profiles held no device record; CUDA-event time of {frags} "
          "instead, the host's launches included", file=sys.stderr, flush=True)
    return cuda_time_ms(fn, reps)


def block_csr(a, starts, sw, num_sw, m):
    """Band blocks ``a`` [Sb, bh, W] (owned entries only: ``sw`` below
    ``num_sw``) as one CSR matrix [num_sw * bh, m] on their device (row
    sw * bh + r, column start + k): the library yardstick's operand.  With
    ``sw = arange(Sb)`` and ``num_sw = Sb`` it holds the entries in bucket
    order."""
    i, r, k = a.nonzero(as_tuple=True)
    keep = sw.long()[i] < num_sw
    i, r, k = i[keep], r[keep], k[keep]
    rows = sw.long()[i] * a.shape[1] + r
    cols = starts.long()[i] + k
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), torch.ones(
        rows.numel(), device=a.device), (num_sw * a.shape[1], m)).coalesce().to_sparse_csr()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench.py measures a CUDA device")
    from hcspmm_tpu_torch.config import PlanConfig
    from hcspmm_tpu_torch.format import reorder, streams
    from hcspmm_tpu_torch.graphs import io
    from hcspmm_tpu_torch.kernels import tband
    from hcspmm_tpu_torch.ops.spmm import HybridSpMM

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    packs = (1, 2, 8) if hasattr(tband, "expand_at") else (1,)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "package": tband.__file__}
    src, dst, n = io.synthetic_blocks(334_928, 5.03, 300, seed=7)
    rp, ci = io.to_csr(src, dst, n)
    graphs = {"blocks": (rp, ci, n, reorder.rcm_reorder)}
    src, dst, n, _ = io.reference_standin("DD", seed=7)
    graphs["DD"] = (*io.to_csr(src, dst, n), n, reorder.cluster_reorder)
    gen = torch.Generator().manual_seed(0)
    for key, (rp, ci, n, order) in graphs.items():
        rp, ci = reorder.apply_permutation(rp, ci, n, order(rp, ci, n))
        op = HybridSpMM(rp, ci, n, PlanConfig(band_impl="tband"), device="cuda")
        p, arrs = op.plan, op.arrays["f"]
        s = max(range(len(p.band_widths)), key=lambda i: len(p.band_sw_ids[i]))
        st, sw, at = arrs[f"band{s}_start"], arrs[f"band{s}_sw"], arrs[f"band{s}_at"]
        num_sw = p.padded_rows // p.band_h
        host = at.cpu().numpy()
        ats = {1: at, 2: streams.pack_a_nibble(host), 8: streams.pack_a_bits(host)}
        xt = torch.randn((32, p.padded_rows), generator=gen).cuda()
        fns = {}
        for pk in packs:
            a = ats[pk] if pk == 1 else torch.from_numpy(ats[pk]).cuda()
            kw = {"pack": pk} if pk != 1 else {}
            fns[f"pack {pk}"] = (lambda a=a, kw=kw: tband.tband_spmm_direct(
                sw, st, a, xt, num_sw, torch.float32, **kw))
        a_rows = block_csr(at.transpose(1, 2), st, sw, num_sw, p.padded_rows)
        x_rows = xt.T.contiguous()
        fns["torch.sparse.mm"] = lambda: torch.sparse.mm(a_rows, x_rows)
        result[key] = dict(shape=f"Sb {at.shape[0]}, W {at.shape[1]}, bh {p.band_h}, dt 32",
                           ms=interleaved_ms(fns, 20))
        print(f"{key}: {result[key]}", flush=True)
        del op, arrs, a_rows, fns
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
