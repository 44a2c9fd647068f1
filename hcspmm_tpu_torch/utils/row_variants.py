"""Times builds of csrc/rows.cu with some of its constants changed, on DD's
row plans, on one CUDA card.

    python -m hcspmm_tpu_torch.utils.row_variants STAGES=2 STAGES=3 EU=8,EW=8

Each argument is one variant: comma-separated ``NAME=VALUE`` pairs, each
replacing the value of the namespace constant ``constexpr int NAME = ...;``
of ``csrc/rows.cu`` (``STAGES``, ``EW``, ``EU``, ``DW``, ...); the source as
it stands is the first variant, ``shipped``.  Every variant is built with
nvcc (all at once, under ``build/hcspmm_tpu_torch/variants/``), then the
dense launch (``dense_rows``) and the ELL launch (``ell_rows``) of DD's
intended and calibrated row plans (``io.reference_standin("DD", seed=7)``,
cluster order, ``band_mode='never'``) are timed by torch.profiler's device
time, 20 calls each, at D 32 in fp32 and bf16 and at D 256 in fp32, the
variants interleaved in 3 rounds; each variant's output must equal the
shipped build's (the dense launch bit for bit, the ELL launch within 1e-5
of max|ref|, its sum order following EW).  Prints the card's name and power
limit, a table of median ms, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from hcspmm_tpu_torch.kernels import _build, block_spmm
from hcspmm_tpu_torch.utils.bench import device_ms


def variant_source(src: str, spec: str) -> str:
    """``src`` with each ``NAME=VALUE`` of ``spec`` substituted."""
    for pair in filter(None, spec.split(",")):
        name, value = pair.split("=")
        src, n = re.subn(rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};",
                         src)
        if n != 1:
            raise ValueError(f"csrc/rows.cu has {n} constants named {name}")
    return src


def build(name: str, src: str) -> ctypes.CDLL:
    out = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out, exist_ok=True)
    for header in os.listdir(_build.CSRC):
        if header.endswith(".cuh"):
            shutil.copy(os.path.join(_build.CSRC, header), out)
    cu, so = os.path.join(out, f"{name}.cu"), os.path.join(out, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
                         capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{res.stderr}")
    return block_spmm.bind_rows(ctypes.CDLL(so))


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("row_variants.py measures a CUDA device")
    from hcspmm_tpu_torch.config import PlanConfig
    from hcspmm_tpu_torch.format import reorder
    from hcspmm_tpu_torch.graphs import io
    from hcspmm_tpu_torch.ops.spmm import HybridSpMM

    specs = {"shipped": ""}
    specs.update({spec: spec for spec in (sys.argv[1:] if argv is None else argv)})
    with open(os.path.join(_build.CSRC, "rows.cu")) as f:
        src = f.read()
    names = {spec: f"v{i}" for i, spec in enumerate(specs)}
    with ThreadPoolExecutor(len(specs)) as pool:
        futures = {spec: pool.submit(build, names[spec], variant_source(src, s))
                   for spec, s in specs.items()}
        libs = {spec: f.result() for spec, f in futures.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    src_e, dst_e, n, _ = io.reference_standin("DD", seed=7)
    rp, ci = io.to_csr(src_e, dst_e, n)
    rp, ci = reorder.apply_permutation(rp, ci, n, reorder.cluster_reorder(rp, ci, n))
    gen = torch.Generator().manual_seed(0)
    cases = []
    for sel in ("intended", "calibrated"):
        op = HybridSpMM(rp, ci, n, PlanConfig(band_mode="never", loi_mode=sel), device="cuda")
        p, arrs = op.plan, op.arrays["f"]
        for d, dtype in ((32, torch.float32), (32, torch.bfloat16), (256, torch.float32)):
            x = torch.randn((n, d), generator=gen).to("cuda", dtype)
            label = f"{sel} D {d} {str(dtype).split('.')[-1]}"
            out = torch.zeros((n, d), device="cuda")
            cases.append((f"dense {label}", "dense_window",
                          lambda p=p, a=arrs, x=x, o=out: block_spmm.dense_rows(a, p, x, o)))
            out = torch.zeros((n, d), device="cuda")
            cases.append((f"ell {label}", "ell_row",
                          lambda a=arrs, x=x, o=out: block_spmm.ell_rows(a, x, o)))
    times, refs = {}, {}
    shipped_lib = block_spmm._rows_lib
    try:
        for rnd in range(3):
            for spec, lib in libs.items():
                block_spmm._rows_lib = lambda lib=lib: lib
                for case, frag, fn in cases:
                    if rnd == 0:
                        got = fn().clone()
                        ref = refs.setdefault(case, got)
                        err = float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
                        if err > (0.0 if case.startswith("dense") else 1e-5):
                            raise AssertionError(f"{spec} {case}: rel err {err:.3e} against "
                                                 "the shipped build")
                    times.setdefault((spec, case), []).append(device_ms(fn, 20, (frag,)))
    finally:
        block_spmm._rows_lib = shipped_lib
    table = {spec: {case: float(np.median(times[(spec, case)])) for case, _, _ in cases}
             for spec in specs}
    print("case".ljust(34) + "".join(spec.rjust(18) for spec in specs))
    for case, _, _ in cases:
        print(case.ljust(34) + "".join(f"{table[spec][case]:18.4f}" for spec in specs))
    print(json.dumps({"nvidia_smi": smi, "device_ms": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
