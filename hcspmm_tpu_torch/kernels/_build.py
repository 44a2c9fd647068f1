"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use, for ``sm_90a`` (Hopper), into ``build/hcspmm_tpu_torch/`` at
the root of the checkout.  The library's file name carries a hash of the
source, the headers of ``csrc/`` and the flags, so an edited source or
header is rebuilt and a stale library is never loaded.  Nothing here runs
at import time: the package imports on machines without nvcc or a GPU,
where the kernels' plain versions run.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

from hcspmm_tpu_torch.utils import profiling

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "hcspmm_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise FileNotFoundError(
            "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA "
            "kernels of hcspmm_tpu_torch are built from source at first use")
    return path


def library_path(name: str) -> str:
    """Path of the shared library built from ``csrc/<name>.cu`` (and the
    headers of ``csrc/`` it may include)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, src), "rb") as f:
            digest.update(src.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it.

    nvcc's output, with ptxas's register and shared-memory report, is kept
    beside the library as ``<library>.log``; a build is a ``build.compile``
    span and counts under ``build.compiled.<name>`` (``utils.profiling``).
    Raises on a failed build."""
    so = library_path(name)
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        with profiling.span("build.compile"):
            res = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
                capture_output=True, text=True, timeout=600)
        with open(so + ".log", "w") as f:
            f.write(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
        profiling.record_build(name)
    return ctypes.CDLL(so)
