"""A cell's graph: its traffic file names a generator of ``generators.py``
and its arguments; the CSR it gives is cached in the checkout, keyed by
the generator, its arguments and the generators' source."""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Tuple

import numpy as np

from benchmark.graphs import generators

#: generator name in a traffic file -> function giving (src, dst, n, ...)
GENERATORS = {
    "reference_standin": generators.reference_standin,
    "synthetic_dcsbm": generators.synthetic_dcsbm,
    "synthetic_blocks": generators.synthetic_blocks,
}


def cache_key(traffic: Dict) -> str:
    with open(generators.__file__, "rb") as f:
        src = f.read()
    spec = json.dumps({"generator": traffic["generator"], "args": traffic["args"]},
                      sort_keys=True)
    return hashlib.sha256(src + spec.encode()).hexdigest()[:20]


def build_csr(traffic: Dict) -> Tuple[np.ndarray, np.ndarray, int]:
    """(row_pointers int32 [n+1], column_index int32 [nnz], n) of the
    traffic's graph, duplicates merged."""
    out = GENERATORS[traffic["generator"]](**traffic["args"])
    src, dst, n = out[0], out[1], int(out[2])
    rp, ci = generators.to_csr(src, dst, n)
    return rp, ci, n


def load_csr(traffic: Dict, cache_dir: str) -> Tuple[np.ndarray, np.ndarray, int]:
    """``build_csr``, read from ``cache_dir`` where an earlier run of the
    same graph left it."""
    path = os.path.join(cache_dir, f"{traffic['generator']}-{cache_key(traffic)}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["rp"], z["ci"], int(z["n"])
    rp, ci, n = build_csr(traffic)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.npz"
    np.savez(tmp, rp=rp, ci=ci, n=n)
    os.replace(tmp, path)
    return rp, ci, n
