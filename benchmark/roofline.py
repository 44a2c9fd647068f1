"""Operations and bytes of one SpMM, counted from the graph and the width
alone (never from the program's plan), and the card's peaks
(``peaks.json``).  A model's operations an epoch are its reference
module's ``epoch_flops``."""

from __future__ import annotations

import json
import os
from typing import Dict

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks(kind: str) -> Dict[str, float]:
    """The published peaks of the card named ``kind``
    (``torch.cuda.get_device_name()``); KeyError for a card not listed."""
    with open(_PEAKS) as f:
        return json.load(f)[kind]


def spmm_bytes(nodes: int, nnz: int, width: int, elt: int = 4) -> int:
    """One SpMM Z = A X at ``width`` columns: X read once, Z written once,
    the graph's CSR (a 4-byte column index a non-zero, a 4-byte row
    pointer a row)."""
    return 2 * nodes * width * elt + 4 * nnz + 4 * (nodes + 1)


def spmm_flops(nnz: int, width: int) -> int:
    """One SpMM: a multiply and an add a non-zero and a column."""
    return 2 * nnz * width


def spmm_least_s(nodes: int, nnz: int, width: int, peak: Dict[str, float]) -> float:
    """The least time of one fp32 SpMM on the card: bytes at its bandwidth
    or operations at its fp32 rate, the larger."""
    return max(spmm_bytes(nodes, nnz, width) / peak["hbm_bytes_per_s"],
               spmm_flops(nnz, width) / peak["fp32_flops_per_s"])
