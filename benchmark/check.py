"""The numbers that decide ``correct``: a cell's first training steps, as
the timed path ran them, against the plain reference's steps from the
same weights, inputs and dropout masks.

- ``loss_gap``: the largest |loss - reference loss| / |reference loss|
  over the steps;
- ``grad_gap``: the first step's gradient, as the optimizer got it, by
  the worst leaf: ||g - g_ref|| over the larger of ||g_ref|| and the
  median leaf's ||g_ref||;
- ``change_gap``: the weights' change over the steps, by the same
  measure (||dw - dw_ref||, the tensors compared element by element, so
  a change of the right size in the wrong direction shows), over the
  leaves whose reference gradient is at least a thousandth of the median
  leaf's (a leaf under that moves by round-off alone under Adam).

A reading that is not finite, or missing, counts as failing.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

NUMBERS = ("loss_gap", "grad_gap", "change_gap")


def _norms(tensors: Sequence[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm(t.detach().double())) for t in tensors]


def _median(values: Sequence[float]) -> float:
    v = sorted(values)
    mid = len(v) // 2
    return v[mid] if len(v) % 2 else 0.5 * (v[mid - 1] + v[mid])


def _worst(gaps: Sequence[float]) -> float:
    """The largest gap; inf where there is none or one is not finite."""
    if not gaps or not all(math.isfinite(g) for g in gaps):
        return math.inf
    return max(gaps)


def _worst_leaf(got: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
                keep: Sequence[bool]) -> float:
    """max over the kept leaves of ||got - ref|| / max(||ref||, the median
    leaf's ||ref||)."""
    if len(got) != len(ref) or any(g.shape != r.shape for g, r in zip(got, ref)):
        return math.inf
    ref_n = _norms(ref)
    diff_n = _norms([g.double() - r.double() for g, r in zip(got, ref)])
    scale = _median(ref_n)
    return _worst([d / max(r, scale) if max(r, scale) > 0 else math.inf
                   for d, r, k in zip(diff_n, ref_n, keep) if k])


def readings(port: Dict, ref: Dict, weights0: Sequence[torch.Tensor]) -> Dict[str, float]:
    """``port`` and ``ref`` each hold ``losses`` (floats), ``first_grads``
    and ``weights`` (tensors, one a leaf, in the same order)."""
    if len(port["losses"]) != len(ref["losses"]):
        raise ValueError("the two sides ran different numbers of steps")
    loss_gap = _worst([abs(p - r) / abs(r) if r else math.inf
                       for p, r in zip(port["losses"], ref["losses"])])
    g_ref = _norms(ref["first_grads"])
    g_med = _median(g_ref)
    moved = [g >= 1e-3 * g_med for g in g_ref]
    grad_gap = _worst_leaf(port["first_grads"], ref["first_grads"], [True] * len(g_ref))
    change = [w.double() - w0.double() for w, w0 in zip(port["weights"], weights0)]
    change_ref = [w.double() - w0.double() for w, w0 in zip(ref["weights"], weights0)]
    change_gap = _worst_leaf(change, change_ref, moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is finite and within its limit."""
    return all(k in values and math.isfinite(values[k]) and values[k] <= limits[k]
               for k in limits)
