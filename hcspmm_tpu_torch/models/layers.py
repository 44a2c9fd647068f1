"""GCN / GIN / SAGE convolution layers (reference: GNN_model.py:264-302);
port of hcspmm_tpu/models/layers.py.

- weights are raw standard-normal parameters (the reference never calls
  its ``reset_parameters``, GNN_model.py:267-268); ``init='glorot'`` is the
  sane extension;
- each layer carries a ``fixed`` strategy in {0: hidden, 1: first,
  2: final} (GNN_model.py:277-282); numerically all three reduce to the two
  op orders of ops.fused.

Parameters are plain dicts of tensors; ``torch.Generator`` draws them.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from hcspmm_tpu_torch.ops import fused

FIXED_HIDDEN, FIXED_FIRST, FIXED_FINAL = 0, 1, 2


def init_conv_params(gen: torch.Generator, input_dim: int, output_dim: int,
                     init: str = "randn") -> Dict[str, torch.Tensor]:
    w = torch.randn((input_dim, output_dim), generator=gen, dtype=torch.float32)
    if init == "glorot":
        w = w * (2.0 / (input_dim + output_dim)) ** 0.5
    elif init != "randn":
        raise ValueError(f"unknown init: {init}")
    return {"weights": w}


class GCNConv:
    """Update-then-aggregate: Z = A (X W) for every ``fixed`` strategy."""

    def __init__(self, fixed: int = FIXED_HIDDEN):
        self.fixed = fixed

    def __call__(self, params, spmm: Callable, x: torch.Tensor) -> torch.Tensor:
        return fused.update_then_aggregate(spmm, x, params["weights"])


class GINConv:
    """Aggregate-then-update: Z = (A X) W (GNN_model.py:166-233)."""

    def __init__(self, fixed: int = FIXED_HIDDEN):
        self.fixed = fixed

    def __call__(self, params, spmm: Callable, x: torch.Tensor) -> torch.Tensor:
        return fused.aggregate_then_update(spmm, x, params["weights"])


class SAGEConv:
    """GraphSAGE-mean layer (Hamilton, Ying and Leskovec, NeurIPS 2017,
    Algorithm 1 line 5; extension, no reference equivalent):
    ``Z = [X | mean_N(X)] W`` with ``mean_N = D^-1 A X`` and one weight
    ``W`` [2 d_in, d_out], the self rows first, computed as
    ``X W[:d_in] + mean_N(X) W[d_in:]`` in the bound operator's layout
    (``dense_sum``)."""

    def __init__(self, fixed: int = FIXED_HIDDEN):
        self.fixed = fixed

    def __call__(self, params, spmm: Callable, x: torch.Tensor) -> torch.Tensor:
        w = params["weights"]
        d = w.shape[0] // 2
        agg = spmm.mean(x)
        return spmm.dense_sum(x, w[:d], agg, w[d:])
