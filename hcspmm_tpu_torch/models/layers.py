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


def init_sage_params(gen: torch.Generator, input_dim: int, output_dim: int,
                     init: str = "randn") -> dict:
    return {
        "w_self": init_conv_params(gen, input_dim, output_dim, init)["weights"],
        "w_neigh": init_conv_params(gen, input_dim, output_dim, init)["weights"],
    }


class SAGEConv:
    """GraphSAGE-mean layer (extension; no reference equivalent):
    ``Z = X W_self + mean_N(X) W_neigh`` with ``mean_N = D^-1 A X``, both
    dense updates in the bound operator's layout."""

    def __init__(self, fixed: int = FIXED_HIDDEN):
        self.fixed = fixed

    def __call__(self, params, spmm: Callable, x: torch.Tensor) -> torch.Tensor:
        agg = spmm.mean(x)
        hs = spmm.dense(x, params["w_self"]).float()
        hn = spmm.dense(agg, params["w_neigh"]).float()
        return (hs + hn).to(x.dtype)
