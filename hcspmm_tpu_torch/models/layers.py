"""GCN / GIN / SAGE convolution layers (reference: GNN_model.py:264-302);
port of hcspmm_tpu/models/layers.py.

- weights are raw standard-normal parameters (the reference never calls
  its ``reset_parameters``, GNN_model.py:267-268); ``init='glorot'`` is the
  sane extension;
- each layer carries a ``fixed`` strategy in {0: hidden, 1: first,
  2: final} (GNN_model.py:277-282); numerically all three reduce to the two
  op orders, the layout's ``gcn`` (Z = A (X W), the reference's
  update-then-aggregate) and ``gin`` (Z = (A X) W, aggregate-then-update,
  the aggregate kept for dW).

``spmm`` is the operator's layout (``HybridSpMM.layout``, an
``ops.spmm`` layout class, or ``parallel.dist_spmm.DistHybridSpMM``): it
owns the activation layout, so it supplies the layer cores.

Parameters are plain dicts of tensors; ``torch.Generator`` draws them.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from hcspmm_tpu_torch.utils import profiling

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
        return spmm.gcn(x, params["weights"])


class GINConv:
    """Aggregate-then-update: Z = (A X) W (GNN_model.py:166-233)."""

    def __init__(self, fixed: int = FIXED_HIDDEN):
        self.fixed = fixed

    def __call__(self, params, spmm: Callable, x: torch.Tensor) -> torch.Tensor:
        return spmm.gin(x, params["weights"])


class SAGEConv:
    """GraphSAGE-mean layer (Hamilton, Ying and Leskovec, NeurIPS 2017,
    Algorithm 1 line 5; extension, no reference equivalent):
    ``Z = [X | mean_N(X)] W`` with ``mean_N = D^-1 A X`` and one weight
    ``W`` [2 d_in, d_out], the self rows first, in the layout ``spmm``.

    The order follows the shapes, as DGL's ``SAGEConv`` chooses
    ``lin_before_mp``: the layer projects before it aggregates,
    ``X W[:d_in] + D^-1 A (X W[d_in:])``, the self product added into the
    mean's output (``dense_add``), where that runs fewer SpMM columns than
    aggregating first, ``X W[:d_in] + mean_N(X) W[d_in:]`` (``dense_sum``);
    ties keep the second.  An SpMM's columns are the layout's
    ``spmm_width`` (the padded layout's lanes or sublanes, the raw width in
    the row layout) at d_out projecting first, at d_in aggregating first.
    Under autograd the backward runs one more SpMM of that width where the
    input takes a gradient, and projecting first also where only the weight
    does (dW of the neighbour rows is X^T A^T D^-1 dZ), so a first layer
    projects first only where it more than halves the width.  In real
    arithmetic both orders are the same function; projecting first keeps no
    [M, d_in] aggregate for dW.  Each forward that projects first counts
    ``models.sage_project_first``."""

    def __init__(self, fixed: int = FIXED_HIDDEN):
        self.fixed = fixed

    def __call__(self, params, spmm: Callable, x: torch.Tensor) -> torch.Tensor:
        w = params["weights"]
        d = w.shape[0] // 2
        grad = torch.is_grad_enabled()
        agg_spmms = 1 + (grad and x.requires_grad)
        proj_spmms = 1 + (grad and (x.requires_grad or w.requires_grad))
        if proj_spmms * spmm.spmm_width(w.shape[1]) < agg_spmms * spmm.spmm_width(d):
            profiling.count("models.sage_project_first")
            return spmm.dense_add(spmm.mean(spmm.dense(x, w[d:])), x, w[:d])
        return spmm.dense_sum(x, w[:d], spmm.mean(x), w[d:])
