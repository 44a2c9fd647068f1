"""Layer-strategy ops mirroring the reference's autograd functions
(GNN_model.py:26-233); port of hcspmm_tpu/ops/fused.py.

- ``update_then_aggregate`` (GCN order): Z = A @ (X W); backward
  dXW = A^T dZ, dX = dXW W^T, dW = X^T dXW.
- ``aggregate_then_update`` (GIN order): Z = (A @ X) W with the aggregate
  kept for dW; backward dAX = dZ W^T, dX = A^T dAX.

``spmm`` is the operator bound to its plan arrays (train.loop.Bound): it
owns the activation layout, so it supplies both layer cores.  The SpMM's
autograd Function (ops.spmm) gives the aggregation backward; autograd
composes the rest.
"""

from __future__ import annotations

import torch


def update_then_aggregate(spmm, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """GCN layer core A @ (X W)."""
    return spmm.gcn_fused(x, w)


def aggregate_then_update(spmm, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """GIN layer core (A @ X) W."""
    return spmm.gin_fused(x, w)
