"""Plain PyTorch reference of a GraphSAGE-mean training step (Hamilton, Ying
and Leskovec, NeurIPS 2017, Algorithm 1 line 5), in float32 with TF32 off:
what a SAGE cell's training steps are held against.

    H_l = [H_{l-1} | D^-1 A H_{l-1}] W_l,  W_l [2 d_in, d_out] (self rows
    first), ReLU after every layer but the last, dropout after the first
    layer, log-softmax, NLL over every node, then Adam (Kingma & Ba;
    torch.optim.Adam's update).

The mean is a torch.sparse CSR product over the graph's own binary CSR,
scaled by 1/max(deg, 1) of each row; its backward is A^T D^-1 g, the
product with the transposed CSR built here.  The concatenation is built
as written.  Dropout takes the keep-masks it is given, node by node.
Nothing here reads the program.  The module gives what ``gcn.py`` gives,
and ``agg_widths``: the width of each SpMM an epoch runs, for
``kernels.mean_roofline``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from benchmark import roofline
from benchmark.reference.gcn import Adam, nll, normalized_adjacency

#: the program's ``models.net.Net`` models this reference stands for
MODELS = ("sage",)


def _dims(cfg: Dict) -> List[int]:
    return [cfg["dim"]] + [cfg["hidden"]] * (cfg["num_layers"] - 1) + [cfg["classes"]]


def layer_shapes(cfg: Dict) -> List[Tuple[int, int]]:
    """[2 d_in, d_out] of each layer's one weight leaf."""
    dims = _dims(cfg)
    return [(2 * din, dout) for din, dout in zip(dims[:-1], dims[1:])]


def agg_widths(cfg: Dict) -> List[int]:
    """The width of each mean aggregation an epoch: every layer's forward at
    its input width, and the backward of every layer past the first (the
    first layer's input needs no gradient)."""
    ins = _dims(cfg)[:-1]
    return ins + ins[1:]


def epoch_flops(cfg: Dict, nodes: int, nnz: int) -> int:
    """One training epoch over every node: each layer's product with its
    [2 d_in, d_out] weight forward, its weight gradient and (past the first
    layer) its input gradient, 2 N 2d_in d_out each; 2 nnz d for each SpMM
    of ``agg_widths``.  The D^-1 scalings, elementwise work, the loss and
    Adam are left out."""
    total = 0
    for i, (rows, dout) in enumerate(layer_shapes(cfg)):
        total += (2 if i == 0 else 3) * 2 * nodes * rows * dout
    return total + sum(roofline.spmm_flops(nnz, w) for w in agg_widths(cfg))


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, at, inv_deg):
        ctx.at, ctx.inv_deg = at, inv_deg
        return torch.sparse.mm(a, x) * inv_deg[:, None]

    @staticmethod
    def backward(ctx, g):
        return torch.sparse.mm(ctx.at, (g * ctx.inv_deg[:, None]).contiguous()), None, None, None


def forward(weights: Sequence[torch.Tensor], a, at, inv_deg, x: torch.Tensor,
            keep_mask, keep: float) -> torch.Tensor:
    """Log-probabilities [N, classes]; ``keep_mask`` [N, hidden] (bool) is
    the first layer's dropout, None for none."""
    h = x
    last = len(weights) - 1
    for i, w in enumerate(weights):
        h = torch.matmul(torch.cat([h, _Mean.apply(h, a, at, inv_deg)], dim=1), w)
        if i != last:
            h = torch.relu(h)
        if i == 0 and keep_mask is not None:
            h = torch.where(keep_mask, h / keep, torch.zeros_like(h))
    return torch.log_softmax(h, dim=-1)


def prepare(row_pointers, column_index, num_nodes: int, cfg: Dict, device):
    """What ``train_steps`` takes from the graph: (A, A^T, 1/max(deg, 1)),
    A binary."""
    a, at = normalized_adjacency(row_pointers, column_index, num_nodes, device,
                                 normalize=False)
    rp = torch.as_tensor(row_pointers, dtype=torch.int64, device=device)
    inv_deg = 1.0 / torch.clamp(rp[1:] - rp[:-1], min=1).to(torch.float32)
    return a, at, inv_deg


def train_steps(cfg: Dict, graph, weights0: Sequence[torch.Tensor], x, labels, keep_masks,
                loss_rows=None) -> Dict:
    """As ``gcn.train_steps``: ``len(keep_masks)`` steps from ``weights0``
    (copied) over ``graph`` (``prepare``'s); each step's loss, the first
    step's gradients and the weights after the last step.  ``loss_rows``
    takes the loss over those rows only (a fault's stand-in, never a
    cell's)."""
    a, at, inv_deg = graph
    keep = 1.0 - cfg["dropout"]
    params = [w.detach().clone().requires_grad_(True) for w in weights0]
    opt = Adam(params, cfg["lr"], tuple(cfg["betas"]), cfg["eps"])
    losses, first_grads = [], None
    for mask in keep_masks:
        mask = mask() if callable(mask) else mask
        logp = forward(params, a, at, inv_deg, x, mask, keep)
        if loss_rows is not None:
            loss = nll(logp[loss_rows], labels[loss_rows])
        else:
            loss = nll(logp, labels)
        grads = torch.autograd.grad(loss, params)
        if first_grads is None:
            first_grads = [g.detach().clone() for g in grads]
        opt.step(grads)
        losses.append(float(loss.detach()))
        del logp, loss, grads, mask
    return {"losses": losses, "first_grads": first_grads,
            "weights": [p.detach() for p in params]}
