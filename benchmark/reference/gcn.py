"""Plain PyTorch reference of a GCN training step (Kipf & Welling), in
float32 with TF32 off: what a cell's training steps are held against.

    Z_l = D^-1/2 A D^-1/2 (H_{l-1} W_l),  H_l = ReLU(Z_l) (not after the last
    layer), dropout after the first layer, log-softmax, NLL over every node,
    then Adam (Kingma & Ba; torch.optim.Adam's update).

The aggregation is a torch.sparse CSR product over the graph's own CSR
(normalised by D, the row degree, at least 1, where the configuration says
``normalize``); its backward is the product with the transposed CSR, built
here.  Dropout takes the keep-masks it is given, node by node.  Nothing
here reads the program.

A reference module gives the harness what a configuration naming it under
``reference`` needs: ``MODELS`` (the program's models it stands for),
``layer_shapes`` (the weight leaves drawn for both sides), ``prepare``
(what it derives from the graph), ``train_steps`` and ``epoch_flops``
(the model's operations an epoch, for ``device.step_mfu``).
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Sequence, Tuple

import torch

from benchmark import roofline

#: the program's ``models.net.Net`` models this reference stands for
MODELS = ("gcn",)

# torch.sparse CSR's beta notice and its invariant-check notice
warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
warnings.filterwarnings("ignore", message="Sparse invariant checks are implicitly disabled")


def layer_shapes(cfg: Dict) -> List[Tuple[int, int]]:
    """[d_in, d_out] of each layer's weight leaf."""
    dims = [cfg["dim"]] + [cfg["hidden"]] * (cfg["num_layers"] - 1) + [cfg["classes"]]
    return list(zip(dims[:-1], dims[1:]))


def epoch_flops(cfg: Dict, nodes: int, nnz: int) -> int:
    """One training epoch over every node: each layer's dense product
    forward, its weight gradient and (past the first layer) its input
    gradient, 2 N d_in d_out each; a forward and a backward SpMM a layer
    at its output width.  Elementwise work, the loss and Adam are left
    out."""
    total = 0
    for i, (din, dout) in enumerate(layer_shapes(cfg)):
        products = 2 if i == 0 else 3
        total += products * 2 * nodes * din * dout
        total += 2 * roofline.spmm_flops(nnz, dout)
    return total


def normalized_adjacency(row_pointers, column_index, num_nodes: int, device,
                         normalize: bool = True):
    """(A_hat, A_hat^T) as float32 CSR tensors on ``device``, A_hat =
    D^-1/2 A D^-1/2 of the binary adjacency (A itself without
    ``normalize``)."""
    rp = torch.as_tensor(row_pointers, dtype=torch.int64, device=device)
    ci = torch.as_tensor(column_index, dtype=torch.int64, device=device)
    rows = torch.repeat_interleave(torch.arange(num_nodes, device=device), rp[1:] - rp[:-1])
    if normalize:
        inv = torch.clamp(rp[1:] - rp[:-1], min=1).to(torch.float32).rsqrt()
        vals = inv[rows] * inv[ci]
    else:
        vals = torch.ones(len(ci), dtype=torch.float32, device=device)
    a = torch.sparse_csr_tensor(rp, ci, vals, (num_nodes, num_nodes))
    order = torch.argsort(ci * num_nodes + rows)
    t_rp = torch.zeros(num_nodes + 1, dtype=torch.int64, device=device)
    t_rp[1:] = torch.cumsum(torch.bincount(ci, minlength=num_nodes), 0)
    at = torch.sparse_csr_tensor(t_rp, rows[order], vals[order], (num_nodes, num_nodes))
    return a, at


class _Aggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, at):
        ctx.at = at
        return torch.sparse.mm(a, x)

    @staticmethod
    def backward(ctx, g):
        return torch.sparse.mm(ctx.at, g.contiguous()), None, None


def forward(weights: Sequence[torch.Tensor], a, at, x: torch.Tensor,
            keep_mask, keep: float) -> torch.Tensor:
    """Log-probabilities [N, classes]; ``keep_mask`` [N, hidden] (bool) is
    the first layer's dropout, None for none."""
    h = x
    last = len(weights) - 1
    for i, w in enumerate(weights):
        h = _Aggregate.apply(torch.matmul(h, w), a, at)
        if i != last:
            h = torch.relu(h)
        if i == 0 and keep_mask is not None:
            h = torch.where(keep_mask, h / keep, torch.zeros_like(h))
    return torch.log_softmax(h, dim=-1)


def nll(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -log_probs.gather(1, labels[:, None]).mean()


class Adam:
    """Adam with bias correction, ``p -= lr * m_hat / (sqrt(v_hat) + eps)``."""

    def __init__(self, params: List[torch.Tensor], lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = m / (1 - b1 ** self.t)
            v_hat = v / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))


def prepare(row_pointers, column_index, num_nodes: int, cfg: Dict, device):
    """What ``train_steps`` takes from the graph: (A_hat, A_hat^T)."""
    return normalized_adjacency(row_pointers, column_index, num_nodes, device,
                                normalize=cfg["normalize"])


def train_steps(cfg: Dict, graph, weights0: Sequence[torch.Tensor], x, labels, keep_masks,
                loss_rows=None) -> Dict:
    """Runs ``len(keep_masks)`` training steps of ``cfg``'s model over
    ``graph`` (``prepare``'s) from ``weights0`` (copied); ``keep_masks[k]``
    is step k's dropout (a tensor, a callable giving it, or None).  Returns
    each step's loss, the first step's gradients and the weights after the
    last step.  ``loss_rows`` takes the loss over those rows only (a
    fault's stand-in, never a cell's)."""
    a, at = graph
    keep = 1.0 - cfg["dropout"]
    params = [w.detach().clone().requires_grad_(True) for w in weights0]
    opt = Adam(params, cfg["lr"], tuple(cfg["betas"]), cfg["eps"])
    losses, first_grads = [], None
    for mask in keep_masks:
        mask = mask() if callable(mask) else mask
        logp = forward(params, a, at, x, mask, keep)
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
