"""Training loop (reference: HC-SpMM_main.py:113-166); port of
hcspmm_tpu/train/loop.py.

Parity: Adam lr=0.01 (main.py:115; ``torch.optim.Adam`` has optax.adam's
defaults and update), loss = NLL of the log-softmax output against the
all-ones labels over every node (main.py:125), 9 warm-up epochs, then the
timed epochs (main.py:157-166).  Activations run in the operator's
``layout``, chosen when it was built: its padded layout (transposed [dt,
M] or wide [M, dp]) where it has the closed padded path, and only the final
logits are sliced (by the layout's ``unpad``) before the softmax;
otherwise (``supports_padded`` False: dense, ELL or residual populations,
or ``impl='xla'``) they stay [N, d] in the row layout, as
hcspmm_tpu/train/loop.py:54-140 does.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from hcspmm_tpu_torch.models.net import (Net, init_net_params, net_forward, params_from_jax,
                                         params_to_jax)
from hcspmm_tpu_torch.utils import profiling
from hcspmm_tpu_torch.utils.checkpoint import save_pytree
from hcspmm_tpu_torch.utils.logging import MetricLogger


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """F.nll_loss: mean negative log-probability of the label."""
    return -log_probs.gather(1, labels[:, None]).mean()


def layout_input(spmm, x) -> torch.Tensor:
    """``x`` in the layout the loop trains in (``spmm.layout``), on
    ``spmm.device``: the padded layout when the operator has it (an input
    already padded stays as it is), else [N, d] as given."""
    layout = spmm.layout
    return x if layout.is_padded(x) else layout.pad(x)


def make_train_step(net: Net, spmm, optimizer: torch.optim.Optimizer):
    """``step(params, x, y, gen) -> loss`` for a HybridSpMM ``spmm``:
    forward, NLL, backward and one optimizer step.  ``x`` is raw [N, d]
    or already in the training layout (``layout_input``); ``gen`` draws the
    dropout mask (None needs ``net.dropout == 0``).  The loss comes back as
    a device tensor, so the step never waits for the device.  With tracing on
    (``utils.profiling``) a step is a ``train.step`` span, which starts a
    new step id, over ``train.forward``, ``train.backward`` and
    ``train.optimizer``."""
    layout = spmm.layout

    def out_slice(h):
        return layout.unpad(h, net.num_classes)

    def train_step(params, x, y, gen=None):
        with profiling.span("train.step", step=True):
            x = layout_input(spmm, x)
            optimizer.zero_grad(set_to_none=True)
            with profiling.span("train.forward"):
                logp = net_forward(net, params, layout, x, dropout_gen=gen,
                                   train=True, out_slice=out_slice)
                loss = nll_loss(logp, y)
            with profiling.span("train.backward"):
                loss.backward()
            with profiling.span("train.optimizer"):
                optimizer.step()
            return loss.detach()

    return train_step


def train(net: Net, spmm, x, y, epochs: int = 200, lr: float = 0.01,
          seed: int = 0, warmup_epochs: int = 9,
          logger: Optional[MetricLogger] = None,
          init_params: Optional[List[Dict]] = None,
          checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
          start_epoch: int = 0, fault_epoch: Optional[int] = None) -> Dict:
    """Runs warm-up + timed epochs on ``spmm.device``; returns params and
    timing.  ``epoch_ms`` is the timed epochs' host time, ended by
    ``torch.cuda.synchronize()`` on a CUDA device, over ``epochs``;
    ``warmup_s`` the warm-up epochs' time, first-call costs included.
    Per-epoch losses are logged after the timed loop, so logging adds no
    device wait inside it.

    ``init_params`` resumes from given parameters (tensors, or the NumPy
    tree of a checkpoint) instead of a fresh draw; the optimizer starts
    fresh, as in the JAX package.  ``checkpoint_path`` with
    ``checkpoint_every > 0`` saves the parameters after every that many
    timed epochs, with the absolute epoch counter ``start_epoch + done`` in
    the metadata (the persistence half of train.elastic); each save waits
    for the device, so leave it off for timing runs.  ``fault_epoch``
    injects a fault: a RuntimeError once the absolute counter reaches it,
    after any save due then (hcspmm_tpu/train/loop.py:160-245)."""
    device = spmm.device
    x = layout_input(spmm, x)  # one-time layout conversion
    y = torch.as_tensor(y).to(device=device, dtype=torch.int64)
    if init_params is not None and not isinstance(
            next(iter(init_params[0].values())), torch.Tensor):
        init_params = params_from_jax(init_params, device=device)
    params = (init_params if init_params is not None
              else init_net_params(net, torch.Generator().manual_seed(seed),
                                   device=device))
    optimizer = torch.optim.Adam([t for layer in params for t in layer.values()],
                                 lr=lr)
    step = make_train_step(net, spmm, optimizer)
    gen = torch.Generator(device=device).manual_seed(seed)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def log(losses):
        if logger is not None:
            for e, v in enumerate(losses):
                logger.log(epoch=e, loss=float(v))

    start = time.perf_counter()
    for _ in range(warmup_epochs):  # main.py:157-159 dry-run epochs
        step(params, x, y, gen)
    sync()
    warmup_s = time.perf_counter() - start
    start = time.perf_counter()
    losses = []
    for done in range(1, epochs + 1):
        losses.append(step(params, x, y, gen))
        if checkpoint_path and checkpoint_every > 0 and done % checkpoint_every == 0:
            save_pytree(checkpoint_path, params_to_jax(net, params),
                        {"epoch": start_epoch + done, "loss": float(losses[-1])})
        if fault_epoch is not None and start_epoch + done >= fault_epoch:
            log(losses)
            raise RuntimeError(f"injected fault at epoch {start_epoch + done}")
    sync()
    total = time.perf_counter() - start
    losses = [float(v) for v in losses]
    log(losses)
    return {
        "params": params,
        "final_loss": losses[-1] if losses else float("nan"),
        "epoch_ms": total * 1e3 / max(epochs, 1),
        "total_s": total,
        "warmup_s": warmup_s,
    }
