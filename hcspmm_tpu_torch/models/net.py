"""GCN / GIN / SAGE networks (reference: the ``Net`` classes in
HC-SpMM_main.py:66-110); port of hcspmm_tpu/models/net.py.

Topology: first layer (fixed=1) -> ReLU -> dropout -> (num_layers - 2)
hidden layers (fixed=0) each followed by ReLU -> final layer (fixed=2) ->
log_softmax.  Dropout p=0.5 (F.dropout, HC-SpMM_main.py:82).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from hcspmm_tpu_torch.models.layers import (
    FIXED_FINAL,
    FIXED_FIRST,
    FIXED_HIDDEN,
    GCNConv,
    GINConv,
    SAGEConv,
    init_conv_params,
)


@dataclasses.dataclass
class Net:
    """Static network description; parameters live in a separate list."""

    model: str          # 'gcn' | 'gin' | 'sage'
    num_features: int
    hidden: int
    num_classes: int
    num_layers: int
    dropout: float = 0.5

    def layer_dims(self) -> List:
        dims = [(self.num_features, self.hidden, FIXED_FIRST)]
        for _ in range(self.num_layers - 2):
            dims.append((self.hidden, self.hidden, FIXED_HIDDEN))
        dims.append((self.hidden, self.num_classes, FIXED_FINAL))
        return dims

    def weight_shapes(self) -> List[Tuple[int, int]]:
        """[rows, d_out] of each layer's one weight leaf: SAGE's W stacks
        its self and neighbour rows (GraphSAGE's CONCAT), 2 d_in rows."""
        k = 2 if self.model == "sage" else 1
        return [(k * din, dout) for din, dout, _ in self.layer_dims()]

    def conv(self, fixed: int):
        if self.model == "gcn":
            return GCNConv(fixed)
        if self.model == "sage":
            return SAGEConv(fixed)
        return GINConv(fixed)


def _leaf(t, device) -> torch.Tensor:
    return t.to(device).requires_grad_(True)


def init_net_params(net: Net, gen: torch.Generator, init: str = "randn", *,
                    device) -> List[Dict[str, torch.Tensor]]:
    """Per-layer parameter dicts, drawn on the host from ``gen`` and moved
    to ``device`` (the operator's, as ``train.loop.train`` passes it) as
    leaf tensors that require grad."""
    return [{k: _leaf(v, device) for k, v in init_conv_params(gen, rows, dout, init).items()}
            for rows, dout in net.weight_shapes()]


def params_from_jax(params, *, device) -> List[Dict[str, torch.Tensor]]:
    """The JAX package's parameter list (dicts of ``weights`` or
    ``w_self``/``w_neigh`` arrays, as numpy or jax arrays) as this
    package's parameters: float32 leaf tensors on ``device``.  A SAGE
    layer's ``w_self`` and ``w_neigh`` [d_in, d_out] become its one
    ``weights`` [2 d_in, d_out], ``w_self`` on top."""
    def leaves(layer):
        if "w_self" in layer:
            return {"weights": np.concatenate([np.asarray(layer["w_self"], np.float32),
                                               np.asarray(layer["w_neigh"], np.float32)])}
        return layer

    return [{k: _leaf(torch.from_numpy(np.array(v, dtype=np.float32)), device)
             for k, v in leaves(layer).items()} for layer in params]


def params_to_jax(net: Net, params) -> List[Dict]:
    """The inverse of ``params_from_jax``: this package's parameters in the
    JAX package's form, as the checkpoints hold them, so that a checkpoint
    written here loads in either package.  A SAGE layer's one ``weights``
    [2 d_in, d_out] is split into ``w_self`` (the top rows) and ``w_neigh``;
    the other models' leaves pass as they are."""
    if net.model != "sage":
        return params
    out = []
    for layer in params:
        w = layer["weights"]
        d = w.shape[0] // 2
        out.append({"w_self": w[:d], "w_neigh": w[d:]})
    return out


def net_forward(net: Net, params: List[Dict], spmm: Callable, x: torch.Tensor,
                dropout_gen: Optional[torch.Generator] = None, train: bool = False,
                out_slice=None) -> torch.Tensor:
    """Log-probabilities [N, classes] (F.log_softmax, main.py:87).

    ``out_slice=(rows, cols)`` slices the final activation before the
    softmax (padded class columns must not enter its normalization); a
    callable ``out_slice`` maps the final activation to logits itself
    (ops.spmm.HybridSpMM.unpad_output).  Dropout draws from
    ``dropout_gen``, which must live on ``x``'s device."""
    h = x
    for i, (_, _, fixed) in enumerate(net.layer_dims()):
        h = net.conv(fixed)(params[i], spmm, h)
        if fixed != FIXED_FINAL:
            h = torch.relu(h)
        if fixed == FIXED_FIRST and train and net.dropout > 0:
            if dropout_gen is None:
                raise ValueError("train=True requires dropout_gen")
            keep = 1.0 - net.dropout
            mask = torch.rand(h.shape, generator=dropout_gen, device=h.device) < keep
            h = torch.where(mask, h / keep, torch.zeros_like(h))
    if callable(out_slice):
        h = out_slice(h)
    elif out_slice is not None:
        h = h[: out_slice[0], : out_slice[1]]
    return torch.log_softmax(h, dim=-1)
