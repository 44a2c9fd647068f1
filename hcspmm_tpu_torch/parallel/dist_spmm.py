"""Row-partitioned distributed hybrid SpMM over ``torch.distributed``; port
of hcspmm_tpu/parallel/dist_spmm.py.

Each rank of a process group holds one contiguous row block of X, Y and Z
(``rows_per_shard`` rows of the padded node space ``n_padded``) and runs
its own shard's plan (``ShardedPlan.plans[rank]``, uploaded as
``ops.spmm.HybridSpMM`` uploads a plan): it assembles its view of X, the
column space its plan was built over, then runs the single-card row-layout
SpMM (``kernels.block_spmm.spmm_rows``, or ``_spmm_xla`` for
``impl='xla'``) on it.  The views match the reference's exactly:

- ``allgather``: every rank's block, ``[n_padded, D]``;
- ``band_halo``: ``[prev strip | own | next strip]``, the last ``hb`` rows
  of the previous rank and the first ``hb`` of the next (wrapping around,
  as ``ppermute`` does), then, when the plan has ``far_pair > 0``, S-1
  index-gather rounds of ``far_pair`` rows each;
- ``halo``: ``[own | rounds]``: in round r rank j sends
  ``x_local[send_idx[j, r]]`` to (j+r+1) % S and receives from
  (j-r-1) % S.

The backward is the same operator on the cotangent (the reference's
symmetric-structure assumption, dist_spmm.py:185-198), so the exchange
runs inside ``backward`` too, in the same order on every rank.

Transport: under NCCL the exchanges take the tensors where they lie.
Under gloo (the backend of several ranks sharing one card, which NCCL
refuses, and of CPU ranks) every exchange of a CUDA tensor is staged
explicitly through host memory: copied to the host, exchanged there, and
copied back to the card; gloo moves the bytes through host memory either
way.  The operator raises without an initialised process group or when
the group's size differs from the plan's shard count: it never runs a
single-process SpMM in their place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.kernels import block_spmm
from hcspmm_tpu_torch.ops.spmm import _SpMM, _dot, _dtype, _spmm_xla, _to_device, default_device
from hcspmm_tpu_torch.parallel.partition import ShardedPlan, build_sharded_plan, pad_rows


def group_size(group=None) -> int:
    """The size of ``group`` (None: the default group); raises RuntimeError
    when no process group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("the distributed SpMM needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    return dist.get_world_size(group)


def shard_config(config: PlanConfig, mode: str) -> PlanConfig:
    """The PlanConfig ``build_sharded_plan`` gives every shard of ``mode``
    (partition.py, carried from the reference, rewrites it at its head: the
    halo mode carves bands out, string band widths are pinned to the
    sharded ladder, the band layout is the wide one).  A single-process plan
    of the same graph built with it is the one the shard plans are cut
    from: the distributed SpMM's single-card yardstick."""
    if mode == "halo":
        config = dataclasses.replace(config, band_mode="never")
    if isinstance(config.band_widths, str):
        config = dataclasses.replace(config, band_widths=(256, 512, 1024, 2048))
    return dataclasses.replace(config, band_impl="wide")


class DistHybridSpMM:
    """CSR graph -> one shard plan per rank -> differentiable distributed
    operator on ``device``.

    Construction builds the sharded plan (``build_sharded_plan`` with one
    shard per rank of ``group``) and uploads this rank's shard.
    ``__call__(x_local)`` maps this rank's rows ``[rows_per_shard, D]`` of
    X to its rows of ``A @ X``; every rank calls it together.  ``pad`` and
    ``local_rows`` cut a global ``[N, D]`` input to those rows.  ``device``:
    None is the CUDA device (a RuntimeError without one), as for
    ``HybridSpMM``."""

    def __init__(self, row_pointers, column_index, num_nodes: int, group=None,
                 config: Optional[PlanConfig] = None, mode: str = "allgather", device=None):
        config = config or PlanConfig()
        sharded = build_sharded_plan(row_pointers, column_index, num_nodes,
                                     num_shards=group_size(group), config=config, mode=mode)
        self._setup(sharded, group, config.compute_dtype, device)

    @classmethod
    def from_sharded(cls, sharded: ShardedPlan, group=None, compute_dtype: str = "float32",
                     device=None) -> "DistHybridSpMM":
        """The operator over a sharded plan built beforehand (its
        ``num_shards`` must equal the group's size)."""
        op = cls.__new__(cls)
        op._setup(sharded, group, compute_dtype, device)
        return op

    def _setup(self, sharded: ShardedPlan, group, compute_dtype: str, device) -> None:
        world = group_size(group)
        if world != sharded.num_shards:
            raise ValueError(f"the process group has {world} ranks, the plan "
                             f"{sharded.num_shards} shards")
        self.group = group
        self.world = world
        self.rank = dist.get_rank(group)
        self.device = default_device(device)
        self.sharded = sharded
        self.mode = sharded.mode
        self.plan = sharded.plans[self.rank]
        self.compute_dtype = _dtype(compute_dtype)
        block_spmm.rows_check(self.plan)
        #: this rank's plan arrays on the device
        self.arrays = _to_device(self.plan, self.device)
        # global ranks of the group's members, for point-to-point ops
        self._peers = [r if group is None else dist.get_global_rank(group, r)
                       for r in range(world)]
        #: stage CUDA tensors through host memory (every backend but NCCL)
        self.staged = dist.get_backend(group) != "nccl"
        self._send = None
        if sharded.send_idx is not None:
            self._send = torch.from_numpy(
                sharded.send_idx[self.rank].astype(np.int64)).to(self.device)

    # ---- global <-> local rows ----

    @property
    def n_padded(self) -> int:
        return self.sharded.n_padded

    @property
    def rows_per_shard(self) -> int:
        return self.sharded.rows_per_shard

    def pad(self, x: np.ndarray) -> np.ndarray:
        """A global node array zero-padded to ``n_padded`` rows."""
        return pad_rows(np.asarray(x), self.sharded.n_padded)

    def local_rows(self, x_global) -> torch.Tensor:
        """This rank's row block of a global ``[N or n_padded, ...]`` array,
        zero-padded as ``pad`` pads it, as a tensor on the device."""
        lo = self.rank * self.rows_per_shard
        x = self.pad(x_global)[lo: lo + self.rows_per_shard]
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ---- the exchange ----

    def exchange_rows(self) -> int:
        """Rows of X this rank receives from the others per SpMM."""
        s, rows = self.world, self.rows_per_shard
        if self.mode == "allgather":
            return (s - 1) * rows
        if self.mode == "band_halo":
            return 2 * self.sharded.halo_pair + (s - 1) * self.sharded.far_pair
        return (s - 1) * self.sharded.halo_pair

    def _host(self, t):
        return t.cpu() if self.staged and t.device.type != "cpu" else t

    def all_reduce_sum(self, tensors) -> None:
        """Sum ``tensors`` over the group's ranks, in place, in one
        all-reduce of their concatenation (staged as the exchanges are)."""
        if not tensors:
            return
        flat = self._host(torch.cat([t.reshape(-1) for t in tensors]))
        dist.all_reduce(flat, group=self.group)
        flat = flat.to(self.device)
        off = 0
        for t in tensors:
            t.copy_(flat[off: off + t.numel()].view_as(t))
            off += t.numel()

    def _p2p(self, sends) -> list:
        """Exchange point to point: ``sends`` is [(tensor, to_rank,
        from_rank)]; returns the tensors received, in order (each shaped as
        its send; a rank's message to itself is its own tensor)."""
        ops, recvs = [], []
        for tag, (t, to, frm) in enumerate(sends):
            if to == self.rank:
                recvs.append(t)
                continue
            t = self._host(t.contiguous())
            buf = torch.empty_like(t)
            ops.append(dist.P2POp(dist.isend, t, self._peers[to], self.group, tag))
            ops.append(dist.P2POp(dist.irecv, buf, self._peers[frm], self.group, tag))
            recvs.append(buf)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [r.to(self.device) for r in recvs]

    def exchange(self, x_local: torch.Tensor) -> torch.Tensor:
        """This rank's view of X, ``[plan.num_cols, D]``, from its rows
        ``[rows_per_shard, D]`` (every rank calls it together)."""
        if tuple(x_local.shape[:1]) != (self.rows_per_shard,):
            raise ValueError(f"x_local has {x_local.shape[0]} rows, a shard "
                             f"{self.rows_per_shard}")
        s, j = self.world, self.rank
        if self.mode == "allgather":
            t = self._host(x_local.contiguous())
            parts = [torch.empty_like(t) for _ in range(s)]
            dist.all_gather(parts, t, group=self.group)
            return torch.cat(parts).to(self.device)
        sends = []
        if self.mode == "band_halo":
            hb = self.sharded.halo_pair
            sends += [(x_local[-hb:], (j + 1) % s, (j - 1) % s),
                      (x_local[:hb], (j - 1) % s, (j + 1) % s)]
        if self._send is not None:  # halo rounds, or band_halo's far rounds
            sends += [(x_local.index_select(0, self._send[r]), (j + r + 1) % s,
                       (j - r - 1) % s) for r in range(s - 1)]
        got = self._p2p(sends)
        if self.mode == "band_halo":
            return torch.cat([got[0], x_local, got[1], *got[2:]])
        return torch.cat([x_local, *got])

    # ---- the operator ----

    def local_spmm(self, x_view: torch.Tensor) -> torch.Tensor:
        """This rank's plan on its view: ``[plan.num_cols, D] ->
        [rows_per_shard, D]``."""
        if self.sharded.impl == "pallas":
            return block_spmm.spmm_rows(self.arrays, x_view, self.plan, self.compute_dtype)
        return _spmm_xla(self.arrays, x_view, self.plan, self.compute_dtype)

    def _apply(self, x_local):
        return self.local_spmm(self.exchange(x_local))

    def __call__(self, x_local: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``A @ X``, differentiable: the backward runs
        the same exchange and plan on the cotangent."""
        return _SpMM.apply(x_local, self._apply, self._apply)

    # the layer cores models.layers calls

    def gcn(self, x, w):
        """GCN layer core A (x w)."""
        return self(_dot(x, w))

    def gin(self, x, w):
        """GIN layer core (A x) w."""
        return _dot(self(x), w)

    def dense(self, x, w):
        return _dot(x, w)
