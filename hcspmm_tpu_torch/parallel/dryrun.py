"""Several ranks of the distributed SpMM on one machine: a launcher, the
distributed training step, and the dry run of the JAX package's
``__graft_entry__.py:dryrun_multichip`` (forward, backward and Adam over the
ranks, then a checkpoint save, restore and resume).

    python -m hcspmm_tpu_torch.parallel.dryrun --world 4 --device cpu

``run_ranks`` starts the ranks with ``torch.multiprocessing.spawn`` and
joins them in one process group through a ``file://`` rendezvous in a
temporary directory, so concurrent worlds never contend for a port.  Ranks
on CUDA share one card under gloo (NCCL refuses two ranks on one card) or,
where the machine has a card for each rank, take one each under NCCL; CPU
ranks run gloo.
"""

from __future__ import annotations

import argparse
import datetime
import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.graphs import io
from hcspmm_tpu_torch.models.net import Net, init_net_params, net_forward, params_from_jax
from hcspmm_tpu_torch.ops.spmm import default_device
from hcspmm_tpu_torch.parallel.dist_spmm import DistHybridSpMM


def _rank_main(rank: int, world: int, fn: Callable, device: str, backend: str, tmp: str,
               timeout_s: float, args: tuple) -> None:
    if backend == "nccl":
        device = f"cuda:{rank}"
        torch.cuda.set_device(rank)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        torch.save(fn(rank, world, device, *args), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, device=None, args: Sequence = (),
              timeout_s: float = 600.0) -> List:
    """``fn(rank, world, device, *args)`` in ``world`` spawned processes of
    one process group; returns each rank's result, in rank order.
    ``device`` None is the CUDA device, and raises where there is none;
    pass ``"cpu"`` for host ranks.

    ``fn`` must be importable by its module path (the workers import it
    afresh); its results travel back through files of a temporary directory.
    A rank that raises ends the run (``torch.multiprocessing`` stops the
    others and raises here); a collective that waits longer than
    ``timeout_s`` raises in its rank."""
    import torch.multiprocessing as mp

    device = str(default_device(device))
    backend = ("nccl" if torch.device(device).type == "cuda"
               and torch.cuda.device_count() >= world > 1 else "gloo")
    with tempfile.TemporaryDirectory(prefix="hcspmm_ranks_") as tmp:
        mp.spawn(_rank_main, args=(world, fn, device, backend, tmp, timeout_s, tuple(args)),
                 nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def nll_sum(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sum of the negative log-probabilities of the labels."""
    return -log_probs.gather(1, labels[:, None]).sum()


def train_step(net: Net, params: List[Dict], op: DistHybridSpMM,
               optimizer: torch.optim.Optimizer, x_local: torch.Tensor,
               y_local: torch.Tensor) -> torch.Tensor:
    """One distributed training step; every rank calls it together with its
    rows of X and of the labels (``op.local_rows``) and the same replicated
    parameters.  The loss is the NLL over this rank's rows over
    ``op.n_padded`` (its share of the global mean, pad rows included, as
    ``dryrun_multichip`` counts them); after the backward, the parameters'
    gradients are summed over the ranks (one all-reduce), then ``optimizer``
    steps.  Returns the global loss (summed over the ranks)."""
    optimizer.zero_grad(set_to_none=True)
    logp = net_forward(net, params, op, x_local)
    loss = nll_sum(logp, y_local.long()) / op.n_padded
    loss.backward()
    leaves = [t for layer in params for t in layer.values()]
    op.all_reduce_sum([t.grad for t in leaves])
    optimizer.step()
    total = loss.detach().reshape(1).clone()
    op.all_reduce_sum([total])
    return total[0]


def adam(params: List[Dict], lr: float = 0.01) -> torch.optim.Adam:
    """``torch.optim.Adam`` over every parameter of ``params``."""
    return torch.optim.Adam([t for layer in params for t in layer.values()], lr=lr)


def run_case(rank: int, world: int, device: str, case: dict) -> dict:
    """One graph and mode on this rank, as the tests hold it against the JAX
    package and scipy:
    ``case`` has ``rp``, ``ci``, ``n``, ``mode``, ``config`` (a
    PlanConfig), ``x`` ([n, D] float32) and optionally ``grad`` (also the
    gradient of sum(z^2)), ``bf16`` (also the forward in bfloat16) and
    ``nets``: [(Net, params as NumPy, steps)], each trained ``steps`` Adam
    steps from those parameters on all-ones labels.  Returns this rank's
    rows of each result (NumPy), the losses and the trained parameters."""
    op = DistHybridSpMM(case["rp"], case["ci"], case["n"], config=case["config"],
                        mode=case["mode"], device=device)
    x = op.local_rows(case["x"].astype(np.float32))
    out = {"rows": (op.rank * op.rows_per_shard, op.rows_per_shard),
           "far_pair": op.sharded.far_pair, "halo_pair": op.sharded.halo_pair,
           "n_padded": op.n_padded, "full_cover": op.plan.band_full_cover}
    with torch.no_grad():
        out["z"] = op(x).cpu().numpy()
    if case.get("grad"):
        xg = x.clone().requires_grad_(True)
        (op(xg) ** 2).sum().backward()
        out["grad"] = xg.grad.cpu().numpy()
    if case.get("bf16"):
        op16 = DistHybridSpMM.from_sharded(op.sharded, compute_dtype="bfloat16", device=device)
        with torch.no_grad():
            out["z_bf16"] = op16(x.to(torch.bfloat16)).float().cpu().numpy()
    y = torch.ones(op.rows_per_shard, dtype=torch.int64, device=op.device)
    for net, params_np, steps in case.get("nets", ()):
        params = params_from_jax(params_np, device=op.device)
        opt = adam(params)
        losses = [float(train_step(net, params, op, opt, x, y)) for _ in range(steps)]
        out[f"{net.model} losses"] = losses
        out[f"{net.model} params"] = [{k: v.detach().cpu().numpy() for k, v in layer.items()}
                                      for layer in params]
    return out


def run_cases(rank: int, world: int, device: str, cases: Sequence[dict]) -> List[dict]:
    """``run_case`` for each of ``cases`` in turn."""
    return [run_case(rank, world, device, c) for c in cases]


def blocks_toy(world: int):
    """``dryrun_multichip``'s graph: unshuffled blocks of 32 nodes, 16 * 8 *
    world nodes, every column within +-32 of its row."""
    n = 16 * 8 * world
    src, dst, nn = io.synthetic_blocks(n, 4.0, block_size=32, seed=0, shuffle=False)
    return src, dst, nn


def far_edges(src, dst, n):
    """``dryrun_multichip``'s long-range edges: node k * n/8 to its
    opposite, both ways."""
    far = np.arange(0, n, n // 8)
    return (np.concatenate([src, far, (far + n // 2) % n]),
            np.concatenate([dst, (far + n // 2) % n, far]))


def uneven_graph(world: int):
    """``dryrun_multichip``'s shuffled graph of 16 * 8 * world - 24 nodes:
    the last shard is padded."""
    n2 = 16 * 8 * world - 24
    return io.synthetic_graph(n2, 4.0, seed=1, span=n2)


#: dryrun_multichip's band plan: Pallas kernels (here CUDA) on each shard
BAND_CONFIG = PlanConfig(band_h=32, band_widths=(64,), band_mode="auto", impl="pallas")


def dryrun(rank: int, world: int, device: str, workdir: str) -> Dict[str, float]:
    """The cases of ``dryrun_multichip`` on this rank: a band_halo GCN step
    on the blocks toy; the halo mode's forward and backward on the uneven
    shuffled graph; band_halo with far edges (index-gather rounds and
    spill), forward, then a GCN step; a GIN step; then a checkpoint saved
    by rank 0 into ``workdir``, restored on every rank and one more GIN step
    with a fresh Adam.  Returns the losses; raises on a non-finite one."""
    from hcspmm_tpu_torch.utils.checkpoint import load_pytree, save_pytree

    def finite(name, v):
        if not np.isfinite(np.asarray(v)).all():
            raise AssertionError(f"{name}: not finite")
        return float(np.asarray(v).ravel()[0])

    dim, classes = 32, 4
    src, dst, nn = blocks_toy(world)
    rp, ci = io.to_csr(src, dst, nn)
    x = np.random.RandomState(0).randn(nn, dim).astype(np.float32)
    op = DistHybridSpMM(rp, ci, nn, config=BAND_CONFIG, mode="band_halo", device=device)
    xs = op.local_rows(x)
    ys = torch.ones(op.rows_per_shard, dtype=torch.int64, device=op.device)
    net = Net(model="gcn", num_features=dim, hidden=16, num_classes=classes, num_layers=3)
    params = init_net_params(net, torch.Generator().manual_seed(0), device=op.device)
    res = {"gcn": finite("band_halo GCN step", train_step(net, params, op, adam(params), xs, ys))}

    src2, dst2, n2 = uneven_graph(world)
    rp2, ci2 = io.to_csr(src2, dst2, n2)
    x2 = np.random.RandomState(1).randn(n2, dim).astype(np.float32)
    op2 = DistHybridSpMM(rp2, ci2, n2, config=PlanConfig(impl="pallas"), mode="halo",
                         device=device)
    u = op2.local_rows(x2).requires_grad_(True)
    (op2(u) ** 2).sum().backward()
    res["halo grad"] = finite("halo backward", u.grad.abs().max().cpu())

    rp3, ci3 = io.to_csr(*far_edges(src, dst, nn), nn)
    op3 = DistHybridSpMM(rp3, ci3, nn, config=BAND_CONFIG, mode="band_halo", device=device)
    if world > 2 and not op3.sharded.far_pair:  # at two ranks the strips span the graph
        raise AssertionError("the far edges must need index-gather rounds")
    with torch.no_grad():
        finite("band_halo+spill forward", op3(op3.local_rows(x)).cpu())
    p3 = init_net_params(net, torch.Generator().manual_seed(1), device=op3.device)
    res["far gcn"] = finite("band_halo+spill step",
                            train_step(net, p3, op3, adam(p3), op3.local_rows(x), ys))

    net_gin = Net(model="gin", num_features=dim, hidden=16, num_classes=classes, num_layers=3)
    pg = init_net_params(net_gin, torch.Generator().manual_seed(2), device=op.device)
    res["gin"] = finite("GIN step", train_step(net_gin, pg, op, adam(pg), xs, ys))

    path = os.path.join(workdir, "ckpt.npz")
    if op.rank == 0:
        save_pytree(path, pg, {"epoch": 1, "loss": res["gin"]})
    dist.barrier()
    restored, meta = load_pytree(path)
    if meta["epoch"] != 1 or not all(
            np.array_equal(restored[i][k], pg[i][k].detach().cpu().numpy())
            for i in range(len(pg)) for k in pg[i]):
        raise AssertionError("the checkpoint does not hold the saved parameters")
    pr = params_from_jax(restored, device=op.device)
    res["resumed gin"] = finite("resumed GIN step", train_step(net_gin, pr, op, adam(pr), xs, ys))
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="distributed SpMM dry run over several ranks")
    p.add_argument("--world", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda: every rank on the card (gloo), or a card a rank (NCCL)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA device; pass --device cpu")
    with tempfile.TemporaryDirectory(prefix="hcspmm_dryrun_") as workdir:
        res = run_ranks(dryrun, args.world, args.device, (workdir,))[0]
    for name, loss in res.items():
        print(f"dryrun({args.world}, {args.device}): {name} {loss:.4f} OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
