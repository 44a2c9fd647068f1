"""The port's distributed SpMM (hcspmm_tpu_torch/parallel) on the CPU under
gloo, held against the JAX package's DistHybridSpMM (impl='pallas', in
interpret mode on the 8-device CPU mesh tests/conftest.py sets up) and
against scipy.

Each world (2 and 4 ranks) is spawned once for the module
(``parallel.dryrun.run_ranks``); its ranks run every graph and mode of
``CASES`` (forward in float32 and bfloat16, the gradient of sum(z^2), and
two Adam steps of GCN or GIN from the JAX package's initial parameters),
and the parametrised tests check what they returned (bfloat16 against
scipy everywhere and against the JAX op at four ranks in two modes).  The graphs are
``dryrun_multichip``'s: its blocks toy of 512 nodes with its long-range
edges (every mode; band_halo needs index-gather rounds and spill) and its
shuffled graph of 488 nodes, whose last shard is padded; and a graph whose
second half is so sparse that its shard plan covers it only in part with
band blocks.  Tolerances: 1e-5 of max|ref| in float32, 1e-2 in bfloat16,
1e-5 relative for training."""

import functools
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hcspmm_tpu.config import PlanConfig as JaxPlanConfig
from hcspmm_tpu.kernels.block_spmm import spmm_pallas
from hcspmm_tpu.models.net import Net as JaxNet, init_net_params as jax_init_net_params
from hcspmm_tpu.models.net import net_forward as jax_net_forward
from hcspmm_tpu.parallel.dist_spmm import DistHybridSpMM as JaxDistHybridSpMM
from hcspmm_tpu.parallel.partition import build_sharded_plan as jax_build_sharded_plan
from hcspmm_tpu.train.loop import nll_loss as jax_nll_loss

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.graphs import io
from hcspmm_tpu_torch.kernels import block_spmm
from hcspmm_tpu_torch.models.net import Net
from hcspmm_tpu_torch.ops.spmm import HybridSpMM, _spmm_xla, _to_device
from hcspmm_tpu_torch.parallel import dryrun
from hcspmm_tpu_torch.parallel.dist_spmm import DistHybridSpMM
from hcspmm_tpu_torch.parallel.partition import build_sharded_plan

from conftest import small_graph

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
DIM, HIDDEN, CLASSES, LAYERS, STEPS = 32, 16, 4, 3, 2
WORLDS = (2, 4)
BAND = dict(band_h=32, band_widths=(64,), band_mode="auto", impl="pallas")  # dryrun's


def sparse_tail(n=1024, every=16):
    """Blocks of 64 over the first half; over the second, one edge every
    ``every`` rows to a random node: at two shards the second's plan
    covers one superwindow of 16 with a band (a partial cover) and spills
    the rest."""
    s1, d1, _ = io.synthetic_blocks(n // 2, 6, block_size=64, seed=0, shuffle=False)
    s2 = np.arange(n // 2, n, every)
    d2 = np.random.RandomState(0).randint(0, n, len(s2))
    return np.concatenate([s1, s2, d2]), np.concatenate([d1, d2, s2]), n


@functools.lru_cache(maxsize=None)
def graph(name):
    """(rp, ci, n): dryrun_multichip's graphs at four shards, and the
    sparse tail."""
    if name == "blocks":
        src, dst, n = dryrun.blocks_toy(4)
        src, dst = dryrun.far_edges(src, dst, n)
    elif name == "uneven":
        src, dst, n = dryrun.uneven_graph(4)
    else:
        src, dst, n = sparse_tail()
    rp, ci = io.to_csr(src, dst, n)
    return rp, ci, n


_TAIL = dict(band_h=64, band_widths=(128,), band_mode="auto", impl="pallas")

# (graph, mode): PlanConfig fields
CASES = {("blocks", "allgather"): BAND, ("blocks", "band_halo"): BAND,
         ("blocks", "halo"): BAND, ("uneven", "halo"): dict(impl="pallas"),
         ("uneven", "allgather"): dict(impl="pallas"), ("tail", "band_halo"): _TAIL}
NETS = {("blocks", "band_halo"): "gcn", ("uneven", "halo"): "gin"}
# the JAX forwards held against (each one a shard_map compile in interpret mode)
JAX_FORWARDS = [(s, "blocks", m) for s in WORLDS for m in ("allgather", "band_halo", "halo")] + [
    (4, "uneven", "halo")]


def ids(v):
    return "-".join(str(u) for u in v)


def x_of(name):
    return np.random.RandomState(0).randn(graph(name)[2], DIM).astype(np.float32)


def net_of(model):
    return JaxNet(model=model, num_features=DIM, hidden=HIDDEN, num_classes=CLASSES,
                  num_layers=LAYERS)


@functools.lru_cache(maxsize=None)
def jax_params(model):
    return jax_init_net_params(net_of(model), jax.random.PRNGKey(0))


def csr(name):
    rp, ci, n = graph(name)
    return sp.csr_matrix((np.ones(len(ci)), ci, rp), shape=(n, n))


def rel_err(got, ref):
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def worlds():
    """world size -> {(graph, mode): the ranks' results, assembled}."""
    cases = []
    for (name, mode), fields in CASES.items():
        rp, ci, n = graph(name)
        nets = []
        if (name, mode) in NETS:
            model = NETS[(name, mode)]
            params = [{k: np.asarray(v) for k, v in layer.items()} for layer in jax_params(model)]
            nets.append((Net(model, DIM, HIDDEN, CLASSES, LAYERS), params, STEPS))
        cases.append(dict(rp=rp, ci=ci, n=n, mode=mode, config=PlanConfig(**fields),
                          x=x_of(name), grad=True, bf16=True, nets=nets))
    out = {}
    for world in WORLDS:
        ranks = dryrun.run_ranks(dryrun.run_cases, world, "cpu", (cases,))
        out[world] = {}
        for i, key in enumerate(CASES):
            per = [r[i] for r in ranks]
            assert [p["rows"][0] for p in per] == [r * per[0]["rows"][1] for r in range(world)]
            res = {k: np.concatenate([p[k] for p in per]) for k in ("z", "grad", "z_bf16")}
            res.update({k: v for k, v in per[0].items() if k.endswith(("losses", "params"))
                        or k in ("far_pair", "n_padded")})
            for p in per[1:]:  # replicated: every rank holds the same losses and parameters
                for k in res:
                    if k.endswith("losses"):
                        assert p[k] == res[k]
            out[world][key] = res
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", list(CASES), ids=ids)
def test_dist_forward_matches_scipy(worlds, world, key):
    name, mode = key
    res = worlds[world][key]
    n = graph(name)[2]
    ref = csr(name) @ x_of(name).astype(np.float64)
    assert res["n_padded"] >= n and not np.abs(res["z"][n:]).any()
    assert rel_err(res["z"][:n], ref) <= TOL["float32"]
    assert rel_err(res["z_bf16"][:n], ref) <= TOL["bfloat16"]
    if key == ("blocks", "band_halo"):
        assert res["far_pair"] > 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", list(CASES), ids=ids)
def test_dist_grad_matches_scipy(worlds, world, key):
    """The backward runs the exchange and the plan on the cotangent: the
    gradient of sum((A x)^2) is 2 A^T A x, and these graphs are symmetric."""
    name, _ = key
    a = csr(name)
    assert (a != a.T).nnz == 0
    x = x_of(name).astype(np.float64)
    n = graph(name)[2]
    assert rel_err(worlds[world][key]["grad"][:n], 2 * (a.T @ (a @ x))) <= TOL["float32"]


@functools.lru_cache(maxsize=None)
def jax_op(world, name, mode):
    rp, ci, n = graph(name)
    mesh = Mesh(np.array(jax.devices()[:world]), ("x",))
    return JaxDistHybridSpMM(rp, ci, n, mesh, mode=mode, config=JaxPlanConfig(**CASES[(name,
                                                                                        mode)]))


@pytest.mark.parametrize("case", JAX_FORWARDS, ids=ids)
def test_dist_forward_matches_jax(worlds, case):
    world, name, mode = case
    op = jax_op(world, name, mode)
    assert op.sharded.impl == "pallas"
    want = np.asarray(op(jax.device_put(op.pad(x_of(name)), op.sharding)), np.float64)
    got = worlds[world][(name, mode)]["z"]
    assert got.shape == want.shape
    assert rel_err(got, want) <= TOL["float32"]


@pytest.mark.parametrize("key", [("blocks", "band_halo"), ("uneven", "halo")], ids=ids)
def test_dist_forward_bf16_matches_jax(worlds, key):
    """bfloat16 compute at four ranks: the band kernel's path (far rounds
    and spill) and the row kernels' (uneven shards)."""
    name, mode = key
    rp, ci, n = graph(name)
    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    op = JaxDistHybridSpMM(rp, ci, n, mesh, mode=mode, config=JaxPlanConfig(
        compute_dtype="bfloat16", **CASES[key]))
    xs = jax.device_put(op.pad(x_of(name)).astype(jnp.bfloat16), op.sharding)
    want = np.asarray(op(xs).astype(jnp.float32), np.float64)
    assert rel_err(worlds[4][key]["z_bf16"], want) <= TOL["bfloat16"]


def test_dist_grad_matches_jax(worlds):
    """Through the strips and the far rounds, at four ranks."""
    op = jax_op(4, "blocks", "band_halo")
    assert op.sharded.far_pair > 0
    xs = jnp.asarray(jax.device_put(op.pad(x_of("blocks")), op.sharding))
    want = np.asarray(jax.grad(lambda v: (op.apply(op.arrays, v) ** 2).sum())(xs), np.float64)
    assert rel_err(worlds[4][("blocks", "band_halo")]["grad"], want) <= TOL["float32"]


@functools.lru_cache(maxsize=None)
def jax_steps(key):
    """dryrun_multichip's training step (Adam 0.01, NLL over the padded
    rows, all-ones labels) at four devices, ``STEPS`` times: (losses,
    parameters)."""
    name, mode = key
    op = jax_op(4, name, mode)
    net = net_of(NETS[key])
    params = jax_params(NETS[key])
    optimizer = optax.adam(0.01)
    opt_state = optimizer.init(params)
    xs = jax.device_put(op.pad(x_of(name)), op.sharding)
    ys = jax.device_put(np.ones(op.n_padded, np.int32), NamedSharding(op.mesh, P("x")))

    def loss_fn(p, arrs, x, y):
        return jax_nll_loss(jax_net_forward(net, p, lambda v: op.apply(arrs, v), x,
                                            train=False), y)

    @jax.jit
    def step(p, s, arrs, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(p, arrs, x, y)
        updates, s = optimizer.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, op.arrays, xs, ys)
        losses.append(float(loss))
    return losses, params


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", list(NETS), ids=ids)
def test_dist_train_steps_match_jax(worlds, world, key):
    """GCN (band_halo, far rounds) and GIN (halo, uneven shards) steps: the
    losses and the updated parameters of every step against the JAX
    package's, from the same parameters."""
    model = NETS[key]
    want_losses, want_params = jax_steps(key)
    res = worlds[world][key]
    np.testing.assert_allclose(res[f"{model} losses"], want_losses, rtol=1e-5)
    for got, want in zip(res[f"{model} params"], want_params):
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5, atol=1e-6)


def views(sharded, xg):
    """Each shard's view of the global padded X, assembled on the host by
    the reference's definitions (dist_spmm.py:88-154)."""
    s, rows = sharded.num_shards, sharded.rows_per_shard
    loc = [xg[i * rows:(i + 1) * rows] for i in range(s)]

    def rounds(i):
        return [loc[(i - r - 1) % s][sharded.send_idx[(i - r - 1) % s, r]] for r in range(s - 1)]

    out = []
    for i in range(s):
        if sharded.mode == "allgather":
            out.append(xg)
        elif sharded.mode == "band_halo":
            hb = sharded.halo_pair
            strips = [loc[(i - 1) % s][-hb:], loc[i], loc[(i + 1) % s][:hb]]
            out.append(np.concatenate(strips + (rounds(i) if sharded.far_pair else [])))
        else:
            out.append(np.concatenate([loc[i]] + rounds(i)))
    return out


_ROWS = dict(band_spill="never", band_h=64, band_widths=(128,), loi_mode="calibrated")
_TWO = dict(band_h=64, band_widths=(128, 256), band_mode="always", impl="pallas")


def mixed_graph():
    """Blocks of 32 over the first half, random edges over the second."""
    rng = np.random.RandomState(0)
    s1, d1, _ = io.synthetic_blocks(512, 6, block_size=32, seed=0, shuffle=False)
    s2, d2 = rng.randint(512, 1024, 6 * 512), rng.randint(0, 1024, 6 * 512)
    rp, ci = io.to_csr(np.concatenate([s1, s2, d2]), np.concatenate([d1, d2, s2]), 1024)
    return rp, ci, 1024


# name: (graph, PlanConfig fields, mode, shards, path of spmm_rows)
RECT = {
    "band_halo_far": (lambda: graph("blocks"), BAND, "band_halo", 4, "full cover"),
    "allgather_two_buckets": (mixed_graph, _TWO, "allgather", 4, "full cover"),
    "halo_rows": (lambda: graph("uneven"), dict(impl="pallas"), "halo", 4, "populations"),
    "allgather_rows": (lambda: small_graph(300, 6), _ROWS, "allgather", 2, "populations"),
    "band_halo_partial": (lambda: graph("tail"), _TAIL, "band_halo", 2, "mixed"),
}


@pytest.mark.parametrize("case", sorted(RECT))
def test_rect_spmm_rows_matches_jax_spmm_pallas(case):
    """``spmm_rows`` on shard plans (num_cols != num_nodes: X is the
    shard's column space, the output its rows) against the JAX package's
    ``spmm_pallas`` on the same shard plans and views, and scipy; the plain
    form ``_spmm_xla`` (``impl='xla'``) too."""
    make, fields, mode, shards, path = RECT[case]
    rp, ci, n = make()
    want_sh = jax_build_sharded_plan(rp, ci, n, shards, JaxPlanConfig(**fields), mode=mode)
    sh = build_sharded_plan(rp, ci, n, shards, PlanConfig(**fields), mode=mode)
    xg = np.zeros((sh.n_padded, 24), np.float32)
    xg[:n] = np.random.RandomState(1).randn(n, 24)
    a = sp.csr_matrix((np.ones(len(ci)), ci, rp), shape=(n, n))
    ref = np.zeros((sh.n_padded, 24))
    ref[:n] = a @ xg[:n].astype(np.float64)
    rows = sh.rows_per_shard
    for i, (p, q, xv) in enumerate(zip(sh.plans, want_sh.plans, views(sh, xg))):
        assert p.num_cols == xv.shape[0] != p.num_nodes
        if path != "mixed":
            assert block_spmm.band_covers_all(p) == (path == "full cover")
        arrs = _to_device(p, "cpu")
        got = block_spmm.spmm_rows(arrs, torch.from_numpy(xv), p, torch.float32).numpy()
        want = np.asarray(spmm_pallas({k: jnp.asarray(v) for k, v in q.device_arrays().items()},
                                      jnp.asarray(xv), q, jnp.float32))
        blk = ref[i * rows:(i + 1) * rows]
        assert got.shape == want.shape == blk.shape
        scale = max(np.abs(blk).max(), 1e-30)
        assert np.abs(got - want).max() / scale <= TOL["float32"]
        assert np.abs(got - blk).max() / scale <= TOL["float32"]
        xla = _spmm_xla(arrs, torch.from_numpy(xv), p, torch.float32).numpy()
        assert np.abs(xla - blk).max() / scale <= TOL["float32"]
    if case == "allgather_two_buckets":  # a bucket of capacity padding only
        assert any(not len(p.band_sw_ids[s]) and p.band_starts[s].shape[0]
                   for p in sh.plans for s in range(len(p.band_widths)))
    if case == "band_halo_partial":  # shard 0 covered, shard 1 partly: band, spill
        p0, p1 = sh.plans
        assert block_spmm.band_covers_all(p0) and sh.far_pair > 0
        assert not p1.band_full_cover and len(p1.band_sw_ids[0]) and p1.has_spill


def test_dist_refuses_without_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    rp, ci, n = graph("uneven")
    with pytest.raises(RuntimeError, match="process group"):
        DistHybridSpMM(rp, ci, n, config=PlanConfig(impl="pallas"), mode="halo", device="cpu")


def test_dist_refuses_wrong_world_size_and_runs_alone():
    """In a group of one rank: a plan of two shards raises; a plan of one
    shard (every exchange a rank's message to itself) equals the
    single-process operator."""
    import torch.distributed as dist

    rp, ci, n = graph("uneven")
    cfg = PlanConfig(impl="pallas")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=0,
                                world_size=1)
        try:
            with pytest.raises(ValueError, match="1 ranks, the plan 2 shards"):
                DistHybridSpMM.from_sharded(build_sharded_plan(rp, ci, n, 2, cfg, mode="halo"),
                                            device="cpu")
            x = x_of("uneven")
            ref = HybridSpMM(rp, ci, n, cfg, device="cpu")(torch.from_numpy(x)).numpy()
            for mode in ("allgather", "halo", "band_halo"):
                fields = dict(BAND) if mode == "band_halo" else dict(impl="pallas")
                if mode == "band_halo":  # this graph's edges leave the strips: spill
                    fields.update(band_widths=(128,), band_h=64)
                op = DistHybridSpMM(rp, ci, n, config=PlanConfig(**fields), mode=mode,
                                    device="cpu")
                with torch.no_grad():
                    z = op(op.local_rows(x)).numpy()[:n]
                assert rel_err(z, ref.astype(np.float64)) <= TOL["float32"]
        finally:
            dist.destroy_process_group()


def test_run_ranks_defaults_to_cuda(monkeypatch):
    """``run_ranks`` with no device asks for the card and, without one,
    raises before it spawns a rank rather than run the ranks on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_ranks(dryrun.run_cases, 2, args=([],))


def test_dryrun_two_ranks():
    """``parallel.dryrun`` (the analog of ``dryrun_multichip``): GCN and
    GIN steps, halo backward, far rounds and the checkpoint cycle, at two
    ranks on the CPU."""
    out = subprocess.run([sys.executable, "-m", "hcspmm_tpu_torch.parallel.dryrun", "--world",
                          "2", "--device", "cpu"], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [v for v in out.stdout.splitlines() if v.startswith("dryrun(2, cpu)")]
    assert [v.split(": ")[1].rsplit(" ", 2)[0] for v in lines] == [
        "gcn", "halo grad", "far gcn", "gin", "resumed gin"]


def test_new_modules_import_no_jax():
    """A fresh interpreter that imports the distributed SpMM, the dry run,
    the checkpoint, profiling and real-graph modules and the elastic
    supervisor, and runs a checkpoint round trip and a world of one rank,
    has imported neither JAX, optax nor hcspmm_tpu."""
    code = """
import sys, tempfile, os
import numpy as np, torch, torch.distributed as dist
from hcspmm_tpu_torch.parallel import dist_spmm, dryrun, partition
from hcspmm_tpu_torch.utils import checkpoint, profiler_age, profiling
from hcspmm_tpu_torch.graphs import real
from hcspmm_tpu_torch.train import elastic
with tempfile.TemporaryDirectory() as tmp:
    checkpoint.save_pytree(os.path.join(tmp, "c"), [{"w": torch.ones(2)}], {"epoch": 1})
    assert checkpoint.load_pytree(os.path.join(tmp, "c"))[1] == {"epoch": 1}
    dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "r"), rank=0,
                            world_size=1)
    src, dst, n = dryrun.blocks_toy(1)
    rp, ci = dryrun.io.to_csr(src, dst, n)
    op = dist_spmm.DistHybridSpMM(rp, ci, n, config=dryrun.BAND_CONFIG, mode="band_halo",
                                  device="cpu")
    assert bool(torch.isfinite(op(op.local_rows(np.ones((n, 4), np.float32)))).all())
    dist.destroy_process_group()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "optax", "hcspmm_tpu"))
print("BAD", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout
