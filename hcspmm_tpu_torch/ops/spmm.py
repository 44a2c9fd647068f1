"""Differentiable hybrid SpMM ``Z = A @ X`` for a binary adjacency A.

Port of hcspmm_tpu/ops/spmm.py over its three layouts: the row layout
[N, d] (every plan; ``kernels/block_spmm.py:spmm_rows`` with its dense,
ELL and residual populations, ``tband.spmm_tband`` on tband plans) and
the two padded layouts, the transposed band (``plan.tband``, X^T [dt, M],
kernels/tband.py) and the wide layout ([M, dp], kernels/block_spmm.py),
which plans with the closed padded path use.  ``impl='xla'`` is the
reference's gather + einsum + segment-sum form in plain torch ops
(``_spmm_xla``), with no kernel.

Forward and backward aggregation are the same operator: the backward of
``A @ X`` is ``A^T @ dZ``, which is the forward SpMM on the same plan when
the graph is symmetric (the reference's assumption) or on a plan built over
A^T (``symmetric=False``).  The GCN and GIN layer cores compose the SpMM
with ``torch.matmul`` for the dense update, as the JAX package's composed
default does with ``jnp.dot``; autograd then yields its backward dataflow
(GCN: dX = (A^T dZ) W^T, dW = X^T (A^T dZ); GIN: the aggregate is kept for
dW).

The kernel-fusion mode (HC-SpMM's fused aggregate and update) is off by
default, as in the JAX package, and turned on per plan by setting
``op.plan.prefer_fused_kernel = True``; it is read at each call.  The layer
cores then run as the reference's custom VJPs (``_LayerCore``): the GIN
forward and the GCN backward are one fused launch each (tband
``tband_fused_direct``, wide and row layouts ``band_fused_spmm_direct``),
where the plan has one full-cover band bucket and, in the tband layout, no
spill; elsewhere they compose as before.

Plans this package does not run raise NotImplementedError at construction
instead of losing edges.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.format.plan import ExecutionPlan, build_plan, transpose_csr
from hcspmm_tpu_torch.kernels import block_spmm, dstream, tband, tspill
from hcspmm_tpu_torch.utils import profiling


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class _SpMM(torch.autograd.Function):
    """``fwd(x)`` with gradient ``bwd(g)``: both are SpMMs over plan arrays
    that are not differentiated; each is one ``spmm.fwd`` or ``spmm.bwd``
    span."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        with profiling.span("spmm.fwd"):
            ctx.bwd = bwd
            ctx.x_dtype = x.dtype
            return fwd(x)

    @staticmethod
    def backward(ctx, g):
        with profiling.span("spmm.bwd"):
            return ctx.bwd(g.contiguous()).to(ctx.x_dtype), None, None


class _Scale(torch.autograd.Function):
    """``(v * inv).to(dtype)`` for a per-row scale ``inv`` that is not
    differentiated (D^-1/2, or the mean aggregation's D^-1, broadcast over
    the layout), forward and backward each one span named ``span``, and
    each counting one ``counter`` where one is given.  The gradient is
    autograd's for the composed form (``ToCopyBackward0`` then
    ``MulBackward0``), so values and gradients equal it bit for bit.  Each
    scaling stays a node of its own: folded into the SpMM's node, the
    backward would hold its incoming gradient through the SpMM and raise the
    step's peak memory."""

    @staticmethod
    def forward(ctx, v, inv, dtype, span="spmm.scale", counter=None):
        if counter:
            profiling.count(counter)
        with profiling.span(span):
            ctx.inv, ctx.v_dtype, ctx.span, ctx.counter = inv, v.dtype, span, counter
            return (v * inv).to(dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.counter:
            profiling.count(ctx.counter)
        with profiling.span(ctx.span):
            inv, vd = ctx.inv, ctx.v_dtype
            return (g.to(torch.promote_types(vd, inv.dtype)) * inv).to(vd), None, None, None, None


# ---------------------------------------------------------------------------
# impl='xla': the reference's plain form (gather + einsum + segment-sum)
# ---------------------------------------------------------------------------


def _band_path_xla(arrs, xp, plan):
    """Band buckets: the contiguous X slice of each superwindow as a
    gather, one fp32 batched product per bucket -> [Sb*bh, D] each (int4
    blocks expanded first)."""
    outs = []
    for s in range(len(plan.band_widths)):
        a = block_spmm.expand_a(arrs[f"band{s}_a"])
        sb, bh, bb = a.shape
        idx = arrs[f"band{s}_start"].long()[:, None] + torch.arange(bb, device=xp.device)
        part = torch.einsum("sbk,skd->sbd", a.float(), xp[idx].float())
        outs.append(part.reshape(sb * bh, xp.shape[1]))
    return outs


def _dense_path_xla(arrs, xp, plan):
    """Dense windows: per-bucket gather + one fp32 batched product (the
    reference's WMMA path, .cu:1385-1472) -> [Wb*wh, D] each."""
    outs = []
    for b in range(len(plan.bucket_widths)):
        a = arrs[f"b{b}_a"]
        part = torch.einsum("wrk,wkd->wrd", a.float(), xp[arrs[f"b{b}_cols"].long()].float())
        outs.append(part.reshape(a.shape[0] * plan.window_h, xp.shape[1]))
    return outs


def _sparse_path_xla(arrs, xp, plan):
    """ELL rows (gather + axis sum, the warp-per-row loop of .cu:964-1036)
    and the residual rows (sorted segment-sum) -> [Rb, D] each, then
    [Rs, D]."""
    outs = [xp[arrs[f"e{e}_cols"].long()].float().sum(1) for e in range(len(plan.ell_widths))]
    rs = plan.num_sparse_rows
    seg = torch.zeros((rs + 1, xp.shape[1]), dtype=torch.float32, device=xp.device)
    seg.index_add_(0, arrs["sparse_edge_seg"], xp[arrs["sparse_edge_col"].long()].float())
    outs.append(seg[:rs])
    return outs


def _spmm_xla(arrs, x, plan, compute_dtype):
    """[C, d] -> [N, d] in x's dtype, C the plan's ``num_cols`` and N its
    ``num_nodes`` (port of hcspmm_tpu/ops/spmm.py:127; they differ on a
    shard plan, whose X is the rank's column space): X with zero rows up
    to the plan's ``xp_rows`` (the pad columns' zero row and band slices
    near the top), every population in fp32, the ``out_perm`` merge, and
    the spill population by the take path."""
    n, d = x.shape
    xp = torch.cat([x, torch.zeros((max(plan.xp_rows - n, 1), d), dtype=x.dtype,
                                   device=x.device)]).to(compute_dtype)
    allrows = torch.cat(_band_path_xla(arrs, xp, plan) + _dense_path_xla(arrs, xp, plan)
                        + _sparse_path_xla(arrs, xp, plan)
                        + [torch.zeros((1, d), device=x.device)])
    out = allrows.index_select(0, arrs["out_perm"])
    if plan.has_spill and "spill_rows" in arrs:
        out = block_spmm._spill_take(out, arrs, xp, plan)
    return out.to(x.dtype)


def _rows_impl(plan, cd, impl):
    """The row-layout SpMM ``fn(arrs, x [N, d])`` of one plan."""
    if impl == "xla":
        if getattr(plan, "tband", False):
            raise ValueError("impl='xla' runs band_impl='wide' plans (the reference's "
                             "CLI builds them under xla); tband plans have no xla form")
        block_spmm.rows_check(plan)
        return lambda arrs, x: _spmm_xla(arrs, x, plan, cd)
    if impl != "pallas":
        raise ValueError(f"unknown impl: {impl}")
    if getattr(plan, "tband", False):
        tband.check_plan(plan)
        return lambda arrs, x: tband.spmm_tband(arrs, x, plan, cd)
    block_spmm.rows_check(plan)
    return lambda arrs, x: block_spmm.spmm_rows(arrs, x, plan, cd)


def _build_impls(plan, pb, cd, impl):
    """(forward, backward) row-layout SpMMs: ``spmm_rows`` (tband plans:
    ``spmm_tband``) for 'pallas', ``_spmm_xla`` for 'xla'."""
    return _rows_impl(plan, cd, impl), _rows_impl(pb, cd, impl)


def make_spmm(plan: ExecutionPlan, plan_bwd: Optional[ExecutionPlan] = None,
              compute_dtype: str = "float32", impl: str = "pallas"):
    """Differentiable row-layout SpMM ``spmm(arrs_f, arrs_b, x [N, d]) ->
    [N, d]``.  ``plan_bwd=None`` reuses the forward plan in the backward
    (symmetric structure)."""
    pb = plan if plan_bwd is None else plan_bwd
    fwd, bwd = _build_impls(plan, pb, _dtype(compute_dtype), impl)

    def spmm(arrs_f, arrs_b, x):
        return _SpMM.apply(x, lambda v: fwd(arrs_f, v), lambda g: bwd(arrs_b, g))

    return spmm


def _dot(x, w):
    """``jnp.dot(x, w, preferred_element_type=f32).astype(x.dtype)``."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _prefers_fused(plan) -> bool:
    """The plan attribute that turns the fused kernels on (read at call
    time, as the JAX package reads it at trace time)."""
    return bool(getattr(plan, "prefer_fused_kernel", False))


class _LayerCore(torch.autograd.Function):
    """A layer core ``z, saved = fwd(x, w)`` whose gradient is ``(dx, dw) =
    bwd(*saved, dz, need_dx)``: the reference's custom VJPs, whose backward
    runs the fused kernel (GCN) or keeps the fused forward's aggregate (GIN).
    ``need_dx`` is False where x needs no gradient (a first layer): the GIN
    backward then skips its SpMM, as autograd skips it in the composed
    form."""

    @staticmethod
    def forward(ctx, x, w, fwd, bwd):
        z, saved = fwd(x, w)
        ctx.bwd = bwd
        ctx.save_for_backward(*saved)
        return z

    @staticmethod
    def backward(ctx, g):
        dx, dw = ctx.bwd(*ctx.saved_tensors, g.contiguous(), ctx.needs_input_grad[0])
        return dx, dw, None, None


def make_fused_ops(plan: ExecutionPlan, plan_bwd: Optional[ExecutionPlan] = None,
                   compute_dtype: str = "float32", impl: str = "pallas"):
    """The GCN and GIN layer cores in the row layout (port of
    hcspmm_tpu/ops/spmm.py:522): ``gcn(arrs_f, arrs_b, x, w) = A (x w)`` and
    ``gin(...) = (A x) w``.  Composed by default: under autograd the GCN
    backward is one SpMM of dZ and two products, dX = (A^T dZ) w^T and dW =
    x^T (A^T dZ); the GIN backward keeps the aggregate for dW and runs one
    SpMM of dZ w^T.  With ``prefer_fused_kernel`` on the plan (impl
    'pallas'), the GCN backward computes (A^T dZ) w^T and A^T dZ in one fused
    launch on the backward plan and the GIN forward (A x) w and A x in one
    on the forward plan (``block_spmm.spmm_fused_rows``, which falls back to
    the SpMM and a product where the plan has no single full-cover band
    bucket), as the reference's ``_fused_impl`` does."""
    cd = _dtype(compute_dtype)
    pb = plan if plan_bwd is None else plan_bwd
    spmm = make_spmm(plan, plan_bwd, compute_dtype, impl)
    fwd_rows, bwd_rows = _build_impls(plan, pb, cd, impl)

    def fused(p, rows, arrs, x, w):
        if impl == "pallas" and _prefers_fused(p):
            res = block_spmm.spmm_fused_rows(arrs, x, w, p, cd)
            if res is not None:
                return res
        agg = rows(arrs, x)
        return _dot(agg, w), agg

    def gcn(arrs_f, arrs_b, x, w):
        if not (impl == "pallas" and _prefers_fused(pb)):
            return spmm(arrs_f, arrs_b, _dot(x, w))

        def fwd(x_, w_):
            return fwd_rows(arrs_f, _dot(x_, w_)), (x_, w_)

        def bwd(x_, w_, g, need_dx):
            dx, adz = fused(pb, bwd_rows, arrs_b, g, w_.T.to(g.dtype))
            return dx.to(x_.dtype), torch.matmul(x_.float().T, adz.float()).to(w_.dtype)

        return _LayerCore.apply(x, w, fwd, bwd)

    def gin(arrs_f, arrs_b, x, w):
        if not (impl == "pallas" and _prefers_fused(plan)):
            return _dot(spmm(arrs_f, arrs_b, x), w)

        def fwd(x_, w_):
            out, agg = fused(plan, fwd_rows, arrs_f, x_, w_)
            return out, (w_, agg)

        def bwd(w_, agg, g, need_dx):
            dx = bwd_rows(arrs_b, _dot(g, w_.T).to(agg.dtype)).to(agg.dtype) if need_dx else None
            return dx, torch.matmul(agg.float().T, g.float()).to(w_.dtype)

        return _LayerCore.apply(x, w, fwd, bwd)

    return {"gcn": gcn, "gin": gin}


def make_spmm_padded(plan: ExecutionPlan, plan_bwd: Optional[ExecutionPlan] = None,
                     compute_dtype: str = "float32"):
    """Differentiable SpMM over the plan's closed padded layout (transposed
    [dt, M] or wide [M, dp]) -> the same layout: ``spmm_p(arrs_f, arrs_b,
    xp)``; None when the plans lack that path (as the reference's
    ``make_spmm_padded``: the caller uses the row layout).  Raises
    NotImplementedError for a plan this package does not run.

    On wide plans that are not tiled, ``spmm_p(arrs_f, arrs_b, xp, scale)``
    with a diagonal scale D (fp32 [M]) is D A D xp, backward D A^T D dZ, each
    one SpMM whose kernels apply D (``block_spmm.spmm_wide_padded``, handed
    D as the plan arrays' ``row_scale`` for the call)."""
    pb = plan if plan_bwd is None else plan_bwd
    for p in (plan, pb):
        if getattr(p, "tband", False):
            tband.check_plan(p)
        else:
            block_spmm.rows_check(p)
    if not (getattr(pb, "tband", False) == getattr(plan, "tband", False)
            and pb.padded_rows == plan.padded_rows
            and all(block_spmm.spmm_padded_supported(p) for p in (plan, pb))):
        return None
    if getattr(plan, "tband", False):
        core = tband.spmm_tband_padded
    else:
        core = block_spmm.spmm_wide_padded
        for p in (plan, pb):
            block_spmm.check_plan(p)
    cd = _dtype(compute_dtype)

    def spmm_p(arrs_f, arrs_b, xp, scale=None):
        if scale is not None:
            arrs_f, arrs_b = {**arrs_f, "row_scale": scale}, {**arrs_b, "row_scale": scale}
        return _SpMM.apply(xp, lambda v: core(arrs_f, v, plan, cd),
                           lambda g: core(arrs_b, g, pb, cd))

    return spmm_p


def _pad_w_lane(w, dpin, dtype):
    """W [d, h] zero-padded to the wide layout's [dpin, 128-multiple]."""
    return F.pad(w.to(dtype), (0, block_spmm.lane_pad(w.shape[1]) - w.shape[1],
                               0, dpin - w.shape[0]))


def _make_fused_ops_tband(plan, pb, cd):
    """The fused GCN/GIN layer cores in the transposed padded layout [dt, M]
    (port of hcspmm_tpu/ops/spmm.py:279): the dense update is W^T X^T, and
    the fused launch (``tband.spmm_tband_fused_padded``) gives (W-form @
    agg^T, agg^T).  Weights stay unpadded; gradients are sliced back."""

    def _wt(w, dint, dtype):
        # transposed padded weight [ht, dint] = (pad W)^T
        ht = tband.sublane_pad(w.shape[1])
        return F.pad(w.T.to(dtype), (0, dint - w.shape[0], 0, ht - w.shape[1]))

    def _wf(w, dint, ht, dtype):
        # forward-form padded weight [dint, ht] (left-multiplies agg^T)
        return F.pad(w.to(dtype), (0, ht - w.shape[1], 0, dint - w.shape[0]))

    def _dw(xt, adzt, w):
        # the two transposed activations contracted over M
        return torch.matmul(xt.float(), adzt.float().T)[: w.shape[0], : w.shape[1]].to(w.dtype)

    def fused(p, arrs, xt, wform):
        if _prefers_fused(p):
            res = tband.spmm_tband_fused_padded(arrs, xt, wform, p)
            if res is not None:
                return res
        agg = tband.spmm_tband_padded(arrs, xt, p, cd)
        return _dot(wform, agg).to(xt.dtype), agg

    def gcn(arrs_f, arrs_b, xt, w):
        def fwd(x_, w_):
            h = _dot(_wt(w_, x_.shape[0], x_.dtype), x_)
            return tband.spmm_tband_padded(arrs_f, h, plan, cd), (x_, w_)

        def bwd(x_, w_, g, need_dx):
            # one fused launch: adz^T = (A^T dZ)^T and dX^T = W_pad adz^T
            dxt, adzt = fused(pb, arrs_b, g, _wf(w_, x_.shape[0], g.shape[0], g.dtype))
            return dxt.to(x_.dtype), _dw(x_, adzt, w_)

        return _LayerCore.apply(xt, w, fwd, bwd)

    def gin(arrs_f, arrs_b, xt, w):
        def fwd(x_, w_):
            out, agg = fused(plan, arrs_f, x_, _wt(w_, x_.shape[0], x_.dtype))
            return out, (w_, agg)

        def bwd(w_, agg, g, need_dx):
            dxt = None
            if need_dx:
                daggt = _dot(_wf(w_, agg.shape[0], g.shape[0], g.dtype), g)
                dxt = tband.spmm_tband_padded(arrs_b, daggt, pb, cd).to(g.dtype)
            return dxt, _dw(agg, g, w_)

        return _LayerCore.apply(xt, w, fwd, bwd)

    return {"gcn": gcn, "gin": gin}


def make_fused_ops_padded(plan: ExecutionPlan, plan_bwd: Optional[ExecutionPlan] = None,
                          compute_dtype: str = "float32"):
    """The fused GCN/GIN layer cores over the closed padded layout (port of
    hcspmm_tpu/ops/spmm.py:369), for the kernel-fusion mode: ``gcn(arrs_f,
    arrs_b, xp, w)`` = A (Xp W) whose backward is one fused launch on the
    backward plan giving dX = (A^T dZ) W^T and A^T dZ (dW from the kept A^T
    dZ), and ``gin(...)`` = (A Xp) W as one fused launch keeping the
    aggregate for dW.  Each fused call composes the SpMM and a product
    where ``prefer_fused_kernel`` is unset on its plan or the fused wrapper
    returns None.  Weights stay unpadded.  None when the plans lack the
    padded path."""
    pb = plan if plan_bwd is None else plan_bwd
    if make_spmm_padded(plan, plan_bwd, compute_dtype) is None:
        return None
    cd = _dtype(compute_dtype)
    if getattr(plan, "tband", False):
        return _make_fused_ops_tband(plan, pb, cd)
    core = block_spmm.spmm_wide_padded

    def _dw_of(m, w):
        return m[: w.shape[0], : w.shape[1]].to(w.dtype)

    def fused(p, arrs, xp, wp):
        if _prefers_fused(p):
            res = block_spmm.spmm_fused_wide_padded(arrs, xp, wp, p)
            if res is not None:
                return res
        agg = core(arrs, xp, p, cd)
        return _dot(agg, wp), agg

    def gcn(arrs_f, arrs_b, xp, w):
        def fwd(x_, w_):
            return core(arrs_f, _dot(x_, _pad_w_lane(w_, x_.shape[1], x_.dtype)), plan, cd), (x_, w_)

        def bwd(x_, w_, g, need_dx):
            # one fused launch: dX = (A^T dZ) W^T and the A^T dZ residual
            wp = _pad_w_lane(w_, x_.shape[1], g.dtype)
            dx, adz = fused(pb, arrs_b, g, wp.T.contiguous())
            return dx.to(x_.dtype), _dw_of(torch.matmul(x_.float().T, adz.float()), w_)

        return _LayerCore.apply(xp, w, fwd, bwd)

    def gin(arrs_f, arrs_b, xp, w):
        def fwd(x_, w_):
            out, agg = fused(plan, arrs_f, x_, _pad_w_lane(w_, x_.shape[1], x_.dtype))
            return out, (w_, agg)

        def bwd(w_, agg, g, need_dx):
            dx = None
            if need_dx:
                wp = _pad_w_lane(w_, agg.shape[1], g.dtype)
                dx = core(arrs_b, _dot(g, wp.T), pb, cd).to(g.dtype)
            return dx, _dw_of(torch.matmul(agg.float().T, g.float()), w_)

        return _LayerCore.apply(xp, w, fwd, bwd)

    return {"gcn": gcn, "gin": gin}


#: row-layout merge arrays the transposed lane path never reads
_ROW_SPILL_KEYS = ("ds_gcols", "ds_local", "ds_blk", "ds_lt", "ds_ucols")


@profiling.spanned("format.upload")
def _to_device(plan: ExecutionPlan, device) -> dict:
    """Plan arrays as tensors on ``device``: plain copies of
    ``device_arrays(dense_band=False)`` plus the dense band blocks
    (``band{s}_at`` transposed, in the plan's ``tband_pack`` encoding:
    ``plan.band_at_stored``; ``band{s}_a`` [Sb, bh, Bb] wide, in its
    ``a_dtype``: ``plan.band_a_stored``, int8 or int4 nibbles), the
    merges' destination segment tables, the lane merge's
    composed columns ``ds_lsrc``, the residual's row starts
    (``sparse_seg_ptr``) and the row layout's owner tables
    (``block_spmm.row_tables``; ``rows_meta`` stays on the host).  A tband
    plan on the lane path drops the row
    merge arrays it never reads.  A tiled plan uploads its pair stream, the
    pair runs ``tp_ptr`` and its A tiles ``tp_a`` [P, bh, 128]
    (``plan.tiled_a_stored``, int8 or int4 nibbles) instead of dense band
    blocks.  The band entries, the row populations' indices,
    ``out_perm``, every spill index array and the pair stream are checked on
    the host first: the kernels read them unchecked."""
    m = plan.padded_rows
    num_sw = m // plan.band_h
    transposed = getattr(plan, "tband", False)
    host = plan.device_arrays(dense_band=False)
    if "ds_tlocal" in host:
        for k in _ROW_SPILL_KEYS:
            host.pop(k, None)
    host.update(tspill.check_spill_arrays(host, plan))
    host.update(dstream.check_row_spill_arrays(host, plan))
    host.update(block_spmm.check_row_arrays(host, plan))
    tiled = getattr(plan, "tiled", False)
    if tiled:
        host.update(block_spmm.check_tiled_arrays(host, plan))
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        "cpu" if k in block_spmm.HOST_KEYS else device) for k, v in host.items()}
    if tiled:
        out["tp_a"] = torch.from_numpy(plan.tiled_a_stored()).to(device)
    # band slices must fit the padded layout where it runs, else the row
    # layout's band table
    limit = m if block_spmm.spmm_padded_supported(plan) else block_spmm.band_table_rows(plan)
    for s, w in enumerate(plan.band_widths):
        if transposed:
            tband.check_band_arrays(host[f"band{s}_start"], host[f"band{s}_sw"],
                                    int(w), m, num_sw)
            out[f"band{s}_at"] = torch.from_numpy(plan.band_at_stored(s)).to(device)
        else:
            block_spmm.check_band_arrays(host[f"band{s}_start"], host[f"band{s}_sw"],
                                         int(w), limit, num_sw,
                                         2 if plan.a_dtype == "int4" else 1)
            if not tiled:  # the tiled kernel reads tp_a only
                out[f"band{s}_a"] = torch.from_numpy(plan.band_a_stored(s)).to(device)
    return out


def default_device(device=None) -> torch.device:
    """``device`` as a torch.device; None is the CUDA device, and raises
    where there is none rather than run on the host unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device=\"cpu\" to run the kernels' plain "
                           "versions on the host")
    return torch.device("cuda")


class HybridSpMM:
    """CSR graph -> plan(s) -> differentiable operator on ``device``.

    The analog of the reference flow ``HYGNN.preprocess(...)`` +
    ``HCSPMM.forward*``: construction runs preprocessing and uploads the
    plan arrays; ``apply``/``__call__`` aggregate in the row layout [N, d];
    ``apply_padded`` in the plan's padded layout (transposed X^T [dt, M]
    for tband plans, wide [M, dp] otherwise), through the row op when the
    plan lacks the closed padded path (``supports_padded`` False: dense,
    ELL or residual populations, or ``impl='xla'``).
    """

    def __init__(self, row_pointers: np.ndarray, column_index: np.ndarray,
                 num_nodes: int, config: PlanConfig = PlanConfig(),
                 symmetric: bool = True, normalize: bool = False,
                 device=None):
        """``normalize=True`` computes D^-1/2 A D^-1/2 X (symmetric GCN
        normalization); False is the reference's unweighted sum.
        ``symmetric=False`` builds the backward plan on A^T.  ``device``:
        None is the CUDA device (a RuntimeError without one); pass
        ``device="cpu"`` to run the kernels' plain versions on the host."""
        self.config = config
        self.normalize = normalize
        self.device = default_device(device)
        self.plan = build_plan(row_pointers, column_index, num_nodes, config)
        if symmetric:
            self.plan_bwd = None
        else:
            rp_t, ci_t = transpose_csr(row_pointers, column_index, num_nodes)
            self.plan_bwd = build_plan(rp_t, ci_t, num_nodes, config)
        for p in (self.plan, self.plan_bwd):
            if p is not None and not getattr(p, "tband", False):
                block_spmm.rows_check(p)
        # raises NotImplementedError for a plan that would drop edges
        self._fn = make_spmm(self.plan, self.plan_bwd, config.compute_dtype, config.impl)
        self._fused = make_fused_ops(self.plan, self.plan_bwd, config.compute_dtype,
                                     config.impl)
        self._fn_padded = (make_spmm_padded(self.plan, self.plan_bwd, config.compute_dtype)
                           if config.impl == "pallas" else None)
        self._fused_padded = (make_fused_ops_padded(self.plan, self.plan_bwd,
                                                    config.compute_dtype)
                              if config.impl == "pallas" else None)
        arrs_f = _to_device(self.plan, self.device)
        arrs_b = arrs_f if self.plan_bwd is None else _to_device(self.plan_bwd,
                                                                 self.device)
        #: plan arrays on the device; ``apply(arrays, x)`` threads them
        self.arrays = {"f": arrs_f, "b": arrs_b}
        deg = np.maximum(np.diff(np.asarray(row_pointers)), 1).astype(np.float32)
        #: 1/deg — mean aggregation (GraphSAGE mean_N = D^-1 A X)
        self.arrays["inv_deg"] = torch.from_numpy(1.0 / deg).to(self.device)
        if normalize:
            inv = 1.0 / np.sqrt(deg)
            self.arrays["inv_sqrt_deg"] = torch.from_numpy(inv).to(self.device)
            if self.folds_scale:
                #: D^-1/2 over the wide layout's M rows, 1 on the pad rows:
                #: the band kernel and the row merge apply it
                self.arrays["inv_sqrt_deg_rows"] = torch.from_numpy(np.pad(
                    inv, (0, self.plan.padded_rows - len(inv)), constant_values=1.0)).to(
                        self.device)

    # ---- padded layout: [dt, M] -> [dt, M] or [M, dp] -> [M, dp] ----

    @property
    def supports_padded(self) -> bool:
        """True when ``apply_padded`` runs the closed padded path; False
        when it falls back to the row op (train.loop then trains in the
        row layout [N, d])."""
        return self._fn_padded is not None

    @property
    def padded_rows(self) -> int:
        return self.plan.padded_rows

    @property
    def transposed(self) -> bool:
        """True when the padded layout is the tband X^T [dt, M]; False for
        the wide [M, dp] (and for a plan without the padded path, whose
        fallback slices rows)."""
        return bool(getattr(self.plan, "tband", False)) and self.supports_padded

    @property
    def folds_scale(self) -> bool:
        """True when ``apply_padded`` applies D^-1/2 inside the SpMM's
        kernels (the wide padded path on plans that are not tiled); the
        tband layout, tiled plans and the row layout scale as ``_Scale``
        nodes around it."""
        return (self.supports_padded and not self.transposed
                and not any(getattr(p, "tiled", False) for p in (self.plan, self.plan_bwd)))

    def is_padded(self, x) -> bool:
        """True when ``x`` already has the padded layout's shape (an [N, d]
        input of that very shape pads to itself)."""
        if self.transposed:
            return x.shape[1] == self.padded_rows and x.shape[0] % 16 == 0
        return x.shape[0] == self.padded_rows and x.shape[1] % 128 == 0

    def _fused_mode(self, arrays, plan) -> bool:
        """True when a padded layer core runs as the reference's custom VJP
        with the fused kernel: the padded path exists, the aggregation is not
        normalized, and ``plan`` (the backward plan for GCN, the forward
        plan for GIN) has ``prefer_fused_kernel`` set."""
        return (self._fused_padded is not None and "inv_sqrt_deg" not in arrays
                and _prefers_fused(plan))

    def pad_input(self, x) -> torch.Tensor:
        """[N, d] -> the padded layout in the compute dtype on the
        operator's device (one-time cost; the layout then stays closed):
        [dt, M] transposed, [M, dp] otherwise (also without the padded
        path, whose fallback slices its first N rows)."""
        x = torch.as_tensor(x)
        n, d = x.shape
        dtype = _dtype(self.config.compute_dtype)
        m = self.plan.padded_rows
        if self.transposed:
            xp = torch.zeros((tband.sublane_pad(d), m), dtype=dtype, device=self.device)
            xp[:d, :n] = x.T.to(device=self.device, dtype=dtype)
        else:
            xp = torch.zeros((m, -(-d // 128) * 128), dtype=dtype, device=self.device)
            xp[:n, :d] = x.to(device=self.device, dtype=dtype)
        return xp

    def unpad_output(self, xp: torch.Tensor, d: Optional[int] = None,
                     dtype=None) -> torch.Tensor:
        """The padded layout -> [N, d]."""
        n = self.plan.num_nodes
        if self.transposed:
            out = (xp[:, :n] if d is None else xp[:d, :n]).T
        else:
            out = xp[:n] if d is None else xp[:n, :d]
        return out if dtype is None else out.to(dtype)

    def padded_width(self, d: int) -> int:
        """The padded layout's feature width for ``d`` features: 16-row
        granules transposed, 128-column lanes wide."""
        return tband.sublane_pad(d) if self.transposed else block_spmm.lane_pad(d)

    def _inv_lanes(self, inv, xp):
        """Per-row scale broadcast over the padded layout; padded rows get
        1."""
        if self.transposed:
            return F.pad(inv, (0, xp.shape[1] - inv.shape[0]), value=1.0)[None, :]
        return F.pad(inv, (0, xp.shape[0] - inv.shape[0]), value=1.0)[:, None]

    def pad_weight(self, w, xp):
        """W [d, h] as the wide layout's [dp, hp] (zero rows and columns),
        in xp's dtype.  The transposed layout has no right-multiply form:
        use ``dense_padded``."""
        if self.transposed:
            raise ValueError("tband layout: use dense_padded(xp, w), the update is "
                             "W^T @ X^T")
        return F.pad(w.to(xp.dtype), (0, block_spmm.lane_pad(w.shape[1]) - w.shape[1],
                                      0, xp.shape[1] - w.shape[0]))

    def _product_padded(self, xp, w, acc=None):
        """``X W`` in the padded layout, (pad W)^T @ xt transposed and xp @
        pad(W) wide; added into ``acc`` in place where one is given."""
        if self.transposed:
            ht = tband.sublane_pad(w.shape[1])
            a = F.pad(w.T.to(xp.dtype), (0, xp.shape[0] - w.shape[0], 0, ht - w.shape[1]))
            b = xp
        else:
            a, b = xp, self.pad_weight(w, xp)
        return torch.matmul(a, b) if acc is None else acc.addmm_(a, b)

    def dense_padded(self, xp, w):
        """Dense update ``X W`` in the padded layout."""
        with profiling.span("models.dense"):
            return self._product_padded(xp, w)

    def dense_sum_padded(self, xp, w1, yp, w2):
        """``X W1 + Y W2`` in the padded layout: ``X W1``, then ``Y W2``
        added into it, so no [M, 2 dp] concatenation is built."""
        with profiling.span("models.dense"):
            return self._product_padded(yp, w2, self._product_padded(xp, w1))

    def dense_add_padded(self, accp, xp, w):
        """``acc + X W`` in the padded layout, added into ``accp`` in place,
        so no second output buffer is built."""
        with profiling.span("models.dense"):
            return self._product_padded(xp, w, accp)

    def apply_padded(self, arrays, xp: torch.Tensor) -> torch.Tensor:
        """SpMM in the padded layout (normalized: D^-1/2 on both sides,
        applied by the SpMM's kernels where ``folds_scale``, else each
        scaling a ``_Scale`` node)."""
        if "inv_sqrt_deg_rows" in arrays and "inv_sqrt_deg" in arrays:
            return self._fn_padded(arrays["f"], arrays["b"], xp,
                                   arrays["inv_sqrt_deg_rows"]).to(xp.dtype)
        if "inv_sqrt_deg" in arrays:
            inv = self._inv_lanes(arrays["inv_sqrt_deg"], xp)
            xs = _Scale.apply(xp, inv, xp.dtype)
            return _Scale.apply(self._padded_core(arrays, xs), inv, xp.dtype)
        return self._padded_core(arrays, xp)

    def _padded_core(self, arrays, xp):
        if self._fn_padded is not None:
            return self._fn_padded(arrays["f"], arrays["b"], xp)
        # no closed padded path: the row op on the first N rows, re-padded
        n = self.plan.num_nodes
        out = self._fn(arrays["f"], arrays["b"], xp[:n])
        return F.pad(out.to(xp.dtype), (0, 0, 0, xp.shape[0] - n))

    def gcn_apply_padded(self, arrays, xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """GCN layer core A (X W) in the padded layout; backward: one SpMM
        of dZ, then the two dense products, or, in the fused mode, one fused
        launch for (A^T dZ) W^T and A^T dZ."""
        if self._fused_mode(arrays, self.plan_bwd or self.plan):
            return self._fused_padded["gcn"](arrays["f"], arrays["b"], xp, w)
        return self.apply_padded(arrays, self.dense_padded(xp, w))

    def gin_apply_padded(self, arrays, xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """GIN layer core (A X) W in the padded layout (one fused launch in
        the fused mode); the aggregate is the residual kept for dW."""
        if self._fused_mode(arrays, self.plan):
            return self._fused_padded["gin"](arrays["f"], arrays["b"], xp, w)
        return self.dense_padded(self.apply_padded(arrays, xp), w)

    def mean_apply(self, arrays, x: torch.Tensor) -> torch.Tensor:
        """Mean aggregation ``D^-1 A X`` in the row layout (raw aggregate
        whatever ``normalize`` says: SAGE's own scaling), D^-1 a ``_Scale``
        node (span ``spmm.scale.mean``, counter ``spmm.mean``)."""
        agg = self._fn(arrays["f"], arrays["b"], x)
        return _Scale.apply(agg, arrays["inv_deg"][:, None], x.dtype, "spmm.scale.mean",
                            "spmm.mean")

    def mean_apply_padded(self, arrays, xp: torch.Tensor) -> torch.Tensor:
        """Mean aggregation in the padded layout (padded rows have
        inv_deg == 1, so they stay exactly zero), D^-1 as in ``mean_apply``."""
        inv = self._inv_lanes(arrays["inv_deg"], xp)
        return _Scale.apply(self._padded_core(arrays, xp), inv, xp.dtype, "spmm.scale.mean",
                            "spmm.mean")

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return self.mean_apply(self.arrays, x)

    def apply(self, arrays, x: torch.Tensor) -> torch.Tensor:
        """Row-layout SpMM [N, d] -> [N, d]."""
        if "inv_sqrt_deg" in arrays:
            inv = arrays["inv_sqrt_deg"][:, None]
            xs = _Scale.apply(x, inv, x.dtype)
            return _Scale.apply(self._fn(arrays["f"], arrays["b"], xs), inv, x.dtype)
        return self._fn(arrays["f"], arrays["b"], x)

    def gcn_apply(self, arrays, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """GCN layer core A (x w) in the row layout (composed through
        ``apply`` in normalized mode; the fused backward where the plan
        prefers it)."""
        if "inv_sqrt_deg" in arrays:
            return self.apply(arrays, self.dense(x, w))
        return self._fused["gcn"](arrays["f"], arrays["b"], x, w)

    def gin_apply(self, arrays, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """GIN layer core (A x) w in the row layout; the aggregate is kept
        for dW (from the fused forward where the plan prefers it)."""
        if "inv_sqrt_deg" in arrays:
            return self.dense(self.apply(arrays, x), w)
        return self._fused["gin"](arrays["f"], arrays["b"], x, w)

    def dense(self, x, w):
        """Dense update ``x w`` in the row layout."""
        with profiling.span("models.dense"):
            return _dot(x, w)

    def dense_sum(self, x, w1, y, w2):
        """``x w1 + y w2`` in the row layout, as ``dense_sum_padded``
        (fp32), in x's dtype."""
        with profiling.span("models.dense"):
            out = torch.matmul(x.float(), w1.float())
            return out.addmm_(y.float(), w2.float()).to(x.dtype)

    def dense_add(self, acc, x, w):
        """``acc + x w`` in the row layout, in fp32 (in place where ``acc``
        is fp32), in acc's dtype."""
        with profiling.span("models.dense"):
            return acc.float().addmm_(x.float(), w.float()).to(acc.dtype)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.arrays, x)


def spmm_reference_dense(row_pointers, column_index, num_nodes, x):
    """NumPy dense oracle ``A @ X`` for tests (binary, unweighted sum)."""
    a = np.zeros((num_nodes, num_nodes), dtype=np.float64)
    rp = np.asarray(row_pointers)
    ci = np.asarray(column_index)
    for r in range(num_nodes):
        a[r, ci[rp[r]: rp[r + 1]]] = 1.0
    return a @ np.asarray(x, dtype=np.float64)
