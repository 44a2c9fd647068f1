"""Differentiable hybrid SpMM ``Z = A @ X`` for a binary adjacency A.

Port of hcspmm_tpu/ops/spmm.py over its three activation layouts, one
class each, which ``HybridSpMM`` chooses once, when it is built: the row
layout ``RowLayout`` [N, d] (every plan; ``kernels/block_spmm.py:spmm_rows``
with its dense, ELL and residual populations, ``tband.spmm_tband`` on
tband plans) and the two padded layouts of plans with the closed padded
path, the transposed band ``TbandLayout`` (``plan.tband``, X^T [dt, M],
kernels/tband.py) and the wide ``WideLayout`` ([M, dp],
kernels/block_spmm.py).  Each layout holds the plan arrays and implements
the layer protocol ``models.layers`` calls (the SpMM, the GCN and GIN
cores, the mean aggregation, the dense updates, ``pad``/``unpad``).
``impl='xla'`` is the reference's gather + einsum + segment-sum form in
plain torch ops (``_spmm_xla``), with no kernel.

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

import functools
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


def _rows_impl(plan, arrs, cd, impl):
    """The row-layout SpMM ``x [C, d] -> [N, d]`` of one plan over its
    arrays ``arrs``: ``spmm_rows`` (tband plans: ``spmm_tband``) for
    'pallas', ``_spmm_xla`` for 'xla'.  Raises for a plan this package does
    not run."""
    if impl == "xla":
        if getattr(plan, "tband", False):
            raise ValueError("impl='xla' runs band_impl='wide' plans (the reference's "
                             "CLI builds them under xla); tband plans have no xla form")
        block_spmm.rows_check(plan)
        return lambda x: _spmm_xla(arrs, x, plan, cd)
    if impl != "pallas":
        raise ValueError(f"unknown impl: {impl}")
    if getattr(plan, "tband", False):
        tband.check_plan(plan)
        return lambda x: tband.spmm_tband(arrs, x, plan, cd)
    block_spmm.rows_check(plan)
    return lambda x: block_spmm.spmm_rows(arrs, x, plan, cd)


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


def _pad_w_lane(w, dpin, dtype):
    """W [d, h] zero-padded to the wide layout's [dpin, 128-multiple]."""
    return F.pad(w.to(dtype), (0, block_spmm.lane_pad(w.shape[1]) - w.shape[1],
                               0, dpin - w.shape[0]))


def _pad_wt(w, dint, dtype):
    """(pad W)^T [ht, dint]: the transposed layout's update W^T X^T."""
    ht = tband.sublane_pad(w.shape[1])
    return F.pad(w.T.to(dtype), (0, dint - w.shape[0], 0, ht - w.shape[1]))


def _pad_wf(w, dint, ht, dtype):
    """Forward-form padded weight [dint, ht] (left-multiplies agg^T)."""
    return F.pad(w.to(dtype), (0, ht - w.shape[1], 0, dint - w.shape[0]))


class _Layout:
    """The layer protocol in one activation layout, the operator's plan
    arrays bound: what ``models.layers`` calls.  ``layout(x)`` is the SpMM,
    normalised as the operator is; ``gcn`` and ``gin`` the layer cores;
    ``mean`` GraphSAGE's D^-1 A X (the raw aggregate whatever ``normalize``
    says); ``dense``, ``dense_sum`` and ``dense_add`` the updates X W, X W1 +
    Y W2 and acc + X W; ``spmm_width(d)`` the width an SpMM of d features
    runs at; ``pad`` and ``unpad`` the conversions from and to [N, d].

    A subclass gives the layout's shape (``pad``, ``unpad``, ``is_padded``,
    ``spmm_width``, ``_lanes``, ``_product``), its unnormalised SpMM
    ``raw`` and, where the kernel-fusion mode runs, the fused layer cores
    (``_gcn_fwd``/``_gcn_bwd``, ``_gin_fwd``/``_gin_bwd``).  The
    normalisation is chosen once, here: none, or D^-1/2 as a ``_Scale``
    node on each side of ``raw``; ``TbandLayout`` and ``WideLayout`` have a
    third form, D^-1/2 inside their kernels (``_fold``, ``folds_scale``).
    The fused cores run only unnormalised, where the plan (the backward
    plan for GCN, the forward plan for GIN) has ``prefer_fused_kernel`` set
    when the core is called; elsewhere the cores compose the SpMM and
    ``dense``."""

    transposed = False
    #: True where D^-1/2 runs inside the SpMM's kernels
    folds_scale = False

    def __init__(self, plan, plan_bwd, arrays, device, compute_dtype="float32",
                 normalize=False, fusable=True):
        """``arrays``: the operator's (``f`` and ``b``, the plan arrays;
        ``inv_deg``; ``inv_sqrt_deg`` where ``normalize``)."""
        self.plan = plan
        self.plan_bwd = plan if plan_bwd is None else plan_bwd
        self.device = torch.device(device)
        self._arrays = arrays
        self._cd = _dtype(compute_dtype)
        self._fused = fusable and not normalize
        self._agg = self.raw
        if normalize:
            self._inv_sqrt = self._lanes(arrays["inv_sqrt_deg"])
            self._agg = self._scaled

    def raw(self, x):
        """The unnormalised SpMM A x, one ``_SpMM`` node."""
        return _SpMM.apply(x, self._fwd, self._bwd)

    def _scaled(self, x):
        inv = self._inv_sqrt
        return _Scale.apply(self.raw(_Scale.apply(x, inv, x.dtype)), inv, x.dtype)

    def _fold(self, core, plan, plan_bwd, arrays):
        """D^-1/2 inside the SpMM's kernels: the SpMM is D A D x, one
        ``_SpMM`` node whose backward is D A^T D dZ, with D (the lanes of
        ``inv_sqrt_deg``, 1 on the pad lanes) handed to ``core`` as the plan
        arrays' ``row_scale``, in copies of the forward and backward arrays
        made once, here."""
        self.folds_scale = True
        scale = self._inv_sqrt.view(-1)
        af, ab = {**arrays["f"], "row_scale": scale}, {**arrays["b"], "row_scale": scale}
        cd = self._cd
        self._fwd_scaled = lambda v: core(af, v, plan, cd)
        self._bwd_scaled = lambda g: core(ab, g, plan_bwd, cd)
        self._agg = self._folded

    def _folded(self, x):
        return _SpMM.apply(x, self._fwd_scaled, self._bwd_scaled).to(x.dtype)

    def __call__(self, x):
        return self._agg(x)

    @functools.cached_property
    def _inv_deg(self):
        return self._lanes(self._arrays["inv_deg"])

    def mean(self, x):
        """``D^-1 A X``, D^-1 a ``_Scale`` node (span ``spmm.scale.mean``,
        counter ``spmm.mean``); pad rows scale by 1 and stay zero."""
        return _Scale.apply(self.raw(x), self._inv_deg, x.dtype, "spmm.scale.mean",
                            "spmm.mean")

    def gcn(self, x, w):
        """GCN layer core A (X W); backward: one SpMM of dZ, then the two
        dense products, or, in the fused mode, one fused launch for (A^T dZ)
        W^T and A^T dZ."""
        if self._fused and _prefers_fused(self.plan_bwd):
            return _LayerCore.apply(x, w, self._gcn_fwd, self._gcn_bwd)
        return self(self.dense(x, w))

    def gin(self, x, w):
        """GIN layer core (A X) W (one fused launch in the fused mode); the
        aggregate is the residual kept for dW."""
        if self._fused and _prefers_fused(self.plan):
            return _LayerCore.apply(x, w, self._gin_fwd, self._gin_bwd)
        return self.dense(self(x), w)

    def dense(self, x, w):
        """Dense update ``X W``."""
        with profiling.span("models.dense"):
            return self._product(x, w).to(x.dtype)

    def dense_sum(self, x, w1, y, w2):
        """``X W1 + Y W2``: ``X W1``, then ``Y W2`` added into it, so no
        [M, 2 dp] concatenation is built."""
        with profiling.span("models.dense"):
            return self._product(y, w2, self._product(x, w1)).to(x.dtype)

    def dense_add(self, acc, x, w):
        """``acc + X W``, added into ``acc`` in place where it has the
        product's dtype, so no second output buffer is built."""
        with profiling.span("models.dense"):
            return self._product(x, w, acc).to(acc.dtype)


class RowLayout(_Layout):
    """The row layout [N, d], which every plan runs (the JAX operator's
    ``apply``): ``spmm_rows`` with its dense, ELL and residual populations,
    ``spmm_tband`` on tband plans, or the plain ``_spmm_xla`` for
    ``impl='xla'``.  Its updates run in fp32 and round to the input's
    dtype; the fused cores (``impl='pallas'``) launch
    ``block_spmm.spmm_fused_rows``, which composes where the plan has no
    single full-cover band bucket.  A plan with more columns than rows (a
    shard's) takes X of its ``num_cols`` rows."""

    def __init__(self, plan, plan_bwd, arrays, device, compute_dtype="float32",
                 normalize=False, impl="pallas"):
        cd = _dtype(compute_dtype)
        self._fwd = _rows_impl(plan, arrays["f"], cd, impl)
        self._bwd = _rows_impl(plan if plan_bwd is None else plan_bwd, arrays["b"], cd, impl)
        super().__init__(plan, plan_bwd, arrays, device, compute_dtype, normalize,
                         fusable=impl == "pallas")

    def spmm_width(self, d):
        return d

    def is_padded(self, x):
        """False: ``pad`` only moves [N, d] to the device."""
        return False

    def pad(self, x):
        return torch.as_tensor(x).to(self.device)

    def unpad(self, h, d=None):
        return h[:, :d]

    def _lanes(self, inv):
        return inv[:, None]

    def _product(self, x, w, acc=None):
        a, b = x.float(), w.float()
        return torch.matmul(a, b) if acc is None else acc.float().addmm_(a, b)

    def _fused_update(self, p, spmm, arrs, x, w):
        if _prefers_fused(p):
            res = block_spmm.spmm_fused_rows(arrs, x, w, p, self._cd)
            if res is not None:
                return res
        agg = spmm(x)
        return _dot(agg, w), agg

    def _gcn_fwd(self, x, w):
        return self._fwd(_dot(x, w)), (x, w)

    def _gcn_bwd(self, x, w, g, need_dx):
        dx, adz = self._fused_update(self.plan_bwd, self._bwd, self._arrays["b"], g,
                                     w.T.to(g.dtype))
        return dx.to(x.dtype), torch.matmul(x.float().T, adz.float()).to(w.dtype)

    def _gin_fwd(self, x, w):
        out, agg = self._fused_update(self.plan, self._fwd, self._arrays["f"], x, w)
        return out, (w, agg)

    def _gin_bwd(self, w, agg, g, need_dx):
        dx = self._bwd(_dot(g, w.T).to(agg.dtype)).to(agg.dtype) if need_dx else None
        return dx, torch.matmul(agg.float().T, g.float()).to(w.dtype)


class TbandLayout(_Layout):
    """The transposed band X^T [dt, M] (``plan.tband``; dt a multiple of
    16): each SpMM one ``tband.spmm_tband_padded``, the update W^T X^T, and
    the fused cores ``tband.spmm_tband_fused_padded``, which gives (W-form
    @ agg^T, agg^T).  Weights stay unpadded; gradients are sliced back.
    Normalised, D^-1/2 runs inside the SpMM's kernels (``folds_scale``):
    the band kernel's scaled mode and the lane spill chain's scaled gathers
    and merges; a plan whose spill takes the legacy row path
    (``spill_lane='off'`` or ``spill_impl='take'``) folds it through the row
    layout's scaled merge or take path (``block_spmm.apply_spill``)."""

    transposed = True

    def __init__(self, plan, plan_bwd, arrays, device, compute_dtype="float32",
                 normalize=False):
        pb = plan if plan_bwd is None else plan_bwd
        cd, core = _dtype(compute_dtype), tband.spmm_tband_padded
        self._fwd = lambda v: core(arrays["f"], v, plan, cd)
        self._bwd = lambda g: core(arrays["b"], g, pb, cd)
        super().__init__(plan, plan_bwd, arrays, device, compute_dtype, normalize)
        if normalize:
            self._fold(core, plan, pb, arrays)

    def spmm_width(self, d):
        return tband.sublane_pad(d)

    def is_padded(self, x):
        return x.shape[1] == self.plan.padded_rows and x.shape[0] % 16 == 0

    def pad(self, x):
        x = torch.as_tensor(x)
        n, d = x.shape
        xp = torch.zeros((tband.sublane_pad(d), self.plan.padded_rows), dtype=self._cd,
                         device=self.device)
        xp[:d, :n] = x.T.to(device=self.device, dtype=self._cd)
        return xp

    def unpad(self, h, d=None):
        return h[:d, : self.plan.num_nodes].T

    def _lanes(self, inv):
        return F.pad(inv, (0, self.plan.padded_rows - inv.shape[0]), value=1.0)[None, :]

    def _product(self, x, w, acc=None):
        a = _pad_wt(w, x.shape[0], x.dtype)
        return torch.matmul(a, x) if acc is None else acc.addmm_(a, x)

    def _fused_update(self, p, spmm, arrs, xt, wform):
        if _prefers_fused(p):
            res = tband.spmm_tband_fused_padded(arrs, xt, wform, p)
            if res is not None:
                return res
        agg = spmm(xt)
        return _dot(wform, agg).to(xt.dtype), agg

    @staticmethod
    def _dw(xt, adzt, w):
        # the two transposed activations contracted over M
        return torch.matmul(xt.float(), adzt.float().T)[: w.shape[0], : w.shape[1]].to(w.dtype)

    def _gcn_fwd(self, x, w):
        return self._fwd(_dot(_pad_wt(w, x.shape[0], x.dtype), x)), (x, w)

    def _gcn_bwd(self, x, w, g, need_dx):
        # one fused launch: adz^T = (A^T dZ)^T and dX^T = W_pad adz^T
        dxt, adzt = self._fused_update(self.plan_bwd, self._bwd, self._arrays["b"], g,
                                       _pad_wf(w, x.shape[0], g.shape[0], g.dtype))
        return dxt.to(x.dtype), self._dw(x, adzt, w)

    def _gin_fwd(self, x, w):
        out, agg = self._fused_update(self.plan, self._fwd, self._arrays["f"], x,
                                      _pad_wt(w, x.shape[0], x.dtype))
        return out, (w, agg)

    def _gin_bwd(self, w, agg, g, need_dx):
        dxt = None
        if need_dx:
            dxt = self._bwd(_dot(_pad_wf(w, agg.shape[0], g.shape[0], g.dtype), g)).to(g.dtype)
        return dxt, self._dw(agg, g, w)


class _WideShape(_Layout):
    """The wide layout's shape [M, dp] (dp a multiple of 128): padding,
    the per-row scales and the update X pad(W)."""

    def spmm_width(self, d):
        return block_spmm.lane_pad(d)

    def is_padded(self, x):
        return x.shape[0] == self.plan.padded_rows and x.shape[1] % 128 == 0

    def pad(self, x):
        x = torch.as_tensor(x)
        n, d = x.shape
        xp = torch.zeros((self.plan.padded_rows, block_spmm.lane_pad(d)), dtype=self._cd,
                         device=self.device)
        xp[:n, :d] = x.to(device=self.device, dtype=self._cd)
        return xp

    def unpad(self, h, d=None):
        return h[: self.plan.num_nodes, :d]

    def _lanes(self, inv):
        return F.pad(inv, (0, self.plan.padded_rows - inv.shape[0]), value=1.0)[:, None]

    def _product(self, x, w, acc=None):
        b = _pad_w_lane(w, x.shape[1], x.dtype)
        return torch.matmul(x, b) if acc is None else acc.addmm_(x, b)


class WideLayout(_WideShape):
    """The wide padded layout [M, dp]: each SpMM one
    ``block_spmm.spmm_wide_padded``, the fused cores
    ``block_spmm.spmm_fused_wide_padded``.  Normalised on plans that are not
    tiled, D^-1/2 runs inside the SpMM's kernels (``folds_scale``, ``_fold``):
    the band kernel's scaled mode and the row merge's or take path's scaled
    forms."""

    def __init__(self, plan, plan_bwd, arrays, device, compute_dtype="float32",
                 normalize=False):
        pb = plan if plan_bwd is None else plan_bwd
        for p in (plan, pb):
            block_spmm.check_plan(p)
        cd, core = _dtype(compute_dtype), block_spmm.spmm_wide_padded
        self._fwd = lambda v: core(arrays["f"], v, plan, cd)
        self._bwd = lambda g: core(arrays["b"], g, pb, cd)
        super().__init__(plan, plan_bwd, arrays, device, compute_dtype, normalize)
        if normalize and not any(getattr(p, "tiled", False) for p in (plan, pb)):
            self._fold(core, plan, pb, arrays)

    def _fused_update(self, p, spmm, arrs, xp, wp):
        if _prefers_fused(p):
            res = block_spmm.spmm_fused_wide_padded(arrs, xp, wp, p)
            if res is not None:
                return res
        agg = spmm(xp)
        return _dot(agg, wp), agg

    @staticmethod
    def _dw(m, w):
        return m[: w.shape[0], : w.shape[1]].to(w.dtype)

    def _gcn_fwd(self, x, w):
        return self._fwd(_dot(x, _pad_w_lane(w, x.shape[1], x.dtype))), (x, w)

    def _gcn_bwd(self, x, w, g, need_dx):
        # one fused launch: dX = (A^T dZ) W^T and the A^T dZ residual
        wp = _pad_w_lane(w, x.shape[1], g.dtype)
        dx, adz = self._fused_update(self.plan_bwd, self._bwd, self._arrays["b"], g,
                                     wp.T.contiguous())
        return dx.to(x.dtype), self._dw(torch.matmul(x.float().T, adz.float()), w)

    def _gin_fwd(self, x, w):
        out, agg = self._fused_update(self.plan, self._fwd, self._arrays["f"], x,
                                      _pad_w_lane(w, x.shape[1], x.dtype))
        return out, (w, agg)

    def _gin_bwd(self, w, agg, g, need_dx):
        dx = None
        if need_dx:
            dx = self._bwd(_dot(g, _pad_w_lane(w, agg.shape[1], g.dtype).T)).to(g.dtype)
        return dx, self._dw(torch.matmul(agg.float().T, g.float()), w)


class _RowsPadded(_WideShape):
    """The padded view of a plan without the closed padded path, as the
    JAX operator falls back: [M, dp] as the wide layout, each SpMM the row
    layout's on the first N rows, padded again; the cores compose."""

    def __init__(self, rows, plan, plan_bwd, arrays, device, compute_dtype="float32",
                 normalize=False):
        self._rows = rows
        super().__init__(plan, plan_bwd, arrays, device, compute_dtype, normalize,
                         fusable=False)

    def raw(self, x):
        n = self.plan.num_nodes
        return F.pad(self._rows.raw(x[:n]).to(x.dtype), (0, 0, 0, x.shape[0] - n))


def padded_layout(plan, plan_bwd=None):
    """The closed padded layout of the plans, ``TbandLayout`` (tband plans)
    or ``WideLayout``; None where they lack that path (dense, ELL or
    residual populations: the row layout, as the reference's
    ``make_spmm_padded`` returns None)."""
    pb = plan if plan_bwd is None else plan_bwd
    if not (getattr(pb, "tband", False) == getattr(plan, "tband", False)
            and pb.padded_rows == plan.padded_rows
            and all(block_spmm.spmm_padded_supported(p) for p in (plan, pb))):
        return None
    return TbandLayout if getattr(plan, "tband", False) else WideLayout


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
    ``HCSPMM.forward*``: construction runs preprocessing, uploads the plan
    arrays and builds the layouts, once: ``rows``, the row layout [N, d]
    (``apply``, ``__call__`` and the other unpadded names), and ``padded``,
    the plan's padded layout (``apply_padded`` and the other ``_padded``
    names, ``pad_input``, ``unpad_output``): ``TbandLayout`` X^T [dt, M] for
    tband plans, ``WideLayout`` [M, dp] otherwise, or, where the plan lacks
    the closed padded path (``supports_padded`` False: dense, ELL or
    residual populations, or ``impl='xla'``), the wide shape over the row
    op.  ``layout`` is the one the training loop runs: ``padded`` where the
    path exists, else ``rows``.  The JAX operator's names keep its
    ``arrays`` argument, ``self.arrays`` at every caller; it selects
    nothing: the layouts hold the arrays bound, and ``normalize`` decides
    the normalisation.
    """

    def __init__(self, row_pointers: np.ndarray, column_index: np.ndarray,
                 num_nodes: int, config: PlanConfig = PlanConfig(),
                 symmetric: bool = True, normalize: bool = False,
                 device=None):
        """``normalize=True`` computes D^-1/2 A D^-1/2 X (symmetric GCN
        normalization); False is the reference's unweighted sum.
        ``symmetric=False`` builds the backward plan on A^T.  ``device``:
        None is the CUDA device (a RuntimeError without one); pass
        ``device="cpu"`` to run the kernels' plain versions on the host.
        Raises NotImplementedError for a plan that would drop edges."""
        self.config = config
        self.normalize = normalize
        self.device = default_device(device)
        self.plan = build_plan(row_pointers, column_index, num_nodes, config)
        if symmetric:
            self.plan_bwd = None
        else:
            rp_t, ci_t = transpose_csr(row_pointers, column_index, num_nodes)
            self.plan_bwd = build_plan(rp_t, ci_t, num_nodes, config)
        arrs_f = _to_device(self.plan, self.device)
        arrs_b = arrs_f if self.plan_bwd is None else _to_device(self.plan_bwd,
                                                                 self.device)
        #: plan arrays on the device, bound into the layouts
        self.arrays = {"f": arrs_f, "b": arrs_b}
        deg = np.maximum(np.diff(np.asarray(row_pointers)), 1).astype(np.float32)
        #: 1/deg — mean aggregation (GraphSAGE mean_N = D^-1 A X)
        self.arrays["inv_deg"] = torch.from_numpy(1.0 / deg).to(self.device)
        if normalize:
            self.arrays["inv_sqrt_deg"] = torch.from_numpy(1.0 / np.sqrt(deg)).to(self.device)
        kw = dict(plan=self.plan, plan_bwd=self.plan_bwd, arrays=self.arrays,
                  device=self.device, compute_dtype=config.compute_dtype, normalize=normalize)
        self.rows = RowLayout(impl=config.impl, **kw)
        padded = padded_layout(self.plan, self.plan_bwd) if config.impl == "pallas" else None
        #: True when ``apply_padded`` runs the closed padded path; False when
        #: it falls back to the row op (train.loop then trains in [N, d])
        self.supports_padded = padded is not None
        self.padded = padded(**kw) if padded else _RowsPadded(self.rows, **kw)
        self.layout = self.padded if padded else self.rows

    @property
    def transposed(self) -> bool:
        """True when the padded layout is the tband X^T [dt, M]; False for
        the wide [M, dp] (and for a plan without the padded path, whose
        fallback slices rows)."""
        return self.padded.transposed

    # ---- padded layout: [dt, M] -> [dt, M] or [M, dp] -> [M, dp] ----

    def pad_input(self, x) -> torch.Tensor:
        """[N, d] -> the padded layout in the compute dtype on the
        operator's device (one-time cost; the layout then stays closed)."""
        return self.padded.pad(x)

    def unpad_output(self, xp: torch.Tensor, d: Optional[int] = None,
                     dtype=None) -> torch.Tensor:
        """The padded layout -> [N, d]."""
        return self.padded.unpad(xp, d).to(dtype)

    def apply_padded(self, arrays, xp: torch.Tensor) -> torch.Tensor:
        """SpMM in the padded layout (normalized: D^-1/2 on both sides)."""
        return self.padded(xp)

    def gcn_apply_padded(self, arrays, xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """GCN layer core A (X W) in the padded layout."""
        return self.padded.gcn(xp, w)

    def gin_apply_padded(self, arrays, xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """GIN layer core (A X) W in the padded layout."""
        return self.padded.gin(xp, w)

    def mean_apply_padded(self, arrays, xp: torch.Tensor) -> torch.Tensor:
        """Mean aggregation ``D^-1 A X`` in the padded layout."""
        return self.padded.mean(xp)

    # ---- row layout: [N, d] -> [N, d] ----

    def apply(self, arrays, x: torch.Tensor) -> torch.Tensor:
        """Row-layout SpMM [N, d] -> [N, d]."""
        return self.rows(x)

    def gcn_apply(self, arrays, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """GCN layer core A (x w) in the row layout."""
        return self.rows.gcn(x, w)

    def gin_apply(self, arrays, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """GIN layer core (A x) w in the row layout."""
        return self.rows.gin(x, w)

    def mean_apply(self, arrays, x: torch.Tensor) -> torch.Tensor:
        """Mean aggregation ``D^-1 A X`` in the row layout (the raw
        aggregate whatever ``normalize`` says: SAGE's own scaling)."""
        return self.rows.mean(x)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return self.rows.mean(x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.rows(x)


def spmm_reference_dense(row_pointers, column_index, num_nodes, x):
    """NumPy dense oracle ``A @ X`` for tests (binary, unweighted sum)."""
    a = np.zeros((num_nodes, num_nodes), dtype=np.float64)
    rp = np.asarray(row_pointers)
    ci = np.asarray(column_index)
    for r in range(num_nodes):
        a[r, ci[rp[r]: rp[r + 1]]] = 1.0
    return a @ np.asarray(x, dtype=np.float64)
