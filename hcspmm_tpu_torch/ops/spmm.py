"""Differentiable hybrid SpMM ``Z = A @ X`` for a binary adjacency A.

Port of hcspmm_tpu/ops/spmm.py over its two padded layouts: the
transposed band (``plan.tband``, X^T [dt, M], kernels/tband.py) and the
wide layout (every other band plan, [M, dp], kernels/block_spmm.py).
Forward and backward aggregation are the same operator: the backward of
``A @ X`` is ``A^T @ dZ``, which is the forward SpMM on the same plan when
the graph is symmetric (the reference's assumption) or on a plan built over
A^T (``symmetric=False``).  The GCN and GIN layer cores compose the SpMM
with ``torch.matmul`` for the dense update (``W^T X^T`` transposed,
``X pad(W)`` wide), as the JAX package's composed default does with
``jnp.dot``; autograd then yields its backward dataflow.

Only plans that the layout's ``check_plan`` accepts run here; any other
plan raises NotImplementedError at construction instead of losing edges.
The row layout [N, d] goes through the padded core with one pad in and one
slice out; the row layout's own populations are ROADMAP A.7.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from hcspmm_tpu_torch.config import PlanConfig
from hcspmm_tpu_torch.format.plan import ExecutionPlan, build_plan, transpose_csr
from hcspmm_tpu_torch.kernels import block_spmm, dstream, tband, tspill


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class _SpMM(torch.autograd.Function):
    """``fwd(x)`` with gradient ``bwd(g)``: both are SpMMs over plan arrays
    that are not differentiated."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        ctx.x_dtype = x.dtype
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g.contiguous()).to(ctx.x_dtype), None, None


def _layout(plan):
    """(check_plan, padded core, row-layout glue) of ``plan``'s layout."""
    if getattr(plan, "tband", False):
        return tband.check_plan, tband.spmm_tband_padded, tband.spmm_tband
    return block_spmm.check_plan, block_spmm.spmm_wide_padded, block_spmm.spmm_wide


def make_spmm_padded(plan: ExecutionPlan, plan_bwd: Optional[ExecutionPlan] = None,
                     compute_dtype: str = "float32"):
    """Differentiable SpMM over the plan's padded layout (transposed [dt, M]
    or wide [M, dp]) -> the same layout: ``spmm_p(arrs_f, arrs_b, xp)``.
    ``plan_bwd=None`` reuses the forward plan in the backward (symmetric
    structure)."""
    pb = plan if plan_bwd is None else plan_bwd
    if getattr(pb, "tband", False) != getattr(plan, "tband", False):
        raise ValueError("forward and backward plans must share the padded layout")
    check, core, _ = _layout(plan)
    for p in (plan, pb):
        check(p)
    if pb.padded_rows != plan.padded_rows:
        raise ValueError("forward and backward plans must share the padded layout")
    cd = _dtype(compute_dtype)

    def spmm_p(arrs_f, arrs_b, xp):
        return _SpMM.apply(xp, lambda v: core(arrs_f, v, plan, cd),
                           lambda g: core(arrs_b, g, pb, cd))

    return spmm_p


def make_spmm(plan: ExecutionPlan, plan_bwd: Optional[ExecutionPlan] = None,
              compute_dtype: str = "float32"):
    """Row-layout form ``spmm(arrs_f, arrs_b, x [N, d]) -> [N, d]`` through
    the layout's glue around the padded core; the plans are checked where
    they are applied."""
    pb = plan if plan_bwd is None else plan_bwd
    glue_f, glue_b = _layout(plan)[2], _layout(pb)[2]
    cd = _dtype(compute_dtype)

    def spmm(arrs_f, arrs_b, x):
        return _SpMM.apply(x, lambda v: glue_f(arrs_f, v, plan, cd),
                           lambda g: glue_b(arrs_b, g, pb, cd))

    return spmm


#: row-layout merge arrays the transposed lane path never reads
_ROW_SPILL_KEYS = ("ds_gcols", "ds_local", "ds_blk", "ds_lt", "ds_ucols")


def _to_device(plan: ExecutionPlan, device) -> dict:
    """Plan arrays as tensors on ``device``: plain copies of
    ``device_arrays(dense_band=False)`` plus the dense int8 band blocks
    (``band{s}_at`` [Sb, W, bh] transposed, ``band{s}_a`` [Sb, bh, Bb]
    wide) and the merges' block runs.  A tband plan on the lane path drops
    the row merge arrays it never reads.  The band entries and every spill
    index array are checked on the host first: the kernels read them
    unchecked."""
    m = plan.padded_rows
    num_sw = m // plan.band_h
    transposed = getattr(plan, "tband", False)
    host = plan.device_arrays(dense_band=False)
    if "ds_tlocal" in host:
        for k in _ROW_SPILL_KEYS:
            host.pop(k, None)
    host.update(tspill.check_spill_arrays(host, plan))
    host.update(dstream.check_row_spill_arrays(host, plan))
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in host.items()}
    for s, w in enumerate(plan.band_widths):
        if transposed:
            tband.check_band_arrays(host[f"band{s}_start"], host[f"band{s}_sw"],
                                    int(w), m, num_sw)
            out[f"band{s}_at"] = torch.from_numpy(plan.band_at_dense(s)).to(device)
        else:
            block_spmm.check_band_arrays(host[f"band{s}_start"], host[f"band{s}_sw"],
                                         int(w), m, num_sw)
            out[f"band{s}_a"] = torch.from_numpy(plan.band_a_dense(s)).to(device)
    return out


class HybridSpMM:
    """CSR graph -> plan(s) -> differentiable operator on ``device``.

    The analog of the reference flow ``HYGNN.preprocess(...)`` +
    ``HCSPMM.forward*``: construction runs preprocessing and uploads the
    plan arrays; ``apply_padded`` aggregates in the plan's padded layout
    (transposed X^T [dt, M] for tband plans, wide [M, dp] otherwise),
    ``apply``/``__call__`` in the row layout [N, d].
    """

    def __init__(self, row_pointers: np.ndarray, column_index: np.ndarray,
                 num_nodes: int, config: PlanConfig = PlanConfig(),
                 symmetric: bool = True, normalize: bool = False,
                 device="cpu"):
        """``normalize=True`` computes D^-1/2 A D^-1/2 X (symmetric GCN
        normalization); False is the reference's unweighted sum.
        ``symmetric=False`` builds the backward plan on A^T."""
        self.config = config
        self.normalize = normalize
        self.device = torch.device(device)
        self.plan = build_plan(row_pointers, column_index, num_nodes, config)
        if symmetric:
            self.plan_bwd = None
        else:
            rp_t, ci_t = transpose_csr(row_pointers, column_index, num_nodes)
            self.plan_bwd = build_plan(rp_t, ci_t, num_nodes, config)
        # raises NotImplementedError for a plan that would drop edges
        self._fn_padded = make_spmm_padded(self.plan, self.plan_bwd,
                                           config.compute_dtype)
        self._fn = make_spmm(self.plan, self.plan_bwd, config.compute_dtype)
        arrs_f = _to_device(self.plan, self.device)
        arrs_b = arrs_f if self.plan_bwd is None else _to_device(self.plan_bwd,
                                                                 self.device)
        #: plan arrays on the device; ``apply(arrays, x)`` threads them
        self.arrays = {"f": arrs_f, "b": arrs_b}
        deg = np.maximum(np.diff(np.asarray(row_pointers)), 1).astype(np.float32)
        #: 1/deg — mean aggregation (GraphSAGE mean_N = D^-1 A X)
        self.arrays["inv_deg"] = torch.from_numpy(1.0 / deg).to(self.device)
        if normalize:
            self.arrays["inv_sqrt_deg"] = torch.from_numpy(
                1.0 / np.sqrt(deg)).to(self.device)

    # ---- padded layout: [dt, M] -> [dt, M] or [M, dp] -> [M, dp] ----

    @property
    def padded_rows(self) -> int:
        return self.plan.padded_rows

    @property
    def transposed(self) -> bool:
        """True when the padded layout is the tband X^T [dt, M]; False for
        the wide [M, dp]."""
        return bool(getattr(self.plan, "tband", False))

    def is_padded(self, x) -> bool:
        """True when ``x`` already has the padded layout's shape (an [N, d]
        input of that very shape pads to itself)."""
        if self.transposed:
            return x.shape[1] == self.padded_rows and x.shape[0] % 16 == 0
        return x.shape[0] == self.padded_rows and x.shape[1] % 128 == 0

    def _check_fused(self):
        if getattr(self.plan, "prefer_fused_kernel", False):
            name = ("tband.py:tband_fused_direct" if self.transposed
                    else "block_spmm.py:band_fused_spmm_direct")
            raise NotImplementedError(
                f"prefer_fused_kernel: the fused band kernel (hcspmm_tpu/kernels/{name}) "
                "is ROADMAP A.11")

    def pad_input(self, x) -> torch.Tensor:
        """[N, d] -> the padded layout in the compute dtype on the
        operator's device (one-time cost; the layout then stays closed):
        [dt, M] transposed, [M, dp] wide."""
        x = torch.as_tensor(x)
        n, d = x.shape
        dtype = _dtype(self.config.compute_dtype)
        m = self.plan.padded_rows
        if self.transposed:
            xp = torch.zeros((tband.sublane_pad(d), m), dtype=dtype, device=self.device)
            xp[:d, :n] = x.T.to(device=self.device, dtype=dtype)
        else:
            xp = torch.zeros((m, block_spmm.lane_pad(d)), dtype=dtype, device=self.device)
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

    def dense_padded(self, xp, w):
        """Dense update ``X W`` in the padded layout: (pad W)^T @ xt
        transposed, xp @ pad(W) wide."""
        if not self.transposed:
            return torch.matmul(xp, self.pad_weight(w, xp))
        ht = tband.sublane_pad(w.shape[1])
        wt = F.pad(w.T.to(xp.dtype), (0, xp.shape[0] - w.shape[0], 0, ht - w.shape[1]))
        return torch.matmul(wt, xp)

    def apply_padded(self, arrays, xp: torch.Tensor) -> torch.Tensor:
        """SpMM in the padded layout."""
        if "inv_sqrt_deg" in arrays:
            inv = self._inv_lanes(arrays["inv_sqrt_deg"], xp)
            xs = (xp * inv).to(xp.dtype)
            return (self._padded_core(arrays, xs) * inv).to(xp.dtype)
        return self._padded_core(arrays, xp)

    def _padded_core(self, arrays, xp):
        return self._fn_padded(arrays["f"], arrays["b"], xp)

    def gcn_apply_padded(self, arrays, xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """GCN layer core A (X W) in the padded layout; backward: one SpMM
        of dZ, then the two dense products."""
        self._check_fused()
        return self.apply_padded(arrays, self.dense_padded(xp, w))

    def gin_apply_padded(self, arrays, xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """GIN layer core (A X) W in the padded layout; the aggregate is the
        residual autograd keeps for dW."""
        self._check_fused()
        return self.dense_padded(self.apply_padded(arrays, xp), w)

    def mean_apply(self, arrays, x: torch.Tensor) -> torch.Tensor:
        """Mean aggregation ``D^-1 A X`` in the row layout (raw aggregate
        whatever ``normalize`` says: SAGE's own scaling)."""
        agg = self._fn(arrays["f"], arrays["b"], x)
        return (agg * arrays["inv_deg"][:, None]).to(x.dtype)

    def mean_apply_padded(self, arrays, xp: torch.Tensor) -> torch.Tensor:
        """Mean aggregation in the padded layout (padded rows have
        inv_deg == 1, so they stay exactly zero)."""
        inv = self._inv_lanes(arrays["inv_deg"], xp)
        return (self._padded_core(arrays, xp) * inv).to(xp.dtype)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return self.mean_apply(self.arrays, x)

    def apply(self, arrays, x: torch.Tensor) -> torch.Tensor:
        """Row-layout SpMM [N, d] -> [N, d]."""
        if "inv_sqrt_deg" in arrays:
            inv = arrays["inv_sqrt_deg"][:, None]
            xs = (x * inv).to(x.dtype)
            return (self._fn(arrays["f"], arrays["b"], xs) * inv).to(x.dtype)
        return self._fn(arrays["f"], arrays["b"], x)

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
