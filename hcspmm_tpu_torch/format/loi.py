"""LOI — the logistic row-window selector (hybrid-core chooser).

Reference: the decision expression inside ``generate_edgetocolumn``
(hybrid_all_kernel.cu:261-262) and its training pipeline (report §IV-C).

The *intended* rule (the commented-out line, .cu:261):

    sparse  if size > 32
            or 0.19854024*size - 6.578043*density - 3.14922857 > 0
    dense   otherwise

where ``size`` is the reference's dedup count (``unique - 1``, see
.cu:213-223) and ``density = nnz / (num_blocks * 16 * 8)`` is the occupancy
of the allocated column blocks.  The *live* line (.cu:262) dropped the
``> 0``, turning the expression into a float truthiness test that routes
virtually every window to the CUDA-core path; ``mode='degenerate'``
reproduces that for bit-parity experiments.

Output encoding matches the reference: 0 = memory-bound (CUDA-core /
TPU gather path), 1 = compute-bound (Tensor-core / TPU MXU block path).
Empty windows get 0 (the reference early-returns over memset zeros,
.cu:251-252, :356-366).

GPU-fitted coefficients do not transfer to the MXU/VPU trade-off, so
``fit_logistic`` + ``make_training_set`` rebuild the report §IV-C
procedure: time both paths on synthetic 16-row windows, label each window
with the faster path, fit a 2-feature logistic model.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np

from hcspmm_tpu_torch.config import BLK_H, BLK_W, LOICoefficients


def loi_score(
    unique_counts: np.ndarray,
    edge_counts: np.ndarray,
    block_partition: np.ndarray,
    coeffs: LOICoefficients,
    window_h: int = BLK_H,
    block_w: int = BLK_W,
    reference_size: bool = True,
) -> np.ndarray:
    """Raw logistic score; positive => sparse path.

    ``reference_size=True`` uses the reference's ``size = unique - 1``
    (its transition-counting dedup, .cu:213-223) so 'intended' mode is
    bit-comparable; calibrated TPU coefficients use the true unique count.
    """
    size = unique_counts.astype(np.float64)
    if reference_size:
        size = np.maximum(size - 1.0, 0.0)
    cap = np.maximum(block_partition.astype(np.float64), 1.0) * window_h * block_w
    density = edge_counts.astype(np.float64) / cap
    return coeffs.w_cols * size + coeffs.w_density * density + coeffs.bias


def decide_hybrid_type(
    unique_counts: np.ndarray,
    edge_counts: np.ndarray,
    block_partition: np.ndarray,
    mode: str = "intended",
    coeffs: LOICoefficients = LOICoefficients(),
    window_h: int = BLK_H,
    block_w: int = BLK_W,
) -> np.ndarray:
    """Per-window routing: 0 = sparse/gather path, 1 = dense/MXU path."""
    nonempty = edge_counts > 0
    if mode == "all_dense":
        out = np.ones_like(unique_counts)
    elif mode == "all_sparse":
        out = np.zeros_like(unique_counts)
    elif mode == "intended":
        score = loi_score(
            unique_counts, edge_counts, block_partition, coeffs,
            window_h, block_w, reference_size=True,
        )
        size_ref = np.maximum(unique_counts - 1, 0)
        sparse = (size_ref > coeffs.max_cols) | (score > 0.0)
        out = np.where(sparse, 0, 1)
    elif mode == "degenerate":
        # Live reference line .cu:262: truthiness of the float expression.
        score = loi_score(
            unique_counts, edge_counts, block_partition, coeffs,
            window_h, block_w, reference_size=True,
        )
        out = np.where(score.astype(np.float32) != 0.0, 0, 1)
    elif mode == "calibrated":
        score = loi_score(
            unique_counts, edge_counts, block_partition, coeffs,
            window_h, block_w, reference_size=False,
        )
        sparse = (unique_counts > coeffs.max_cols) | (score > 0.0)
        out = np.where(sparse, 0, 1)
    else:
        raise ValueError(f"unknown LOI mode: {mode}")
    return np.where(nonempty, out, 0).astype(np.int32)


# ---------------------------------------------------------------------------
# Re-calibration (report §IV-C): synthetic windows -> timings -> logistic fit.
# ---------------------------------------------------------------------------


def make_training_windows(
    num_samples: int,
    window_h: int = BLK_H,
    max_unique: int = 128,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic per-window (unique_cols, nnz) feature pairs spanning the
    density/width space, mirroring the paper's synthetic 16-row matrices."""
    rng = np.random.RandomState(seed)
    uniq = rng.randint(1, max_unique + 1, size=num_samples)
    # nnz in [uniq, uniq * window_h] (each unique column appears >= 1 time).
    frac = rng.rand(num_samples)
    nnz = (uniq + frac * uniq * (window_h - 1)).astype(np.int64)
    return uniq.astype(np.int32), nnz.astype(np.int32)


def fit_logistic(
    features: np.ndarray,   # [S, 2]: (size, density)
    labels: np.ndarray,     # [S]: 1 if sparse path faster else 0
    lr: float = 0.5,
    steps: int = 3000,
    l2: float = 1e-4,
    seed: int = 0,
    max_cols: int = 256,
    weights: np.ndarray | None = None,
) -> LOICoefficients:
    """Plain NumPy logistic regression (no sklearn in the image).

    ``max_cols`` defaults to the widest MXU bucket: a freshly calibrated
    TPU selector must not inherit the reference's GPU cap of 32, which
    would force-route every wider window sparse regardless of the fitted
    coefficients (the measured v5e crossover favors MXU almost
    everywhere — see config.LOI_TPU_V5E)."""
    x = np.asarray(features, dtype=np.float64)
    y = np.asarray(labels, dtype=np.float64)
    # sample weights (e.g. window counts per mixture bin) normalized to
    # mean 1 so lr/l2 keep their scale
    sw = (np.ones(len(y)) if weights is None
          else np.asarray(weights, np.float64) * len(y)
          / max(float(np.sum(weights)), 1e-12))
    mu, sd = x.mean(0), x.std(0) + 1e-9
    xn = (x - mu) / sd
    w = np.zeros(2)
    b = 0.0
    n = len(y)
    for _ in range(steps):
        z = xn @ w + b
        p = 1.0 / (1.0 + np.exp(-z))
        g = (p - y) * sw
        gw = xn.T @ g / n + l2 * w
        gb = g.mean()
        w -= lr * gw
        b -= lr * gb
    # De-normalize back to raw-feature coefficients.
    w_raw = w / sd
    b_raw = b - float((w * mu / sd).sum())
    return LOICoefficients(
        w_cols=float(w_raw[0]),
        w_density=float(w_raw[1]),
        bias=float(b_raw),
        max_cols=max_cols,
    )


def calibrate(
    time_dense_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    time_sparse_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    num_samples: int = 256,
    window_h: int = BLK_H,
    block_w: int = BLK_W,
    seed: int = 0,
) -> LOICoefficients:
    """Refit the selector from measured per-window path timings.

    ``time_*_fn(unique_counts, edge_counts) -> seconds per window`` are
    supplied by the bench harness (they run the real Pallas/XLA paths on
    the current backend); this function only owns the fitting procedure.
    """
    uniq, nnz = make_training_windows(num_samples, window_h, seed=seed)
    t_dense = np.asarray(time_dense_fn(uniq, nnz), dtype=np.float64)
    t_sparse = np.asarray(time_sparse_fn(uniq, nnz), dtype=np.float64)
    labels = (t_sparse < t_dense).astype(np.float64)  # 1 => sparse wins
    blocks = (uniq + block_w - 1) // block_w
    density = nnz / (np.maximum(blocks, 1) * window_h * block_w)
    feats = np.stack([uniq.astype(np.float64), density], axis=1)
    return fit_logistic(feats, labels, seed=seed)
