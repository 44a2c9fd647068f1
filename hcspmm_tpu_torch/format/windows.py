"""Row-window analysis: the host-side equivalent of the reference's GPU
``preprocess`` (hybrid_all_kernel.cu:339-408).

The reference builds, on-GPU with thrust + three kernels:
  1. ``edgeToRow``  — eid -> owning row            (.cu:314-337)
  2. ``fill_segment`` + zip-sort — sorts each window's neighbour ids
     (.cu:289-313, :386-399)
  3. ``generate_edgetocolumn`` — per-window unique-column dedup, block
     counts, LOI hybrid type, eid -> compressed column (.cu:242-288)

Here the whole pipeline is vectorized NumPy on the host (it runs once per
graph and feeds static-shaped device arrays, so there is nothing for the
TPU to do); the per-window dedup that the reference runs single-threaded
per block is a single ``np.unique`` over (window, col) keys.

Semantics preserved:
- window height BLK_H = 16;
- ``block_partition[w] = ceil(unique_cols / BLK_W)`` — note the reference's
  expression ``(size + 8) / 8`` operates on ``size = unique - 1`` (its
  dedup routine counts transitions, .cu:213-223), so it equals the true
  ceiling; we compute the ceiling directly;
- ``edge_to_column[eid]`` is the index of the edge's neighbour in the
  window's sorted unique-column list (.cu:264-268);
- ``hybrid_type[w]`` from the LOI selector (see format.loi).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

from hcspmm_tpu_torch.config import BLK_H, BLK_W, LOICoefficients
from hcspmm_tpu_torch.format import loi
from hcspmm_tpu_torch.utils import profiling

#: The package's own copy of the C++ host passes (``native/``), compiled on
#: first use with g++; without a compiler the NumPy fallbacks run.
NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "native")
_SRC = os.path.join(NATIVE_DIR, "preprocess.cpp")
_LIB_CACHE: Optional[ctypes.CDLL] = None
_LIB_FAILED = False


def _native_lib() -> Optional[ctypes.CDLL]:
    """Compile native/preprocess.cpp to a cached shared library.

    The C++ analyzer is the host equivalent of the reference's GPU
    preprocessing kernels (hybrid_all_kernel.cu:213-408, OpenMP over
    windows instead of one thread block per window); the NumPy path
    below stays as the portable fallback and test oracle."""
    global _LIB_CACHE, _LIB_FAILED
    if _LIB_CACHE is not None:
        return _LIB_CACHE
    if _LIB_FAILED or not os.path.exists(_SRC):
        return None
    so_path = os.path.join(
        tempfile.gettempdir(),
        f"hcspmm_torch_preprocess_{os.getuid()}_{int(os.path.getmtime(_SRC))}.so",
    )
    if not os.path.exists(so_path):
        with profiling.span("build.compile"):
            try:
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-fopenmp", "-shared",
                     "-fPIC", "-o", so_path, _SRC],
                    check=True, capture_output=True, timeout=120,
                )
            except (subprocess.SubprocessError, FileNotFoundError):
                try:  # toolchains without OpenMP
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", "-o", so_path, _SRC],
                        check=True, capture_output=True, timeout=120,
                    )
                except (subprocess.SubprocessError, FileNotFoundError):
                    _LIB_FAILED = True
                    return None
        profiling.record_build("preprocess")
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        _LIB_FAILED = True
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.hcspmm_analyze_windows.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int32, i32p, i64p, i32p,
    ]
    lib.hcspmm_analyze_windows.restype = ctypes.c_int32
    lib.hcspmm_band_extents.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int32, i64p, i64p,
    ]
    lib.hcspmm_band_extents.restype = ctypes.c_int32
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.hcspmm_band_robust.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int32, f64p, ctypes.c_int32,
        i64p, i64p, i64p, i64p,
    ]
    lib.hcspmm_band_robust.restype = ctypes.c_int32
    lib.hcspmm_band_place.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        i64p, ctypes.c_int32, u8p, i64p, i64p, i64p,
    ]
    lib.hcspmm_band_place.restype = ctypes.c_int32
    _LIB_CACHE = lib
    return lib


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def native_band_robust(rp, ci, n: int, band_h: int, qs):
    """Native per-super robust-width quantiles + count/min/max
    (format.plan._robust_widths ported to OpenMP C++; the per-edge
    quantile passes are the plan build's hottest loop at power-law
    scale).  Returns (cnt, min_col, max_col, rw[nq, num_sw]) or None
    when the native lib is unavailable."""
    lib = _native_lib()
    if lib is None:
        return None
    rp32 = np.ascontiguousarray(rp, dtype=np.int32)
    ci32 = np.ascontiguousarray(ci, dtype=np.int32)
    num_sw = (int(n) + band_h - 1) // band_h
    qs_a = np.ascontiguousarray(qs, dtype=np.float64)
    cnt = np.empty(num_sw, dtype=np.int64)
    mn = np.empty(num_sw, dtype=np.int64)
    mx = np.empty(num_sw, dtype=np.int64)
    rw = np.empty((len(qs_a), num_sw), dtype=np.int64)
    rc = lib.hcspmm_band_robust(
        _i32ptr(rp32), _i32ptr(ci32), int(n), band_h,
        qs_a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(qs_a),
        _i64ptr(cnt), _i64ptr(mn), _i64ptr(mx), _i64ptr(rw))
    if rc != 0:
        return None
    return cnt, mn, mx, rw


def native_band_place(rp, ci, n: int, band_h: int, align: int, widths,
                      mask=None, num_sw: int = 0):
    """Native aligned band-window placement per (width, superwindow)
    (format.plan._place_band_windows ported).  ``mask`` selects edges
    (CSR order).  ``num_sw`` > the row-derived count pads the trailing
    (empty) superwindows with zeros — the planner rounds its super count
    up to a multiple of 16 (format.plan).  Returns (cov[nb, num_sw],
    start[nb, num_sw], cnt[num_sw]) or None when the native lib is
    unavailable."""
    lib = _native_lib()
    if lib is None:
        return None
    rp32 = np.ascontiguousarray(rp, dtype=np.int32)
    ci32 = np.ascontiguousarray(ci, dtype=np.int32)
    nsw0 = (int(n) + band_h - 1) // band_h
    w_a = np.ascontiguousarray(widths, dtype=np.int64)
    cov = np.empty((len(w_a), nsw0), dtype=np.int64)
    start = np.empty((len(w_a), nsw0), dtype=np.int64)
    cnt = np.empty(nsw0, dtype=np.int64)
    if mask is None:
        mp = ctypes.POINTER(ctypes.c_uint8)()
    else:
        mask = np.ascontiguousarray(mask, dtype=np.uint8)
        mp = mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    rc = lib.hcspmm_band_place(
        _i32ptr(rp32), _i32ptr(ci32), int(n), band_h, int(align),
        _i64ptr(w_a), len(w_a), mp, _i64ptr(cov), _i64ptr(start),
        _i64ptr(cnt))
    if rc != 0:
        return None
    if num_sw and num_sw > nsw0:
        pad = num_sw - nsw0
        cov = np.pad(cov, ((0, 0), (0, pad)))
        start = np.pad(start, ((0, 0), (0, pad)))
        cnt = np.pad(cnt, (0, pad))
    return cov, start, cnt


@dataclasses.dataclass
class WindowAnalysis:
    """Everything the execution planner and parity checks need."""

    num_nodes: int
    num_windows: int
    window_h: int

    # Per-edge (CSR order) arrays — reference parity surface.
    edge_to_row: np.ndarray      # int32 [nnz]: eid -> global row
    edge_to_window: np.ndarray   # int32 [nnz]: eid -> window id
    edge_to_column: np.ndarray   # int32 [nnz]: eid -> window-local unique-col index

    # Per-window arrays.
    window_edge_ptr: np.ndarray  # int32 [W+1]: CSR-style edge ranges per window
    unique_counts: np.ndarray    # int32 [W]: # unique neighbour columns
    edge_counts: np.ndarray      # int32 [W]: # edges (nnz) in window
    block_partition: np.ndarray  # int32 [W]: ceil(unique/BLK_W)
    hybrid_type: np.ndarray      # int32 [W]: 0 = sparse/gather path, 1 = dense/MXU path

    # Flat sorted-unique columns per window, CSR-indexed by unique_ptr.
    unique_cols: np.ndarray      # int32 [sum(unique_counts)]
    unique_ptr: np.ndarray       # int64 [W+1]

    @property
    def total_blocks(self) -> int:
        """Reference's ``blocknum`` atomic total (.cu:259)."""
        return int(self.block_partition.sum())


def analyze_windows(
    row_pointers: np.ndarray,
    column_index: np.ndarray,
    num_nodes: int,
    window_h: int = BLK_H,
    block_w: int = BLK_W,
    loi_mode: str = "intended",
    loi_coeffs: LOICoefficients | None = None,
    num_cols: int | None = None,
    backend: str = "auto",
) -> WindowAnalysis:
    """``num_nodes`` is the number of *rows* (the window axis).  For a
    rectangular operand (a row-block shard of a square adjacency, used by
    the distributed layer) pass ``num_cols`` = global column count."""
    row_pointers = np.asarray(row_pointers, dtype=np.int64)
    # ci stays int32: the native analyzer consumes int32 directly and the
    # NumPy fallback's key math upcasts through its int64 partner — the
    # unconditional int64 copy cost 8 B/edge twice per analysis
    column_index = np.ascontiguousarray(column_index)
    if column_index.dtype != np.int32:
        column_index = column_index.astype(np.int32)
    nnz = int(row_pointers[-1])
    num_windows = (num_nodes + window_h - 1) // window_h
    num_cols = num_nodes if num_cols is None else num_cols

    # edge -> row/window via boundary-mark cumsum, NOT np.repeat or //:
    # on this rig np.repeat's tiny-run write pattern measured 2-6 s at
    # 5.5M edges (fresh-page fault pathology) vs 0.04 s for the cumsum
    # form; integer division on the result was similarly slow.
    marks = row_pointers[1:num_nodes]
    edge_to_row = np.bincount(marks, minlength=max(nnz, 1))[:max(nnz, 1)]
    np.cumsum(edge_to_row, out=edge_to_row)
    edge_to_row = edge_to_row[:nnz]
    wmarks = row_pointers[window_h:num_nodes:window_h]
    edge_to_window = np.bincount(wmarks, minlength=max(nnz, 1))[:max(nnz, 1)]
    np.cumsum(edge_to_window, out=edge_to_window)
    edge_to_window = edge_to_window[:nnz]

    # Window edge ranges: windows cover contiguous row ranges, so the edge
    # range of window w is [row_ptr[16w], row_ptr[min(16w+16, N)]).
    starts = row_pointers[np.minimum(np.arange(num_windows) * window_h, num_nodes)]
    ends = row_pointers[np.minimum(np.arange(num_windows) * window_h + window_h, num_nodes)]
    window_edge_ptr = np.concatenate([starts, ends[-1:]])

    # Per-window unique neighbour columns + per-edge compressed index —
    # the dedup + binary-search of .cu:242-268.  Native path: OpenMP C++
    # over windows (native/preprocess.cpp).  NumPy path: one np.unique
    # over (window * C + col) keys; kept as portable fallback and oracle.
    # 'auto' prefers the C++ analyzer whenever it builds: it scales with
    # cores (OpenMP) AND is robust at scale — np.unique's int64 argsort
    # measured 21 s at 5.5M edges on this rig (power-law TT stand-in)
    # vs 2.8 s for the native pass even single-core.  (The one regime
    # where NumPy wins — small graphs on a 1-core host — is prep-time
    # noise: ~0.4 s at DD scale.)
    use_native = backend == "native" or backend == "auto"
    lib = _native_lib() if use_native else None
    if backend == "native" and lib is None:
        raise RuntimeError("native analyzer unavailable (g++ failed?)")
    if lib is not None and nnz > 0:
        rp32 = np.ascontiguousarray(row_pointers, dtype=np.int32)
        ci32 = np.ascontiguousarray(column_index, dtype=np.int32)
        unique_cols = np.empty(nnz, dtype=np.int32)
        unique_ptr = np.zeros(num_windows + 1, dtype=np.int64)
        edge_to_column = np.empty(nnz, dtype=np.int32)
        rc = lib.hcspmm_analyze_windows(
            _i32ptr(rp32), _i32ptr(ci32), num_nodes, window_h,
            _i32ptr(unique_cols), _i64ptr(unique_ptr),
            _i32ptr(edge_to_column),
        )
        if rc != 0:
            raise RuntimeError(f"hcspmm_analyze_windows rc={rc}")
        unique_cols = unique_cols[: int(unique_ptr[-1])].copy()
        unique_counts = np.diff(unique_ptr).astype(np.int32)
    else:
        keys = edge_to_window * np.int64(num_cols) + column_index
        unique_keys, inverse = np.unique(keys, return_inverse=True)
        unique_windows = unique_keys // num_cols
        unique_cols = (unique_keys % num_cols).astype(np.int32)
        unique_counts = np.bincount(
            unique_windows, minlength=num_windows
        ).astype(np.int32)
        unique_ptr = np.zeros(num_windows + 1, dtype=np.int64)
        np.cumsum(unique_counts, out=unique_ptr[1:])
        # Window-local compressed column index per edge.
        edge_to_column = (inverse - unique_ptr[edge_to_window]).astype(np.int32)

    edge_counts = (ends - starts).astype(np.int32)
    block_partition = ((unique_counts + block_w - 1) // block_w).astype(np.int32)

    # 'calibrated' defaults to the coefficients refit on this hardware
    # (tools/calibrate_loi.py) unless the caller supplies custom ones;
    # other modes default to the reference's GPU-fitted values.  None is
    # the ONLY 'unset' sentinel — an explicitly passed LOICoefficients()
    # (the reference GPU values) is honored verbatim.
    if loi_coeffs is None:
        from hcspmm_tpu_torch.config import LOI_TPU_V5E

        loi_coeffs = LOI_TPU_V5E if loi_mode == "calibrated" else LOICoefficients()
    hybrid_type = loi.decide_hybrid_type(
        unique_counts=unique_counts,
        edge_counts=edge_counts,
        block_partition=block_partition,
        mode=loi_mode,
        coeffs=loi_coeffs,
        window_h=window_h,
        block_w=block_w,
    )

    return WindowAnalysis(
        num_nodes=num_nodes,
        num_windows=num_windows,
        window_h=window_h,
        edge_to_row=edge_to_row.astype(np.int32),
        edge_to_window=edge_to_window.astype(np.int32),
        edge_to_column=edge_to_column,
        window_edge_ptr=window_edge_ptr.astype(np.int64),
        unique_counts=unique_counts,
        edge_counts=edge_counts,
        block_partition=block_partition,
        hybrid_type=hybrid_type,
        unique_cols=unique_cols,
        unique_ptr=unique_ptr,
    )
