"""Graph layout reordering (LOA) — the offline preprocessing step that
regroups rows into denser windows (reference: standalone LOI.cpp binary,
invoked via text files; report §V-B, Alg. 5/6).

Here it is a library call with two backends:

- **native** (preferred): ``native/loa.cpp`` compiled on first use into a
  shared library and driven through ctypes.  Same greedy
  computing-intensity maximization as the reference's
  ``reorder_plus_new_direct`` (LOI.cpp:660-805).
- **numpy fallback**: a vectorized-ish pure-Python implementation with the
  same objective, used when no compiler is available (slower; fine for
  tests and small graphs).

Also provides ``rcm_reorder`` (reverse Cuthill-McKee via scipy) — the
bandwidth-minimizing ordering that feeds the TPU *banded* execution path
(no reference equivalent; the GPU gets this reuse implicitly from L2).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

from hcspmm_tpu_torch.format.windows import NATIVE_DIR
from hcspmm_tpu_torch.utils import profiling

_SRC = os.path.join(NATIVE_DIR, "loa.cpp")
_LIB_CACHE: Optional[ctypes.CDLL] = None
_LIB_FAILED = False
_CL_SRC = os.path.join(NATIVE_DIR, "cluster.cpp")
_CL_CACHE: Optional[ctypes.CDLL] = None
_CL_FAILED = False


def _cluster_lib() -> Optional[ctypes.CDLL]:
    """Compile native/cluster.cpp (agglomeration backend) on first use."""
    global _CL_CACHE, _CL_FAILED
    if _CL_CACHE is not None:
        return _CL_CACHE
    if _CL_FAILED or not os.path.exists(_CL_SRC):
        return None
    so_path = os.path.join(
        tempfile.gettempdir(),
        f"hcspmm_torch_cluster_{os.getuid()}_{int(os.path.getmtime(_CL_SRC))}.so",
    )
    if not os.path.exists(so_path):
        with profiling.span("build.compile"):
            try:
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-fopenmp", "-shared",
                     "-fPIC", "-o", so_path, _CL_SRC],
                    check=True, capture_output=True, timeout=120,
                )
            except (subprocess.SubprocessError, FileNotFoundError):
                try:
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", "-o", so_path,
                         _CL_SRC],
                        check=True, capture_output=True, timeout=120,
                    )
                except (subprocess.SubprocessError, FileNotFoundError):
                    _CL_FAILED = True
                    return None
        profiling.record_build("cluster")
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        _CL_FAILED = True
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.hcspmm_cluster_labels.argtypes = [
        i64p, i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p]
    lib.hcspmm_cluster_labels.restype = ctypes.c_int32
    _CL_CACHE = lib
    return lib


def _build_lib() -> Optional[ctypes.CDLL]:
    """Compile native/loa.cpp to a cached shared library (g++ -O3)."""
    global _LIB_CACHE, _LIB_FAILED
    if _LIB_CACHE is not None:
        return _LIB_CACHE
    if _LIB_FAILED or not os.path.exists(_SRC):
        return None
    so_path = os.path.join(
        tempfile.gettempdir(),
        f"hcspmm_torch_loa_{os.getuid()}_{int(os.path.getmtime(_SRC))}.so",
    )
    if not os.path.exists(so_path):
        with profiling.span("build.compile"):
            try:
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     "-o", so_path, _SRC],
                    check=True, capture_output=True, timeout=120,
                )
            except (subprocess.SubprocessError, FileNotFoundError):
                _LIB_FAILED = True
                return None
        profiling.record_build("loa")
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        _LIB_FAILED = True
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.loa_reorder.argtypes = [i32p, i32p, i32p, i32p,
                                ctypes.c_int32, ctypes.c_int32,
                                ctypes.c_int32, ctypes.c_int32, i32p]
    lib.loa_reorder.restype = ctypes.c_int32
    lib.window_stats.argtypes = [i32p, i32p, ctypes.c_int32,
                                 ctypes.c_int32, i32p, i32p]
    lib.window_stats.restype = ctypes.c_int32
    _LIB_CACHE = lib
    return lib


def _as_i32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x), dtype=np.int32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def loa_reorder_py(rp, ci, rp_in, ci_in, n: int, window_h: int = 16,
                   max_cols: int = 0, hub_cap: int = 0) -> np.ndarray:
    """Pure-NumPy greedy LOA (same objective as the native version)."""
    rp = np.asarray(rp, dtype=np.int64)
    ci = np.asarray(ci, dtype=np.int64)
    rp_in = np.asarray(rp_in, dtype=np.int64)
    ci_in = np.asarray(ci_in, dtype=np.int64)
    if max_cols <= 0:
        max_cols = np.iinfo(np.int64).max
    if hub_cap <= 0:
        hub_cap = np.iinfo(np.int64).max
    visited = np.zeros(n, dtype=bool)
    perm = np.empty(n, dtype=np.int32)
    pos = 0
    indeg = np.diff(rp_in)
    deg = np.diff(rp)
    next_seed = 0
    cns: dict = {}
    while pos < n:
        while next_seed < n and visited[next_seed]:
            next_seed += 1
        if next_seed >= n:
            break
        seed = next_seed
        visited[seed] = True
        perm[pos] = seed
        pos += 1
        cols = set(ci[rp[seed]: rp[seed + 1]].tolist())
        cur_eles = int(deg[seed])
        cns = {}

        def add_incidence(new_cols):
            # sorted iteration matches the native version's candidate
            # insertion order, so first-max tie-breaking agrees
            for c in sorted(new_cols):
                if indeg[c] > hub_cap:
                    continue
                for v in ci_in[rp_in[c]: rp_in[c + 1]]:
                    if not visited[v]:
                        cns[v] = cns.get(v, 0) + 1

        add_incidence(cols)
        for _ in range(window_h - 1):
            best, best_profit = -1, 0.0
            for v, c in cns.items():
                if visited[v]:
                    continue
                ones = cur_eles + int(deg[v])
                rows = max(1, len(cols) + int(deg[v]) - c)
                p = ones / rows
                if p > best_profit:
                    best, best_profit = int(v), p
            if best < 0:
                break
            nb = set(ci[rp[best]: rp[best + 1]].tolist())
            new_cols = nb - cols
            if len(cols) + len(new_cols) > max_cols and cols:
                break
            visited[best] = True
            perm[pos] = best
            pos += 1
            cur_eles += int(deg[best])
            cols |= new_cols
            add_incidence(new_cols)
    return perm


@profiling.spanned("format.reorder")
def loa_reorder(row_pointers, column_index, num_nodes: int,
                window_h: int = 16, max_cols: int = 0, hub_cap: int = 4096,
                symmetric: bool = True, backend: str = "auto") -> np.ndarray:
    """Greedy LOA row permutation; ``perm[new_row] = old_row``."""
    rp = _as_i32(row_pointers)
    ci = _as_i32(column_index)
    if symmetric:
        rp_in, ci_in = rp, ci
    else:
        from hcspmm_tpu_torch.format.plan import transpose_csr

        rp_in, ci_in = transpose_csr(rp, ci, num_nodes)
        rp_in, ci_in = _as_i32(rp_in), _as_i32(ci_in)

    lib = _build_lib() if backend in ("auto", "native") else None
    if backend == "native" and lib is None:
        raise RuntimeError("native LOA backend unavailable (g++ failed?)")
    if lib is not None:
        perm = np.empty(num_nodes, dtype=np.int32)
        rc = lib.loa_reorder(_ptr(rp), _ptr(ci), _ptr(rp_in), _ptr(ci_in),
                             num_nodes, window_h, max_cols, hub_cap,
                             _ptr(perm))
        if rc != 0:
            raise RuntimeError(f"loa_reorder failed rc={rc}")
        return perm
    return loa_reorder_py(rp, ci, rp_in, ci_in, num_nodes, window_h,
                          max_cols, hub_cap)


@profiling.spanned("format.reorder")
def rcm_reorder(row_pointers, column_index, num_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (bandwidth minimizer) for the banded
    execution path; ``perm[new_row] = old_row``."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    a = sp.csr_matrix(
        (np.ones(len(column_index), dtype=np.int8),
         _as_i32(column_index), _as_i32(row_pointers)),
        shape=(num_nodes, num_nodes),
    )
    return np.asarray(
        reverse_cuthill_mckee(a, symmetric_mode=True), dtype=np.int32
    )


def pack_reorder(row_pointers, column_index, num_nodes: int,
                 band_h: int = 256) -> np.ndarray:
    """Component-aligned packing for the banded path.

    RCM orders each connected component contiguously but lets superwindow
    boundaries straddle components, inflating band extents.  This ordering
    (a) RCM-orders the graph, (b) bin-packs the components into
    ``band_h``-row bins — components that do not fit the current bin's
    remainder start at the next bin boundary, and smaller components
    back-fill the remainders (first-fit decreasing) — so most superwindows
    see only whole components and extents hug the component size.  The
    TPU-shaped analog of the reference's LOA objective (fewer unique
    columns per window -> here: smaller band extent per superwindow).
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    rp = _as_i32(row_pointers)
    ci = _as_i32(column_index)
    a = sp.csr_matrix(
        (np.ones(len(ci), dtype=np.int8), ci, rp),
        shape=(num_nodes, num_nodes),
    )
    ncomp, labels = connected_components(a, directed=False)
    rcm = rcm_reorder(rp, ci, num_nodes)

    # component order and members in RCM order (components are contiguous
    # under RCM; gather their RCM positions to be safe either way)
    comp_members: list = [[] for _ in range(ncomp)]
    for pos, node in enumerate(rcm):
        comp_members[labels[node]].append(node)
    sizes = np.array([len(m) for m in comp_members])
    order = np.argsort(-sizes, kind="stable")

    # First-fit-decreasing into units of capacity ceil(size/band_h)*band_h.
    units: list = []      # lists of component ids
    free: list = []       # free rows in each unit
    for c in order:
        s = int(sizes[c])
        if s == 0:
            continue
        for u in range(len(units)):
            if free[u] >= s:
                units[u].append(c)
                free[u] -= s
                break
        else:
            units.append([c])
            free.append(-(-s // band_h) * band_h - s)

    # Bin alignment survives only while every earlier unit is an exact
    # multiple of band_h, so exactly-full units lead.
    unit_rows = [sum(int(sizes[c]) for c in u) for u in units]
    layout = sorted(range(len(units)),
                    key=lambda u: (unit_rows[u] % band_h != 0, u))
    perm = []
    for u in layout:
        for c in units[u]:
            perm.extend(comp_members[c])
    # degree-0 / leftover nodes
    seen = np.zeros(num_nodes, dtype=bool)
    if perm:
        seen[np.asarray(perm, dtype=np.int64)] = True
    perm.extend(np.where(~seen)[0].tolist())
    return np.asarray(perm, dtype=np.int32)


def _agglomerate_labels(row_pointers, column_index, num_nodes: int,
                        cap: int = 1024, rounds: int = 20,
                        backend: str = "auto") -> np.ndarray:
    """Size-capped mutual-best heavy-edge agglomeration.

    ``backend='auto'`` runs the native C++ port (native/cluster.cpp —
    hash-table pair dedup instead of per-round scipy COO->CSR; measured
    14.7 s -> ~1 s at PRODUCTS@0.25 single-core) and falls back to the
    NumPy implementation below; 'numpy' forces the fallback (tests
    assert the two produce identical labels).

    Each round: contract the graph by current labels (parallel edges act
    as weights), find every cluster's heaviest-weight partner, and merge
    exactly the MUTUAL best pairs whose combined size stays <= ``cap``
    (mutual matching is acyclic, so one vectorized relabel per round).
    Cluster pairs inside a true community accumulate many parallel
    coarse edges while mixing edges stay spread thin, so fragments of
    the same community find each other even when the community subgraph
    is near-tree sparse — the regime where plain label propagation
    fragments (measured: q90 cluster size 10 vs true community sizes
    64-480 on the DD stand-in).  O(E log E) per round; converges when no
    admissible pair remains.
    """
    if backend in ("auto", "native"):
        lib = _cluster_lib()
        if lib is not None:
            rp64 = np.ascontiguousarray(row_pointers, dtype=np.int64)
            ci32 = _as_i32(column_index)
            out = np.empty(num_nodes, dtype=np.int32)
            rc = lib.hcspmm_cluster_labels(
                rp64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                _ptr(ci32), num_nodes, cap, rounds, _ptr(out))
            if rc == 0:
                return out.astype(np.int64)
        if backend == "native":
            raise RuntimeError("native cluster backend unavailable")
    rp = np.asarray(row_pointers, dtype=np.int64)
    ci = np.asarray(column_index, dtype=np.int64)
    n = num_nodes
    nnz = len(ci)
    e_row = np.empty(max(nnz, 1), dtype=np.int64)
    cnt = np.bincount(rp[1:n], minlength=max(nnz, 1))[: max(nnz, 1)]
    np.cumsum(cnt, out=e_row)
    e_row = e_row[:nnz]
    labels = np.arange(n, dtype=np.int64)
    big = np.int64(n) + 1
    # Coarse multigraph carried between rounds: (e_u, e_v, e_w) with
    # e_w = number of ORIGINAL edges between the two clusters.  Each
    # round dedups pairs (summing weights), which contracts the list
    # geometrically — pair weights are identical to recomputing from the
    # full edge list (the round-1 behaviour), so merges are bit-identical
    # to the uncontracted formulation, at ~one full-size sort total
    # instead of one per round (measured 27 s -> ~6 s of 42 at
    # PRODUCTS@0.25 scale).
    e_u = labels[e_row]
    e_v = labels[ci]
    e_w = np.ones(nnz, dtype=np.int64)
    import scipy.sparse as sp

    for rnd in range(rounds):
        m = e_u != e_v
        if not m.any():
            break
        # pair dedup (sum weights, rows ascending, partners ascending
        # within a row) via scipy's C++ COO->CSR — 5-10x the int64
        # argsort formulation at PRODUCTS scale (round-3 prep fix; the
        # reduceat logic below is unchanged, so merges stay
        # bit-identical to the sort-based rounds)
        k = int(max(e_u[m].max(), e_v[m].max())) + 1
        # int32 indices/weights halve the per-round memory traffic
        # (labels < n < 2^31; weights <= original nnz)
        a = sp.coo_matrix(
            (e_w[m].astype(np.int32),
             (e_u[m].astype(np.int32), e_v[m].astype(np.int32))),
            shape=(k, k)).tocsr()  # tocsr sums duplicate pairs
        a.sort_indices()
        w = a.data.astype(np.int64)
        plb = a.indices.astype(np.int64)
        row_nnz = np.diff(a.indptr)
        rows_ne = np.flatnonzero(row_nnz)
        pla = np.repeat(np.arange(k, dtype=np.int64), row_nnz)
        # the deduped pair list IS the next round's edge list
        e_u, e_v, e_w = pla, plb, w
        # best partner per row: max weight, ties -> smallest partner id
        gb = a.indptr[rows_ne].astype(np.int64)
        wmax = np.maximum.reduceat(w, gb)
        seg = np.repeat(np.arange(len(rows_ne)), row_nnz[rows_ne])
        cand = np.where(w == wmax[seg], plb, big)
        bestp = np.minimum.reduceat(cand, gb)
        who = rows_ne.astype(np.int64)
        sizes = np.bincount(labels, minlength=n)
        # hash-parity matching: clusters with bit 0 merge into their
        # best partner when it has bit 1 — no cycles or chains, exact
        # size accounting, ~half the desirable merges land per round.
        # (Mutual-best matching stalls on weight-1 ties: measured 228k
        # singletons left on the DD stand-in.)
        h = (np.arange(n, dtype=np.int64) * 2654435761 + rnd * 40503)
        bit = (h >> 13) & 1
        ok = (bit[who] == 0) & (bit[bestp] == 1) \
            & (sizes[who] + sizes[bestp] <= cap)
        if not ok.any():
            continue
        labmap = np.arange(n, dtype=np.int64)
        labmap[who[ok]] = bestp[ok]
        labels = labmap[labels]
        e_u = labmap[e_u]
        e_v = labmap[e_v]
    return labels


def _pack_groups(labels: np.ndarray, within_pos: np.ndarray,
                 num_nodes: int, band_h: int) -> np.ndarray:
    """Order nodes so each ``band_h``-row bin sees whole label groups:
    groups sorted by size descending, first-fit-decreasing into bins of
    ``band_h``-multiple capacity; exact-multiple bins lead so alignment
    survives.  ``within_pos`` orders members inside a group."""
    order = np.lexsort((within_pos, labels))
    lab_sorted = labels[order]
    gb = np.flatnonzero(np.concatenate(
        [[True], lab_sorted[1:] != lab_sorted[:-1]]))
    gsizes = np.diff(np.append(gb, num_nodes))
    gorder = np.argsort(-gsizes, kind="stable")
    # best-fit-decreasing with units bucketed by free capacity (always
    # < band_h after the ceil): O(G * band_h) instead of the O(G^2)
    # linear first-fit scan (measured 2.2 s at 100k+ groups)
    units: list = []
    free: list = []
    by_free: list = [[] for _ in range(band_h)]  # unit ids, LIFO
    for g in gorder:
        s = int(gsizes[g])
        u = None
        if s < band_h:
            for f in range(s, band_h):
                if by_free[f]:
                    u = by_free[f].pop()
                    break
        if u is None:
            units.append([g])
            f0 = -(-s // band_h) * band_h - s
            free.append(f0)
            if f0:
                by_free[f0].append(len(units) - 1)
        else:
            units[u].append(g)
            free[u] -= s
            if free[u]:
                by_free[free[u]].append(u)
    unit_rows = [
        sum(int(gsizes[g]) for g in u) for u in units
    ]
    layout = sorted(range(len(units)),
                    key=lambda u: (unit_rows[u] % band_h != 0, u))
    out = np.empty(num_nodes, dtype=np.int32)
    pos = 0
    for u in layout:
        for g in units[u]:
            s = int(gsizes[g])
            out[pos: pos + s] = order[gb[g]: gb[g] + s]
            pos += s
    return out


@profiling.spanned("format.reorder")
def cluster_reorder(row_pointers, column_index, num_nodes: int,
                    band_h: int = 256, iters: int = 30) -> np.ndarray:
    """Community-locality ordering for the banded path on *mixed*
    clustered graphs (DC-SBM / social networks), where RCM fails: a few
    percent of inter-community edges destroy BFS layering and RCM
    bandwidth blows up to O(N) even though ~all mass is block-local
    (measured: extent_q50 67k post-RCM on the DD stand-in whose
    communities are <=480 nodes).

    Label propagation discovers the communities; communities are packed
    whole into ``band_h`` bins (first-fit decreasing, as pack_reorder
    does with connected components); inside a community members keep
    their global-RCM relative order so multi-bin communities stay
    banded.  The mixing edges spill (format.plan band_spill).

    TPU-design note: this is the band-path analog of the reference's
    LOA objective (LOI.cpp:660-805 regroups rows for window density;
    here rows regroup for superwindow extent).
    """
    labels = _agglomerate_labels(row_pointers, column_index, num_nodes,
                                 rounds=iters)
    rcm = rcm_reorder(row_pointers, column_index, num_nodes)
    rcm_pos = np.empty(num_nodes, dtype=np.int64)
    rcm_pos[rcm] = np.arange(num_nodes)
    return _pack_groups(labels, rcm_pos, num_nodes, band_h)


@profiling.spanned("format.reorder")
def apply_permutation(row_pointers, column_index, num_nodes: int,
                      perm: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Relabel vertices: returns CSR of ``A[perm][:, perm]``.

    (The reference feeds its permutation back through text files and
    reloads, HC-SpMM_main.py:19 / LOI.cpp:853-891.)
    """
    import scipy.sparse as sp

    a = sp.csr_matrix(
        (np.ones(len(column_index), dtype=np.int8),
         _as_i32(column_index), _as_i32(row_pointers)),
        shape=(num_nodes, num_nodes),
    )
    a = a[perm][:, perm].tocsr()
    a.sort_indices()
    return a.indptr.astype(np.int32), a.indices.astype(np.int32)


def window_intensity(row_pointers, column_index, num_nodes: int,
                     window_h: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """Per-window (nnz, unique_cols) — the LOA objective report."""
    rp = _as_i32(row_pointers)
    ci = _as_i32(column_index)
    num_windows = (num_nodes + window_h - 1) // window_h
    lib = _build_lib()
    if lib is not None:
        nnz = np.empty(num_windows, dtype=np.int32)
        uniq = np.empty(num_windows, dtype=np.int32)
        rc = lib.window_stats(_ptr(rp), _ptr(ci), num_nodes, window_h,
                              _ptr(nnz), _ptr(uniq))
        if rc == 0:
            return nnz, uniq
    from hcspmm_tpu_torch.format.windows import analyze_windows

    wa = analyze_windows(rp, ci, num_nodes, window_h=window_h)
    return wa.edge_counts, wa.unique_counts
