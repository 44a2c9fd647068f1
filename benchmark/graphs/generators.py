"""The benchmark's graph generators: a frozen NumPy copy of the port's
``graphs/io.py`` (``to_csr``, ``synthetic_blocks``, ``synthetic_powerlaw``,
``synthetic_dcsbm``, ``reference_standin`` and the tables they read).

A cell's graph is its traffic, so the yardstick keeps its own copy: a
change to the program's generators cannot change what the benchmark runs.
``benchmark/tests/test_bench_graphs.py`` holds the copy equal, array for
array, to the port's at a small scale and at the cells' parameters.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp


def to_csr(
    src: np.ndarray, dst: np.ndarray, num_nodes: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Build CSR over rows=src, cols=dst with duplicate edges merged.

    Matches dataset.py:93-103 (coo with val=1 -> tocsr; the kernels never
    read values, so duplicate merging only removes repeat accumulation).
    Returns (row_pointers int32 [N+1], column_index int32 [nnz]).
    """
    coo = sp.coo_matrix(
        (np.ones(len(src), dtype=np.int8), (src, dst)),
        shape=(num_nodes, num_nodes),
    )
    csr = coo.tocsr()
    csr.sum_duplicates()
    return csr.indptr.astype(np.int32), csr.indices.astype(np.int32)


def synthetic_blocks(
    num_nodes: int,
    avg_degree: float,
    block_size: int = 300,
    seed: int = 0,
    shuffle: bool = True,
    symmetric: bool = True,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Block-diagonal community graph — the structure of the reference's
    molecular datasets (DD/PROTEINS/Yeast are unions of small disjoint
    graphs, report Table II), which is what makes them locality-friendly.

    ``shuffle=True`` scrambles vertex ids so the locality is *latent*:
    layout reordering (format.reorder LOA/RCM) has to rediscover it, as it
    would on real downloads.
    """
    rng = np.random.RandomState(seed)
    num_blocks = max(1, num_nodes // block_size)
    bounds = np.linspace(0, num_nodes, num_blocks + 1).astype(np.int64)
    sizes = np.diff(bounds)
    num_edges = int(num_nodes * avg_degree) // (2 if symmetric else 1)
    # edges per block proportional to its size
    counts = rng.multinomial(num_edges, sizes / sizes.sum())
    src_parts, dst_parts = [], []
    for b, cnt in enumerate(counts):
        if cnt == 0 or sizes[b] < 2:
            continue
        lo, hi = bounds[b], bounds[b + 1]
        src_parts.append(rng.randint(lo, hi, size=cnt))
        dst_parts.append(rng.randint(lo, hi, size=cnt))
    src = np.concatenate(src_parts)
    dst = np.concatenate(dst_parts)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if shuffle:
        perm = rng.permutation(num_nodes)
        src, dst = perm[src], perm[dst]
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    return src.astype(np.int32), dst.astype(np.int32), num_nodes


# Reference report Table II (BASELINE.md): vertex/edge counts of the
# headline power-law graphs.  Dataset.zip is a missing large blob in the
# snapshot and this rig has no network egress, so benchmarks build
# size-matched power-law stand-ins via ``synthetic_powerlaw`` (documented
# divergence: degree *quantiles* follow a Chung-Lu alpha=2.5 tail, the
# typical social/web-graph exponent, rather than the unpublished true
# distributions; N, E, and dim match Table II exactly).
REFERENCE_GRAPHS = {
    # all 13 report Table II rows (BASELINE.md)
    "CS": dict(num_nodes=3_327, num_edges=9_464, dim=3703),
    "CR": dict(num_nodes=2_708, num_edges=10_858, dim=1433),
    "PM": dict(num_nodes=19_717, num_edges=88_676, dim=500),
    "PT": dict(num_nodes=43_471, num_edges=162_088, dim=29),
    "DD": dict(num_nodes=334_925, num_edges=1_686_092, dim=89),
    "AZ": dict(num_nodes=410_236, num_edges=3_356_824, dim=96),
    "YS": dict(num_nodes=1_710_902, num_edges=3_636_546, dim=74),
    "OC": dict(num_nodes=1_889_542, num_edges=3_946_402, dim=66),
    "GH": dict(num_nodes=1_448_038, num_edges=5_971_562, dim=64),
    "YH": dict(num_nodes=3_138_114, num_edges=6_487_230, dim=75),
    "RD": dict(num_nodes=4_859_280, num_edges=10_149_830, dim=96),
    "TT": dict(num_nodes=3_771_081, num_edges=22_011_034, dim=96),
    "DP": dict(num_nodes=18_268_981, num_edges=172_183_984, dim=96),
    # ogbn scale stand-ins (BASELINE.json configs; public statistics)
    "ARXIV": dict(num_nodes=169_343, num_edges=1_166_243, dim=128),
    "PRODUCTS": dict(num_nodes=2_449_029, num_edges=61_859_140, dim=100),
}


def synthetic_powerlaw(
    num_nodes: int,
    avg_degree: float,
    exponent: float = 2.5,
    seed: int = 0,
    symmetric: bool = True,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Chung-Lu power-law graph: endpoint probability ∝ rank^(-1/(α-1)),
    giving a degree distribution with tail exponent ≈ ``exponent``.

    This is the reference's *headline* regime (report §V-B: only 15-22%
    of row windows are TC-suitable on such graphs) and is non-bandable by
    construction: vertex ids are scrambled and hubs touch every region,
    so RCM bandwidth is O(N) and the band path must rely on robust
    window placement + spill (format.plan ``band_spill='auto'``) rather
    than full-extent coverage.
    """
    rng = np.random.RandomState(seed)
    num_edges = int(num_nodes * avg_degree) // (2 if symmetric else 1)
    gamma = 1.0 / (exponent - 1.0)
    w = np.arange(1, num_nodes + 1, dtype=np.float64) ** (-gamma)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    src = np.searchsorted(cdf, rng.random_sample(num_edges)).astype(np.int64)
    dst = np.searchsorted(cdf, rng.random_sample(num_edges)).astype(np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # scramble ids: degree rank must not correlate with vertex id, or the
    # hub rows would be trivially groupable without LOA
    perm = rng.permutation(num_nodes)
    src, dst = perm[src], perm[dst]
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    return src.astype(np.int32), dst.astype(np.int32), num_nodes


def synthetic_dcsbm(
    num_nodes: int,
    avg_degree: float,
    exponent: float = 2.5,
    mixing: float = 0.3,
    comm_min: int = 16,
    comm_max: int = 512,
    comm_exponent: float = 1.8,
    seed: int = 0,
    symmetric: bool = True,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Degree-corrected stochastic block model: a power-law degree tail
    (Chung-Lu weights, tail exponent ``exponent``) PLUS community
    structure (sizes ~ truncated power law in [comm_min, comm_max],
    exponent ``comm_exponent``; a ``mixing`` fraction of edge endpoints
    fall outside the community).

    Why this exists: real power-law graphs (the reference's RD/TT/AZ
    headliners, report Table II) are clustered — that is why 15-22% of
    their 16-row windows are TC-suitable (report §V-B, Fig. 8) and why
    the hybrid design pays off.  A pure Chung-Lu graph has clustering
    coefficient ~0 and measures **0%** TC-suitable windows — an
    adversarial lower bound, not a stand-in.  This generator restores
    the clustered component; ``tools/standin_fidelity.py`` checks a
    stand-in against the reference anchors (degree quantiles, TC-window
    fraction, non-bandability).  Vertex ids are scrambled, so layout
    reordering (LOA/RCM) must rediscover the communities exactly as it
    must on the real downloads.
    """
    rng = np.random.RandomState(seed)
    num_edges = int(num_nodes * avg_degree) // (2 if symmetric else 1)

    # community sizes: truncated power law; node -> community contiguous
    # in a hidden id space (scrambled at the end)
    n_draw = max(2 * num_nodes // comm_min, 4)
    u = rng.random_sample(n_draw)
    a1 = 1.0 - comm_exponent
    sizes = ((comm_min ** a1 + u * (comm_max ** a1 - comm_min ** a1))
             ** (1.0 / a1)).astype(np.int64)
    csz = np.cumsum(sizes)
    k = int(np.searchsorted(csz, num_nodes))
    sizes = sizes[: k + 1]
    sizes[-1] = num_nodes - (csz[k - 1] if k else 0)
    if sizes[-1] <= 0:
        sizes = sizes[:-1]
    comm_start = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    ncomm = len(sizes)

    # Chung-Lu weights assigned to hidden ids in random rank order
    gamma = 1.0 / (exponent - 1.0)
    w = np.arange(1, num_nodes + 1, dtype=np.float64) ** (-gamma)
    w = w[rng.permutation(num_nodes)]
    cumw = np.concatenate([[0.0], np.cumsum(w)])

    # endpoint 1: global Chung-Lu draw (sets the degree distribution)
    src = np.searchsorted(cumw, rng.random_sample(num_edges) * cumw[-1],
                          side="right").astype(np.int64) - 1
    np.clip(src, 0, num_nodes - 1, out=src)
    # endpoint 2: with prob 1-mixing from src's community (w-proportional
    # within the community slice), else a global draw
    comm_of = np.repeat(np.arange(ncomm, dtype=np.int64), sizes)
    c = comm_of[src]
    lo_w = cumw[comm_start[c]]
    hi_w = cumw[comm_start[c + 1]]
    local = rng.random_sample(num_edges) >= mixing
    target = np.where(
        local,
        lo_w + rng.random_sample(num_edges) * (hi_w - lo_w),
        rng.random_sample(num_edges) * cumw[-1],
    )
    dst = np.searchsorted(cumw, target, side="right").astype(np.int64) - 1
    np.clip(dst, 0, num_nodes - 1, out=dst)

    keep = src != dst
    src, dst = src[keep], dst[keep]
    perm = rng.permutation(num_nodes)
    src, dst = perm[src], perm[dst]
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    return src.astype(np.int32), dst.astype(np.int32), num_nodes


# Stand-in structure parameters per reference graph, calibrated with
# tools/standin_fidelity.py against the report's anchors: TC-suitable
# window fraction 15-22% on representative graphs (§V-B Fig. 8) and the
# degree-tail shape.  DD is a union of small disjoint protein graphs
# (avg component ~280 nodes), hence tiny communities and low mixing.
STANDIN_STRUCTURE = {
    # DD is a union of ~disjoint small protein graphs (Table II; avg
    # component ~280 nodes): near-zero mixing, RCM/pack can band it —
    # the band path's home regime (round-1 headline config).
    "DD": dict(kind="dcsbm", mixing=0.02, comm_min=64, comm_max=480),
    # citation graphs: moderate clustering, small communities
    "CS": dict(kind="dcsbm", mixing=0.20, comm_min=8, comm_max=64),
    "CR": dict(kind="dcsbm", mixing=0.20, comm_min=8, comm_max=64),
    "PM": dict(kind="dcsbm", mixing=0.25, comm_min=8, comm_max=128),
    # molecule-union datasets like DD (TUDataset unions of small
    # disjoint graphs): near-zero mixing, small components
    "PT": dict(kind="dcsbm", mixing=0.02, comm_min=16, comm_max=128),
    "YS": dict(kind="dcsbm", mixing=0.02, comm_min=16, comm_max=128),
    "OC": dict(kind="dcsbm", mixing=0.02, comm_min=16, comm_max=128),
    "YH": dict(kind="dcsbm", mixing=0.02, comm_min=16, comm_max=128),
    # social / web graphs: hub-heavy, high mixing
    "GH": dict(kind="dcsbm", mixing=0.35, comm_min=16, comm_max=512),
    "DP": dict(kind="dcsbm", mixing=0.30, comm_min=16, comm_max=512),
    "AZ": dict(kind="dcsbm", mixing=0.25, comm_min=16, comm_max=256),
    "RD": dict(kind="dcsbm", mixing=0.30, comm_min=16, comm_max=512),
    "TT": dict(kind="dcsbm", mixing=0.30, comm_min=16, comm_max=512),
    "ARXIV": dict(kind="dcsbm", mixing=0.30, comm_min=16, comm_max=256),
    "PRODUCTS": dict(kind="dcsbm", mixing=0.30, comm_min=16, comm_max=512),
}


def reference_standin(
    key: str, seed: int = 0, scale: float = 1.0, kind: str = "auto"
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Size-matched stand-in for a reference Table II graph.

    ``kind``: 'auto' uses the calibrated clustered model
    (STANDIN_STRUCTURE, degree-corrected SBM); 'chunglu' forces the
    unclustered pure power-law graph — the adversarial no-locality
    lower bound where no reordering can create dense windows.

    Returns (src, dst, num_nodes, feature_dim).  ``scale`` < 1 shrinks
    N and E together (degree structure preserved) for memory-limited
    runs; results must then be labeled with the scale used.
    """
    g = REFERENCE_GRAPHS[key.upper()]
    n = int(g["num_nodes"] * scale)
    e = int(g["num_edges"] * scale)
    st = STANDIN_STRUCTURE.get(key.upper(), {"kind": "chunglu"})
    if kind == "chunglu" or st.get("kind") == "chunglu":
        src, dst, _ = synthetic_powerlaw(
            n, avg_degree=e / n, seed=seed, symmetric=True
        )
    else:
        src, dst, _ = synthetic_dcsbm(
            n, avg_degree=e / n, seed=seed, symmetric=True,
            mixing=st["mixing"], comm_min=st["comm_min"],
            comm_max=st["comm_max"],
        )
    return src, dst, n, g["dim"]

