"""Real (non-synthetic) datasets available without network access; port of
hcspmm_tpu/graphs/real.py.

- **digits-knn**: scikit-learn's bundled handwritten-digits set (1,797
  samples, real 64-dim pixel features, real 10-class labels) under the
  k-NN-graph construction GNN benchmarks use.
- **karate / lesmis / davis / florentine**: the classic real graphs shipped
  with networkx (Zachary's karate club, Les Miserables co-occurrence, Davis
  southern women, Florentine families).  Features follow the reference's
  convention (random normal, labels all-ones, dataset.py:109-121) since
  these graphs carry no feature matrix.

networkx and scikit-learn are imported when a graph is asked for, never
when this module is imported: a machine without them runs everything else
and raises ImportError naming the package for these graphs.

``write_reference_txt`` emits the reference's text format ("dst,src",
1-indexed, dataset.py:46-61).
"""

from __future__ import annotations

import importlib
import os
from typing import Tuple

import numpy as np

REAL_GRAPHS = ("karate", "lesmis", "davis", "florentine")


def _need(module: str, graph: str):
    try:
        return importlib.import_module(module)
    except ImportError as exc:
        raise ImportError(f"the real graph {graph!r} needs the package "
                          f"{module.split('.')[0]!r}, which is not installed") from exc


def networkx_edges(name: str) -> Tuple[np.ndarray, np.ndarray, int]:
    """Symmetric (src, dst, num_nodes) of a classic real graph."""
    if name not in REAL_GRAPHS:
        raise ValueError(f"unknown real graph {name!r}: one of {REAL_GRAPHS}")
    nx = _need("networkx", name)
    g = {
        "karate": nx.karate_club_graph,
        "lesmis": nx.les_miserables_graph,
        "davis": nx.davis_southern_women_graph,
        "florentine": nx.florentine_families_graph,
    }[name]()
    relabel = {v: i for i, v in enumerate(g.nodes())}
    e = np.array([(relabel[u], relabel[v]) for u, v in g.edges()], dtype=np.int32)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    return src, dst, g.number_of_nodes()


def digits_knn(k: int = 8) -> Tuple[np.ndarray, np.ndarray, int, np.ndarray, np.ndarray]:
    """k-NN graph over scikit-learn's real digits data.

    Returns (src, dst, num_nodes, x [N, 64] float32 real pixel features,
    y [N] int64 real class labels).  The graph is symmetrised (an edge in
    either direction keeps both), the reference's symmetric-A assumption
    (GNN_model.py:49-57)."""
    datasets = _need("sklearn.datasets", "digits-knn")
    neighbors = _need("sklearn.neighbors", "digits-knn")
    d = datasets.load_digits()
    x = d.data.astype(np.float32) / 16.0  # real 8x8 pixel intensities
    y = d.target.astype(np.int64)
    _, idx = neighbors.NearestNeighbors(n_neighbors=k + 1).fit(x).kneighbors(x)
    n = x.shape[0]
    src = np.repeat(np.arange(n, dtype=np.int32), k)
    dst = idx[:, 1:].reshape(-1).astype(np.int32)  # drop self
    return np.concatenate([src, dst]), np.concatenate([dst, src]), n, x, y


def write_reference_txt(path: str, src: np.ndarray, dst: np.ndarray) -> None:
    """Emit the reference's edge-list text format: one "dst,src" pair per
    line, 1-indexed (dataset.py:46-61)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for d, s in zip(dst, src):
            f.write(f"{int(d) + 1},{int(s) + 1}\n")
