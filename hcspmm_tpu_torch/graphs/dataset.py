"""Graph dataset container (reference: dataset.py:8-121 `HCSPMM_dataset`).

Parity notes:
- node features are random normal ``[N, dim]`` (dataset.py:114);
- labels are all-ones int64 (dataset.py:121);
- masks are overlapping prefixes with train=100%, val=30%, test=10%
  (dataset.py:33-41);
- sqrt-degree array is computed but unused by the reference kernels
  (dataset.py:106-107); we keep it for the optional normalized mode;
- stats: ``avg_degree`` and ``avg_edgeSpan`` (dataset.py:84-85).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from hcspmm_tpu_torch.config import degree_clamp
from hcspmm_tpu_torch.graphs import io


@dataclasses.dataclass
class GraphDataset:
    num_nodes: int
    num_edges: int
    row_pointers: np.ndarray  # int32 [N+1]
    column_index: np.ndarray  # int32 [nnz]
    x: np.ndarray             # float32 [N, dim]
    y: np.ndarray             # int64 [N]
    num_features: int = 0
    num_classes: int = 0
    train_mask: Optional[np.ndarray] = None
    val_mask: Optional[np.ndarray] = None
    test_mask: Optional[np.ndarray] = None
    degrees_sqrt: Optional[np.ndarray] = None
    avg_degree: float = -1.0
    avg_edge_span: float = -1.0
    load_seconds: float = 0.0

    @classmethod
    def from_edges(
        cls,
        src: np.ndarray,
        dst: np.ndarray,
        num_nodes: int,
        dim: int,
        num_classes: int,
        seed: int = 0,
        t0: float = 0.0,
    ) -> "GraphDataset":
        row_ptr, col_idx = io.to_csr(src, dst, num_nodes)
        num_edges = len(src)

        rng = np.random.RandomState(seed)
        x = rng.randn(num_nodes, dim).astype(np.float32)
        y = np.ones(num_nodes, dtype=np.int64)

        # degree_clamp mirrors config.py:5-9 `func` (clamp to >= 1), vectorized
        deg = np.maximum(np.diff(row_ptr), degree_clamp(0))
        degrees_sqrt = np.sqrt(deg.astype(np.float32))

        def prefix_mask(frac: float) -> np.ndarray:
            m = np.zeros(num_nodes, dtype=bool)
            m[: int(num_nodes * frac)] = True
            return m

        return cls(
            num_nodes=num_nodes,
            num_edges=num_edges,
            row_pointers=row_ptr,
            column_index=col_idx,
            x=x,
            y=y,
            num_features=dim,
            num_classes=num_classes,
            train_mask=prefix_mask(1.0),
            val_mask=prefix_mask(0.3),
            test_mask=prefix_mask(0.1),
            degrees_sqrt=degrees_sqrt,
            avg_degree=num_edges / num_nodes,
            avg_edge_span=float(np.mean(np.abs(src.astype(np.int64) - dst))),
            load_seconds=time.perf_counter() - t0 if t0 else 0.0,
        )

    @classmethod
    def from_txt(cls, path: str, dim: int, num_classes: int, seed: int = 0) -> "GraphDataset":
        t0 = time.perf_counter()
        src, dst, n = io.load_edges_txt(path)
        return cls.from_edges(src, dst, n, dim, num_classes, seed, t0)

    @classmethod
    def from_npz(cls, path: str, dim: int, num_classes: int, seed: int = 0) -> "GraphDataset":
        t0 = time.perf_counter()
        src, dst, n = io.load_edges_npz(path)
        return cls.from_edges(src, dst, n, dim, num_classes, seed, t0)

    @classmethod
    def from_file(cls, path: str, dim: int, num_classes: int,
                  seed: int = 0) -> "GraphDataset":
        """Any supported adjacency format (io.load_edges_any): reference
        txt/npz, ogb edge_index npz/npy, scipy CSR npz, ogb raw dir."""
        t0 = time.perf_counter()
        src, dst, n = io.load_edges_any(path)
        return cls.from_edges(src, dst, n, dim, num_classes, seed, t0)

    @classmethod
    def real(cls, name: str, dim: int = 0, num_classes: int = 0,
             seed: int = 0) -> "GraphDataset":
        """The JAX package's bundled real graphs (hcspmm_tpu.graphs.real)
        need networkx and scikit-learn; not ported yet (ROADMAP A.8)."""
        raise NotImplementedError(
            f"real dataset {name!r}: graphs/real.py is not ported yet "
            "(ROADMAP A.8)")

    @classmethod
    def synthetic(
        cls,
        num_nodes: int,
        avg_degree: float,
        dim: int,
        num_classes: int,
        seed: int = 0,
        **kwargs,
    ) -> "GraphDataset":
        t0 = time.perf_counter()
        src, dst, n = io.synthetic_graph(num_nodes, avg_degree, seed=seed, **kwargs)
        return cls.from_edges(src, dst, n, dim, num_classes, seed, t0)

    @property
    def nnz(self) -> int:
        """Number of stored CSR entries (duplicates merged)."""
        return int(self.row_pointers[-1])

    def permuted(self, perm: np.ndarray) -> "GraphDataset":
        """Vertex relabeling: graph, features, labels, masks all follow
        ``perm[new_id] = old_id`` (the reference round-trips this through
        reorder_direct.txt, LOI.cpp:853-891)."""
        import dataclasses as _dc

        from hcspmm_tpu_torch.format.reorder import apply_permutation

        rp, ci = apply_permutation(
            self.row_pointers, self.column_index, self.num_nodes, perm
        )
        take = lambda a: None if a is None else a[perm]
        return _dc.replace(
            self,
            row_pointers=rp,
            column_index=ci,
            x=self.x[perm],
            y=self.y[perm],
            train_mask=take(self.train_mask),
            val_mask=take(self.val_mask),
            test_mask=take(self.test_mask),
            degrees_sqrt=take(self.degrees_sqrt),
        )

    def dense_adjacency(self) -> np.ndarray:
        """Binary dense adjacency for oracle tests (small graphs only)."""
        a = np.zeros((self.num_nodes, self.num_nodes), dtype=np.float32)
        for r in range(self.num_nodes):
            a[r, self.column_index[self.row_pointers[r]: self.row_pointers[r + 1]]] = 1.0
        return a
