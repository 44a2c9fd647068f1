from hcspmm_tpu_torch.graphs.io import (  # noqa: F401
    load_edges_txt,
    load_edges_npz,
    save_edges_npz,
    synthetic_graph,
    to_csr,
)
from hcspmm_tpu_torch.graphs.dataset import GraphDataset  # noqa: F401
