"""hcspmm_tpu_torch — the PyTorch and CUDA port of hcspmm_tpu for one
NVIDIA H100 (Hopper).

It keeps hcspmm_tpu's module layout and public names and imports neither
JAX nor hcspmm_tpu:

- ``graphs``  : graph loading, CSR building, datasets (NumPy).
- ``format``  : window analysis, LOI selector, execution plans, reordering
                (NumPy host side carried from hcspmm_tpu, so both packages
                build identical plans).
- ``native``  : the package's copy of the C++ host passes (window analysis,
                LOA and cluster reordering), compiled with g++ at first use.
- ``kernels`` : hand-written CUDA kernels (``csrc/``), built with nvcc at
                first use, each beside its plain PyTorch version.
- ``ops``     : the differentiable SpMM (``torch.autograd.Function``) and
                the layer strategies.
- ``models``  : GCN / GIN / SAGE layers and networks, the SAG profiler.
- ``parallel``: the row-partitioned distributed SpMM over
                ``torch.distributed`` (sharded plans, one per rank).
- ``train``   : training loop, command line, elastic restart.
- ``utils``   : logging, checkpoints (the JAX package's npz format),
                profiling.
"""

__version__ = "0.1.0"

from hcspmm_tpu_torch.config import BLK_H, BLK_W, HCSpMMConfig, PlanConfig  # noqa: F401
