from hcspmm_tpu_torch.ops.spmm import (  # noqa: F401
    HybridSpMM,
    RowLayout,
    TbandLayout,
    WideLayout,
    spmm_reference_dense,
)
