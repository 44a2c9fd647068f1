from hcspmm_tpu_torch.ops.spmm import HybridSpMM, make_spmm, spmm_reference_dense  # noqa: F401
from hcspmm_tpu_torch.ops.fused import aggregate_then_update, update_then_aggregate  # noqa: F401
