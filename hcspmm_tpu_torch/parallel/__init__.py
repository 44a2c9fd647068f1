"""Row-partitioned distributed SpMM over torch.distributed (port of
hcspmm_tpu/parallel)."""
