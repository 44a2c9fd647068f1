from hcspmm_tpu_torch.utils.logging import MetricLogger  # noqa: F401
