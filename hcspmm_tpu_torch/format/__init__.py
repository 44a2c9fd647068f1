from hcspmm_tpu_torch.format.windows import WindowAnalysis, analyze_windows  # noqa: F401
from hcspmm_tpu_torch.format.loi import decide_hybrid_type, loi_score  # noqa: F401
from hcspmm_tpu_torch.format.plan import ExecutionPlan, build_plan  # noqa: F401
