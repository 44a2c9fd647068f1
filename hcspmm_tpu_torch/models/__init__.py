from hcspmm_tpu_torch.models.layers import GCNConv, GINConv, init_conv_params  # noqa: F401
from hcspmm_tpu_torch.models.net import Net, init_net_params, net_forward  # noqa: F401
from hcspmm_tpu_torch.models.sag import SAG  # noqa: F401
