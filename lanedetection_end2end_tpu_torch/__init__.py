"""PyTorch + CUDA port of lanedetection_end2end_tpu.

See README.md, section "PyTorch port". The package and its sub-packages
export the names of the JAX package's `__init__.py` files where the port
has the counterpart; where a JAX name means nothing here the port's own
stands in its place: `models.state_dict_from_variables` /
`variables_from_state_dict` for `port_torch_state_dict` /
`load_into_variables`, `ops.nb1d.nb1d` for `ops.nb1d_fused`, and
`parallel`'s `DataParallel`, `init_data_parallel`, `replicate` and
`local_rows` for the mesh helpers (`make_mesh`, `shard_batch`, ...).
Importing the package builds no CUDA library: a kernel's library is built
by the first call that launches it.
"""

__version__ = "0.1.0"

from lanedetection_end2end_tpu_torch.config import (  # noqa: F401
    LaneConfig, bev_defaults, bp_defaults, config_from_args, train_sh_config)
from lanedetection_end2end_tpu_torch.ops import (  # noqa: F401
    BackprojectionLoss, WLSFitter, activation_fn, area_loss, bce_with_logits,
    cross_entropy_logits, mse_params_loss, trapezoidal_area,
    weighted_cross_entropy)
from lanedetection_end2end_tpu_torch.models import (  # noqa: F401
    Classification, ERFNet, LaneNet, LaneNetOutput, define_model,
    init_weights)
