"""Plain tensor ops and the hand-written kernel wrappers of the port.

K1's wrapper, the counterpart of JAX's `nb1d_fused`, is
`ops.nb1d.nb1d`: its name here would hide the module `ops.nb1d`."""

from lanedetection_end2end_tpu_torch.ops.activations import activation_fn  # noqa: F401
from lanedetection_end2end_tpu_torch.ops.wls import WLSFitter  # noqa: F401
from lanedetection_end2end_tpu_torch.ops.solve import spd_solve  # noqa: F401
from lanedetection_end2end_tpu_torch.ops.wls_moments import wls_moments  # noqa: F401
from lanedetection_end2end_tpu_torch.ops.nb1d import (  # noqa: F401
    fold_bn, nb1d_chain, pack_chain, pack_nb1d)
from lanedetection_end2end_tpu_torch.ops.losses import (  # noqa: F401
    BackprojectionLoss, area_loss, bce_with_logits, cross_entropy_logits,
    mse_params_loss, weighted_cross_entropy)
from lanedetection_end2end_tpu_torch.ops.metrics import trapezoidal_area  # noqa: F401
