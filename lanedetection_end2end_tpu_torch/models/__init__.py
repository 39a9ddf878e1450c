"""The port's modules: ERFNet, heads, LaneNet, the serving engine, the
backbone registry, weight init and the weight carrier."""

from lanedetection_end2end_tpu_torch.models.erfnet import ERFNet  # noqa: F401
from lanedetection_end2end_tpu_torch.models.heads import Classification  # noqa: F401
from lanedetection_end2end_tpu_torch.models.lanenet import (  # noqa: F401
    LaneNet, LaneNetOutput)
from lanedetection_end2end_tpu_torch.models.registry import (  # noqa: F401
    MODEL_REGISTRY, define_model)
from lanedetection_end2end_tpu_torch.models.init import init_weights  # noqa: F401
from lanedetection_end2end_tpu_torch.models.port import (  # noqa: F401
    state_dict_from_variables, variables_from_state_dict)
