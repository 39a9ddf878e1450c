"""TuSimple evaluation: LaneEval, the backprojection of fitted curves and
the test-set driver."""

from lanedetection_end2end_tpu_torch.eval.lane_eval import LaneEval  # noqa: F401
from lanedetection_end2end_tpu_torch.eval.projections import Projections  # noqa: F401
from lanedetection_end2end_tpu_torch.eval.results import write_lsq_results  # noqa: F401
from lanedetection_end2end_tpu_torch.eval.test_driver import test_model  # noqa: F401
