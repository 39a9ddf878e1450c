from lanedetection_end2end_tpu_torch.utils.observability import (  # noqa: F401
    AverageMeter, Logger, first_run, mkdir_if_missing, write_run_marker)
