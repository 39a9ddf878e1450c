"""Training: optimizers, the train state, the steps, checkpoints and the
Trainer."""

from lanedetection_end2end_tpu_torch.train.optim import (  # noqa: F401
    Scheduler, define_optim)
from lanedetection_end2end_tpu_torch.train.state import TrainState  # noqa: F401
from lanedetection_end2end_tpu_torch.train.steps import (  # noqa: F401
    make_eval_step, make_train_step)
from lanedetection_end2end_tpu_torch.train.checkpoint import (  # noqa: F401
    latest_checkpoint_epoch, load_checkpoint, save_checkpoint)
from lanedetection_end2end_tpu_torch.train.driver import Trainer  # noqa: F401
