"""Configuration of the PyTorch port: every flag of the reference CLI.

Counterpart of `lanedetection_end2end_tpu/config.py`, kept as the port's
own copy (it never imports the JAX package): the same `LaneConfig` fields
with the same defaults, the presets (`bp_defaults`, `bev_defaults`,
`train_sh_config`), the argparse surface (`build_parser` /
`config_from_args`, with the reference's str2bool convention), the staged
schedule (`phase_for_epoch`) and the run naming (`save_id`). The port has
no environment knobs, so `save_id` appends none.

Fields that select what the port does not run yet (more than one device)
are accepted here and refused with NotImplementedError where a Trainer
would act on them (`train/driver.py`). `no_cuda` is how a caller asks for
the CPU (`torch_device`). The Pallas switches are kept for the CLI:
`packed_train` None and True train the e2e phase on the port's kernels,
False on the plain graph (`LaneNet.forward`, as JAX's flax graph); None
takes the plain graph where the kernels do not serve the config (the
learned homography), and True raises there (`train/steps.py`);
`use_pallas_wls` None and True select the port's moments kernel, False
(the JAX package's XLA moments) is refused.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from lanedetection_end2end_tpu_torch.device import resolve_device


def str2bool(argument: str) -> bool:
    """Boolean CLI convention of the reference."""
    if argument.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if argument.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(
        "Wrong argument in argparse, should be a boolean")


@dataclass(frozen=True)
class LaneConfig:
    # ---- profile: "bev" normalized BEV coordinates, "bp" pixels ----
    profile: str = "bp"

    # ---- segmentation model settings ----
    dataset: str = "lane_detection"
    batch_size: int = 8
    val_batch_size: Optional[int] = None
    nepochs: int = 500
    learning_rate: float = 1e-4
    no_cuda: bool = False  # True: run on the CPU (torch_device)
    nworkers: int = 8
    no_dropout: bool = False
    nclasses: int = 2  # choices [2, 4]
    crop_size: int = 80
    resize: int = 256  # image resized to (resize, 2*resize)
    mod: str = "erfnet"
    layers: int = 18
    pool: bool = True
    draw_testset: bool = False
    pretrained: bool = False
    pretrain_epochs: int = 20
    skip_epochs: int = 10
    channels_in: int = 3
    norm: str = "batch"
    flip_on: bool = False
    num_train: int = 3626
    split_percentage: float = 0.2
    test_mode: bool = False
    start_epoch: int = 0
    evaluate: bool = False
    resume: str = ""

    # ---- optimizer settings ----
    optimizer: str = "adam"  # adam | sgd | rmsprop
    weight_init: str = "kaiming"  # normal | xavier | kaiming | orthogonal
    weight_decay: float = 0.0
    lr_decay: bool = False
    niter: int = 50
    niter_decay: int = 400
    lr_policy: Optional[str] = None  # lambda | step | plateau | none
    lr_decay_iters: int = 30
    clip_grad_norm: float = 0.0

    # ---- fitting layer settings ----
    order: int = 2
    activation_layer: str = "square"
    reg_ls: float = 0.0
    no_ortho: bool = False
    mask_percentage: float = 0.3
    use_cholesky: bool = False  # inert: the solve is always spd_solve
    activation_net: str = "relu"

    # ---- paths ----
    image_dir: str = ""
    gt_dir: str = ""
    test_dir: str = ""
    save_path: str = "Saved/"
    json_file: str = "Labels/Curve_parameters.json"

    # ---- loss settings ----
    weight_seg: float = 30.0
    weight_class: float = 1.0
    weight_fit: float = 1.0
    loss_policy: str = "area"  # area | mse | backproject
    weight_funct: str = "none"  # none | linear | quadratic
    end_to_end: bool = True
    no_mapping: bool = False
    gamma: float = 0.0
    clas: bool = False

    # ---- parity-only flags of the reference ----
    cudnn: bool = True
    no_tb: bool = True
    print_freq: int = 500
    save_freq: int = 100
    skip_list: List[int] = field(default_factory=lambda: [954, 2789])

    # ---- additions of the JAX package ----
    compute_dtype: str = "float32"  # float32 | bfloat16: backbone compute
    num_devices: int = 0  # 0 = every local device; the port runs one
    num_slices: int = 1
    prefetch: int = 2  # batches copied to the card ahead of the step
    seed: int = 0
    use_pallas_wls: Optional[bool] = None  # False refused by the Trainer
    packed_train: Optional[bool] = None    # False: e2e on LaneNet.forward
    learn_homography: bool = False
    val_laneeval: bool = False  # LaneEval-score the validation split (bp)

    def __post_init__(self):
        if self.profile not in ("bev", "bp"):
            raise ValueError(f"unknown profile {self.profile!r}")
        if self.nclasses not in (2, 4):
            raise ValueError("nclasses must be 2 or 4")
        if not self.end_to_end and self.pretrained:
            raise ValueError("pretrained requires end_to_end")
        if self.clas and self.nclasses != 4:
            raise ValueError("classification branches require nclasses == 4")
        if self.order not in (0, 1, 2, 3):
            raise ValueError("polynomial order must be in 0..3")
        if self.profile == "bev" and self.order == 3:
            raise ValueError("order 3 is only supported by the 'bp' profile")
        if self.learn_homography and (self.profile != "bp"
                                      or self.no_mapping):
            raise ValueError("learn_homography requires the 'bp' profile "
                             "with a real (non-identity) homography")

    @property
    def effective_val_batch_size(self) -> int:
        return self.val_batch_size if self.val_batch_size else self.batch_size

    @property
    def image_height(self) -> int:
        return self.resize

    @property
    def image_width(self) -> int:
        return 2 * self.resize

    @property
    def seg_out_channels(self) -> int:
        """Decoder output channels: nclasses (+1 background when
        seg-pretraining)."""
        return self.nclasses + int(not self.end_to_end)

    @property
    def out_channels(self) -> int:
        """Channels of the decoder head the e2e phase reads."""
        return self.nclasses if self.pretrained else self.seg_out_channels

    @property
    def save_id(self) -> str:
        """The run directory's name, per profile, as the reference names
        it."""
        if self.profile == "bev":
            return (
                "Mod_{}_opt_{}_loss_{}_lr_{}_batch_{}_end2end_{}_lanes_{}"
                "_resize_{}_pretrain{}_clas{}".format(
                    self.mod, self.optimizer, self.loss_policy,
                    self.learning_rate, self.batch_size, self.end_to_end,
                    self.nclasses, self.resize, self.pretrained, self.clas))
        return (
            "Mod_{}_opt_{}_loss_{}_lr_{}_batch_{}_end2end_{}_chol_{}"
            "_lanes_{}_pretrain{}_clas{}_mask{}_flip_on{}_activation_{}"
            .format(
                self.mod, self.optimizer, self.loss_policy,
                self.learning_rate, self.batch_size, self.end_to_end,
                self.use_cholesky, self.nclasses, self.pretrained,
                self.clas, self.mask_percentage, self.flip_on,
                self.activation_layer))

    def replace(self, **kw) -> "LaneConfig":
        return dataclasses.replace(self, **kw)

    def phase_for_epoch(self, epoch: int) -> str:
        """'skip' | 'seg' | 'e2e' for an epoch of the staged schedule."""
        if self.pretrained:
            if epoch < self.pretrain_epochs:
                if self.profile == "bp" and epoch < self.skip_epochs:
                    return "skip"
                return "seg"
            return "e2e"
        return "e2e" if self.end_to_end else "seg"

    def torch_device(self) -> torch.device:
        """The CPU where `no_cuda`, else the current card (RuntimeError
        without one)."""
        return resolve_device("cpu" if self.no_cuda else None)


def bev_defaults(**kw) -> LaneConfig:
    """Defaults of the Birds_Eye_View_Loss tree CLI."""
    base = dict(profile="bev", nepochs=350, num_train=2535, save_freq=500,
                test_dir="")
    base.update(kw)
    return LaneConfig(**base)


def bp_defaults(**kw) -> LaneConfig:
    """Defaults of the Backprojection_Loss tree CLI."""
    base = dict(profile="bp", nepochs=500, num_train=3626, save_freq=100)
    base.update(kw)
    return LaneConfig(**base)


def train_sh_config(**kw) -> LaneConfig:
    """The canonical multi-lane configuration of Backprojection_Loss/train.sh:
    backproject loss, 4 lanes, order 3, line and horizon heads, no
    pretraining, 20% top-row mask."""
    base = dict(profile="bp", loss_policy="backproject", nclasses=4, order=3,
                clas=True, pretrained=False, mask_percentage=0.20,
                flip_on=True, num_train=3626, end_to_end=True)
    base.update(kw)
    return LaneConfig(**base)


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------

# flags that take the str2bool convention; `--no_cuda` also stands alone
_BOOL_STR_FLAGS = {
    "pool", "draw_testset", "pretrained", "flip_on", "use_cholesky",
    "end_to_end", "no_mapping", "clas", "cudnn", "no_tb", "use_pallas_wls",
    "packed_train", "learn_homography", "val_laneeval", "no_cuda",
}
_STORE_TRUE_FLAGS = {
    "no_dropout", "test_mode", "evaluate", "lr_decay", "no_ortho",
}


def build_parser(profile: str = "bp") -> argparse.ArgumentParser:
    """argparse parser mirroring the reference `define_args`."""
    defaults = bev_defaults() if profile == "bev" else bp_defaults()
    parser = argparse.ArgumentParser(description="Lane_detection_all_objectives")
    parser.add_argument("--profile", type=str, default=profile,
                        choices=["bev", "bp"])
    for f in dataclasses.fields(LaneConfig):
        if f.name in ("profile", "skip_list"):
            continue
        flag = "--" + f.name
        default = getattr(defaults, f.name)
        if f.name in _BOOL_STR_FLAGS:
            parser.add_argument(flag, type=str2bool, nargs="?", const=True,
                                default=default)
        elif f.name in _STORE_TRUE_FLAGS:
            parser.add_argument(flag, action="store_true", default=default)
        elif f.name == "val_batch_size":
            parser.add_argument(flag, type=int, default=None)
        elif f.name == "lr_policy":
            parser.add_argument(flag, type=str, default=default)
        else:
            parser.add_argument(flag, type=type(default) if default is not None
                                else str, default=default)
    parser.add_argument("--list", dest="skip_list", type=int, nargs="+",
                        default=[954, 2789],
                        help="Images you want to skip")
    return parser


def config_from_args(argv=None, profile: str = "bp") -> LaneConfig:
    parser = build_parser(profile)
    kw = vars(parser.parse_args(argv))
    prof = kw.pop("profile")
    base = bev_defaults() if prof == "bev" else bp_defaults()
    merged = dataclasses.asdict(base)
    merged.update({k: v for k, v in kw.items()
                   if v is not None or k == "lr_policy"})
    merged["val_batch_size"] = kw.get("val_batch_size")
    merged["profile"] = prof
    return LaneConfig(**merged)
