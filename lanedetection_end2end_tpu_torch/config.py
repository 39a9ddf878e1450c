"""Configuration of the PyTorch port: the fields the serving path and the
e2e train step read.

Counterpart of `lanedetection_end2end_tpu/config.py`. The port keeps its own
copy (it never imports the JAX package), restricted to the flags that the e2e
forward, the e2e train step and the named presets read or set. Defaults
equal the JAX ones. There is no CLI parser yet.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LaneConfig:
    # "bev": normalized BEV coordinates; "bp": pixel coordinates
    profile: str = "bp"
    batch_size: int = 8
    nepochs: int = 500
    learning_rate: float = 1e-4
    nclasses: int = 2  # choices [2, 4]
    resize: int = 256  # image resized to (resize, 2*resize)
    pretrained: bool = False
    num_train: int = 3626
    flip_on: bool = False
    save_freq: int = 100

    # optimizer
    optimizer: str = "adam"  # adam | sgd | rmsprop
    weight_decay: float = 0.0
    clip_grad_norm: float = 0.0

    # fitting layer
    order: int = 2
    activation_layer: str = "square"
    reg_ls: float = 0.0
    mask_percentage: float = 0.3
    use_cholesky: bool = False  # inert: the solve is always spd_solve

    # loss / mode
    weight_seg: float = 30.0
    weight_class: float = 1.0
    weight_fit: float = 1.0
    loss_policy: str = "area"  # area | mse | backproject
    weight_funct: str = "none"  # none | linear | quadratic
    end_to_end: bool = True
    no_mapping: bool = False
    clas: bool = False

    compute_dtype: str = "float32"  # float32 | bfloat16: backbone compute
    seed: int = 0

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
