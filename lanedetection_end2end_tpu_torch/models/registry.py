"""Backbone registry.

Counterpart of `lanedetection_end2end_tpu/models/registry.py`, mirroring
the reference's `model_dict` / `define_model`: `MODEL_REGISTRY` maps a
model name to its builder, and `define_model` builds the port's `ERFNet`
(`models/erfnet.py`) with the reference's arguments. `layers` and `pool`
are accepted and unused, as there. `dtype` is the compute dtype: float32
parameters, the forward in `dtype` (`models/erfnet.py::call_in_dtype`),
as flax's `ERFNet(dtype=...)`.
"""

from __future__ import annotations

import torch

from lanedetection_end2end_tpu_torch.models.erfnet import ERFNet


def _build_erfnet(layers=18, in_channels=3, out_channels=2, pretrained=False,
                  pool=True, dtype=torch.float32):
    return ERFNet(out_channels, pretrained, in_channels=in_channels,
                  compute_dtype=dtype)


MODEL_REGISTRY = {"erfnet": _build_erfnet}


def define_model(mod="erfnet", layers=18, in_channels=3, out_channels=2,
                 pretrained=False, pool=True, dtype=torch.float32):
    if mod not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model '{mod}'; available: {list(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[mod](layers=layers, in_channels=in_channels,
                               out_channels=out_channels,
                               pretrained=pretrained, pool=pool, dtype=dtype)
