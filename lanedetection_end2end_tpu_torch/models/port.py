"""Carry JAX checkpoint variables into the port's torch `state_dict`.

`state_dict_from_variables` takes the JAX package's `{params, batch_stats}`
(nested numpy arrays; JAX arrays convert too) and returns the reference
torch names the port's modules use. It is the exact inverse of the JAX
package's `port_torch_state_dict`. Layout conversions:

- flax conv kernel (kH, kW, I, O)          -> Conv2d weight (O, I, kH, kW)
- flax ConvTranspose kernel (kH, kW, I, O) -> SPATIAL FLIP, then
  ConvTranspose2d weight (I, O, kH, kW) (flax scatters the kernel
  unflipped; torch scatters the flipped correlation)
- BatchNorm scale/bias + batch_stats mean/var -> weight/bias +
  running_mean/running_var (num_batches_tracked = 0)
- Dense kernel (I, O) -> Linear weight (O, I)
- Dense after a flatten: flax flattens NHWC, torch NCHW, so the input
  dimension is permuted (H, W, C) -> (C, H, W)
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from lanedetection_end2end_tpu_torch.models.erfnet import ENC_DILATIONS

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # owned copy


def conv_state(p: Mapping, name: str) -> StateDict:
    return {f"{name}.weight": _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1)),
            f"{name}.bias": _t(p["bias"])}


def conv_transpose_state(p: Mapping, name: str) -> StateDict:
    k = np.asarray(p["kernel"], np.float32)[::-1, ::-1]  # undo the flip
    return {f"{name}.weight": _t(k.transpose(2, 3, 0, 1)),
            f"{name}.bias": _t(p["bias"])}


def bn_state(p: Mapping, s: Mapping, name: str) -> StateDict:
    return {f"{name}.weight": _t(p["scale"]), f"{name}.bias": _t(p["bias"]),
            f"{name}.running_mean": _t(s["mean"]),
            f"{name}.running_var": _t(s["var"]),
            f"{name}.num_batches_tracked": torch.tensor(0, dtype=torch.long)}


def dense_state(p: Mapping, name: str) -> StateDict:
    return {f"{name}.weight": _t(np.asarray(p["kernel"]).T),
            f"{name}.bias": _t(p["bias"])}


def dense_after_flatten_state(p: Mapping, name: str, c: int, h: int,
                              w: int) -> StateDict:
    """Linear whose input is a flatten of a (h, w, c) map in flax and of a
    (c, h, w) map in torch."""
    k = np.asarray(p["kernel"], np.float32)               # (h*w*c, O)
    out = k.shape[1]
    k = k.reshape(h, w, c, out).transpose(3, 2, 0, 1).reshape(out, c * h * w)
    return {f"{name}.weight": _t(k), f"{name}.bias": _t(p["bias"])}


def nb1d_state(p: Mapping, s: Mapping, name: str) -> StateDict:
    sd: StateDict = {}
    for conv in ("conv3x1_1", "conv1x3_1", "conv3x1_2", "conv1x3_2"):
        sd.update(conv_state(p[conv], f"{name}.{conv}"))
    for bn in ("bn1", "bn2"):
        sd.update(bn_state(p[bn], s[bn], f"{name}.{bn}"))
    return sd


def downsampler_state(p: Mapping, s: Mapping, name: str) -> StateDict:
    return {**conv_state(p["conv"], f"{name}.conv"),
            **bn_state(p["bn"], s["bn"], f"{name}.bn")}


def upsampler_state(p: Mapping, s: Mapping, name: str) -> StateDict:
    return {**conv_transpose_state(p["conv"], f"{name}.conv"),
            **bn_state(p["bn"], s["bn"], f"{name}.bn")}


def _erfnet_state(p: Mapping, s: Mapping) -> StateDict:
    ep, es = p["encoder"], s["encoder"]
    sd = downsampler_state(ep["initial_block"], es["initial_block"],
                           "net.encoder.initial_block")
    # encoder.layers: 0=down1, 1-5=nb64_*, 6=down2, 7-14=nb128_{j}_d{d}
    names = ["down1"] + [f"nb64_{i}" for i in range(5)] + ["down2"] + [
        f"nb128_{j}_d{d}" for j in range(2) for d in (2, 4, 8, 16)]
    assert len(names) == 2 + len(ENC_DILATIONS)
    for i, n in enumerate(names):
        fn = downsampler_state if n.startswith("down") else nb1d_state
        sd.update(fn(ep[n], es[n], f"net.encoder.layers.{i}"))
    sd.update(conv_state(ep["output_conv"], "net.encoder.output_conv"))

    dp, ds = p["decoder"], s["decoder"]
    # decoder.layers: 0=up1, 1-2=nb64_*, 3=up2, 4-5=nb16_*
    for i, n in enumerate(["up1", "nb64_0", "nb64_1", "up2", "nb16_0",
                           "nb16_1"]):
        fn = upsampler_state if n.startswith("up") else nb1d_state
        sd.update(fn(dp[n], ds[n], f"net.decoder.layers.{i}"))
    sd.update(conv_transpose_state(dp["output_conv"],
                                   "net.decoder.output_conv"))
    return sd


def _classification_state(p: Mapping, s: Mapping, name: str,
                          resize: int) -> StateDict:
    sd: StateDict = {}
    for i in range(1, 5):
        sd.update(conv_state(p[f"conv{i}"], f"{name}.conv{i}"))
        sd.update(bn_state(p[f"conv{i}_bn"], s[f"conv{i}_bn"],
                           f"{name}.conv{i}_bn"))
    rows, cols = resize // 8, 2 * resize // 8  # encoder feature plane
    if "fc1" in p:  # line head
        sd.update(dense_after_flatten_state(p["fc1"], f"{name}.fully_connected1",
                                            64, rows // 2, cols // 2))
        sd.update(dense_state(p["fc_line1"], f"{name}.fully_connected_line1"))
    else:  # horizon head: (rows, 64) after the full-width average
        sd.update(dense_after_flatten_state(
            p["fc_horizon"], f"{name}.fully_connected_horizon", 64, rows, 1))
    return sd


def state_dict_from_variables(variables: Mapping) -> StateDict:
    """JAX `{params, batch_stats}` of `LaneNetModule` (BP profile, e2e
    phase, no pretraining head) -> the port's `LaneNet` state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = _erfnet_state(params["erfnet"], stats["erfnet"])
    if "line_classification" in params:
        # the horizon head's output width is the resize
        resize = int(np.shape(
            params["horizon_estimation"]["fc_horizon"]["kernel"])[1])
        for key in ("line_classification", "horizon_estimation"):
            sd.update(_classification_state(params[key], stats[key], key,
                                            resize))
    return sd
