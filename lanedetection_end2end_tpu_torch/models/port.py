"""Carry JAX checkpoint variables into the port's torch `state_dict`, and
back.

`state_dict_from_variables` takes the JAX package's `{params, batch_stats}`
(nested numpy arrays; JAX arrays convert too) and returns the reference
torch names the port's modules use. It is the exact inverse of the JAX
package's `port_torch_state_dict`. `variables_from_state_dict` goes the
other way, for a whole `state_dict` or for any dict keyed by the same names
(gradients, updated parameters), so the two packages can be compared leaf
by leaf in the flax tree's layout. Layout conversions, forward:

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

# flax names of `encoder.layers.{i}` and `decoder.layers.{i}`
_ENC_NAMES = ["down1"] + [f"nb64_{i}" for i in range(5)] + ["down2"] + [
    f"nb128_{j}_d{d}" for j in range(2) for d in (2, 4, 8, 16)]
_DEC_NAMES = ["up1", "nb64_0", "nb64_1", "up2", "nb16_0", "nb16_1"]
assert len(_ENC_NAMES) == 2 + len(ENC_DILATIONS)


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
    for i, n in enumerate(_ENC_NAMES):
        fn = downsampler_state if n.startswith("down") else nb1d_state
        sd.update(fn(ep[n], es[n], f"net.encoder.layers.{i}"))
    sd.update(conv_state(ep["output_conv"], "net.encoder.output_conv"))

    dp, ds = p["decoder"], s["decoder"]
    # decoder.layers: 0=up1, 1-2=nb64_*, 3=up2, 4-5=nb16_*
    for i, n in enumerate(_DEC_NAMES):
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


# ----------------------------------------------------------------------
# Back: reference torch names -> the flax tree
# ----------------------------------------------------------------------

_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}
_DENSE_NAMES = {"fully_connected1": "fc1", "fully_connected_line1": "fc_line1",
                "fully_connected_horizon": "fc_horizon"}


def _flax_path(name: str):
    """Reference torch module name -> (flax path, kind) with kind in
    conv | convT | bn | dense."""
    parts = name.split(".")
    if parts[0] == "net":
        side, rest = parts[1], parts[2:]
        if rest[0] == "layers":
            block = (_ENC_NAMES if side == "encoder"
                     else _DEC_NAMES)[int(rest[1])]
            path, leaf = ["erfnet", side, block], rest[2]
        else:
            path, leaf = ["erfnet", side], rest[0]
            if len(rest) > 1:           # initial_block.conv / .bn
                path, leaf = path + [rest[0]], rest[1]
        if leaf.startswith("bn"):
            kind = "bn"
        elif side == "decoder" and (leaf == "output_conv" or (
                leaf == "conv" and path[-1].startswith("up"))):
            kind = "convT"
        else:
            kind = "conv"
        return path + [leaf], kind
    head, leaf = parts
    if leaf.endswith("_bn"):
        return [head, leaf], "bn"
    if leaf in _DENSE_NAMES:
        return [head, _DENSE_NAMES[leaf]], "dense"
    return [head, leaf], "conv"


def variables_from_state_dict(named: Mapping[str, torch.Tensor],
                              resize: int) -> Dict:
    """Inverse of `state_dict_from_variables` for any dict keyed by the
    port's parameter and buffer names: returns `{"params": tree,
    "batch_stats": tree}` of numpy arrays in the flax layouts (a subtree is
    empty where `named` has no such entries, as for gradients)."""
    out: Dict = {"params": {}, "batch_stats": {}}
    rows, cols = resize // 8, 2 * resize // 8

    def put(coll, path, leaf, value):
        node = out[coll]
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(value)

    for key, t in named.items():
        module, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        a = t.detach().cpu().float().numpy()
        path, kind = _flax_path(module)
        if kind == "bn":
            coll, name = _BN_LEAVES[leaf]
            put(coll, path, name, a)
        elif leaf == "bias":
            put("params", path, "bias", a)
        elif kind == "conv":
            put("params", path, "kernel", a.transpose(2, 3, 1, 0))
        elif kind == "convT":
            put("params", path, "kernel",
                a.transpose(2, 3, 0, 1)[::-1, ::-1])
        elif path[-1] == "fc_line1":
            put("params", path, "kernel", a.T)
        else:  # a Linear after a flatten: (O, c*h*w) -> (h*w*c, O)
            h, w = (rows // 2, cols // 2) if path[-1] == "fc1" else (rows, 1)
            k = a.reshape(a.shape[0], 64, h, w).transpose(2, 3, 1, 0)
            put("params", path, "kernel", k.reshape(h * w * 64, -1))
    return out
