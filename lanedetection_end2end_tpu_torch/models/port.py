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

Both directions carry every leaf `LaneNetModule` makes: the encoder's
predict head, the decoder's pretraining head `output_conv2` (with
`pretrained`), the line head of either variant (`fc_line1` of the
'bp' profile, `fc_line1..4` of 'bev'), the learned homography's head
and ERFNet's dormant second decoder. No reference torch name exists for
the last two (the reference's spatial-transformer head is dormant, and
the JAX package's `port_torch_state_dict` has no place for them), so
they take the flax names: `homography_head.<flax name>.*` (`conv1..4`,
`conv{i}_bn`, `fc1`, `fc_offsets`; Dense kernels transposed, as every
Linear) and `net.decoder_seg.*` laid out as `net.decoder.*`. A leaf with
no place on the other side raises; nothing is dropped.
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

    for side in ("decoder", "decoder_seg"):
        if side not in p:
            continue
        dp, ds = p[side], s[side]
        # decoder.layers: 0=up1, 1-2=nb64_*, 3=up2, 4-5=nb16_*
        for i, n in enumerate(_DEC_NAMES):
            fn = upsampler_state if n.startswith("up") else nb1d_state
            sd.update(fn(dp[n], ds[n], f"net.{side}.layers.{i}"))
        for head in ("output_conv", "output_conv2"):
            if head in dp:
                sd.update(conv_transpose_state(dp[head],
                                               f"net.{side}.{head}"))
    return sd


def _homography_head_state(p: Mapping, s: Mapping) -> StateDict:
    """`homography_head` under its flax names (models/dlt.py)."""
    sd: StateDict = {}
    for i in range(1, 5):
        sd.update(conv_state(p[f"conv{i}"], f"homography_head.conv{i}"))
        sd.update(bn_state(p[f"conv{i}_bn"], s[f"conv{i}_bn"],
                           f"homography_head.conv{i}_bn"))
    for fc in ("fc1", "fc_offsets"):
        sd.update(dense_state(p[fc], f"homography_head.{fc}"))
    return sd


def _classification_state(p: Mapping, s: Mapping, name: str,
                          resize: int, variant: str) -> StateDict:
    sd: StateDict = {}
    for i in range(1, 5):
        sd.update(conv_state(p[f"conv{i}"], f"{name}.conv{i}"))
        sd.update(bn_state(p[f"conv{i}_bn"], s[f"conv{i}_bn"],
                           f"{name}.conv{i}_bn"))
    rows, cols = resize // 8, 2 * resize // 8  # encoder feature plane
    if "fc1" in p:  # line head
        sd.update(dense_after_flatten_state(p["fc1"], f"{name}.fully_connected1",
                                            64, rows // 2, cols // 2))
        for k in range(1, 5 if variant == "bev" else 2):
            sd.update(dense_state(p[f"fc_line{k}"],
                                  f"{name}.fully_connected_line{k}"))
    else:  # horizon head: (rows, 64) after the full-width average
        sd.update(dense_after_flatten_state(
            p["fc_horizon"], f"{name}.fully_connected_horizon", 64, rows, 1))
    return sd


def state_dict_from_variables(variables: Mapping,
                              profile: str = "bp") -> StateDict:
    """JAX `{params, batch_stats}` of `LaneNetModule` -> the port's
    `LaneNet` state_dict. `profile` picks the line head's variant, as the
    JAX package's `port_torch_state_dict` takes it; a leaf of `variables`
    that has no place in the state_dict raises ValueError."""
    if profile not in ("bp", "bev"):
        raise ValueError(f"unknown profile {profile!r}")
    params, stats = variables["params"], variables["batch_stats"]
    sd = _erfnet_state(params["erfnet"], stats["erfnet"])
    if "line_classification" in params:
        # the horizon head's output width is the resize
        resize = int(np.shape(
            params["horizon_estimation"]["fc_horizon"]["kernel"])[1])
        for key in ("line_classification", "horizon_estimation"):
            sd.update(_classification_state(params[key], stats[key], key,
                                            resize, profile))
    if "homography_head" in params:
        sd.update(_homography_head_state(params["homography_head"],
                                         stats["homography_head"]))
    left = _leaves(variables) - _carried(sd)
    if left:
        raise ValueError("leaves with no place in the port's state_dict: "
                         + ", ".join(sorted(left)))
    return sd


def _leaves(tree: Mapping, prefix: str = "") -> set:
    """'collection/.../leaf' paths of a nested dict."""
    out = set()
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out |= _leaves(v, f"{prefix}{k}/")
        else:
            out.add(prefix + k)
    return out


def _carried(sd: Mapping) -> set:
    """The flax leaf paths the entries of `sd` stand for."""
    out = set()
    for key in sd:
        module, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        path, kind = _flax_path(module)
        if kind == "bn":
            coll, name = _BN_LEAVES[leaf]
        else:
            coll, name = "params", "kernel" if leaf == "weight" else leaf
        out.add("/".join([coll] + path + [name]))
    return out


# ----------------------------------------------------------------------
# Back: reference torch names -> the flax tree
# ----------------------------------------------------------------------

_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}
_DENSE_NAMES = {"fully_connected1": "fc1",
                "fully_connected_horizon": "fc_horizon",
                **{f"fully_connected_line{k}": f"fc_line{k}"
                   for k in range(1, 5)}}
_HEAD_CONVS = {f"conv{i}" for i in range(1, 5)}
_HEADS = ("line_classification", "horizon_estimation")
_BLOCK_LEAVES = {"conv", "bn", "conv3x1_1", "conv1x3_1", "conv3x1_2",
                 "conv1x3_2", "bn1", "bn2"}


def _flax_path(name: str):
    """Reference torch module name -> (flax path, kind) with kind in
    conv | convT | bn | dense; KeyError for a module the flax tree has no
    place for."""
    parts = name.split(".")
    if parts[0] == "net" and len(parts) >= 3 and parts[1] in (
            "encoder", "decoder", "decoder_seg"):
        side, rest = parts[1], parts[2:]
        names = _ENC_NAMES if side == "encoder" else _DEC_NAMES
        if (rest[0] == "layers" and len(rest) == 3 and rest[1].isdigit()
                and int(rest[1]) < len(names)
                and rest[2] in _BLOCK_LEAVES):
            path, leaf = ["erfnet", side, names[int(rest[1])]], rest[2]
        elif (side == "encoder" and len(rest) == 2
              and rest[0] == "initial_block" and rest[1] in ("conv", "bn")):
            path, leaf = ["erfnet", side, rest[0]], rest[1]
        elif len(rest) == 1 and rest[0] in (
                ("output_conv", "output_conv2") if side == "decoder"
                else ("output_conv",)):
            path, leaf = ["erfnet", side], rest[0]
        else:
            raise KeyError(f"{name}: no place in the flax tree")
        if leaf.startswith("bn"):
            kind = "bn"
        elif side != "encoder" and (leaf.startswith("output_conv") or (
                leaf == "conv" and path[-1].startswith("up"))):
            kind = "convT"
        else:
            kind = "conv"
        return path + [leaf], kind
    if len(parts) == 2 and parts[0] in _HEADS:
        head, leaf = parts
        if leaf.endswith("_bn") and leaf[:-3] in _HEAD_CONVS:
            return [head, leaf], "bn"
        if leaf in _DENSE_NAMES:
            return [head, _DENSE_NAMES[leaf]], "dense"
        if leaf in _HEAD_CONVS:
            return [head, leaf], "conv"
    if len(parts) == 2 and parts[0] == "homography_head":
        leaf = parts[1]
        if leaf.endswith("_bn") and leaf[:-3] in _HEAD_CONVS:
            return list(parts), "bn"
        if leaf in ("fc1", "fc_offsets"):
            return list(parts), "dense"
        if leaf in _HEAD_CONVS:
            return list(parts), "conv"
    raise KeyError(f"{name}: no place in the flax tree")


def variables_from_state_dict(named: Mapping[str, torch.Tensor],
                              resize: int) -> Dict:
    """Inverse of `state_dict_from_variables` for any dict keyed by the
    port's parameter and buffer names: returns `{"params": tree,
    "batch_stats": tree}` of numpy arrays in the flax layouts (a subtree is
    empty where `named` has no such entries, as for gradients). A name
    with no place in the flax tree raises KeyError."""
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
        elif path[-1].startswith("fc_line") or path[0] == "homography_head":
            put("params", path, "kernel", a.T)
        else:  # a Linear after a flatten: (O, c*h*w) -> (h*w*c, O)
            h, w = (rows // 2, cols // 2) if path[-1] == "fc1" else (rows, 1)
            k = a.reshape(a.shape[0], 64, h, w).transpose(2, 3, 1, 0)
            put("params", path, "kernel", k.reshape(h * w * 64, -1))
    return out
