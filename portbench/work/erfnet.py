"""Frozen work counts of LaneNet: each operation's FLOPs and bytes.

Computed from ERFNet's layer list at a cell's batch, resolution, lanes and
dtype, and from nothing of the program, so that a change to the program
cannot move them. Conventions, as in the port's chip checks:

- a convolution's FLOPs are 2 * cin * cout for every tap that lands on the
  plane (the zero padding is no work): a 3-tap convolution of dilation d
  along n rows has n + 2 * max(0, n - d) taps a column; a 3x3/s2
  convolution to (Ho, Wo) (3 Ho - 1)(3 Wo - 1); a 3x3/s2 transposed one
  from (H, W) (3 H - 1)(3 W - 1); the 2x2/s2 output head 4 a pixel;
- its bytes: each input read once and each output written once;
- training counts every convolution and linear layer three times:
  forward, input gradient (but the first layer's, whose input is the
  image) and weight gradient, at layer boundaries, in the training dtype;
  BatchNorm, activations, pooling and the optimizer are left out of the
  FLOPs;
- serving counts the encoder (image in, features out) and the decoder
  (features in, the fit's row sums out) at the serving kernels'
  boundaries, and the heads' layers, in the serving dtype.

At 256 x 512 the backbone's forward is 12.757 GFLOP an image with four
lanes (the output head counted over every row), the BP heads' 2.192.
"""

from __future__ import annotations

import dataclasses
from typing import List

ENC_DILATIONS = [1] * 5 + [2, 4, 8, 16] * 2


@dataclasses.dataclass(frozen=True)
class Layer:
    name: str
    part: str            # encoder | decoder | heads
    cin: int
    cout: int
    taps: int            # taps that land on the plane, per image
    x: int               # input values per image
    y: int               # output values per image
    w: int               # weight and bias values

    def flops(self, batch: int) -> int:
        return 2 * self.cin * self.cout * self.taps * batch


def _valid(n: int, d: int) -> int:
    return n + 2 * max(0, n - d)


def _nb1d(pre: str, part: str, C: int, H: int, W: int, d: int) -> List[Layer]:
    plane, w = C * H * W, C * C * 3 + C
    return [Layer(f"{pre}.conv3x1_1", part, C, C, _valid(H, 1) * W, plane,
                  plane, w),
            Layer(f"{pre}.conv1x3_1", part, C, C, _valid(W, 1) * H, plane,
                  plane, w),
            Layer(f"{pre}.conv3x1_2", part, C, C, _valid(H, d) * W, plane,
                  plane, w),
            Layer(f"{pre}.conv1x3_2", part, C, C, _valid(W, d) * H, plane,
                  plane, w)]


def _down(pre: str, cin: int, cout: int, H: int, W: int) -> Layer:
    Ho, Wo = H // 2, W // 2
    cc = cout - cin
    return Layer(f"{pre}.conv", "encoder", cin, cc,
                 (3 * Ho - 1) * (3 * Wo - 1), cin * H * W, cc * Ho * Wo,
                 cc * cin * 9 + cc)


def _up(pre: str, cin: int, cout: int, H: int, W: int) -> Layer:
    return Layer(f"{pre}.conv", "decoder", cin, cout,
                 (3 * H - 1) * (3 * W - 1), cin * H * W, cout * 4 * H * W,
                 cin * cout * 9 + cout)


def layers(model: dict) -> List[Layer]:
    """Every convolution and linear layer of the e2e graph, in order."""
    H, W, C = model["resize"], 2 * model["resize"], model["out_channels"]
    e, d = "net.encoder", "net.decoder"
    out = [_down(f"{e}.initial_block", 3, 16, H, W),
           _down(f"{e}.layers.0", 16, 64, H // 2, W // 2)]
    for i in range(5):
        out += _nb1d(f"{e}.layers.{1 + i}", "encoder", 64, H // 4, W // 4,
                     ENC_DILATIONS[i])
    out.append(_down(f"{e}.layers.6", 64, 128, H // 4, W // 4))
    for i in range(8):
        out += _nb1d(f"{e}.layers.{7 + i}", "encoder", 128, H // 8, W // 8,
                     ENC_DILATIONS[5 + i])
    out.append(_up(f"{d}.layers.0", 128, 64, H // 8, W // 8))
    for i in (1, 2):
        out += _nb1d(f"{d}.layers.{i}", "decoder", 64, H // 4, W // 4, 1)
    out.append(_up(f"{d}.layers.3", 64, 16, H // 4, W // 4))
    for i in (4, 5):
        out += _nb1d(f"{d}.layers.{i}", "decoder", 16, H // 2, W // 2, 1)
    out.append(Layer(f"{d}.output_conv", "decoder", 16, C,
                     4 * (H // 2) * (W // 2), 16 * (H // 2) * (W // 2),
                     C * H * W, 16 * C * 4 + C))
    if model["clas"]:
        r, c = H // 8, W // 8
        for pre in ("line_classification", "horizon_estimation"):
            chans = (128, 128, 128, 64, 64)
            for i in range(4):
                taps = r * c if i == 0 else (3 * r - 2) * (3 * c - 2)
                k2 = 1 if i == 0 else 9
                out.append(Layer(f"{pre}.conv{i + 1}", "heads", chans[i],
                                 chans[i + 1], taps, chans[i] * r * c,
                                 chans[i + 1] * r * c,
                                 chans[i] * chans[i + 1] * k2 + chans[i + 1]))
            if pre == "line_classification":
                n_in = 64 * (r // 2) * (c // 2)
                lin = [("fully_connected1", n_in, 128)]
                lin += ([(f"fully_connected_line{k}", 128, 3)
                         for k in range(1, 5)]
                        if model["profile"] == "bev"
                        else [("fully_connected_line1", 128, 4)])
            else:
                lin = [("fully_connected_horizon", 64 * r, model["resize"])]
            out += [Layer(f"{pre}.{n}", "heads", i, o, 1, i, o, i * o + o)
                    for n, i, o in lin]
    return out


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    flops: int
    bytes: int


def train_ops(model: dict, batch: int, es: int = 4) -> List[Op]:
    """A training step's operations on planes and weights of `es` bytes a
    value: forward, input gradient and weight gradient of every layer."""
    out = []
    for i, L in enumerate(layers(model)):
        f = L.flops(batch)
        x, y = es * L.x * batch, es * L.y * batch
        out.append(Op(L.name + ".fwd", f, x + es * L.w + y))
        if i > 0:
            out.append(Op(L.name + ".dgrad", f, y + es * L.w + x))
        out.append(Op(L.name + ".wgrad", f, y + x + es * L.w))
    return out


def serve_ops(model: dict, batch: int, es: int = 2) -> List[Op]:
    """A serving call's operations: the encoder and the decoder whole (the
    uint8 image in, `es`-byte features between them, the fit's float32
    row sums (B, H, 2C) out, `es`-byte weights), then each layer of the
    heads."""
    ls = layers(model)
    H, C = model["resize"], model["out_channels"]
    enc_out = 128 * (H // 8) * (2 * H // 8) * batch
    out = []
    for part, x_bytes, y_bytes in (
            ("encoder", 3 * H * 2 * H * batch, es * enc_out),
            ("decoder", es * enc_out, 4 * H * 2 * C * batch)):
        sel = [L for L in ls if L.part == part]
        out.append(Op(part, sum(L.flops(batch) for L in sel),
                      x_bytes + y_bytes + es * sum(L.w for L in sel)))
    out += [Op(L.name, L.flops(batch),
               es * (batch * (L.x + L.y) + L.w))
            for L in ls if L.part == "heads"]
    return out


def bound_s(ops: List[Op], peak_flops: float, peak_bytes: float) -> float:
    """The least time the card could take: per operation the larger of
    its FLOPs over the peak rate and its bytes over the peak bandwidth."""
    return sum(max(o.flops / peak_flops, o.bytes / peak_bytes) for o in ops)
