"""Frozen work counts of the learned homography's head, by the conventions
of `work/erfnet.py` (the taps that land on the plane, each input read
once and each output written once, forward, input and weight gradient in
training), from nothing of the program.

The program's head, its redesign of the published one (`assumed` in
`configs/bp_learned_h.json`), runs on the encoder features (128
channels at H/8 x W/8): `conv1`
1x1 128 -> 128, `conv2` 3x3 128 -> 128, `conv3` 3x3 128 -> 64, a 2x2 max
pool, `conv4` 3x3 64 -> 64, the mean over the plane, `fc1` 64 -> 128 and
`fc_offsets` 128 -> 3. At 256 x 512 its forward is 0.9804 GFLOP an image
(67.1 M, 585.2 M, 292.6 M and 35.4 M in the convolutions, 0.017 M in the
linear layers; counting the taps on the zero padding as well, the 3x3
ones would read 604.0 M, 302.0 M and 37.7 M): 7.7% of the backbone's
12.757.
"""

from __future__ import annotations

from typing import List

from portbench.work.erfnet import Layer, Op

HEAD = "homography_head"


def layers(model: dict) -> List[Layer]:
    """The head's convolutions and linear layers, in order."""
    r, c = model["resize"] // 8, model["resize"] // 4
    out = []
    for i, (cin, cout, k, h, w) in enumerate(
            ((128, 128, 1, r, c), (128, 128, 3, r, c), (128, 64, 3, r, c),
             (64, 64, 3, r // 2, c // 2))):
        taps = h * w if k == 1 else (3 * h - 2) * (3 * w - 2)
        out.append(Layer(f"{HEAD}.conv{i + 1}", "heads", cin, cout, taps,
                         cin * h * w, cout * h * w, cin * cout * k * k + cout))
    out += [Layer(f"{HEAD}.{n}", "heads", i, o, 1, i, o, i * o + o)
            for n, i, o in (("fc1", 64, 128), ("fc_offsets", 128, 3))]
    return out


def train_ops(model: dict, batch: int, es: int = 4) -> List[Op]:
    """A training step's operations of the head on `es`-byte values:
    forward, input gradient and weight gradient of every layer (its input,
    the encoder's features, takes a gradient too)."""
    out = []
    for L in layers(model):
        f = L.flops(batch)
        x, y, w = es * L.x * batch, es * L.y * batch, es * L.w
        out += [Op(L.name + ".fwd", f, x + w + y),
                Op(L.name + ".dgrad", f, y + w + x),
                Op(L.name + ".wgrad", f, y + x + w)]
    return out
