"""The frozen work counts against hand counts: every layer's taps that
land on the plane, counted by running the layer's geometry on ones."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from portbench.work import erfnet

MODELS = {"bp": dict(resize=32, out_channels=4, clas=True, profile="bp"),
          "bev": dict(resize=32, out_channels=2, clas=False, profile="bev")}


def _three_tap(name: str):
    """(kernel, padding, dilation, plane (H, W)) of an NB1D convolution of
    a resize-32 model, from its name; None for another layer."""
    from portbench.reference.model import ENC_DILATIONS
    if "conv3x1" not in name and "conv1x3" not in name:
        return None
    parts = name.split(".")
    layer = int(parts[3])
    if parts[1] == "encoder":
        scale = 4 if layer < 6 else 8
        d = ENC_DILATIONS[layer - 1 if layer < 6 else layer - 2]
    else:
        scale, d = (4 if layer < 3 else 2), 1
    d = d if name.endswith("_2") else 1
    plane = (32 // scale, 64 // scale)
    if "conv3x1" in name:
        return (3, 1), (d, 0), (d, 1), plane
    return (1, 3), (0, d), (1, d), plane


@pytest.mark.parametrize("profile", sorted(MODELS))
def test_three_tap_layers_count_landing_taps(profile):
    checked = 0
    for L in erfnet.layers(MODELS[profile]):
        geo = _three_tap(L.name)
        if geo is None:
            continue
        checked += 1
        k, p, dil, (h, w) = geo
        ones = torch.ones(1, 1, h, w, dtype=torch.float64)
        hits = F.conv2d(ones, torch.ones(1, 1, *k, dtype=torch.float64),
                        padding=p, dilation=dil).sum()
        assert L.taps == int(hits), L.name
        assert L.flops(3) == 2 * L.cin * L.cout * int(hits) * 3
    assert checked == 17 * 4


@pytest.mark.parametrize("cin,cout,H,W", [(3, 16, 8, 12), (16, 64, 4, 6),
                                          (64, 128, 6, 10)])
def test_downsampler_taps(cin, cout, H, W):
    L = erfnet._down("d", cin, cout, H, W)
    hits = F.conv2d(torch.ones(1, 1, H, W, dtype=torch.float64),
                    torch.ones(1, 1, 3, 3, dtype=torch.float64), stride=2,
                    padding=1).sum()
    assert L.taps == int(hits) and L.cout == cout - cin
    assert L.y == (cout - cin) * (H // 2) * (W // 2)


@pytest.mark.parametrize("H,W", [(4, 8), (3, 5)])
def test_upsampler_taps(H, W):
    L = erfnet._up("u", 8, 4, H, W)
    hits = F.conv_transpose2d(torch.ones(1, 1, H, W, dtype=torch.float64),
                              torch.ones(1, 1, 3, 3, dtype=torch.float64),
                              stride=2, padding=1, output_padding=1).sum()
    assert L.taps == int(hits) and L.y == 4 * 4 * H * W


def test_head_and_totals_at_the_published_size():
    m = dict(resize=256, out_channels=4, clas=True, profile="bp")
    ls = erfnet.layers(m)
    head = next(L for L in ls if L.name == "net.decoder.output_conv")
    assert head.taps == 4 * 128 * 256
    by_part = {}
    for L in ls:
        by_part[L.part] = by_part.get(L.part, 0) + L.flops(1)
    assert by_part["encoder"] + by_part["decoder"] == 12_756_619_086
    assert by_part["heads"] == 2_191_983_616
    ops = erfnet.train_ops(m, 32)
    assert len(ops) == 3 * len(ls) - 1  # no input gradient of the image
    assert sum(o.flops for o in ops) == 3 * 32 * sum(
        L.flops(1) for L in ls) - 32 * ls[0].flops(1)


def test_bytes_read_once_written_once():
    m = MODELS["bp"]
    L = erfnet.layers(m)[0]
    fwd = erfnet.train_ops(m, 2, es=4)[0]
    assert fwd.bytes == 4 * (2 * L.x + L.w + 2 * L.y)
    serve = erfnet.serve_ops(m, 2)
    enc = serve[0]
    assert enc.name == "encoder"
    assert enc.bytes == (3 * 32 * 64 * 2 + 2 * 128 * 4 * 8 * 2 + 2 * sum(
        x.w for x in erfnet.layers(m) if x.part == "encoder"))
    assert erfnet.bound_s(serve, 1.0, 1e30) == sum(o.flops for o in serve)
