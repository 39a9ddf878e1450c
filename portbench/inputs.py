"""What the benchmark makes from `--seed` and hands to both the program
and the reference: weights, training batches and camera frames.

Everything is drawn with a `torch.Generator` on the run's device, in a few
large calls, so the same seed gives the same values on the same kind of
device. Sub-seeds are derived from the run's seed, one per purpose.
"""

from __future__ import annotations

from typing import Dict, List

import torch

_PURPOSES = ("weights", "batches", "dropout", "frames")


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed of its own for each purpose of a run's seed."""
    k = _PURPOSES.index(purpose) + 1
    return (int(seed) * 0x9E3779B1 + k * 0x632BE5AB) % (1 << 63)


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


def make_state(spec: Dict[str, tuple], seed: int,
               device) -> Dict[str, torch.Tensor]:
    """A model state with every tensor of `spec` (name -> (shape, kind,
    fan_in), `reference/model.py::state_spec`), drawn in two calls:
    convolution and linear weights N(0, 1 / fan_in), biases N(0, 1e-4),
    BatchNorm scales U(0.8, 1.2) and shifts N(0, 0.01), running means N(0,
    0.01) and running variances U(0.5, 1.5), so that the eval-mode
    forward is no BatchNorm of the identity."""
    g = generator(seed, "weights", device)
    sizes = [int(torch.Size(shape).numel()) for shape, _, _ in spec.values()]
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uniform = torch.rand(sum(sizes), generator=g, device=device)
    rules = {"weight": lambda z, u, fan: z / fan ** 0.5,
             "bias": lambda z, u, fan: 0.01 * z,
             "bn_weight": lambda z, u, fan: 0.8 + 0.4 * u,
             "bn_bias": lambda z, u, fan: 0.1 * z,
             "running_mean": lambda z, u, fan: 0.1 * z,
             "running_var": lambda z, u, fan: 0.5 + u}
    out, at = {}, 0
    for (name, (shape, kind, fan)), n in zip(spec.items(), sizes):
        if kind == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
        else:
            out[name] = rules[kind](normal[at:at + n].view(shape),
                                    uniform[at:at + n].view(shape), fan)
        at += n
    return out


def training_batches(count: int, batch: int, resize: int, profile: str,
                     seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """`count` distinct batches of random labelled images on `device`, as
    the program's synthetic benchmark source draws them: images U(0, 1)
    (B, H, 2H, 3) float32; 'bp': lanes U(0, 2H - 1) and valid points (u >
    0.3) (B, 4, 56), line presence (u > 0.3) (B, 4); 'bev': curve
    parameters N(0.5, 0.1) (B, 4, 3), line classes in {0, 1, 2} (B, 4);
    horizon targets 0 (B, H)."""
    g = generator(seed, "batches", device)
    H, W = resize, 2 * resize
    f32 = dict(device=device, dtype=torch.float32)
    out = []
    for _ in range(count):
        b = {"image": torch.rand(batch, H, W, 3, generator=g, **f32),
             "horizon": torch.zeros(batch, H, **f32)}
        if profile == "bev":
            b["params"] = 0.5 + 0.1 * torch.randn(batch, 4, 3, generator=g,
                                                  **f32)
            b["line"] = torch.randint(0, 3, (batch, 4), generator=g,
                                      device=device)
        else:
            b["lanes"] = (W - 1) * torch.rand(batch, 4, 56, generator=g,
                                              **f32)
            b["valid_points"] = (torch.rand(batch, 4, 56, generator=g, **f32)
                                 > 0.3).float()
            b["line"] = (torch.rand(batch, 4, generator=g, **f32)
                         > 0.3).float()
        out.append(b)
    return out


def frames(count: int, batch: int, resize: int, seed: int,
           device) -> torch.Tensor:
    """(count, B, H, 2H, 3) uint8 camera frames of road scenes, drawn on
    `device`, each its own: a sky band down to a horizon row at 25-40% of
    the height, a road of noise below it, and four bright lane markings
    that meet at a vanishing point on the horizon, each at its own
    offset, with a shared bend and marking widths that grow towards the
    camera; a colour tint a frame. Scenes, not noise, so that what the
    model computes differs from frame to frame at the scale of the
    image."""
    g = generator(seed, "frames", device)
    n, H, W = count * batch, resize, 2 * resize
    u = lambda *shape: torch.rand(*shape, generator=g, device=device)
    ys = torch.arange(H, device=device, dtype=torch.float32)[None, :, None]
    xs = torch.arange(W, device=device, dtype=torch.float32)[None, None, :]
    horizon = H * (0.25 + 0.15 * u(n))[:, None, None]
    t = ((ys - horizon) / (H - horizon)).clamp(min=0.0)      # 0 at horizon
    vp = W * (0.4 + 0.2 * u(n))[:, None, None]
    bend = W * (0.3 * u(n) - 0.15)[:, None, None]
    img = 70.0 + 20.0 * torch.randn(n, H, W, generator=g, device=device)
    img = img + 60.0 * (ys < horizon)
    for k in range(4):
        spread = W * (0.25 * (k - 1.5) + 0.06 * (u(n) - 0.5))[:, None, None]
        x_k = vp + spread * t + bend * (1.0 - t) ** 2 * t
        width = 1.0 + 0.012 * W * t
        lane = ((xs - x_k).abs() < width) & (ys > horizon) & (
            u(n)[:, None, None] < 0.9)
        img = torch.where(lane, 220.0 + 10.0 * u(n)[:, None, None], img)
    tint = 0.8 + 0.4 * u(n, 1, 1, 3)
    out = (img[..., None] * tint).clamp(0.0, 255.0).to(torch.uint8)
    return out.view(count, batch, H, W, 3)
