"""The plain reference of the learned homography: the offset head, the
six-equation DLT, each image's coefficient rows of the fit, and the
backprojection loss on each image's matrices, over `model.py`'s ERFNet,
line and horizon heads, fit and losses.

Plain PyTorch over a dict of tensors, NCHW, float32, autograd for the
gradients; it imports nothing of the program. The published model keeps
the DLT branch and its offset head as dead code (the reference
repository's `Backprojection_Loss/Networks/Least_squares_net.py:225-282`
and `:284-329`, `Spatial_transformer_net`) and reports its finetuned
homography's accuracy in its README. The head here is the program's
redesign of that head, not the published one: it reads the encoder
features the line and horizon heads share, with four convolutions and a
global mean, where the published head runs its own full-resolution input
through five convolutions and a Linear over the flattened plane
(`assumed` in the configuration file gives both):

- the head (`homography_head.*`, BatchNorm eps 1e-5): `conv1` 1x1
  128 -> 128, `conv2` to `conv4` 3x3 with padding 1 (128 -> 128, 128 ->
  64, 64 -> 64), each followed by its BatchNorm `conv{i}_bn` and relu, a
  2x2 max pool after `conv3`; the mean over the plane; `fc1` 64 -> 128
  and relu; `fc_offsets` 128 -> 3; tanh, divided by 16: the offsets
  (dx_left, dx_right, dy_top) of the target trapezoid, in units of the
  width, the width and the height;
- the DLT: H = [[h0, h1, h2], [0, h3, h4], [0, h5, 1]] maps the source
  trapezoid of the BP pixel homography (`geometry.matrices`) onto the
  target one moved by the offsets; two y-equations (the bottom and the
  top row) and four x-equations (the corners), six unknowns;
- the fit: the separable moments with each image's coefficient rows,
  built from its H as `geometry.fit_constants` builds them from the fixed
  one (the y scale, the column centre and the column scale stay the fixed
  matrix's), then `model.Model.fit`'s regularized Cholesky solve;
- the loss: the heights' bird's-eye images, the Vandermonde rows and the
  backprojection follow each image's H and its inverse.

Departure: the 6x6 system is solved, and H inverted, in float64 from the
float32 offsets, and the matrices rounded to float32 (the program solves
in float32; the system's condition number is about 1.9e6 at resize 256).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import check, geometry, model
from portbench.reference.model import Model, Params

HEAD = "homography_head"
CHANNELS = (128, 128, 128, 64, 64)  # the input, then conv1 .. conv4


def head_shapes() -> Dict[str, tuple]:
    """{name: shape} of the head's state, in the program's order."""
    out = []
    for i in range(4):
        k = 1 if i == 0 else 3
        out += model._conv(f"{HEAD}.conv{i + 1}",
                           (CHANNELS[i + 1], CHANNELS[i], k, k))
        out += model._bn(f"{HEAD}.conv{i + 1}_bn", CHANNELS[i + 1])
    out += model._conv(f"{HEAD}.fc1", (128, CHANNELS[-1]))
    out += model._conv(f"{HEAD}.fc_offsets", (3, 128))
    return dict(out)


def state_spec(m: dict) -> Dict[str, tuple]:
    """`model.state_spec` with the head's entries after the rest, so that
    every other tensor is drawn as in the configuration without the head;
    the same kinds and fans."""
    out = dict(model.state_spec(m))
    for name, shape in head_shapes().items():
        owner, leaf = name.rsplit(".", 2)[-2:]
        if leaf == "num_batches_tracked":
            kind, fan = "count", 0
        elif leaf in ("running_mean", "running_var"):
            kind, fan = leaf, 0
        elif owner.endswith("_bn"):
            kind, fan = "bn_" + leaf, 0
        else:
            kind = leaf
            fan = int(torch.Size(shape[1:]).numel()) if leaf == "weight" \
                else 0
        out[name] = (tuple(shape), kind, fan)
    return out


def head(x: torch.Tensor, p: Params, train: bool) -> torch.Tensor:
    """Encoder features (B, 128, H/8, W/8) -> offsets (B, 3)."""
    for i in range(1, 5):
        x = model.conv(x, p, f"{HEAD}.conv{i}", padding=0 if i == 1 else 1)
        x = torch.relu(model.batchnorm(x, p, f"{HEAD}.conv{i}_bn", train,
                                       model.BN_EPS_HEAD))
        if i == 3:
            x = F.max_pool2d(x, 2, 2)
    x = x.mean(dim=(2, 3))
    x = torch.relu(F.linear(x, p[f"{HEAD}.fc1.weight"],
                            p[f"{HEAD}.fc1.bias"]))
    x = F.linear(x, p[f"{HEAD}.fc_offsets.weight"],
                 p[f"{HEAD}.fc_offsets.bias"])
    return torch.tanh(x) / 16.0


def anchors(resize: int) -> tuple:
    """(src, dst) trapezoids of the BP pixel homography: [top-left,
    top-right, bottom-left, bottom-right] (x, y), float64."""
    w, y0, y1 = 2 * resize, 0.2 * resize, resize - 1.0
    src = [[0.45 * w, y0], [0.55 * w, y0], [0.02 * w, y1], [0.97 * w, y1]]
    dst = [[0.45 * w, y0], [0.55 * w, y0], [0.45 * w, y1], [0.55 * w, y1]]
    return np.float64(src), np.float64(dst)


def dlt(offsets: torch.Tensor, resize: int) -> tuple:
    """offsets (B, 3) -> (M, M_inv) (B, 3, 3) float32, M_inv[2, 2] = 1.

    The target trapezoid: both left corners at x = dst_left + dx_left *
    W, both right ones at dst_right + dx_right * W, the top row at y_top +
    dy_top * H, the bottom row fixed. With D(y) = h5 y + 1 an x-equation
    at (x, y) -> u is h0 x + h1 y + h2 - u y h5 = u, a y-equation at y ->
    v is h3 y + h4 - v y h5 = v. Solved in float64."""
    src, dst = anchors(resize)
    o = offsets.double()
    B, w = o.shape[0], 2.0 * resize
    u_l = dst[0, 0] + o[:, 0] * w
    u_r = dst[1, 0] + o[:, 1] * w
    v_top = dst[0, 1] + o[:, 2] * resize
    y_bot = src[2, 1]
    zero, one = torch.zeros_like(u_l), torch.ones_like(u_l)
    c = lambda v: torch.full_like(u_l, float(v))

    def x_eq(x, y, u):
        return [c(x), c(y), one, zero, zero, -u * y], u

    def y_eq(y, v):
        return [zero, zero, zero, c(y), one, -v * y], v

    eqs = [y_eq(y_bot, c(y_bot)), x_eq(src[2, 0], y_bot, u_l),
           x_eq(src[3, 0], y_bot, u_r), y_eq(src[0, 1], v_top),
           x_eq(src[0, 0], src[0, 1], u_l), x_eq(src[1, 0], src[1, 1], u_r)]
    A = torch.stack([torch.stack(row, -1) for row, _ in eqs], 1)
    b = torch.stack([rhs for _, rhs in eqs], 1)
    h = torch.linalg.solve(A, b)                                   # (B, 6)
    M = torch.stack([h[:, 0], h[:, 1], h[:, 2], zero, h[:, 3], h[:, 4],
                     zero, h[:, 5], one], -1).reshape(B, 3, 3)
    M_inv = torch.linalg.inv(M)
    return M.float(), (M_inv / M_inv[:, 2:3, 2:3]).float()


class LearnedModel(Model):
    """`model.Model` of a BP configuration with the learned homography:
    the forward adds the head, the DLT and the per-image fit; the losses
    backproject on each image's matrices."""

    def __init__(self, m: dict, device):
        super().__init__(m, device)
        M, _ = geometry.matrices("bp", m["resize"], m["no_mapping"])
        H, W = m["resize"], 2 * m["resize"]
        ys = np.arange(H, dtype=np.float64)
        xs = np.arange(W, dtype=np.float64)
        y_rows = H - 1.0 - (M[1, 1] * ys + M[1, 2]) / (M[2, 1] * ys
                                                      + M[2, 2])
        self.y_scale = max(float(np.abs(y_rows).max()), 1e-12)
        self.x0 = float(xs.mean())
        self.sx = max(float(np.abs(xs - self.x0).max()), 1e-12)
        self.ys = torch.as_tensor(ys, dtype=torch.float32,
                                  device=self.device)
        y_d = (geometry.H_SAMPLES - 80.0) / 2.5  # the loss's heights
        self.y_d = torch.as_tensor(y_d, dtype=torch.float32,
                                   device=self.device)

    def coeff_rows(self, M: torch.Tensor) -> torch.Tensor:
        """(B, 3, 3) -> each image's coefficient rows (B, 2H, K):
        `geometry.fit_constants` with the image's own matrix."""
        ys, H, o1 = self.ys[None, :], self.m["resize"], self.m["order"] + 1
        D = M[:, 2, 1:2] * ys + M[:, 2, 2:3]                         # (B, H)
        alpha = M[:, 0, 0:1] / D
        gamma = (M[:, 0, 1:2] * ys + M[:, 0, 2:3]) / D
        t = (H - 1.0 - (M[:, 1, 1:2] * ys + M[:, 1, 2:3]) / D) / self.y_scale
        Yr = torch.stack([t ** k for k in range(o1 - 1, -1, -1)], -1)
        c0 = torch.cat([(Yr[..., :, None] * Yr[..., None, :]).flatten(2),
                        Yr * (gamma + alpha * self.x0)[..., None]], -1)
        c1 = torch.cat([torch.zeros_like(c0[..., :o1 * o1]),
                        Yr * (alpha * self.sx)[..., None]], -1)
        return torch.cat([c0, c1], 1)

    def fit_per_image(self, logits: torch.Tensor,
                      coeff: torch.Tensor) -> torch.Tensor:
        """`Model.fit` with each image's coefficient rows (B, 2H, K)."""
        w2 = self.act(logits) ** 2
        w2 = torch.cat([torch.zeros_like(w2[:, :, :self.zero_rows]),
                        w2[:, :, self.zero_rows:]], dim=2)
        S = torch.cat([w2.sum(dim=3), (w2 * self.xs).sum(dim=3)], -1)
        moments = (S.unsqueeze(-1) * coeff.unsqueeze(1)).sum(dim=2)
        o1 = self.m["order"] + 1
        Z0 = moments[..., :o1 * o1].reshape(*moments.shape[:2], o1, o1)
        trace = torch.diagonal(Z0, dim1=-2, dim2=-1).sum(-1, keepdim=True)
        floor = (geometry.REG_FLOOR * (trace / o1)
                 + torch.finfo(torch.float32).tiny)
        Z = Z0 + torch.diag_embed(self.reg_diag + floor)
        return model.spd_solve(Z, moments[..., o1 * o1:]) * self.unscale

    def forward(self, p: Params, images: torch.Tensor, train: bool,
                generator: Optional[torch.Generator] = None,
                with_normal: bool = False) -> dict:
        """images (B, H, W, 3) -> {beta, line, horizon, M, M_inv}."""
        x = images.permute(0, 3, 1, 2).contiguous()
        enc, logits = model.erfnet(x, p, train, generator)
        M, M_inv = dlt(head(enc, p, train), self.m["resize"])
        out = {"beta": self.fit_per_image(logits, self.coeff_rows(M)),
               "M": M, "M_inv": M_inv}
        for pre, kind in (("line_classification", "line"),
                          ("horizon_estimation", "horizon")):
            out[kind] = model.head(enc, p, pre, kind, "bp", train)
        return out

    def backproject(self, beta: torch.Tensor, M: torch.Tensor,
                    M_inv: torch.Tensor) -> torch.Tensor:
        """beta (B, o1) of one lane -> x at the 56 heights (B, 56), resized
        pixels, through each image's matrices."""
        yd = self.y_d[None, :]
        yp = (M[:, 1, 1:2] * yd + M[:, 1, 2:3]) / (M[:, 2, 1:2] * yd
                                                   + M[:, 2, 2:3])
        y_eval = self.m["resize"] - 1.0 - yp
        o1 = beta.shape[-1]
        Y = torch.stack([y_eval ** k for k in range(o1 - 1, -1, -1)], -1)
        xp = (beta[:, None, :] * Y).sum(-1)
        Mi = lambda i, j: M_inv[:, i, j:j + 1]
        return ((Mi(0, 0) * xp + Mi(0, 1) * yp + Mi(0, 2))
                / (Mi(2, 0) * xp + Mi(2, 1) * yp + Mi(2, 2)))

    def losses(self, out: dict, batch: dict) -> dict:
        """`Model.losses` of the BP profile, each image's matrices in the
        backprojection."""
        m, beta, C = self.m, out["beta"], self.m["out_channels"]
        curve = 0.0
        for k in range(C):
            x = self.backproject(beta[:, k], out["M"], out["M_inv"])
            valid = batch["valid_points"][:, k]
            err = (batch["lanes"][:, k] - x) * valid
            n = valid.sum()
            curve = curve + torch.where(n > 0, (err * err).sum()
                                        / n.clamp(min=1.0),
                                        torch.zeros_like(n))
        line = model.bce(out["line"], batch["line"])
        horizon = model.bce(out["horizon"], batch["horizon"])
        return {"loss": curve / C * m["weight_fit"]
                + (line + horizon) * m["weight_class"],
                "loss_line": line, "loss_horizon": horizon}


def train_reference(m: dict, state: Dict[str, torch.Tensor],
                    batches: List[dict], dropout: torch.Generator,
                    optim: dict, device) -> dict:
    """`check.train_reference` on `LearnedModel`, with the first step's
    matrices: {"losses", "grad", "state", "M" (B, 3, 3)}."""
    ref = LearnedModel(m, device)
    p = {k: v.detach().clone().float() if v.is_floating_point()
         else v.detach().clone() for k, v in state.items()}
    params = {k: v.requires_grad_() for k, v in p.items()
              if not k.endswith(("running_mean", "running_var",
                                 "num_batches_tracked"))}
    opt = torch.optim.Adam(list(params.values()), lr=optim["lr"],
                           betas=tuple(optim["betas"]), eps=optim["eps"])
    losses, grad, M = [], None, None
    with check.exact_float32():
        for batch in batches:
            opt.zero_grad(set_to_none=True)
            out = ref.forward(p, batch["image"], True, dropout)
            terms = ref.losses(out, batch)
            terms["loss"].backward()
            if grad is None:
                grad = {k: (v.grad.detach().clone() if v.grad is not None
                            else torch.zeros_like(v))
                        for k, v in params.items()}
                M = out["M"].detach().clone()
            opt.step()
            losses.append({k: float(v.detach()) for k, v in terms.items()})
    return {"losses": losses, "grad": grad, "M": M,
            "state": {k: v.detach() for k, v in p.items()}}


def homography_gaps(prog: dict, ref: dict) -> dict:
    """The two numbers this configuration adds to `check.train_gaps`:

    - M_gap: the first step's matrices, max |M_prog - M_ref| / max
      |M_ref| over the batch;
    - head_grad_gap: the worst `homography_head.*` leaf of the first
      gradient's norm, each leaf against max(its norm, the head's median
      leaf's): the whole model's median, which `grad_gap` takes, lies
      above most of the head's leaves.

    `prog` and `ref` as `check.train_gaps` takes them, each with "M"
    (matrices of another shape read inf).
    Returns {name: value, "where": {name: leaf}}."""
    M_ref = ref["M"].double()
    M_gap = (float((prog["M"].double() - M_ref).abs().max()
                   / M_ref.abs().max())
             if prog["M"].shape == M_ref.shape else math.inf)
    g_ref = {k: check._norm(v) for k, v in ref["grad"].items()
             if k.startswith(HEAD + ".")}
    g_prog = {k: check._norm(prog["grad"][k]) for k in g_ref}
    gap, at = check._worst_leaf(g_prog, g_ref)
    return {"M_gap": M_gap if math.isfinite(M_gap) else math.inf,
            "head_grad_gap": gap, "where": {"head_grad_gap": at}}
