"""The plain reference of LaneNet: ERFNet, the line and horizon heads, the
weighted-least-squares fit, the losses and the lane projection.

Plain PyTorch over a dict of tensors named as the reference repository's
checkpoints name them (`net.encoder.layers.3.conv3x1_1.weight`, ...), in
NCHW and in float32, autograd for the gradients. It imports nothing of
the program. The math follows the published model:

- ERFNet (Romera et al. 2018): downsampler = 3x3/s2 convolution beside a
  2x2 max pool, BatchNorm (eps 1e-3), relu; non-bottleneck-1D = 3x1, relu,
  1x3, BatchNorm, relu, dilated 3x1, relu, dilated 1x3, BatchNorm,
  Dropout2d, residual relu; upsampler = 3x3/s2 transposed convolution,
  BatchNorm, relu; output head a 2x2/s2 transposed convolution;
- BatchNorm in train mode normalizes with the batch's biased variance
  mean(x^2) - mean(x)^2, which the running variance also accumulates
  (momentum 0.1 on the new value);
- Dropout2d drops whole channels of a sample: one (B, C) draw per
  encoder block from the step's generator, `u < keep`, the rest scaled
  by 1 / keep (the encoder's 64-channel blocks 0.03, its 128-channel
  blocks 0.3, the decoder none);
- the heads (BatchNorm eps 1e-5): four convolutions 1x1, 3x3, 3x3, 3x3
  (128, 128, 64, 64 channels), then a 2x2 max pool and two linear layers
  (line) or the mean over the width and one linear layer (horizon);
- the fit: w = act(logits) with the rows above the mask zeroed, the
  separable moments of w^2 (`geometry.fit_constants`), a Cholesky solve.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import geometry

Params = Dict[str, torch.Tensor]

ENC_DILATIONS = [1] * 5 + [2, 4, 8, 16] * 2
DROP_64, DROP_128 = 0.03, 0.3
BN_EPS_NET, BN_EPS_HEAD = 1e-3, 1e-5
MOMENTUM = 0.1  # weight of the new batch statistic in the running one
ACTIVATIONS = {"square": lambda x: x * x, "sigmoid": torch.sigmoid,
               "relu": torch.relu, "abs": torch.abs, "none": lambda x: x,
               "softplus": F.softplus}
LINE_ORDER = [1, 2, 0, 3]  # line-head slots [ll, l, r, rr] -> [l, r, ll, rr]


# ----------------------------------------------------------------------
# Names and shapes
# ----------------------------------------------------------------------

def _bn(pre: str, c: int) -> List[Tuple[str, tuple]]:
    return [(f"{pre}.weight", (c,)), (f"{pre}.bias", (c,)),
            (f"{pre}.running_mean", (c,)), (f"{pre}.running_var", (c,)),
            (f"{pre}.num_batches_tracked", ())]


def _conv(pre: str, shape: tuple) -> List[Tuple[str, tuple]]:
    """A convolution's weight and bias; a transposed one's shape is (in,
    out, kh, kw), its bias `out`."""
    return [(f"{pre}.weight", shape), (f"{pre}.bias", (shape[0],))]


def _convt(pre: str, shape: tuple) -> List[Tuple[str, tuple]]:
    return [(f"{pre}.weight", shape), (f"{pre}.bias", (shape[1],))]


def _nb1d(pre: str, c: int) -> List[Tuple[str, tuple]]:
    return (_conv(f"{pre}.conv3x1_1", (c, c, 3, 1))
            + _conv(f"{pre}.conv1x3_1", (c, c, 1, 3)) + _bn(f"{pre}.bn1", c)
            + _conv(f"{pre}.conv3x1_2", (c, c, 3, 1))
            + _conv(f"{pre}.conv1x3_2", (c, c, 1, 3)) + _bn(f"{pre}.bn2", c))


def _head(pre: str, kind: str, resize: int, profile: str):
    chans = (128, 128, 128, 64, 64)
    out = []
    for i in range(4):
        k = 1 if i == 0 else 3
        out += _conv(f"{pre}.conv{i + 1}", (chans[i + 1], chans[i], k, k))
        out += _bn(f"{pre}.conv{i + 1}_bn", chans[i + 1])
    rows, cols = resize // 8, resize // 4
    if kind == "line":
        out += _conv(f"{pre}.fully_connected1",
                     (128, 64 * (rows // 2) * (cols // 2)))
        if profile == "bev":
            for k in range(1, 5):
                out += _conv(f"{pre}.fully_connected_line{k}", (3, 128))
        else:
            out += _conv(f"{pre}.fully_connected_line1", (4, 128))
    else:
        out += _conv(f"{pre}.fully_connected_horizon", (resize, 64 * rows))
    return out


def param_shapes(model: dict) -> Dict[str, tuple]:
    """{name: shape} of every tensor of the model's state, in the order of
    the reference checkpoints. `model`: the configuration file's `model`
    section."""
    C = model["out_channels"]
    e, d = "net.encoder", "net.decoder"
    out = _conv(f"{e}.initial_block.conv", (13, 3, 3, 3))
    out += _bn(f"{e}.initial_block.bn", 16)
    out += _conv(f"{e}.layers.0.conv", (48, 16, 3, 3)) + _bn(
        f"{e}.layers.0.bn", 64)
    for i in range(1, 6):
        out += _nb1d(f"{e}.layers.{i}", 64)
    out += _conv(f"{e}.layers.6.conv", (64, 64, 3, 3)) + _bn(
        f"{e}.layers.6.bn", 128)
    for i in range(7, 15):
        out += _nb1d(f"{e}.layers.{i}", 128)
    out += _conv(f"{e}.output_conv", (C, 128, 1, 1))
    out += _convt(f"{d}.layers.0.conv", (128, 64, 3, 3)) + _bn(
        f"{d}.layers.0.bn", 64)
    out += _nb1d(f"{d}.layers.1", 64) + _nb1d(f"{d}.layers.2", 64)
    out += _convt(f"{d}.layers.3.conv", (64, 16, 3, 3)) + _bn(
        f"{d}.layers.3.bn", 16)
    out += _nb1d(f"{d}.layers.4", 16) + _nb1d(f"{d}.layers.5", 16)
    out += _convt(f"{d}.output_conv", (16, C, 2, 2))
    if model["clas"]:
        for pre, kind in (("line_classification", "line"),
                          ("horizon_estimation", "horizon")):
            out += _head(pre, kind, model["resize"], model["profile"])
    return dict(out)


TRANSPOSED = ("net.decoder.layers.0.conv.weight",
              "net.decoder.layers.3.conv.weight",
              "net.decoder.output_conv.weight")


def state_spec(model: dict) -> Dict[str, Tuple[tuple, str, int]]:
    """{name: (shape, kind, fan_in)}: kind is 'weight' or 'bias' of a
    convolution or linear layer, or 'bn_weight', 'bn_bias',
    'running_mean', 'running_var', 'count' of a BatchNorm; fan_in is the
    inputs a weight's output sums over (a transposed convolution's (in,
    out, k, k) weight: in * k * k), 0 for the rest."""
    out = {}
    for name, shape in param_shapes(model).items():
        owner, leaf = name.rsplit(".", 2)[-2:]
        bn = owner.startswith("bn") or owner.endswith("_bn")
        fan = 0
        if leaf == "num_batches_tracked":
            kind = "count"
        elif leaf in ("running_mean", "running_var"):
            kind = leaf
        elif bn:
            kind = "bn_" + leaf
        else:
            kind = leaf
            if leaf == "weight":
                fan = (shape[0] * shape[2] * shape[3] if name in TRANSPOSED
                       else int(torch.Size(shape[1:]).numel()))
        out[name] = (tuple(shape), kind, fan)
    return out


# ----------------------------------------------------------------------
# Layers
# ----------------------------------------------------------------------

def batchnorm(x: torch.Tensor, p: Params, pre: str, train: bool,
              eps: float) -> torch.Tensor:
    """Train mode: the batch's statistics, the running ones updated in
    place; eval mode: the running ones."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            for key, v in (("running_mean", mean), ("running_var", var)):
                p[f"{pre}.{key}"].mul_(1.0 - MOMENTUM).add_(
                    v.detach(), alpha=MOMENTUM)
    else:
        mean, var = p[f"{pre}.running_mean"], p[f"{pre}.running_var"]
    mul = p[f"{pre}.weight"] * torch.rsqrt(var + eps)
    add = p[f"{pre}.bias"] - mean * mul
    return x * mul[None, :, None, None] + add[None, :, None, None]


def conv(x, p, pre, **kw):
    return F.conv2d(x, p[f"{pre}.weight"], p[f"{pre}.bias"], **kw)


def downsampler(x, p, pre, train):
    y = torch.cat([conv(x, p, f"{pre}.conv", stride=2, padding=1),
                   F.max_pool2d(x, 2, 2)], dim=1)
    return torch.relu(batchnorm(y, p, f"{pre}.bn", train, BN_EPS_NET))


def upsampler(x, p, pre, train):
    y = F.conv_transpose2d(x, p[f"{pre}.conv.weight"], p[f"{pre}.conv.bias"],
                           stride=2, padding=1, output_padding=1)
    return torch.relu(batchnorm(y, p, f"{pre}.bn", train, BN_EPS_NET))


def nb1d(x, p, pre, d, train, drop=0.0, generator=None):
    y = torch.relu(conv(x, p, f"{pre}.conv3x1_1", padding=(1, 0)))
    y = conv(y, p, f"{pre}.conv1x3_1", padding=(0, 1))
    y = torch.relu(batchnorm(y, p, f"{pre}.bn1", train, BN_EPS_NET))
    y = torch.relu(conv(y, p, f"{pre}.conv3x1_2", padding=(d, 0),
                        dilation=(d, 1)))
    y = conv(y, p, f"{pre}.conv1x3_2", padding=(0, d), dilation=(1, d))
    y = batchnorm(y, p, f"{pre}.bn2", train, BN_EPS_NET)
    if train and drop > 0.0 and generator is not None:
        keep = 1.0 - drop
        mask = torch.rand(y.shape[0], y.shape[1], generator=generator,
                          device=y.device, dtype=torch.float32) < keep
        y = y * mask.to(y.dtype)[:, :, None, None] / keep
    return torch.relu(y + x)


def erfnet(x: torch.Tensor, p: Params, train: bool,
           generator: Optional[torch.Generator] = None):
    """images NCHW -> (encoder features (B, 128, H/8, W/8), logits (B, C,
    H, W))."""
    e, d = "net.encoder", "net.decoder"
    x = downsampler(x, p, f"{e}.initial_block", train)
    x = downsampler(x, p, f"{e}.layers.0", train)
    for i in range(5):
        x = nb1d(x, p, f"{e}.layers.{1 + i}", ENC_DILATIONS[i], train,
                 DROP_64, generator)
    x = downsampler(x, p, f"{e}.layers.6", train)
    for i in range(8):
        x = nb1d(x, p, f"{e}.layers.{7 + i}", ENC_DILATIONS[5 + i], train,
                 DROP_128, generator)
    enc = x
    x = upsampler(x, p, f"{d}.layers.0", train)
    x = nb1d(x, p, f"{d}.layers.1", 1, train)
    x = nb1d(x, p, f"{d}.layers.2", 1, train)
    x = upsampler(x, p, f"{d}.layers.3", train)
    x = nb1d(x, p, f"{d}.layers.4", 1, train)
    x = nb1d(x, p, f"{d}.layers.5", 1, train)
    logits = F.conv_transpose2d(x, p[f"{d}.output_conv.weight"],
                                p[f"{d}.output_conv.bias"], stride=2)
    return enc, logits


def head(x: torch.Tensor, p: Params, pre: str, kind: str, profile: str,
         train: bool) -> torch.Tensor:
    """Line logits (B, 4) 'bp' or (B, 3, 4) 'bev', or horizon logits (B,
    resize), from the encoder features."""
    for i in range(1, 5):
        x = conv(x, p, f"{pre}.conv{i}", padding=0 if i == 1 else 1)
        x = torch.relu(batchnorm(x, p, f"{pre}.conv{i}_bn", train,
                                 BN_EPS_HEAD))
    lin = lambda x, n: F.linear(x, p[f"{pre}.{n}.weight"],
                                p[f"{pre}.{n}.bias"])
    if kind == "line":
        x = torch.relu(lin(F.max_pool2d(x, 2, 2).flatten(1),
                           "fully_connected1"))
        if profile == "bev":
            return torch.stack([lin(x, f"fully_connected_line{k}")
                                for k in range(1, 5)], dim=2)
        return lin(x, "fully_connected_line1")
    return lin(x.mean(dim=3).flatten(1), "fully_connected_horizon")


# ----------------------------------------------------------------------
# Fit, losses, projection
# ----------------------------------------------------------------------

def spd_solve(Z: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Z b = rhs for small SPD Z (..., n, n), by Cholesky, element-wise."""
    n = Z.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = Z[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s)
        for i in range(j + 1, n):
            s = Z[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    y = []
    for i in range(n):
        s = rhs[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y.append(s / L[i][i])
    b = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * b[k]
        b[i] = s / L[i][i]
    return torch.stack(b, dim=-1)


class Model:
    """The reference of one configuration (`model`: the configuration
    file's `model` section) on `device`: float32 constants of the fit and
    the projection, and the forward of both phases."""

    def __init__(self, model: dict, device, round_tail=None):
        """`round_tail`: a function applied to the operands of the fit's
        moments and of the projection (the serving control's lower
        precision of the stages the configuration states in float32);
        None computes them in float32."""
        self.m = model
        self.device = torch.device(device)
        self.round = round_tail or (lambda t: t)
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                        device=self.device)
        fc = geometry.fit_constants(model["profile"], model["resize"],
                                    model["order"], model["reg_ls"],
                                    model["no_mapping"])
        self.coeff, self.xs = f32(fc["coeff"]), f32(fc["xs"])
        self.reg_diag, self.unscale = f32(fc["reg_diag"]), f32(fc["unscale"])
        self.zero_rows = geometry.zero_rows(model["resize"],
                                            model["mask_percentage"])
        self.act = ACTIVATIONS[model["activation"]]
        if model["profile"] == "bp":
            self.loss_proj, self.proj = (
                self._projection(model, factor) for factor in (2.5, None))

    def _projection(self, model: dict, factor) -> dict:
        """The projection's constants: float32 tensors, and M_inv as
        Python floats (scalars of the element-wise contraction)."""
        c = geometry.projection_constants(model["resize"], model["order"],
                                          model["no_mapping"], factor)
        f32 = dict(dtype=torch.float32, device=self.device)
        return {"Y": torch.as_tensor(c["Y"], **f32),
                "y_prime": torch.as_tensor(c["y_prime"], **f32),
                "M_inv": [[float(v) for v in row] for row in c["M_inv"]],
                "factor": c["factor"]}

    # -- forward -------------------------------------------------------
    def normal(self, logits: torch.Tensor, second: bool = False) -> dict:
        """logits (B, C, H, W) -> {"Z": the fit's normal matrix sum w^2 Y
        Y^T (B, C, o1, o1) in the scaled basis, before the regularizer;
        "rhs": its right-hand side sum w^2 x Y (B, C, o1)}; with `second`
        also "m2": sum w^2 x^2 (B, C), float64, x each pixel's position
        in the fit's plane. The basis's last power is 0, so Z[..., -1,
        -1] is the lane's weight mass sum w^2."""
        w = self.act(logits)
        w2 = w * w
        w2 = torch.cat([torch.zeros_like(w2[:, :, :self.zero_rows]),
                        w2[:, :, self.zero_rows:]], dim=2)
        S0, S1 = w2.sum(dim=3), (w2 * self.xs).sum(dim=3)       # (B, C, H)
        S = self.round(torch.cat([S0, S1], dim=-1))              # (B, C, 2H)
        moments = (S.unsqueeze(-1) * self.round(self.coeff)).sum(dim=2)
        o1 = self.m["order"] + 1
        out = {"Z": moments[..., :o1 * o1].reshape(*moments.shape[:2], o1,
                                                   o1),
               "rhs": moments[..., o1 * o1:]}
        if second:
            # x = a_r + b_r xs on row r: the power-0 column of the basis
            H, col = S0.shape[-1], o1 * o1 + o1 - 1
            a, b = self.coeff[:H, col].double(), self.coeff[H:, col].double()
            S2 = (w2 * self.xs * self.xs).sum(dim=3).double()
            out["m2"] = (a * a * S0.double() + 2.0 * a * b * S1.double()
                         + b * b * S2).sum(-1)
        return out

    def fit(self, logits: torch.Tensor, with_normal: bool = False):
        """logits (B, C, H, W) -> beta (B, C, order+1); with `with_normal`
        (beta, `normal(logits, second=True)`)."""
        n = self.normal(logits, second=with_normal)
        Z0 = n["Z"]
        o1 = Z0.shape[-1]
        trace = torch.diagonal(Z0, dim1=-2, dim2=-1).sum(-1, keepdim=True)
        floor = (geometry.REG_FLOOR * (trace / o1)
                 + torch.finfo(torch.float32).tiny)
        Z = Z0 + torch.diag_embed(self.reg_diag + floor)
        beta = spd_solve(Z, n["rhs"]) * self.unscale
        return (beta, n) if with_normal else beta

    def forward(self, p: Params, images: torch.Tensor, train: bool,
                generator: Optional[torch.Generator] = None,
                with_normal: bool = False) -> dict:
        """images (B, H, W, 3) float in [0, 1] -> {beta, line, horizon}
        (the heads where the configuration has them), with `with_normal`
        also the fit's moments (`normal(..., second=True)`) as `normal`."""
        x = images.permute(0, 3, 1, 2).contiguous()
        enc, logits = erfnet(x, p, train, generator)
        if with_normal:
            beta, n = self.fit(logits, with_normal=True)
            out = {"beta": beta, "normal": n}
        else:
            out = {"beta": self.fit(logits)}
        if self.m["clas"]:
            out["line"] = head(enc, p, "line_classification", "line",
                               self.m["profile"], train)
            out["horizon"] = head(enc, p, "horizon_estimation", "horizon",
                                  self.m["profile"], train)
        return out

    # -- training loss -------------------------------------------------
    def _backproject(self, beta: torch.Tensor, c: dict) -> torch.Tensor:
        """beta (..., o1) -> x at the 56 heights (..., 56), resized px."""
        x_prime = (self.round(beta)[..., None, :] * self.round(c["Y"])).sum(-1)
        Mi, yp = c["M_inv"], c["y_prime"]
        den = Mi[2][0] * x_prime + Mi[2][1] * yp + Mi[2][2]
        return (Mi[0][0] * x_prime + Mi[0][1] * yp + Mi[0][2]) / den

    def losses(self, out: dict, batch: dict) -> dict:
        """{loss, and loss_line, loss_horizon with the heads}: the e2e
        objective, weight_fit * curve + weight_class * (line + horizon)."""
        m, beta = self.m, out["beta"]
        C = m["out_channels"]
        curve = 0.0
        if m["profile"] == "bp":
            for k in range(C):
                x = self._backproject(beta[:, k], self.loss_proj)
                valid = batch["valid_points"][:, k]
                err = (batch["lanes"][:, k] - x) * valid
                n = valid.sum()
                curve = curve + torch.where(
                    n > 0, (err * err).sum() / n.clamp(min=1.0),
                    torch.zeros_like(n))
            curve = curve / C
        else:
            for k in range(C):
                curve = curve + area_loss(beta[:, k], batch["params"][:, k])
        res = {"loss": curve}
        if m["clas"]:
            if m["profile"] == "bev":
                lp = F.log_softmax(out["line"], dim=1)
                line = -lp.gather(1, batch["line"].long().unsqueeze(1)).mean()
            else:
                line = bce(out["line"], batch["line"])
            horizon = bce(out["horizon"], batch["horizon"])
            res.update(loss=curve * m["weight_fit"]
                       + (line + horizon) * m["weight_class"],
                       loss_line=line, loss_horizon=horizon)
        return res

    # -- served lanes --------------------------------------------------
    def project(self, beta: torch.Tensor) -> torch.Tensor:
        """The ungated x of each lane at the 56 heights, original-image
        pixels."""
        return self._backproject(beta.float(), self.proj) * self.proj["factor"]

    def lanes(self, beta, line, horizon) -> Tuple[torch.Tensor, dict]:
        """The served lanes (B, C, 56) in original-image pixels, -2 where
        gated, and {x: the ungated x, gate: the line logits in lane order,
        arg: the horizon rounding argument, bound: the row bound}, the
        quantities each gate decides on."""
        c = self.proj
        x = self.project(beta)                                    # (B,C,56)
        info = {"x": x}
        if self.m["clas"]:
            arg = (c["factor"] * torch.sigmoid(horizon).sum(1) + 80.0) / 10.0
            bound = (torch.round(arg) * 10.0 - 160.0) / 10.0      # (B,)
            present = torch.round(torch.sigmoid(line))[:, LINE_ORDER] > 0
            x = torch.where(present[:, :, None], x, -2.0)
            cols = torch.arange(x.shape[-1], device=x.device,
                                dtype=torch.float32)
            x = torch.where(cols[None, None, :] < bound[:, None, None],
                            -2.0, x)
            info.update(gate=line[:, LINE_ORDER], arg=arg, bound=bound)
        x = torch.where((x > 1279.0) | (x < 0.0), -2.0, x)
        return x, info


def area_loss(params: torch.Tensor, gt: torch.Tensor,
              t: float = 0.7) -> torch.Tensor:
    """int_0^t (x_pred(y) - x_gt(y))^2 dy of order-2 curves, averaged
    over the present lanes (no gt coefficient 0), 0 with none."""
    diff = params - gt
    a, b, c = diff[:, 0], diff[:, 1], diff[:, 2]
    fit = (a * a * t ** 5 / 5 + a * b * t ** 4 / 2
           + (b * b + 2 * a * c) * t ** 3 / 3 + b * c * t ** 2 + c * c * t)
    present = (gt != 0).all(dim=1)
    n = present.sum()
    total = torch.where(present, fit, torch.zeros_like(fit)).sum()
    return torch.where(n > 0, total / n.clamp(min=1), torch.zeros_like(total))


def bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy with logits, the mean."""
    t = targets.to(logits.dtype)
    return (torch.clamp(logits, min=0) - logits * t
            + torch.log1p(torch.exp(-logits.abs()))).mean()
