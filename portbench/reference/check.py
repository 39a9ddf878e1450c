"""The reference's side of `correct`: it recomputes from the benchmark's
own inputs what the program's timed path produced, and the gaps between
the two.

Training (`train_reference`, `train_gaps`): three steps of the e2e
objective with Adam from the same weights, batches and dropout seed,
then the worst of each step's loss terms, of the first gradient's norm
per leaf and of the norm of each leaf's change after the three steps.
Serving (`serve_reference`, `serve_gaps`): the eval-mode forward of every
frame batch of the pool, then the gaps of beta, of the line and horizon
logits and of the served lanes, call by call.

It imports nothing of the program and runs in float32 with TF32 off,
the flags restored after it.
"""

from __future__ import annotations

import contextlib
import math
import statistics
from typing import Dict, List

import torch

from portbench.reference import model
from portbench.reference.model import Model

BETA1 = 0.9  # Adam's first-moment decay: the first gradient is m / (1 - b1)
# a parameter whose reference gradient is under STILL times the median
# leaf's moves under Adam by round-off alone: left out of change_gap
STILL = 1e-3


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and cuDNN within the block."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


# ----------------------------------------------------------------------
# Training
# ----------------------------------------------------------------------

def train_reference(model: dict, state: Dict[str, torch.Tensor],
                    batches: List[dict], dropout: torch.Generator,
                    optim: dict, device) -> dict:
    """Steps on `batches` in order from `state` (copied): {"losses": [per
    step {term: float}], "grad": {param: first gradient}, "state": {name:
    tensor after the last step}}. `optim`: the configuration's
    optimizer section (Adam: lr, betas, eps)."""
    ref = Model(model, device)
    p = {k: v.detach().clone().float() if v.is_floating_point()
         else v.detach().clone() for k, v in state.items()}
    params = {k: v.requires_grad_() for k, v in p.items()
              if not k.endswith(("running_mean", "running_var",
                                 "num_batches_tracked"))}
    opt = torch.optim.Adam(list(params.values()), lr=optim["lr"],
                           betas=tuple(optim["betas"]), eps=optim["eps"])
    losses, grad = [], None
    with exact_float32():
        for batch in batches:
            opt.zero_grad(set_to_none=True)
            terms = ref.losses(ref.forward(p, batch["image"], True, dropout),
                               batch)
            terms["loss"].backward()
            if grad is None:
                grad = {k: (v.grad.detach().clone() if v.grad is not None
                            else torch.zeros_like(v)) for k, v in
                        params.items()}
            opt.step()
            losses.append({k: float(v.detach()) for k, v in terms.items()})
    return {"losses": losses, "grad": grad,
            "state": {k: v.detach() for k, v in p.items()}}


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float]) -> tuple:
    """max over leaves of |prog - ref| / max(ref, the median leaf's ref),
    and that leaf."""
    med = statistics.median(ref.values())
    worst, at = 0.0, None
    for k, r in ref.items():
        gap = abs(prog[k] - r) / max(r, med, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst or at is None:
            worst, at = gap, k
    return worst, at


def train_gaps(prog: dict, ref: dict,
               state0: Dict[str, torch.Tensor]) -> dict:
    """The numbers compared for a training cell.

    `prog`: {"losses": [per step {term: float}], "grad": {param: first
    gradient}, "state": {name: tensor after the checked steps}}, read
    from the program; `ref`: `train_reference`'s; `state0`: the state
    both started from.

    - loss_gap: max over the first step's loss terms of |prog - ref| /
      |ref| (the later steps' losses are reported beside it, under
      "where", and not compared: Adam's first updates are near lr * sign(g)
      for every element, so round-off in a near-zero gradient element
      moves it by a whole lr and the later losses of two sound runs part
      by percents);
    - grad_gap: the worst leaf of the first gradient's norm;
    - change_gap: the worst leaf of the norm of the change after the
      steps, over the BatchNorm statistics and the parameters, leaving
      out each parameter whose reference gradient is under STILL times
      the median leaf's (a bias under a BatchNorm, say: it moves under
      Adam by round-off alone).

    Returns {name: value} and, under "where", the term or leaf that reads
    worst and the later steps' loss gaps."""
    gaps = [{term: abs(lp[term] - r) / max(abs(r), 1e-30)
             for term, r in lr.items()}
            for lp, lr in zip(prog["losses"], ref["losses"])]
    if not gaps or len(prog["losses"]) != len(ref["losses"]):
        loss_gap, loss_at = math.inf, "steps missing"
    else:
        loss_at = max(gaps[0], key=lambda k: (not math.isfinite(gaps[0][k]),
                                               gaps[0][k]))
        loss_gap = gaps[0][loss_at]
    later = ", ".join(f"step {t + 2} {max(g.values()):.3e}"
                      for t, g in enumerate(gaps[1:]))
    g_ref = {k: _norm(v) for k, v in ref["grad"].items()}
    g_prog = {k: _norm(prog["grad"][k]) for k in g_ref}
    grad_gap, grad_at = _worst_leaf(g_prog, g_ref)
    med = statistics.median(g_ref.values())
    moved = [k for k in ref["state"] if k not in g_ref or g_ref[k] >= STILL
             * med]
    moved = [k for k in moved if ref["state"][k].is_floating_point()]
    d_ref = {k: _norm(ref["state"][k].double() - state0[k].double())
             for k in moved}
    d_prog = {k: _norm(prog["state"][k].double() - state0[k].double())
              for k in moved}
    change_gap, change_at = _worst_leaf(d_prog, d_ref)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap,
            "where": {"loss_gap": f"step 1 {loss_at}; not compared: "
                                  f"{later}",
                      "grad_gap": grad_at, "change_gap": change_at}}


# ----------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------

def serve_reference(model: dict, state: Dict[str, torch.Tensor],
                    frames: torch.Tensor, device, round_to=None) -> list:
    """Per frame batch of the pool (uint8 (N, B, H, W, 3), any device):
    {beta, normal, line, horizon, lanes, x, gate, arg, bound} of the
    reference's eval forward, on `device`. `round_to`: a function applied to every
    convolution's input and weight (the control's lower precision)."""
    ref = Model(model, device)
    p = {k: v.detach().to(device).float() if v.is_floating_point()
         else v.detach().to(device) for k, v in state.items()}
    out = []
    with exact_float32(), torch.no_grad(), rounded(round_to):
        for j in range(frames.shape[0]):
            images = frames[j].to(device).float() * (1.0 / 255.0)
            o = ref.forward(p, images, train=False, with_normal=True)
            lanes, info = ref.lanes(o["beta"], o.get("line"),
                                    o.get("horizon"))
            out.append({**o, **info, "lanes": lanes})
    return out


@contextlib.contextmanager
def rounded(round_to):
    """Within the block, F.conv2d, F.conv_transpose2d and F.linear take
    `round_to` of their input and weight (nothing with None)."""
    if round_to is None:
        yield
        return
    import torch.nn.functional as F
    saved = {n: getattr(F, n) for n in ("conv2d", "conv_transpose2d",
                                        "linear")}

    def wrap(fn):
        return lambda x, w, *a, **k: fn(round_to(x), round_to(w), *a, **k)
    try:
        for n, fn in saved.items():
            setattr(F, n, wrap(fn))
        yield
    finally:
        for n, fn in saved.items():
            setattr(F, n, fn)


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude to 448), back in float32: the control's precision."""
    amax = t.detach().abs().amax().clamp_min(1e-30)
    s = 448.0 / amax
    return (t * s).to(torch.float8_e4m3fn).float() / s


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, in float64."""
    want = want.double()
    return float(torch.linalg.vector_norm(got.double() - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-300))


def serve_gaps(calls: list, refs: list, limits: dict, ref: Model) -> dict:
    """The numbers compared for a serving cell, over every call.

    `calls`: per call {"pool": index into `refs`, "beta", "line",
    "horizon" (the engine's outputs; line and horizon None without the
    heads), "lanes" (the served lanes, on the host)}; `refs`:
    `serve_reference`'s; `limits`: the cell's limits of fit_shift,
    logit_gap and lanes_px; `ref`: the reference `Model` whose float32
    projection and gates judge the served lanes.

    - fit_shift: beta judged where the lane's weight lies: over every
      call and lane, the weighted mean square gap between the served and
      the reference's fitted curves in the fit's plane, sum d^T Z d (d
      the coefficients' gap in the fit's scaled basis, Z the reference's
      normal matrix, so sum w^2 (x_served - x_ref)^2 over the pixels),
      over the weight's own spread about the reference's curve, sum w^2
      (x - x_ref)^2; its root. The rounding of the weight maps moves the
      fit in proportion to that spread, which random weights set anew
      with each seed: the gap in pixels read the sound engine from 0.011
      to 0.090 and the float8 control from 0.20 (returned beside as
      "fit_px"), and the curves' gap at the 56 heights, which reaches
      past the weight to the horizon, from 0.10 to 1.96 against 2.88;
    - logit_gap: the worse head's root mean square of |logit - ref| over
      every call, in logit units (against a norm of the reference's
      logits it read up to 0.059 on a sound seed, where the drawn weights
      made a head's logits small);
    - lanes_px: each call's served lanes against the reference's
      projection, gates and clip applied to the call's own beta and
      logits, which the two numbers above judge: max |lane - that| in
      pixels, leaving out the points within 0.01 px of the image's edges,
      where the clip decides on rounding. A call over its limit has
      `failed`.

    Returns {name: value, "failed", "judged": served points compared,
    "fit_px": sqrt(sum d^T Z d / sum w^2)}."""
    failed, judged, lanes_px = 0, 0, 0.0
    fit_sq, spread_sq, mass = 0.0, 0.0, 0.0
    heads = {}
    unscale = ref.unscale.double()
    for call in calls:
        r = refs[call["pool"]]
        nm = r["normal"]
        Z, b = nm["Z"].double(), r["beta"].double() / unscale
        d = call["beta"].double() / unscale - b
        fit_sq += float(torch.einsum("bci,bcij,bcj->", d, Z, d))
        spread = (nm["m2"] - 2.0 * (b * nm["rhs"].double()).sum(-1)
                  + torch.einsum("bci,bcij,bcj->bc", b, Z, b))
        spread_sq += float(spread.clamp(min=0.0).sum())
        mass += float(Z[..., -1, -1].sum())
        for k in ("line", "horizon"):
            if r.get(k) is not None:
                dk, n = heads.get(k, (0.0, 0))
                heads[k] = (dk + float(((call[k].double() - r[k].double())
                                        ** 2).sum()), n + r[k].numel())
        want, info = ref.lanes(call["beta"].float(), call["line"],
                               call["horizon"])
        served = torch.as_tensor(call["lanes"]).to(want.device)
        keep = ((info["x"] - 0.0).abs() > 0.01) & (
            (info["x"] - 1279.0).abs() > 0.01)
        gap = (served.double() - want.double()).abs()[keep]
        judged += int(keep.sum())
        worst = float(gap.max()) if gap.numel() else 0.0
        if not worst <= limits["lanes_px"]:
            failed += 1
        lanes_px = max(lanes_px, worst) if math.isfinite(worst) else math.inf
    shift = math.sqrt(fit_sq / spread_sq) if spread_sq > 0 else math.inf
    logit = max([math.sqrt(dk / max(n, 1)) for dk, n in heads.values()]
                or [0.0])
    return {"fit_shift": shift, "logit_gap": logit, "lanes_px": lanes_px,
            "failed": failed, "judged": judged,
            "fit_px": math.sqrt(fit_sq / mass) if mass > 0 else math.inf}


def bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16, back in float32."""
    return t.to(torch.bfloat16).float()


def program_train_record(losses: List[dict], exp_avg: Dict[str, torch.Tensor],
                         state: Dict[str, torch.Tensor]) -> dict:
    """The program's side of `train_gaps` from what its first steps left:
    each step's metrics, the optimizer's first moment after step one (the
    first gradient times 1 - b1) and the state after the steps."""
    return {"losses": losses,
            "grad": {k: v / (1.0 - BETA1) for k, v in exp_avg.items()},
            "state": state}

