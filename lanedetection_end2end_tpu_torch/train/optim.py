"""Optimizers.

Counterpart of `define_optim`, `set_lr` and `get_lr` in
`lanedetection_end2end_tpu/train/optim.py`, on `torch.optim`:

- adam (betas 0.9 / 0.999, eps 1e-8), sgd (momentum 0.9), rmsprop (alpha
  0.99, eps 1e-8 outside the square root, momentum 0.9);
- L2 weight decay added to the raw gradient before the update
  (`weight_decay` of `torch.optim`, not decoupled AdamW decay);
- optional clipping of the gradients' global norm, ahead of the decay, as
  a pre-step hook of the optimizer.

The learning rate is set by the host between epochs (`set_lr`). The
epoch schedules are not ported yet.
"""

from __future__ import annotations

from typing import Iterable

import torch


def _clip_by_global_norm(optimizer: torch.optim.Optimizer,
                         max_norm: float) -> None:
    """g <- g * max_norm / max(norm, max_norm) over all gradients."""
    grads = [p.grad for group in optimizer.param_groups
             for p in group["params"] if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def define_optim(params: Iterable[torch.nn.Parameter], name: str,
                 learning_rate: float, weight_decay: float = 0.0,
                 clip_grad_norm: float = 0.0) -> torch.optim.Optimizer:
    """The optimizer `name` over `params`."""
    if name == "adam":
        opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                               eps=1e-8, weight_decay=weight_decay)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=learning_rate, momentum=0.9,
                              weight_decay=weight_decay)
    elif name == "rmsprop":
        opt = torch.optim.RMSprop(params, lr=learning_rate, alpha=0.99,
                                  eps=1e-8, momentum=0.9,
                                  weight_decay=weight_decay)
    else:
        raise KeyError(f"The requested optimizer: {name} is not implemented")
    if clip_grad_norm:
        opt.register_step_pre_hook(
            lambda o, args, kwargs: _clip_by_global_norm(o, clip_grad_norm))
    return opt


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_lr(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])
