"""Optimizers and learning-rate schedules.

Counterpart of `define_optim`, `set_lr`, `get_lr` and `Scheduler` in
`lanedetection_end2end_tpu/train/optim.py`, on `torch.optim`:

- adam (betas 0.9 / 0.999, eps 1e-8), sgd (momentum 0.9), rmsprop (alpha
  0.99, eps 1e-8 outside the square root, momentum 0.9);
- L2 weight decay added to the raw gradient before the update
  (`weight_decay` of `torch.optim`, not decoupled AdamW decay);
- optional clipping of the gradients' global norm, ahead of the decay, as
  a pre-step hook of the optimizer.

The learning rate is set by the host between epochs (`set_lr`) from the
epoch schedule of `Scheduler`: lambda and step at an epoch's start,
plateau at its end on the epoch's score. The plateau rule is the JAX
package's: a score improves on the best only when it is below best - 1e-4
(an absolute threshold), where torch's `ReduceLROnPlateau` defaults to a
relative one.
"""

from __future__ import annotations

from typing import Iterable, Optional

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


class Scheduler:
    """Epoch-level learning-rate schedule (host side, stateful for plateau).

    lambda:  lr * (1 - max(0, e+1-niter)/(niter_decay+1))
    step:    lr * gamma^(e // lr_decay_iters)
    plateau: decay by gamma once the score has not gone below best - 1e-4
             for more than lr_decay_iters epochs
    none/None: constant.
    """

    def __init__(self, policy: Optional[str], base_lr: float,
                 niter: int = 50, niter_decay: int = 400, gamma: float = 0.0,
                 lr_decay_iters: int = 30):
        if policy not in (None, "none", "lambda", "step", "plateau"):
            raise NotImplementedError(
                "learning rate policy [%s] is not implemented" % policy)
        self.policy = None if policy == "none" else policy
        self.base_lr = base_lr
        self.niter = niter
        self.niter_decay = niter_decay
        self.gamma = gamma
        self.lr_decay_iters = lr_decay_iters
        self._lr = base_lr
        self._best = float("inf")
        self._num_bad = 0

    def epoch_lr(self, epoch: int) -> float:
        """lr for this epoch; call at the epoch's start (lambda, step)."""
        if self.policy == "lambda":
            factor = 1.0 - max(0, epoch + 1 - self.niter) / float(
                self.niter_decay + 1)
            self._lr = self.base_lr * factor
        elif self.policy == "step":
            self._lr = self.base_lr * (
                self.gamma ** (epoch // self.lr_decay_iters))
        return self._lr

    def plateau_step(self, score: float) -> float:
        """Call at the epoch's end with its score (plateau)."""
        if self.policy != "plateau":
            return self._lr
        if score < self._best - 1e-4:
            self._best = score
            self._num_bad = 0
        else:
            self._num_bad += 1
            if self._num_bad > self.lr_decay_iters:
                self._lr *= self.gamma
                self._num_bad = 0
        return self._lr
