"""The collectives of the data-parallel step, on `torch.distributed`.

Counterpart of the `jax.lax.pmean` calls that the JAX package writes by
hand inside `shard_map` (`train/steps.py::make_train_step`,
`ops/packed_graph.py::_channel_moments`). Only `all_reduce`,
`broadcast` and `barrier` are used: the collectives that gloo supports on
CUDA tensors, so the same code runs on NCCL (a card per rank), on gloo on
the CPU, and on gloo with several ranks sharing one card.

- `all_reduce_mean(x, group)`: the mean of x over the ranks,
  differentiable; its backward is the same mean of the cotangents, the
  transpose of JAX's `pmean`, so each rank's gradient is that of the mean
  loss over the global batch;
- `gather_rows(x, group)`: every rank's rows of x in rank order, by an
  all_reduce of a zero-filled global buffer;
- `all_reduce_grads(params, group)`: the gradients' mean, one flat
  buffer and one call;
- `set_sync_group(module, group)`: makes the train-mode BatchNorms of
  `module` reduce their moments over `group`.

A group of None is one process: every function returns its input.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def rank_of(group) -> int:
    """This process's rank in `group`; 0 for None."""
    return 0 if group is None else dist.get_rank(group)


def _mean(x: torch.Tensor, group) -> torch.Tensor:
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y / dist.get_world_size(group)


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _mean(x, group)

    @staticmethod
    def backward(ctx, g):
        return _mean(g, ctx.group), None


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of x over the ranks of `group` (x itself for None),
    differentiable: the backward takes the same mean of the cotangents."""
    if group is None:
        return x
    return _AllReduceMean.apply(x, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(b, ...) on each rank -> (world * b, ...), rank r's rows at [r*b,
    (r+1)*b): an all_reduce of a zero-filled buffer into which each rank
    writes its own rows. Not differentiable. bool travels as uint8."""
    if group is None:
        return x
    b, r = x.shape[0], dist.get_rank(group)
    dtype = torch.uint8 if x.dtype == torch.bool else x.dtype
    out = x.new_zeros((dist.get_world_size(group) * b,) + tuple(x.shape[1:]),
                      dtype=dtype)
    out[r * b:(r + 1) * b] = x.detach()
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


def all_reduce_grads(params: Sequence[torch.nn.Parameter], group) -> None:
    """Replace every parameter's gradient by its mean over the ranks, in
    place: one flat buffer in parameter order, one all_reduce. Every
    parameter must hold a gradient of one dtype."""
    if group is None:
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def set_sync_group(module: torch.nn.Module, group) -> None:
    """Every `models/erfnet.py::BatchNorm2d` in `module` (the backbone's,
    the heads', the homography head's) reduces its train-mode mean and
    mean of squares over `group`, on the plain graph and on the packed
    backbone (`ops/packed_graph.py::bn_mul_add`) alike. None: each
    process normalizes with its own batch."""
    from lanedetection_end2end_tpu_torch.models.erfnet import BatchNorm2d
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.sync_group = group
