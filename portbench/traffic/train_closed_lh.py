"""Closed-loop training of a configuration with the learned homography:
`train_closed`'s session (the same parameters, window and traced
stretch), on the model with the homography head, checked against
`reference/homography.py`.

Set-up differs from `train_closed` in four places: the configuration
file's `model` section also names `learn_homography`, held against the
program's `LaneConfig`; the program's graph for the e2e step
(`train/steps.py::resolve_packed`) is asked for before the kernel
libraries are built, so that a program whose packed path refuses the
configuration (a forced `packed_train`) fails within seconds; the state
is drawn from `homography.state_spec`, the head after every other
tensor; and the first checked step's matrices M (B, 3, 3) are kept from
the output of the program's forward (`LaneNet.apply_packed`, or
`LaneNet.forward` on the plain graph), wrapped on the instance for the
checked steps alone.

`check()` reports `train_closed`'s three numbers (`loss_gap`,
`grad_gap`, `change_gap`) and two more: `M_gap`, the first step's
matrices against the reference's, and `head_grad_gap`, the worst head
leaf of the first gradient against the head's own median leaf
(`homography.homography_gaps`). `ops()` adds the head's work
(`work/homography.py`) to the backbone's and the other heads'.
"""

from __future__ import annotations

import gc
from pathlib import Path

import torch

from portbench import harness, inputs
from portbench.harness import synchronize
from portbench.reference import check as refcheck
from portbench.reference import homography as refhom
from portbench.work import erfnet, homography

train_closed = harness.load_plugin("traffic", "train_closed",
                                   Path(__file__).resolve().parents[1])


class Session(train_closed.Session):

    def __init__(self, ctx):
        from lanedetection_end2end_tpu_torch.models import lanenet as ln
        from lanedetection_end2end_tpu_torch.train import optim, steps

        t = ctx.traffic
        self.ctx, self.B, self.pool = ctx, t["batch"], t["pool"]
        dev, m = ctx.device, ctx.model
        cfg = ctx.port_config(batch_size=self.B)
        if cfg.learn_homography != m["learn_homography"]:
            raise ValueError(f"{ctx.config['name']}: the program's preset "
                             f"gives learn_homography="
                             f"{cfg.learn_homography!r}, the configuration "
                             f"file {m['learn_homography']!r}")
        ctx.mark("imports")
        self.dtype = cfg.compute_dtype
        net = ln.LaneNet(cfg, device=dev)
        steps.resolve_packed(net, cfg, "e2e")
        ctx.build()
        self.state0 = inputs.make_state(refhom.state_spec(m), ctx.seed, dev)
        ctx.load_state(net, self.state0)
        opt = optim.define_optim(net.parameters(), cfg.optimizer,
                                 cfg.learning_rate)
        self.step = steps.make_train_step(net, cfg, opt, "e2e", device=dev)
        ctx.mark("model and weights")
        self.batches = inputs.training_batches(
            self.pool, self.B, m["resize"], m["profile"], ctx.seed, dev)
        self.gen = inputs.generator(ctx.seed, "dropout", dev)
        ctx.mark("traffic")
        kept = []

        def keeping_M(forward):
            def call(*a, **k):
                out = forward(*a, **k)
                if not kept:
                    kept.append(out.M.detach().clone())
                return out
            return call
        net.apply_packed = keeping_M(net.apply_packed)
        net.forward = keeping_M(net.forward)
        losses, exp_avg = [], None
        for i in range(t["check_steps"]):
            metrics = self.step(self.batches[i % self.pool], self.gen)
            losses.append({k: float(metrics[k]) for k in
                           ("loss", "loss_line", "loss_horizon")})
            if exp_avg is None:
                exp_avg = {n: opt.state[p]["exp_avg"].clone()
                           if p in opt.state else torch.zeros_like(p)
                           for n, p in net.named_parameters()}
        del net.apply_packed, net.forward
        state = {k: v.detach().clone() for k, v in net.state_dict().items()}
        self.prog = refcheck.program_train_record(losses, exp_avg, state)
        self.prog["M"] = kept[0]
        ctx.mark("checked steps")
        self.i = t["check_steps"]
        for _ in range(t["warm_steps"]):
            self._step()
        synchronize(dev)

    def ops(self):
        """`train_closed`'s work of one step, and the head's."""
        es = 2 if self.dtype == "bfloat16" else 4
        return (erfnet.train_ops(self.ctx.model, self.B, es)
                + homography.train_ops(self.ctx.model, self.B, es))

    def check(self) -> dict:
        """The reference's steps on the checked batches, once the
        program's state is freed, and the gaps."""
        ctx = self.ctx
        n = ctx.traffic["check_steps"]
        batches = [self.batches[i % self.pool] for i in range(n)]
        del self.step, self.batches
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = refhom.train_reference(
            ctx.model, self.state0, batches,
            inputs.generator(ctx.seed, "dropout", ctx.device),
            ctx.config["optimizer"], ctx.device)
        gaps = refcheck.train_gaps(self.prog, ref, self.state0)
        extra = refhom.homography_gaps(self.prog, ref)
        where = {**gaps.pop("where"), **extra.pop("where")}
        return {"numbers": {**gaps, **extra}, "where": where,
                "failed": self.failed}
