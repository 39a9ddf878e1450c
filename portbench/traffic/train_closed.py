"""Closed-loop training: one process calls the program's e2e train step
back to back, each step on the next batch of a pool on the card.

Parameters (the workload file's `traffic`): `batch` images a step, `pool`
distinct batches cycled, `check_steps` first steps the reference follows,
`warm_steps` more before the window, and with `--trace 1`
`profile_warm` steps under the profiler, then `profile_steps` in its
traced window. The step is `train/steps.py::make_train_step(lanenet, cfg, optimizer,
"e2e")` on the configuration's preset, called as `step(batch, generator)`
with dropout drawn from a card generator seeded from the run's seed. The
first `check_steps` steps are the set-up's: their loss terms, the
optimizer's first moment after step one and the state after them are
kept, and `check()` holds them against the reference's steps from the
same weights, batches and dropout seed.
"""

from __future__ import annotations

import gc
import time

import torch
from torch.profiler import record_function

from portbench import inputs
from portbench.harness import synchronize
from portbench.reference import check as refcheck
from portbench.reference import model as refmodel
from portbench.work import erfnet


class Session:
    family = "train"

    def __init__(self, ctx):
        from lanedetection_end2end_tpu_torch.models import lanenet as ln
        from lanedetection_end2end_tpu_torch.train import optim, steps

        t = ctx.traffic
        self.ctx, self.B, self.pool = ctx, t["batch"], t["pool"]
        dev, m = ctx.device, ctx.model
        cfg = ctx.port_config(batch_size=self.B)
        ctx.mark("imports")
        self.dtype = cfg.compute_dtype
        ctx.build()
        self.state0 = inputs.make_state(refmodel.state_spec(m), ctx.seed, dev)
        net = ln.LaneNet(cfg, device=dev)
        ctx.load_state(net, self.state0)
        opt = optim.define_optim(net.parameters(), cfg.optimizer,
                                 cfg.learning_rate)
        self.step = steps.make_train_step(net, cfg, opt, "e2e", device=dev)
        ctx.mark("model and weights")
        self.batches = inputs.training_batches(
            self.pool, self.B, m["resize"], m["profile"], ctx.seed, dev)
        self.gen = inputs.generator(ctx.seed, "dropout", dev)
        ctx.mark("traffic")
        terms = ("loss", "loss_line", "loss_horizon") if m["clas"] else (
            "loss",)
        losses, exp_avg = [], None
        for i in range(t["check_steps"]):
            metrics = self.step(self.batches[i % self.pool], self.gen)
            losses.append({k: float(metrics[k]) for k in terms})
            if exp_avg is None:
                exp_avg = {n: opt.state[p]["exp_avg"].clone()
                           if p in opt.state else torch.zeros_like(p)
                           for n, p in net.named_parameters()}
        state = {k: v.detach().clone() for k, v in net.state_dict().items()}
        self.prog = refcheck.program_train_record(losses, exp_avg, state)
        ctx.mark("checked steps")
        self.i = t["check_steps"]
        for _ in range(t["warm_steps"]):
            self._step()
        synchronize(dev)

    def _step(self):
        metrics = self.step(self.batches[self.i % self.pool], self.gen)
        self.i += 1
        return metrics

    def ops(self):
        """The work of one step: every layer's forward, input and weight
        gradient at the step's batch, in its dtype."""
        es = 2 if self.dtype == "bfloat16" else 4
        return erfnet.train_ops(self.ctx.model, self.B, es)

    def window(self, seconds: float) -> dict:
        """Steps back to back until `seconds` have passed on the host; the
        window ends at a synchronize after the last."""
        losses = []
        synchronize(self.ctx.device)
        t0 = time.perf_counter()
        while True:
            losses.append(self._step()["loss"])
            if time.perf_counter() - t0 >= seconds:
                break
        synchronize(self.ctx.device)
        secs = time.perf_counter() - t0
        self.failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"units": len(losses), "images": self.B * len(losses),
                "seconds": secs, "latencies_s": None}

    def profile(self, traced) -> int:
        """`profile_warm` steps under the profiler and outside its traced
        window (the profiler's first launches cost the host more), a
        synchronize, then `profile_steps` steps in the window."""
        for _ in range(self.ctx.traffic["profile_warm"]):
            self._step()
        synchronize(self.ctx.device)
        n = self.ctx.traffic["profile_steps"]
        with traced.window():
            for _ in range(n):
                with record_function("portbench.step"):
                    self._step()
            synchronize(self.ctx.device)
        return n

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
        ref = refcheck.train_reference(
            ctx.model, self.state0, batches,
            inputs.generator(ctx.seed, "dropout", ctx.device),
            ctx.config["optimizer"], ctx.device)
        gaps = refcheck.train_gaps(self.prog, ref, self.state0)
        where = gaps.pop("where")
        return {"numbers": gaps, "where": where, "failed": self.failed}
