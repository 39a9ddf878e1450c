"""Closed-loop serving of the fit alone: one client calls the program's
serving engine on batches of camera frames, each call waiting for the
last, and takes each call's beta to the host.

For a configuration without TuSimple's projection (the BEV profile fits
its lanes in normalized bird's-eye-view coordinates, and scoring compares
those curves), so no lanes are projected or gated. Parameters (the
workload file's `traffic`) as `serve_closed`'s: `batch` frames a call,
`pool` distinct frame batches cycled, `warm_calls` before the window, and
with `--trace 1` `profile_warm` calls under the profiler, then
`profile_calls` in its traced window.

A call is the serving call of `eval/test_driver.py::make_infer_fn`
without its projection: uint8 frames in pinned host memory, drawn on the
card from the run's seed, copied to the card and widened to float in
[0, 1], then `models/infer_engine.py::FusedLaneNetEngine` (the full path:
`encoder_fused`, `decoder_fused`, the separable fit), and beta (B, C,
order+1) copied to the host. The program has no such function, so the
session composes it from the engine and opens the program's spans
around it as `make_infer_fn` does (`serve.call`, the root, and
`serve.h2d`; the engine opens `serve.backbone`). A call's latency runs
from the call to beta on the host.

`check()` holds every call's beta against the reference's eval forward
of its frame batch (`reference/model.py::Model.forward`, float32, TF32
off): `fit_shift`, as `reference/check.py::serve_gaps`
defines it (the served fit's weighted gap to the reference's curve over
the weight's own spread about it). A call whose beta is not finite has
`failed`.
"""

from __future__ import annotations

import gc
import math
import time

import torch
from torch.profiler import record_function

from portbench import inputs
from portbench.harness import synchronize
from portbench.reference import check as refcheck
from portbench.reference import model as refmodel
from portbench.work import erfnet


class Session:
    family = "serve"

    def __init__(self, ctx):
        from lanedetection_end2end_tpu_torch.models import infer_engine as ie
        from lanedetection_end2end_tpu_torch.models import lanenet as ln
        from lanedetection_end2end_tpu_torch.utils.profiling import span

        t = ctx.traffic
        self.ctx, self.B, self.pool = ctx, t["batch"], t["pool"]
        dev, m = ctx.device, ctx.model
        cfg = ctx.port_config(batch_size=self.B)
        ctx.mark("imports")
        ctx.build()
        self.state = inputs.make_state(refmodel.state_spec(m), ctx.seed, dev)
        net = ln.LaneNet(cfg, device=dev)
        ctx.load_state(net, self.state)
        self.engine = ie.FusedLaneNetEngine(cfg, device=dev)
        self.packed = self.engine.prepare(net.state_dict())
        del net
        self.span = span
        ctx.mark("model, weights and engine")
        frames = inputs.frames(self.pool, self.B, m["resize"], ctx.seed, dev)
        self.frames = frames.cpu()
        if dev.type == "cuda":
            self.frames = self.frames.pin_memory()
        del frames
        ctx.mark("traffic")
        self.i = 0
        for _ in range(t["warm_calls"]):
            self._call()
        synchronize(dev)

    def _call(self):
        j, dev = self.i % self.pool, self.ctx.device
        with torch.no_grad(), self.span("serve.call", dev, root=self.i):
            self.i += 1
            with self.span("serve.h2d", dev):
                images = self.frames[j].to(dev, non_blocking=True)
                images = images.float() * (1.0 / 255.0)
            beta = self.engine(self.packed, images)[0]
            return j, beta.cpu()

    def ops(self):
        """The work of one call: the encoder and the decoder at the serving
        kernels' boundaries (and the heads where the model has them), bf16
        planes."""
        return erfnet.serve_ops(self.ctx.model, self.B, 2)

    def window(self, seconds: float) -> dict:
        """Calls back to back until `seconds` have passed; each call's
        latency on the host clock."""
        self.calls, lat = [], []
        synchronize(self.ctx.device)
        t0 = time.perf_counter()
        while True:
            ts = time.perf_counter()
            self.calls.append(self._call())
            te = time.perf_counter()
            lat.append(te - ts)
            if te - t0 >= seconds:
                break
        return {"units": len(lat), "images": self.B * len(lat),
                "seconds": time.perf_counter() - t0, "latencies_s": lat}

    def profile(self, traced) -> int:
        """`profile_warm` calls under the profiler and outside its traced
        window, then `profile_calls` calls in the window."""
        for _ in range(self.ctx.traffic["profile_warm"]):
            self._call()
        n = self.ctx.traffic["profile_calls"]
        with traced.window():
            for _ in range(n):
                with record_function("portbench.call"):
                    self._call()
            synchronize(self.ctx.device)
        return n

    def check(self) -> dict:
        """The reference's eval forward of each frame batch of the pool,
        once the program's state is freed, and every call's gap."""
        ctx = self.ctx
        del self.engine, self.packed
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = refmodel.Model(ctx.model, ctx.device)
        p = {k: v.float() if v.is_floating_point() else v
             for k, v in self.state.items()}
        with refcheck.exact_float32(), torch.no_grad():
            refs = [ref.forward(p, self.frames[j].to(ctx.device).float()
                                * (1.0 / 255.0), train=False,
                                with_normal=True)
                    for j in range(self.pool)]
        gaps = fit_gaps(self.calls, refs, ref)
        return {"numbers": {"fit_shift": gaps["fit_shift"]},
                "failed": gaps["failed"],
                "where": {"fit_shift": f"the fitted curves' gap "
                                       f"{gaps['fit_rms']} in the fit's "
                                       f"plane over {len(self.calls)} "
                                       f"calls"}}


def fit_gaps(calls: list, refs: list, ref) -> dict:
    """`fit_shift` of `check.serve_gaps` over every call: sum d^T Z d (d
    the gap of the call's beta to the reference's in the fit's scaled
    basis, Z the reference's normal matrix) over the weight's spread about
    the reference's curve, sum w^2 (x - x_ref)^2; its root. `calls`: (pool
    index, beta on the host); `refs`: per pool batch the reference's
    `Model.forward(..., with_normal=True)`; `ref`: that `Model`. ->
    {"fit_shift", "fit_rms" (sqrt(sum d^T Z d / sum w^2), in the fit
    plane's units), "failed" (calls whose beta is not finite)}."""
    fit_sq, spread_sq, mass, failed = 0.0, 0.0, 0.0, 0
    unscale = ref.unscale.double()
    for j, beta in calls:
        r = refs[j]
        nm = r["normal"]
        Z, b = nm["Z"].double(), r["beta"].double() / unscale
        beta = beta.to(Z.device).double()
        failed += int(not bool(torch.isfinite(beta).all()))
        d = beta / unscale - b
        fit_sq += float(torch.einsum("bci,bcij,bcj->", d, Z, d))
        spread = (nm["m2"] - 2.0 * (b * nm["rhs"].double()).sum(-1)
                  + torch.einsum("bci,bcij,bcj->bc", b, Z, b))
        spread_sq += float(spread.clamp(min=0.0).sum())
        mass += float(Z[..., -1, -1].sum())
    shift = math.sqrt(fit_sq / spread_sq) if spread_sq > 0 else math.inf
    return {"fit_shift": shift if math.isfinite(shift) else math.inf,
            "fit_rms": math.sqrt(fit_sq / mass) if mass > 0 else math.inf,
            "failed": failed}
