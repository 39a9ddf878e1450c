"""Closed-loop serving: one client calls the program's inference function
on batches of camera frames, each call waiting for the last.

Parameters (the workload file's `traffic`): `batch` frames a call, `pool`
distinct frame batches cycled, `warm_calls` before the window, and with
`--trace 1` `profile_warm` calls under the profiler, then `profile_calls`
in its traced window. The call is
`eval/test_driver.py::make_infer_fn(lanenet, cfg, Projections(...),
FusedLaneNetEngine, packed)` on the configuration's preset, as
`test_model(use_engine=True)` scores a test set: uint8 frames in pinned
host memory, drawn on the card from the run's seed, go through the
function's own copy to the card, and each call ends with the gated lanes
(B, C, 56) copied to the host. A call's latency runs from the call to
the lanes on the host.

The engine is handed to `make_infer_fn` inside a recorder that keeps a
reference to each call's beta and head logits (no copy, no wait), so
that `check()` can judge them beside the served lanes.
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


class Recorder:
    """The engine, passed through; `outputs`, when a list, collects each
    call's (beta, line logits, horizon logits)."""

    def __init__(self, engine):
        self.engine, self.device, self.outputs = engine, engine.device, None

    def __call__(self, packed, images):
        out = self.engine(packed, images)
        if self.outputs is not None:
            self.outputs.append(out)
        return out


class Session:
    family = "serve"

    def __init__(self, ctx):
        from lanedetection_end2end_tpu_torch.eval import projections as pj
        from lanedetection_end2end_tpu_torch.eval import test_driver as td
        from lanedetection_end2end_tpu_torch.models import infer_engine as ie
        from lanedetection_end2end_tpu_torch.models import lanenet as ln

        t = ctx.traffic
        self.ctx, self.B, self.pool = ctx, t["batch"], t["pool"]
        dev, m = ctx.device, ctx.model
        cfg = ctx.port_config(batch_size=self.B)
        ctx.mark("imports")
        ctx.build()
        self.state = inputs.make_state(refmodel.state_spec(m), ctx.seed, dev)
        net = ln.LaneNet(cfg, device=dev)
        ctx.load_state(net, self.state)
        engine = ie.FusedLaneNetEngine(cfg, device=dev)
        packed = engine.prepare(net.state_dict())
        ctx.mark("model, weights and engine")
        self.recorder = Recorder(engine)
        self.infer = td.make_infer_fn(
            net, cfg, pj.Projections(cfg.resize, cfg.order, cfg.no_mapping,
                                     device=dev), self.recorder, packed)
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
        j = self.i % self.pool
        self.i += 1
        return j, self.infer(self.frames[j]).cpu()

    def ops(self):
        """The work of one call: the encoder and the decoder at the serving
        kernels' boundaries and the heads, bf16 planes."""
        return erfnet.serve_ops(self.ctx.model, self.B, 2)

    def window(self, seconds: float) -> dict:
        """Calls back to back until `seconds` have passed; each call's
        latency on the host clock."""
        self.recorder.outputs, self.calls, lat = [], [], []
        synchronize(self.ctx.device)
        t0 = time.perf_counter()
        while True:
            ts = time.perf_counter()
            j, lanes = self._call()
            te = time.perf_counter()
            lat.append(te - ts)
            self.calls.append((j, lanes))
            if te - t0 >= seconds:
                break
        secs = time.perf_counter() - t0
        self.outputs, self.recorder.outputs = self.recorder.outputs, None
        return {"units": len(lat), "images": self.B * len(lat),
                "seconds": secs, "latencies_s": lat}

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
        once the program's state is freed, and every call's gaps."""
        ctx = self.ctx
        calls = [{"pool": j, "beta": o[0], "line": o[1], "horizon": o[2],
                  "lanes": lanes}
                 for (j, lanes), o in zip(self.calls, self.outputs)]
        del self.infer, self.recorder
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        refs = refcheck.serve_reference(ctx.model, self.state, self.frames,
                                        ctx.device)
        gaps = refcheck.serve_gaps(calls, refs, ctx.limits,
                                   refmodel.Model(ctx.model, ctx.device))
        failed, judged = gaps.pop("failed"), gaps.pop("judged")
        fit_px = gaps.pop("fit_px")
        return {"numbers": gaps, "failed": failed,
                "where": {"lanes_px": f"{judged} served points judged",
                          "fit_shift": f"the fitted curves' gap {fit_px} px"}}
