"""The benchmark's general machinery: it finds a cell's pieces by name, runs
set-up, the measured window, the optional traced stretch and the check,
and builds the result line.

Everything that belongs to one configuration, traffic kind or metric is a
file of its own, found by the name `BENCHMARK.json` gives it:

- `configs/<config>.json`: the model as it is run (the program's preset
  and its keywords, the values the reference needs, the optimizer, the
  precision of each part, `reduced` and `assumed`);
- `workloads/<cell>.json`: the traffic (its kind and parameters) and the
  limits of the numbers that decide `correct`; the cell's configuration,
  chips and why are its `BENCHMARK.json` entry's alone;
- `traffic/<kind>.py`: a `Session(ctx)` whose construction is the set-up
  and which has `window(seconds)`, `profile(traced)` and `check()`;
- `metrics/<metric>.py`: `read(run) -> float | None` on the run's record.
  A metric `<name>.<family>` with no file of its own is read by
  `metrics/<name>.py` in the runs of that family ("train", "serve") only.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
import types
from pathlib import Path
from typing import Dict, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lanedetection_end2end_tpu")
# the values of a configuration file's `model` section, as the program's
# LaneConfig names them
MODEL_FIELDS = {"profile": "profile", "resize": "resize",
                "out_channels": "out_channels", "order": "order",
                "clas": "clas", "activation": "activation_layer",
                "mask_percentage": "mask_percentage", "reg_ls": "reg_ls",
                "no_mapping": "no_mapping", "loss_policy": "loss_policy",
                "weight_fit": "weight_fit", "weight_class": "weight_class"}


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cache_dirs() -> None:
    """Every build and kernel cache a library could keep goes to a fixed
    directory inside the checkout."""
    base = ROOT / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def load_plugin(kind: str, name: str,
                bench_dir: Path = BENCH) -> types.ModuleType:
    """`<bench_dir>/<kind>/<name>.py` as a module (names may hold dots)."""
    path = Path(bench_dir) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH):
    """(the reader of metric `name`, the family it is read in or None):
    `metrics/<name>.py`, else `metrics/<base>.py` for `<base>.<family>`."""
    own = Path(bench_dir) / "metrics" / f"{name}.py"
    if own.is_file() or "." not in name:
        return load_plugin("metrics", name, bench_dir), None
    base, family = name.rsplit(".", 1)
    return load_plugin("metrics", base, bench_dir), family


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's, flax's or the
    JAX package's."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


class Cell:
    """A cell's pieces: its `BENCHMARK.json` entry (configuration, traffic
    mix, chips), its workload file (traffic kind and parameters, limits)
    and its configuration file. `bench_dir`: the directory that holds
    `configs/`, `workloads/`, `traffic/` and `metrics/`; `bench`: the
    parsed `BENCHMARK.json` (read from the checkout's root where None)."""

    def __init__(self, name: str, bench: Optional[dict] = None,
                 bench_dir: Path = BENCH):
        bench = bench if bench is not None else read_json(
            ROOT / "BENCHMARK.json")
        self.dir = Path(bench_dir)
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry, self.bench = entries[name], bench
        spec = read_json(self.dir / "workloads" / f"{name}.json")
        self.config = read_json(self.dir / "configs"
                                / f"{self.entry['config']}.json")
        self.name, self.chips = name, self.entry["chips"]
        self.traffic, self.limits = spec["traffic"], spec["limits"]
        self.model = self.config["model"]

    def metrics(self, per_layer: bool) -> list:
        """The metric entries this cell reports: those that list it, and
        those that list no cells."""
        return [m for m in self.bench["per_layer" if per_layer
                                      else "end_to_end"]
                if self.name in m.get("workloads", [self.name])]


class Context:
    """What a traffic session is handed: the cell, the run's seed and
    device, and the program's configuration for it."""

    def __init__(self, cell: Cell, seed: int, device, overrides=None):
        import torch
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.model, self.config = cell.model, cell.config
        self.traffic, self.limits = cell.traffic, cell.limits
        self.overrides = dict(overrides or {})
        self.marks = [("start", time.perf_counter())]

    def mark(self, label: str) -> None:
        """Note the end of a set-up stage (the run prints their seconds)."""
        self.marks.append((label, time.perf_counter()))

    def port_config(self, **extra):
        """The program's LaneConfig from the configuration file's preset,
        checked against the file's `model` section."""
        from lanedetection_end2end_tpu_torch import config as pc
        c = self.config
        cfg = getattr(pc, c["preset"])(**c["preset_kwargs"], **extra,
                                       **self.overrides)
        for key, field in MODEL_FIELDS.items():
            if getattr(cfg, field) != self.model[key]:
                raise ValueError(
                    f"{c['name']}: the program's {c['preset']} gives "
                    f"{field}={getattr(cfg, field)!r}, the configuration "
                    f"file {key}={self.model[key]!r}")
        opt = c["optimizer"]
        if (cfg.optimizer, cfg.learning_rate) != (opt["name"], opt["lr"]):
            raise ValueError(f"{c['name']}: optimizer {cfg.optimizer} "
                             f"{cfg.learning_rate} is not the file's")
        return cfg

    def build(self) -> None:
        """Every kernel library of the program, built once per checkout
        (later runs load them)."""
        if self.device.type == "cuda":
            from lanedetection_end2end_tpu_torch.ops import _build
            _build.build()
        self.mark("kernel libraries")

    @staticmethod
    def load_state(module, state: Dict) -> None:
        """Load the benchmark's state into the program's module, whose
        state must hold exactly the same names and shapes."""
        own = module.state_dict()
        mismatch = sorted(set(own) ^ set(state)) + sorted(
            k for k in own if k in state and own[k].shape != state[k].shape)
        if mismatch:
            raise ValueError("the program's model state differs from the "
                             f"reference's: {mismatch[:8]}")
        module.load_state_dict(state)


def synchronize(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def run(cell_name: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, bench: Optional[dict] = None,
        overrides: Optional[dict] = None, bench_dir: Path = BENCH) -> dict:
    """One run of a cell: set-up, the window, the traced stretch with
    `trace`, the check. Returns the result object (without printing).
    `overrides`: keywords added to the program's preset (the control's
    lower precision)."""
    import torch

    from portbench import trace as tracing
    from portbench import peaks as peak_table

    cell = Cell(cell_name, bench, bench_dir)
    ctx = Context(cell, seed, device, overrides)
    traffic = load_plugin("traffic", cell.traffic["kind"], cell.dir)
    if ctx.device.type == "cuda":
        torch.cuda.set_device(ctx.device)
        torch.empty(1, device=ctx.device)  # the allocator, before its stats
        torch.cuda.reset_peak_memory_stats(ctx.device)
    session = traffic.Session(ctx)
    synchronize(ctx.device)
    ctx.mark("warm-up")
    setup_s = time.perf_counter() - t_start
    window = session.window(seconds)
    traced = None
    if trace:
        with tracing.profiled() as tr:
            units = session.profile(tr)
        traced, window["traced_units"] = tr.stats, units
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    kind = (torch.cuda.get_device_name(ctx.device)
            if ctx.device.type == "cuda" else "cpu")
    record = types.SimpleNamespace(
        family=session.family, cell=cell, setup_s=setup_s, trace=traced,
        ops=session.ops(), peaks=peak_table.for_card(kind),
        batch=cell.traffic["batch"], **window)
    verdict = session.check()
    del session
    gc.collect()
    metrics = {}
    for m in cell.metrics(per_layer=bool(trace)):
        reader, family = metric_reader(m["name"], cell.dir)
        value = (reader.read(record) if family in (None, record.family)
                 else None)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    numbers = {k: verdict["numbers"][k] for k in cell.limits}
    correct = (all(v <= cell.limits[k] for k, v in numbers.items())
               and verdict["failed"] == 0 and window["units"] > 0)
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": kind, "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(window["units"]),
              "failed": int(verdict["failed"]), "metrics": metrics,
              "device": dev}
    if traced is not None:
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in
                                              traced.device_ops],
                               "idle_gaps": [list(x) for x in
                                             traced.idle_gaps]}
    result["where"] = verdict.get("where", {})
    result["setup_stages"] = {
        label: t - ctx.marks[i][1]
        for i, (label, t) in enumerate(ctx.marks[1:])}
    result["setup_stages"]["before set-up"] = ctx.marks[0][1] - t_start
    result["checks"] = {k: {"value": _finite(v), "limit": cell.limits[k]}
                        for k, v in numbers.items()}
    return result
