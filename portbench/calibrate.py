"""Readings for the limits of `correct`, on the card at a cell's own size.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--mode program|control|fault:<name>] [--seconds 10] [--out FILE]

Runs the cell once a seed in this one process (set-up, a window of
`--seconds`, the check; no trace) and prints, a line each, the numbers
the check compares. `program`: the program as the configuration states
it, whose largest readings are the limits' lower ends; `control`: the
nearest lower precision in the program's place (a training cell: the
program's own bf16 path; a serving cell: the reference with float8
convolutions and a bfloat16 fit and projection in the infer function's
place), whose smallest readings are their upper ends;
`fault:<name>`: a fault of `portbench/faults.py` planted in the timed
path. The benchmark's own runs run none of this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import faults, harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    harness.cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(a.workload)
    family = "train" if cell.traffic["kind"].startswith("train") else "serve"
    overrides, plant = None, None
    if a.mode == "control" and family == "train":
        overrides = {"compute_dtype": "bfloat16"}
    elif a.mode == "control":
        plant = faults.SERVE["control"]
    elif a.mode.startswith("fault:"):
        plant = (faults.TRAIN if family == "train" else faults.SERVE)[
            a.mode.split(":", 1)[1]]
    elif a.mode != "program":
        raise SystemExit(f"unknown mode {a.mode!r}")
    out = open(a.out, "a") if a.out else None
    try:
        for seed in (int(s) for s in a.seeds.split(",")):
            t0 = time.perf_counter()
            if plant is None:
                res = harness.run(a.workload, seed, a.seconds, False,
                                  "cuda", t0, overrides=overrides)
            else:
                with plant():
                    res = harness.run(a.workload, seed, a.seconds, False,
                                      "cuda", t0, overrides=overrides)
            line = {"workload": a.workload, "mode": a.mode, "seed": seed,
                    "correct": res["correct"], "failed": res["failed"],
                    "attempted": res["attempted"],
                    "numbers": {k: v["value"]
                                for k, v in res["checks"].items()},
                    "where": res["where"],
                    "setup_stages": res["setup_stages"],
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            del res
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
