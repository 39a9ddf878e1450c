"""Run one cell of the port's benchmark on this machine's card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. One process, one cell: it prints the card's
name and power limit, runs set-up (the kernel libraries built into the
checkout on its first run, weights and traffic drawn on the card from the
seed, the cell's shapes warmed up), measures `--seconds` of the cell's
traffic, with `--trace 1` profiles a few more steps or calls, checks the
timed path's outputs against the plain reference, and prints the numbers
compared beside their limits on standard error and, as the last line of
standard output, the result object. Without a card, with fewer cards than
the cell asks for, or with JAX loaded when the window has closed, it exits
with a non-zero code and prints no result.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def process_start() -> float:
    """This process's start on the `time.perf_counter` clock: its age from
    /proc where the system gives it, else the import of this module."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        if 0.0 <= age < 600.0:
            return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        pass
    return T_IMPORT


def card_line() -> str:
    """The first card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave no reading"


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from portbench import harness
    harness.cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA card; the benchmark runs only on a card",
              file=sys.stderr)
        return 2
    cell = harness.Cell(a.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {a.workload} asks for {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    card = card_line()
    print(f"portbench: card {card}", file=sys.stderr, flush=True)
    result = harness.run(a.workload, a.seed, a.seconds, bool(a.trace),
                         torch.device("cuda", 0), t_start, bench=cell.bench)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the run must not load: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = card.split(",")[-1].strip()
    checks = result.pop("checks")
    print("portbench: set-up " + ", ".join(
        f"{k} {v:.3f} s" for k, v in result.pop("setup_stages").items()),
        file=sys.stderr)
    for k, v in result["where"].items():
        print(f"portbench: {k} worst at {v}", file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
