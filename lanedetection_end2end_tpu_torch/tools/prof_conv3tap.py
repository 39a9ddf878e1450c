"""Card time of the bf16 3-tap tiles (K6 / K7, K11) beside cuDNN's, for
one checkout of the port.

Runs `chip_smoke.py`'s own per-shape loops in bf16 (those of
`--tiles-only`): the half blocks `nb_half_a` / `nb_half_b` forward and
backward at each (plane, d) of the default 256x512 train step at batch 8
beside cuDNN's products alone, and K11 (`packed_conv_act`, `packed_conv`)
at each (plane, d, axis) of the unfused step beside cuDNN's call, each
held against its plain version and timed in card time (`card_ms`). What
this tool adds is `--root`: the wrappers timed are those of the port in
DIR (default: this checkout), whose wrappers take the same arguments, so
that one call on one card can time two trees with the same loop.

    python lanedetection_end2end_tpu_torch/tools/prof_conv3tap.py \\
        [--root DIR]

Run it by its path, not with `-m`, so that DIR's package is the one
imported. Prints the card's name and power limit, the check lines, and
last one JSON object: per kernel, ms a step forward and backward of the
port and of the library. Exits 1 if a check fails. Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
KEYS = ("ms", "bwd_ms", "library_ms", "bwd_library_ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose port is timed (default: this one)")
    root = os.path.abspath(ap.parse_args(argv).root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    if not torch.cuda.is_available():
        print("prof_conv3tap: no CUDA device", file=sys.stderr)
        return 2
    from lanedetection_end2end_tpu_torch.ops import _build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.gpu_line()
    print(card, flush=True)
    _build.build(["nb_half_fwd", "nb_half_bwd", "packed_conv"])
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(smoke.SEED + 1)
    halves, failures = smoke.check_training_kernels(dev, g, torch.bfloat16)
    k11, f = smoke.check_k11(dev, g, {torch.bfloat16: "bfloat16"})
    rows = {**halves, **{n: k11[n]["bfloat16"]
                         for n in ("packed_conv_act", "packed_conv")}}
    print(json.dumps({"card": card, "root": root, "per_step_ms": {
        n: {k: s[k] for k in KEYS} for n, s in rows.items()}}))
    return 1 if failures + f else 0


if __name__ == "__main__":
    sys.exit(main())
