"""The race check of `chip_smoke.py` (compute-sanitizer's racecheck and
synccheck over the fused kernels' row tile) judged from the tool's own
output: `sanitizer_verdict` on canned outputs of each kind, the tool's
refusal of the card, clean runs, hazards, errors, a failed child and a
timeout. The tool itself runs only beside a card."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

BANNER = "========= COMPUTE-SANITIZER\n"
CHILD = "race child: outputs finite: True\n"
REFUSED = (BANNER + "========= Error: Device not supported. Please refer to "
           "the \"Supported Devices\" section of the sanitizer "
           "documentation\n=========\nTraceback (most recent call last):\n"
           "torch.AcceleratorError: CUDA error: unknown error\n")

CASES = {
    # the tool refused the card: its summaries count the refusal itself
    "racecheck refused": (1, REFUSED + "========= Target application "
                          "returned an error\n========= RACECHECK SUMMARY: "
                          "1 hazard displayed (1 error, 0 warnings)\n",
                          "not run"),
    "synccheck refused": (1, REFUSED + "========= ERROR SUMMARY: 1 error\n",
                          "not run"),
    "racecheck clean": (0, BANNER + CHILD + "========= RACECHECK SUMMARY: 0 "
                        "hazards displayed (0 errors, 0 warnings)\n", "clean"),
    "synccheck clean": (0, BANNER + CHILD + "========= ERROR SUMMARY: 0 "
                        "errors\n", "clean"),
    "racecheck hazard": (1, BANNER + "========= Error: Race reported "
                         "between Write access at nb1d::tile+0x1a40\n"
                         "=========     and Read access at nb1d::tile+0x2b10"
                         "\n" + CHILD + "========= RACECHECK SUMMARY: 1 "
                         "hazard displayed (1 error, 0 warnings)\n", "fail"),
    # a warning is a hazard too, though it leaves the exit code 0
    "racecheck warning": (0, BANNER + CHILD + "========= RACECHECK SUMMARY: "
                          "2 hazards displayed (0 errors, 2 warnings)\n",
                          "fail"),
    "synccheck error": (1, BANNER + "========= Barrier error detected. "
                        "Divergent thread(s) in warp\n" + CHILD +
                        "========= ERROR SUMMARY: 1 error\n", "fail"),
    # the child failed with no summary, or the run timed out (rc None)
    "child failed": (1, BANNER + "Traceback (most recent call last):\n"
                     "RuntimeError: nb1d_chain: an illegal memory access\n",
                     "fail"),
    "timed out": (None, BANNER, "fail"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sanitizer_verdict(case):
    rc, text, want = CASES[case]
    assert chip_smoke.sanitizer_verdict(rc, text) == want
