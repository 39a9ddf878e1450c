"""The check that decides `correct`, driven through the harness on the
CPU at a small size: the program's plain CPU path (the kernels' plain
versions) against the reference comes out correct; the controls (a
lower precision in the program's place) and each fault that a cell can
have, planted in the timed path, come out not correct."""

from __future__ import annotations

import math

import pytest
import torch

from portbench import faults
from portbench.reference import check, geometry, model
from portbench.tests.conftest import run_small

CELLS = ["bp_train_sh.train_b128", "bev_egolane.train_b128",
         "bp_train_sh.serve_b128"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(small, cell):
    res = run_small(small, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    for v in res["checks"].values():
        assert math.isfinite(v["value"]) and v["value"] <= v["limit"]


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS[:2] for f in sorted(faults.TRAIN)] + [
    (CELLS[2], f) for f in ("half", "altered")])
def test_each_fault_is_caught(small, cell, fault):
    table = faults.SERVE if cell.endswith("serve_b128") else faults.TRAIN
    with table[fault]():
        res = run_small(small, cell)
    assert not res["correct"], res["checks"]


def test_training_control_bf16_is_caught(small):
    res = run_small(small, CELLS[0], overrides={"compute_dtype": "bfloat16"})
    assert not res["correct"], res["checks"]


def test_serving_control_is_caught(small):
    with faults.SERVE["control"]():
        res = run_small(small, CELLS[2])
    assert not res["correct"], res["checks"]


def test_fit_recovers_a_drawn_curve():
    """The reference fit on weight maps drawn along a known BEV curve
    recovers its coefficients (BEV profile, order 2, no regularization)."""
    m = dict(profile="bev", resize=64, out_channels=1, order=2, clas=False,
             activation="none", mask_percentage=0.0, reg_ls=0.0,
             no_mapping=False, loss_policy="area", weight_fit=1.0,
             weight_class=1.0)
    ref = model.Model(m, "cpu")
    M, _ = geometry.matrices("bev", 64)
    H, W = 64, 128
    ys = torch.linspace(0.0, 1.0 - 1.0 / H, H, dtype=torch.float64)
    xs = torch.linspace(0.0, 1.0 - 1.0 / W, W, dtype=torch.float64)
    coef = torch.tensor([0.05, -0.02, 0.5], dtype=torch.float64)
    logits = torch.zeros(1, 1, H, W, dtype=torch.float64)
    for r in range(H):
        D = M[2, 1] * ys[r] + M[2, 2]
        yb = 1.0 - (M[1, 1] * ys[r] + M[1, 2]) / D
        xb = coef[0] * yb ** 2 + coef[1] * yb + coef[2]
        # the image column whose BEV x is xb
        x_img = (xb * D - M[0, 1] * ys[r] - M[0, 2]) / M[0, 0]
        c = int(torch.argmin((xs - x_img).abs()))
        if 0 < c < W - 1:
            logits[0, 0, r, c] = 1.0
    beta = ref.fit(logits.float())
    assert torch.allclose(beta[0, 0].double(), coef, atol=2e-2)


def test_serve_gaps_judge_each_call():
    """The reference's own outputs read 0; served lanes moved by 1 px read
    1 px; a gate flipped on the served lanes while the logits stay reads
    the distance to -2; beta moved by a constant reads that constant in
    pixels, and over the weight's spread about the curve as summed pixel
    by pixel from the homography."""
    m = dict(profile="bp", resize=32, out_channels=4, order=3, clas=True,
             activation="square", mask_percentage=0.2, reg_ls=1.0,
             no_mapping=False, loss_policy="backproject", weight_fit=1.0,
             weight_class=1.0)
    from portbench import inputs
    state = inputs.make_state(model.state_spec(m), 3, "cpu")
    frames = inputs.frames(1, 2, 32, 3, "cpu")
    refs = check.serve_reference(m, state, frames, "cpu")
    r = refs[0]
    ref = model.Model(m, "cpu")
    limits = {"fit_px": 1.0, "logit_gap": 0.1, "lanes_px": 0.5}
    call = {"pool": 0, "beta": r["beta"], "line": r["line"],
            "horizon": r["horizon"], "lanes": r["lanes"]}
    g = check.serve_gaps([call], refs, limits, ref)
    assert (g["fit_px"], g["logit_gap"], g["lanes_px"]) == (0, 0, 0)
    g = check.serve_gaps([dict(call, lanes=r["lanes"] + 1.0)], refs,
                         limits, ref)
    assert g["lanes_px"] == pytest.approx(1.0) and g["failed"] == 1
    two = check.serve_gaps([call, dict(call, lanes=r["lanes"] + 1.0)], refs,
                           limits, ref)
    assert two["failed"] == 1 and two["lanes_px"] == pytest.approx(1.0)
    served = r["lanes"].clone()
    at = (served >= 0).nonzero()[0].tolist()
    x = float(served[tuple(at)])
    served[tuple(at)] = -2.0
    g = check.serve_gaps([dict(call, lanes=served)], refs, limits, ref)
    assert g["lanes_px"] == pytest.approx(x + 2.0, rel=1e-6)
    beta = r["beta"].clone()
    beta[..., -1] += 1.0  # x' one pixel over in the fit's plane everywhere
    g = check.serve_gaps([dict(call, beta=beta)], refs, limits, ref)
    assert g["fit_px"] == pytest.approx(1.0, rel=1e-6)
    assert g["fit_shift"] == pytest.approx(1.0 / _spread(ref, m, state,
                                                         frames[0]), rel=1e-4)


def _spread(ref, m, state, images):
    """The root mean square, weighted by w^2, of each pixel's position in
    the fit's plane about the reference's fitted curve, summed pixel by
    pixel from the homography (not from the moments)."""
    p = {k: v.float() if v.is_floating_point() else v for k, v in
         state.items()}
    x = (images.float() / 255.0).permute(0, 3, 1, 2)
    with torch.no_grad():
        _, logits = model.erfnet(x, p, False, None)
        beta = ref.fit(logits).double()
    w2 = ref.act(logits).double() ** 2
    w2[:, :, :ref.zero_rows] = 0.0
    M, _ = geometry.matrices("bp", m["resize"])
    H, W = m["resize"], 2 * m["resize"]
    ys = torch.arange(H, dtype=torch.float64)[:, None]
    xs = torch.arange(W, dtype=torch.float64)[None, :]
    D = M[2, 1] * ys + M[2, 2]
    x_bev = (M[0, 0] * xs + M[0, 1] * ys + M[0, 2]) / D          # (H, W)
    y_bev = H - 1.0 - (M[1, 1] * ys + M[1, 2]) / D               # (H, 1)
    powers = torch.arange(m["order"], -1, -1, dtype=torch.float64)
    curve = (beta[..., None, :] * y_bev ** powers).sum(-1)      # (B, C, H)
    sq = (w2 * (x_bev - curve[..., None]) ** 2).sum()
    return float((sq / w2.sum()) ** 0.5)
