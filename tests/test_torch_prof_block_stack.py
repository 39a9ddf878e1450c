"""The row-12 harness (`lanedetection_end2end_tpu_torch/tools/
prof_block_stack.py`) on the CPU, where `nb1d_chain` runs its plain
version: B = 4 images, the block applied REPS = 2 times; the command line
at the tool's own 32 x 64 x 128 plane, the cases below on a small plane
at each width, built with the tool's `setup`.

- The outputs with 1, 2 and 4 images per launch are equal bit for bit and
  equal `nb1d_chain_plain` of the block repeated.
- At C = 128, where the JAX tool's `Kh1` / `Kw1` taps are the channel
  matrices themselves, they match the JAX body the tool runs
  (`ops/pallas_nb1d.py::_nb1d_body`, interpret mode) applied REPS times, to
  2e-2 of max|JAX|, the bar the JAX package holds its own chains to
  (tests/test_pallas_wls.py:180): both sides round to bf16 at the same
  points, summing in other orders.

The module runs PyTorch on one thread: with eight or more, oneDNN's CPU
convolution in the plain version splits a one-image batch's sums in
another order than a larger batch's, which changes the last bit of some
bf16 outputs. The card's kernel runs the same tile code for every pixel
whatever the batch; `chip_smoke.py` holds its stacked outputs bit for bit
at the tool's full size."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.ops.pallas_nb1d import _nb1d_body
from lanedetection_end2end_tpu_torch.ops.nb1d import (
    chain_blocks, nb1d_chain_plain)
from lanedetection_end2end_tpu_torch.tools import prof_block_stack as pbs

B, REPS, H, W, D = 4, 2, 8, 16, 2
STACKS = (1, 2, 4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs():
    res = {}
    for c in (16, 64, 128):
        x, chain = pbs.setup(B, REPS, "cpu", H, W, c, D)
        res[c] = {"x": x, "chain": chain,
                  "outputs": {s: pbs.run_stacked(x, chain, s)
                              for s in STACKS}}
    return res


@pytest.mark.parametrize("channels", [16, 64, 128])
def test_stacked_outputs_equal_and_are_the_block_repeated(runs, channels):
    r = runs[channels]
    x, out = r["x"], r["outputs"]
    assert x.shape == (B, H, W, channels) and x.dtype == torch.bfloat16
    assert out[1].shape == x.shape and out[1].dtype == torch.bfloat16
    for s in STACKS:
        assert torch.equal(out[s], out[1])
    blocks = chain_blocks(r["chain"])
    assert len(blocks) == REPS
    assert all(torch.equal(p["w"], blocks[0]["w"])
               and torch.equal(p["vec"], blocks[0]["vec"])
               and p["dilation"] == D for p in blocks)
    assert torch.equal(out[1], nb1d_chain_plain(x, r["chain"]))


def test_matches_the_jax_body_repeated(runs):
    consts, x = pbs.draw(B, H, W, 128)
    jc = tuple(jnp.asarray(consts[k], jnp.bfloat16 if k.startswith("K")
                           else jnp.float32)
               for k, _, _ in pbs.CONSTS)
    L = W * 128
    xj = jnp.asarray(x.reshape(B, H, L), jnp.bfloat16)
    want = []
    for b in range(B):
        t = xj[b]
        for _ in range(REPS):
            t = _nb1d_body(t, jc, H=H, L=L, C=128, d=D, interpret=True
                           ).astype(jnp.bfloat16).reshape(H, L)
        want.append(np.asarray(t, np.float32))
    want = np.stack(want).reshape(B, H, W, 128)
    got = runs[128]["outputs"][1].float().numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-2


def test_cli_prints_a_rate_per_stack(capsys):
    rc = pbs.main(["--bs", str(B), "--reps", str(REPS), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert [ln.split(":")[0] for ln in lines] == [
        f"BS={B} REPS={REPS} STACK={s}" for s in STACKS]
    assert all("block-img/s" in ln and "NOT" not in ln for ln in lines)


@pytest.mark.parametrize("args", [dict(reps=17), dict(reps=0),
                                  dict(bs=4, stacks=(3,))])
def test_refuses_what_the_chain_cannot_run(args):
    kw = dict(bs=B, reps=REPS, stacks=STACKS, device="cpu", timed=False)
    kw.update(args)
    with pytest.raises(ValueError):
        pbs.run(**kw)
