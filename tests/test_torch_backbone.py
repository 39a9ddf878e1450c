"""K2 downsampler, K3 upsampler and K4 head_rowsums of the PyTorch port:
their plain versions (what the wrappers run on a CPU tensor) against the
JAX TPU bodies `body_downsampler`, `body_upsampler` and `body_head` + the
activation / row-mask / row-sum tail of `_decoder_plane_b`, in interpret
mode, at the shapes of tests/test_pallas_wls.py. Same bf16 inputs, weights
carried across by the port's converters; bf16 bar max|diff| / max|ref| <
1e-2, as the JAX package holds its own bodies."""

from math import ceil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.models.erfnet import (
    DownsamplerBlock, UpsamplerBlock)
from lanedetection_end2end_tpu.ops.pallas_backbone import (
    body_downsampler, body_head, body_upsampler, pack_downsampler as j_down,
    pack_head as j_head, pack_upsampler as j_up)
from lanedetection_end2end_tpu_torch.models.port import (
    conv_transpose_state, downsampler_state, upsampler_state)
from lanedetection_end2end_tpu_torch.ops.activations import ACTIVATIONS
from lanedetection_end2end_tpu_torch.ops.backbone import (
    downsampler, downsampler_plain, head_rowsums, head_rowsums_plain,
    pack_downsampler, pack_head, pack_upsampler, upsampler, upsampler_plain)


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _init(mod, x, seed):
    """Module variables as numpy, with non-trivial BatchNorm."""
    rng = np.random.default_rng(seed)
    v = jax.device_get(mod.init({"params": jax.random.PRNGKey(seed)},
                                jnp.asarray(x), train=False))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    n = stats["bn"]["mean"].shape[0]
    params["bn"] = {"scale": rng.uniform(0.8, 1.2, n).astype(np.float32),
                    "bias": rng.normal(0, 0.1, n).astype(np.float32)}
    stats["bn"] = {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                   "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
    return params, stats


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("H,W,cin,cout", [(16, 32, 16, 64), (8, 16, 64, 128),
                                          (32, 64, 3, 16)])
def test_downsampler_plain_matches_jax_body(H, W, cin, cout):
    rng = np.random.default_rng(cin)
    x = _bf16(rng.normal(size=(1, H, W, cin)))
    params, stats = _init(DownsamplerBlock(cout), x, cin + 1)
    ci = 4 if cin == 3 else cin  # the TPU pads RGB to 4 lanes
    xin = np.pad(x[0], ((0, 0), (0, 0), (0, ci - cin)))
    want = np.asarray(body_downsampler(
        jnp.asarray(xin.reshape(H, W * ci), jnp.bfloat16),
        j_down(params, stats, ci, cout), H=H, W=W, interpret=True
    ).astype(jnp.float32)).reshape(1, H // 2, W // 2, cout)
    p = pack_downsampler(downsampler_state(params, stats, "blk"), "blk")
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = downsampler_plain(xt, p)
    assert _rel(got, want) < 1e-2
    assert torch.equal(downsampler(xt, p), got)  # CPU wrapper = plain


@pytest.mark.parametrize("H,W,cin,cout", [(8, 16, 128, 64), (8, 16, 64, 16)])
def test_upsampler_plain_matches_jax_body(H, W, cin, cout):
    rng = np.random.default_rng(cin)
    x = _bf16(rng.normal(size=(1, H, W, cin)))
    params, stats = _init(UpsamplerBlock(cout), x, cin + 1)
    want = np.asarray(body_upsampler(
        jnp.asarray(x[0].reshape(H, W * cin), jnp.bfloat16),
        j_up(params, stats, cin, cout), H=H, W=W, interpret=True
    ).astype(jnp.float32)).reshape(1, 2 * H, 2 * W, cout)
    p = pack_upsampler(upsampler_state(params, stats, "blk"), "blk")
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = upsampler_plain(xt, p)
    assert _rel(got, want) < 1e-2
    assert torch.equal(upsampler(xt, p), got)


_JAX_ACT = {"square": lambda d: jnp.square(jnp.square(d)),
            "relu": lambda d: jnp.square(jnp.maximum(d, 0.0)),
            "abs": jnp.square, "none": jnp.square,
            "sigmoid": lambda d: jnp.square(jax.nn.sigmoid(d)),
            "softplus": lambda d: jnp.square(jax.nn.softplus(d))}


@pytest.mark.parametrize("act", ACTIVATIONS)
def test_head_rowsums_plain_matches_jax_body_and_tail(act):
    Hh, Wh, cin, C = 16, 32, 16, 4
    H, W = 2 * Hh, 2 * Wh
    rng = np.random.default_rng(10)
    x = _bf16(rng.normal(size=(1, Hh, Wh, cin)))
    head = fnn.ConvTranspose(C, (2, 2), strides=(2, 2), padding="VALID")
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(
        head.init(jax.random.PRNGKey(11), jnp.asarray(x)))["params"])
    xs = (np.arange(W) - (W - 1) / 2) / ((W - 1) / 2)
    zero = ceil(H * 0.2)
    dec = body_head(jnp.asarray(x[0].reshape(Hh, Wh * cin), jnp.bfloat16),
                    j_head(params, cin, C), H=Hh, W=Wh, interpret=True)
    w2 = _JAX_ACT[act](dec).reshape(H, W, C)
    s0 = jnp.sum(w2, axis=1)
    s1 = jnp.sum(w2 * jnp.asarray(xs, jnp.float32)[:, None], axis=1)
    want = np.array(jnp.concatenate([s0, s1], axis=1))[None]
    want[:, :zero] = 0.0
    p = pack_head(conv_transpose_state(params, "head"), "head",
                  torch.from_numpy(xs), zero, act)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = head_rowsums_plain(xt, p)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, H, 2 * C)
    assert _rel(got, want) < 1e-2, act
    assert not got[:, :zero].any()
    assert torch.equal(head_rowsums(xt, p), got)
