"""The port's training backbone (`ops/packed_graph.py`) against the JAX
package's `erfnet_packed` on the CPU, float32, at 32x64.

The JAX side runs PACKED_FUSED_BLOCKS=1 (every NB1D block on the fused
Pallas half-block kernels, interpret mode) and PACKED_FUSED_MAPS=0
(downsamplers, upsamplers and head in jnp with the Pallas `channel_sums`),
which the port follows with `fused_maps=False`; the default configuration,
fused maps on, is held in tests/test_torch_train_step_fused.py. The same
weights cross through `state_dict_from_variables`; the new running statistics come back through
`variables_from_state_dict`. Bars are the JAX package's own
(tests/test_fused_blocks.py:143-153): enc and logits atol 5e-4, rtol 2e-3;
every new running statistic atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.config import train_sh_config as jax_config
from lanedetection_end2end_tpu.models import LaneNet as JaxLaneNet
from lanedetection_end2end_tpu.ops import packed_graph as pg
from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.models.erfnet import DownsamplerBlock
from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
from lanedetection_end2end_tpu_torch.models.port import (
    downsampler_state, state_dict_from_variables, variables_from_state_dict)
from lanedetection_end2end_tpu_torch.ops import packed_graph as tg
from lanedetection_end2end_tpu_torch.ops.activations import activation_fn
from test_torch_threads import one_torch_thread  # noqa: F401

RESIZE, BATCH = 32, 2
ENC_BLOCKS = (["initial_block", "down1"] + [f"nb64_{i}" for i in range(5)]
              + ["down2"] + [f"nb128_{j}_d{d}" for j in range(2)
                             for d in (2, 4, 8, 16)])
DEC_BLOCKS = ["up1", "nb64_0", "nb64_1", "up2", "nb16_0", "nb16_1"]


def randomize_bn(variables, rng):
    """BatchNorm scale/bias and running statistics away from identity."""
    def walk(p, s):
        for k in p:
            if "mean" in s.get(k, {}):
                n = s[k]["mean"].shape[0]
                p[k] = {"scale": rng.uniform(0.8, 1.2, n).astype(np.float32),
                        "bias": rng.normal(0, 0.1, n).astype(np.float32)}
                s[k] = {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])
    v = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    walk(v["params"], v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def run():
    mp = pytest.MonkeyPatch()
    mp.setenv("PACKED_PALLAS", "1")
    mp.setenv("PACKED_FUSED_BLOCKS", "1")
    mp.setenv("PACKED_FUSED_MAPS", "0")
    mp.delenv("PACKED_BANDED", raising=False)
    try:
        rng = np.random.default_rng(0)
        jcfg = jax_config(resize=RESIZE, batch_size=BATCH, reg_ls=1.0)
        v = randomize_bn(JaxLaneNet(jcfg, dtype=jnp.float32).init(
            jax.random.PRNGKey(0)), rng)
        x = rng.uniform(size=(BATCH, RESIZE, 2 * RESIZE, 3)).astype(
            np.float32)
        out = {}
        for train in (True, False):
            net = LaneNet(train_sh_config(resize=RESIZE, reg_ls=1.0),
                          device="cpu")
            net.load_state_dict(state_dict_from_variables(v))
            net.train(train)
            tenc, tdec = tg.erfnet_train(net.net, torch.from_numpy(x),
                                         train=train, dtype=torch.float32,
                                         fused_maps=False)
            stats = variables_from_state_dict(
                net.state_dict(), RESIZE)["batch_stats"]["erfnet"]
            out[train] = {"tenc": tenc.detach().numpy(),
                          "tdec": tdec.detach().numpy(), "tns": stats,
                          "old": v["batch_stats"]["erfnet"]}
        # op by op, as the JAX package's own test of this function runs it
        # (tests/test_fused_blocks.py): under jit XLA fuses the moment sums
        # differently, and the train-mode noise that follows (see
        # tests/test_torch_train_step.py) moves 2 of 16384 logits past atol
        enc, dec, ns = pg.erfnet_packed(
            v["params"]["erfnet"], v["batch_stats"]["erfnet"],
            jnp.asarray(x), out_channels=4, train=True, rng=None,
            dtype=jnp.float32, pallas_convs=True)
        out[True].update(
            enc=np.asarray(enc),
            dec=np.asarray(dec).reshape(BATCH, RESIZE, 2 * RESIZE, 4),
            ns=jax.tree_util.tree_map(np.asarray, ns))
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("what", ["enc", "dec"])
def test_erfnet_train_matches_jax(run, what):
    got, want = run[True]["t" + what], run[True][what]
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=2e-3)


@pytest.mark.parametrize("side,block", [("encoder", b) for b in ENC_BLOCKS]
                         + [("decoder", b) for b in DEC_BLOCKS])
def test_new_running_stats_match_jax(run, side, block):
    r = run[True]
    for bn, leaves in r["ns"][side][block].items():
        for leaf, want in leaves.items():
            got = r["tns"][side][block][bn][leaf]
            np.testing.assert_allclose(got, want, atol=1e-4,
                                       err_msg=f"{block}.{bn}.{leaf}")
            # and they did move: momentum 0.9 on the old value
            assert np.abs(want - r["old"][side][block][bn][leaf]).max() > 1e-4


def test_eval_leaves_running_stats_alone(run):
    """Eval mode (the port alone: its eval forward is held against JAX in
    tests/test_torch_engine.py and, per block, in
    tests/test_torch_nb_block.py) normalizes with the running statistics
    and does not move them."""
    r = run[False]
    assert np.abs(r["tenc"] - run[True]["tenc"]).max() > 1e-3
    for side in ("encoder", "decoder"):
        for block, bns in r["old"][side].items():
            if block == "output_conv":
                continue
            for bn, leaves in bns.items():
                for leaf, want in leaves.items():
                    np.testing.assert_array_equal(
                        r["tns"][side][block][bn][leaf], want)


@pytest.mark.parametrize("cin,cout", [(16, 64), (64, 128)])
def test_downsampler_tie_routing_matches_jax(monkeypatch, cin, cout):
    """The input is relu'd, so many 2x2 pooling windows are all zero: a
    four-way tie. Both sides send such a window's gradient to one element,
    the same one, so the input gradients agree everywhere."""
    monkeypatch.setenv("PACKED_FUSED_MAPS", "0")
    rng = np.random.default_rng(1)
    H, W = 8, 16
    x = np.maximum(rng.normal(-0.5, 1, (BATCH, H, W, cin)), 0).astype(
        np.float32)
    windows = x.reshape(BATCH, H // 2, 2, W // 2, 2, cin).max(axis=(2, 4))
    assert (windows == 0).mean() > 0.1  # ties are common in this input
    params = {"conv": {"kernel": rng.normal(0, 0.1, (3, 3, cin, cout - cin)
                                            ).astype(np.float32),
                       "bias": rng.normal(0, 0.1, cout - cin).astype(
                           np.float32)},
              "bn": {"scale": rng.uniform(0.8, 1.2, cout).astype(np.float32),
                     "bias": rng.normal(0, 0.1, cout).astype(np.float32)}}
    stats = {"bn": {"mean": np.zeros(cout, np.float32),
                    "var": np.ones(cout, np.float32)}}
    wy = rng.normal(0, 1, (BATCH, H // 2, W // 2, cout)).astype(np.float32)

    def f(xx):
        y, _ = pg.downsampler_packed(
            xx.reshape(BATCH, H, W * cin), params, stats, cin=cin, cout=cout,
            train=True, pallas=True)
        return jnp.sum(y.reshape(wy.shape) * wy), y
    (_, jy), jdx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))

    block = DownsamplerBlock(cin, cout)
    block.load_state_dict({k[2:]: v for k, v in
                           downsampler_state(params, stats, "b").items()})
    t = torch.from_numpy(x).requires_grad_()
    y = tg.downsampler_train(t, block, train=True, fused_maps=False)
    (y * torch.from_numpy(wy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jy).reshape(wy.shape),
                               atol=2e-4, rtol=1e-3)
    jdx = np.asarray(jdx)
    np.testing.assert_allclose(t.grad.numpy(), jdx,
                               atol=2e-3 * np.abs(jdx).max(), rtol=2e-3)


def test_rowsums_match_jax():
    rng = np.random.default_rng(2)
    H, W, C = 32, 64, 4
    dec = rng.normal(0, 1, (BATCH, H, W, C)).astype(np.float32)
    xs = np.linspace(-1, 1, W).astype(np.float32)
    jS0, jS1 = pg.rowsums_packed(
        jnp.asarray(dec).reshape(BATCH, H, W * C), lambda t: t * t,
        jnp.asarray(xs), C=C, resize=H, mask_percentage=0.2)
    S0, S1 = tg.rowsums(torch.from_numpy(dec), activation_fn("square"),
                        torch.from_numpy(xs), 7)  # ceil(32 * 0.2)
    assert S0.shape == (BATCH, C, H)
    np.testing.assert_allclose(S0.numpy(), np.asarray(jS0), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(S1.numpy(), np.asarray(jS1), rtol=1e-5,
                               atol=1e-4)
    assert np.all(S0.numpy()[:, :, :7] == 0)


@pytest.mark.parametrize("channel_dim", [-1, 1])
def test_dropout2d_mask_semantics(channel_dim):
    """Whole (image, channel) maps drop, the rest scale by 1 / keep; the
    mask is a function of the generator's seed; no generator, eval mode or
    rate 0 is the identity."""
    B, C, rate = 4, 64, 0.3
    shape = (B, 8, 8, C) if channel_dim == -1 else (B, C, 8, 8)
    x = torch.rand(shape) + 0.5
    gen = lambda: torch.Generator().manual_seed(7)
    y = tg.dropout2d(x, rate, gen(), True, channel_dim)
    ratio = (y / x).movedim(channel_dim, 1).reshape(B, C, -1)
    # one value per (b, c) map
    torch.testing.assert_close(ratio, ratio[..., :1].expand_as(ratio),
                               rtol=1e-6, atol=0)
    vals = ratio[..., 0]
    kept = vals > 0
    np.testing.assert_allclose(vals[kept].numpy(), 1 / (1 - rate), rtol=1e-6)
    assert 0.5 < kept.float().mean() < 0.9
    assert not torch.equal(kept[0], kept[1])              # per sample
    assert torch.equal(y, tg.dropout2d(x, rate, gen(), True, channel_dim))
    other = tg.dropout2d(x, rate, torch.Generator().manual_seed(8), True,
                         channel_dim)
    assert not torch.equal(y, other)
    for args in ((rate, None, True), (rate, gen(), False), (0.0, gen(), True)):
        assert tg.dropout2d(x, *args, channel_dim) is x


@pytest.mark.parametrize("dropout", [False, True], ids=["no-drop", "dropout"])
def test_reference_train_forward_matches_packed_path(dropout):
    """The f32 reference modules in train mode (`LaneNet.forward(train=
    True)`: `BatchNorm2d` with batch statistics, Dropout2d from the
    generator) against `apply_packed` on the same weights: outputs,
    gradients and new running statistics (biased variance on both sides).
    With a generator of the same seed both draw the same masks, block by
    block."""
    cfg = train_sh_config(resize=RESIZE, reg_ls=1.0)
    torch.manual_seed(0)
    ref, packed = LaneNet(cfg, device="cpu"), LaneNet(cfg, device="cpu")
    packed.load_state_dict(ref.state_dict())
    x = torch.rand(BATCH, RESIZE, 2 * RESIZE, 3,
                   generator=torch.Generator().manual_seed(1))
    gen = lambda: torch.Generator().manual_seed(2) if dropout else None
    a = ref(x, train=True, generator=gen())
    b = packed.apply_packed(x, train=True, generator=gen(),
                            fused_maps=False)
    assert a.beta.requires_grad and b.weightmaps is None
    for f in ("beta", "seg_logits", "line_logits", "horizon_logits",
              "encoder_features"):
        torch.testing.assert_close(getattr(b, f), getattr(a, f), rtol=1e-4,
                                   atol=1e-4)
    if dropout:  # and the masks did bite
        plain = ref(x, train=True).encoder_features
        assert (plain - a.encoder_features).abs().max() > 1e-2
        return
    for out, net in ((a, ref), (b, packed)):
        (out.beta.square().sum() + out.line_logits.sum()).backward()
    sa, sb = ref.state_dict(), packed.state_dict()
    for k in sa:
        if "running" in k:
            torch.testing.assert_close(sb[k], sa[k], rtol=1e-5, atol=1e-6)
    gmax = max(float(p.grad.abs().max()) for p in ref.parameters()
               if p.grad is not None)
    for (k, p), q in zip(ref.named_parameters(), packed.parameters()):
        assert (p.grad is None) == (q.grad is None), k
        if p.grad is not None:
            torch.testing.assert_close(q.grad, p.grad, rtol=2e-3,
                                       atol=2e-3 * gmax, msg=k)
