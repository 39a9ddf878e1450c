"""The port's blocks-mode serving engine and its chain of NB1D blocks
against the JAX package on the CPU.

Same weights (JAX `LaneNet.init` with non-trivial BatchNorm statistics,
carried across only through `state_dict_from_variables`) and the same
images, resize 64, batch 2, go through the blocks path of the port's
`FusedLaneNetEngine(cfg, device="cpu")` (kernel wrappers on their plain
versions) and JAX `FusedLaneNetEngine(mode="blocks", interpret=True)`, and
the port's plain f32 `LaneNet`; first with the config's own (separable)
homography, where the port's public call takes the full path and the
blocks path is driven through `_run(..., blocks=True)`, then with a
general one, the BP trapezoid after a 2 degree camera roll, swapped into
both engines as `engine.fitter` (JAX with `use_pallas=True,
pallas_interpret=True`, which reaches its K12; the port's call takes the
blocks path by itself). Bars: the JAX package's own for its engine
(tests/test_pallas_wls.py:206-215): beta max relative error < 3e-2,
line/horizon rtol = atol = 1e-2. The chain's plain version against JAX
`nb1d_chain` at JAX's own case and bar (tests/test_pallas_wls.py:162-180)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import _randomize_bn
from test_torch_nb1d import _block
from test_torch_wls_general import m_roll

from lanedetection_end2end_tpu.config import train_sh_config as jax_config
from lanedetection_end2end_tpu.models.infer_engine import (
    FusedLaneNetEngine as JaxEngine)
from lanedetection_end2end_tpu.models.lanenet import LaneNet as JaxLaneNet
from lanedetection_end2end_tpu.ops.pallas_nb1d import nb1d_chain as jax_chain
from lanedetection_end2end_tpu.ops.pallas_nb1d import pack_nb1d as jax_pack
from lanedetection_end2end_tpu.ops.wls import WLSFitter as JaxFitter
import lanedetection_end2end_tpu_torch.models.infer_engine as infer_engine
import lanedetection_end2end_tpu_torch.ops.wls as port_wls
from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.models import fused_graph
from lanedetection_end2end_tpu_torch.models.infer_engine import (
    FusedLaneNetEngine)
from lanedetection_end2end_tpu_torch.models.lanenet import (
    LaneNet, make_fitter)
from lanedetection_end2end_tpu_torch.models.port import (
    nb1d_state, state_dict_from_variables)
from lanedetection_end2end_tpu_torch.ops.nb1d import (
    nb1d_chain, nb1d_chain_plain, nb1d_plain, pack_chain, pack_nb1d)
from lanedetection_end2end_tpu_torch.ops.wls import WLSFitter
from lanedetection_end2end_tpu_torch.ops.wls_moments import wls_moments

RESIZE, BATCH = 64, 2
H, W = RESIZE, 2 * RESIZE


def _roll_fitter():
    return WLSFitter(m_roll(RESIZE), H, W, 3, normalized=False, reg_ls=1.0,
                     device="cpu")


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(0)
    jcfg = jax_config(resize=RESIZE, batch_size=BATCH, reg_ls=1.0)
    v = _randomize_bn(JaxLaneNet(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0)), rng)
    x = rng.uniform(size=(BATCH, H, W, 3)).astype(np.float32)

    jeng = JaxEngine(jcfg, dtype=jnp.float32, interpret=True, mode="blocks")
    jpacked = jeng.prepare(v)
    call = lambda: [np.asarray(a) for a in jax.jit(
        lambda p, vv, xx: jeng(p, vv, xx))(jpacked, v, x)]
    jout = call()
    jeng.fitter = JaxFitter(m_roll(RESIZE), H, W, 3, normalized=False,
                            reg_ls=1.0, use_pallas=True,
                            pallas_interpret=True)
    jroll = call()

    cfg = train_sh_config(resize=RESIZE, reg_ls=1.0)
    sd = state_dict_from_variables(v)
    eng = FusedLaneNetEngine(cfg, device="cpu")
    packed = eng.prepare(sd)
    xt = torch.from_numpy(x)
    out = [t.numpy() for t in eng._run(packed, xt, blocks=True)]
    fout = [t.numpy() for t in eng(packed, xt)]
    eng.fitter = _roll_fitter()
    roll = [t.numpy() for t in eng(packed, xt)]

    net = LaneNet(cfg, device="cpu")
    net.load_state_dict(sd)
    ref = net(xt)
    net.fitter = _roll_fitter()
    ref_roll = net(xt)
    lanenet = lambda r: [t.numpy() for t in (r.beta, r.line_logits,
                                             r.horizon_logits)]
    return {"out": out, "jout": jout, "full": fout, "roll": roll,
            "jroll": jroll, "ref": lanenet(ref), "ref_roll": lanenet(ref_roll),
            "eng": eng, "packed": packed, "x": xt, "sd": sd}


def _check_serving(out, beta, line, hor):
    rel = float(np.abs(out[0] - beta).max() / np.abs(beta).max())
    assert rel < 3e-2, rel
    np.testing.assert_allclose(out[1], line, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(out[2], hor, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("got,want", [
    ("out", "jout"), ("out", "ref"), ("out", "full"),
    ("roll", "jroll"), ("roll", "ref_roll")])
def test_blocks_engine_matches(run, got, want):
    """Blocks engine against the JAX blocks engine, the port's f32 LaneNet
    and its own full engine (config homography), and with the rolled
    homography against the JAX blocks engine with that homography and the
    f32 LaneNet with the same fitter."""
    _check_serving(run[got], *run[want])


def test_blocks_engine_outputs(run):
    for key in ("out", "roll"):
        beta, line, hor = run[key]
        assert beta.shape == (BATCH, 4, 4) and beta.dtype == np.float32
        assert line.shape == (BATCH, 4) and hor.shape == (BATCH, RESIZE)
        assert all(np.isfinite(a).all() for a in run[key])
    # the roll moves the fit, not the heads
    assert np.abs(run["roll"][0] - run["out"][0]).max() > 1e-3
    np.testing.assert_array_equal(run["roll"][1], run["out"][1])


def _counting(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] += 1
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, counted)


def test_blocks_engine_wrapper_calls(run, monkeypatch):
    """Per blocks-path call: 4 chains, no single-block or K2-K4 wrapper,
    and one `wls_moments` only with the general homography; on the CPU
    none of them counts a kernel launch."""
    calls = dict.fromkeys(("nb1d_chain", "nb1d", "downsampler", "upsampler",
                           "head_rowsums", "wls_moments"), 0)
    _counting(monkeypatch, infer_engine, "nb1d_chain", calls)
    _counting(monkeypatch, port_wls, "wls_moments", calls)
    for name in ("nb1d", "downsampler", "upsampler", "head_rowsums"):
        _counting(monkeypatch, fused_graph, name, calls)
    launches = (nb1d_chain.launches, wls_moments.launches)
    eng, packed, x = run["eng"], run["packed"], run["x"]
    seen = []
    cfg = train_sh_config(resize=RESIZE, reg_ls=1.0)
    for fitter in (make_fitter(cfg, "cpu"), _roll_fitter()):
        eng.fitter = fitter
        eng._run(packed, x, blocks=True)
        seen.append(dict(calls))
        calls.update(dict.fromkeys(calls, 0))
    assert seen == [
        {"nb1d_chain": 4, "nb1d": 0, "downsampler": 0, "upsampler": 0,
         "head_rowsums": 0, "wls_moments": n} for n in (0, 1)]
    assert (nb1d_chain.launches, wls_moments.launches) == launches


def test_full_mode_switches_to_blocks_for_a_general_homography(
        run, monkeypatch):
    """One engine, one `prepare`: a call takes the full path (the whole
    encoder and the whole decoder, on the CPU their plain versions) while
    the fitter is separable and the blocks path once a general fitter is
    assigned; an engine whose fitter is general when it prepares packs no
    full-path constants and serves the same outputs."""
    calls = dict.fromkeys(("nb1d_chain", "encoder_plain", "decoder_plain",
                           "wls_moments"), 0)
    _counting(monkeypatch, infer_engine, "nb1d_chain", calls)
    _counting(monkeypatch, fused_graph, "encoder_plain", calls)
    _counting(monkeypatch, fused_graph, "decoder_plain", calls)
    _counting(monkeypatch, port_wls, "wls_moments", calls)
    eng, packed, x = run["eng"], run["packed"], run["x"]
    cfg = train_sh_config(resize=RESIZE, reg_ls=1.0)
    seen = []
    for fitter in (make_fitter(cfg, "cpu"), _roll_fitter()):
        eng.fitter = fitter
        eng(packed, x)
        seen.append(dict(calls))
        calls.update(dict.fromkeys(calls, 0))
    assert seen == [{"nb1d_chain": 0, "encoder_plain": 1, "decoder_plain": 1,
                     "wls_moments": 0},
                    {"nb1d_chain": 4, "encoder_plain": 0, "decoder_plain": 0,
                     "wls_moments": 1}]
    monkeypatch.setattr(infer_engine, "make_fitter",
                        lambda cfg, device: _roll_fitter())
    general = FusedLaneNetEngine(cfg, device="cpu")
    gpacked = general.prepare(run["sd"])
    assert not {"enc", "dec"} & set(gpacked)
    for got, want in zip(general(gpacked, x), run["roll"]):
        np.testing.assert_array_equal(got.numpy(), want)


def test_nb1d_chain_plain_matches_jax_chain():
    """JAX's own case: C = 64, d = [1, 2, 4], an 8 x 16 plane; the plain
    chain is exactly `nb1d_plain` block after block, and the wrapper on a
    CPU tensor is the plain chain and counts no launch."""
    C, dils = 64, [1, 2, 4]
    blocks = [_block(C, d, 8, 16, seed=30 + i) for i, d in enumerate(dils)]
    x = blocks[0][0]
    want = np.asarray(jax_chain(
        jnp.asarray(x, jnp.bfloat16),
        [jax_pack(p, s, d) for (_, p, s), d in zip(blocks, dils)], dils,
        interpret=True).astype(jnp.float32))
    packs = [pack_nb1d(nb1d_state(p, s, "blk"), "blk", d)
             for (_, p, s), d in zip(blocks, dils)]
    chain = pack_chain(packs)
    assert chain["w"].shape == (3, 4, 3, C, C)
    assert chain["dilations"] == tuple(dils)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = nb1d_chain_plain(xt, chain)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)
    loop = xt
    for p in packs:
        loop = nb1d_plain(loop, p)
    assert torch.equal(got, loop)
    before = nb1d_chain.launches
    assert torch.equal(nb1d_chain(xt, chain), got)
    assert nb1d_chain.launches == before


def test_chain_and_moments_wrappers_refuse_other_devices():
    """Neither new wrapper takes its plain version for a tensor that is
    not on the CPU: anything but a CUDA tensor raises."""
    x = torch.zeros(1, 2, 2, 16, dtype=torch.bfloat16, device="meta")
    chain = {"w": torch.zeros(1, 4, 3, 16, 16, dtype=torch.bfloat16,
                              device="meta"),
             "vec": torch.zeros(1, 6, 16, device="meta"), "dilations": (1,)}
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        nb1d_chain(x, chain)
    w = torch.zeros(1, 8, 4, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        wls_moments(w, torch.zeros(8, 20, device="meta"))
