"""The PyTorch port's serving path against the JAX package on the CPU.

Same weights (JAX `LaneNet.init` with non-trivial BatchNorm statistics,
carried across only through `state_dict_from_variables`) and the same
images go through:

- the port's `FusedLaneNetEngine(cfg, device="cpu")` (kernel wrappers on
  their plain versions) and JAX `FusedLaneNetEngine(mode="full")` with the
  Pallas kernels in interpret mode;
- the port's plain f32 `LaneNet` and JAX `LaneNet.apply(phase="e2e")`;
- the port's `encoder_fused` / `decoder_fused` and the JAX ones.

Bars: the JAX package's own for its engine (tests/test_pallas_wls.py):
beta max relative error < 3e-2, line/horizon rtol = atol = 1e-2; f32
LaneNet parity at rtol 1e-4; the bf16 encoder (16 chained blocks) and
decoder stages at max|diff| / max|ref| < 2e-2, the bar the JAX package
holds its own bf16 NB1D blocks and chains to (tests/test_pallas_wls.py:137,
:180): both sides round to bf16 after every stage, in other places."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.config import train_sh_config as jax_config
from lanedetection_end2end_tpu.models import LaneNet as JaxLaneNet
from lanedetection_end2end_tpu.models import fused_graph as jax_fused
from lanedetection_end2end_tpu.models.infer_engine import (
    FusedLaneNetEngine as JaxEngine)
from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.models.fused_graph import (
    decoder_fused, encoder_fused)
from lanedetection_end2end_tpu_torch.models.infer_engine import (
    FusedLaneNetEngine)
from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
from lanedetection_end2end_tpu_torch.models.port import (
    state_dict_from_variables)
from lanedetection_end2end_tpu_torch.ops.backbone import (
    downsampler, head_rowsums, upsampler)
from lanedetection_end2end_tpu_torch.ops.nb1d import nb1d

RESIZE, BATCH = 64, 2


def _randomize_bn(variables, rng):
    """BatchNorm scale/bias and running statistics away from identity, so
    the folding is exercised."""
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
    rng = np.random.default_rng(0)
    jcfg = jax_config(resize=RESIZE, batch_size=BATCH, reg_ls=1.0)
    jnet = JaxLaneNet(jcfg, dtype=jnp.float32)
    v = _randomize_bn(jnet.init(jax.random.PRNGKey(0)), rng)
    x = rng.uniform(size=(BATCH, RESIZE, 2 * RESIZE, 3)).astype(np.float32)
    ref = jnet.apply(v, jnp.asarray(x), phase="e2e", train=False)

    jeng = JaxEngine(jcfg, dtype=jnp.float32, interpret=True, mode="full")
    jpacked = jeng.prepare(v)
    jout = jax.jit(lambda p, vv, xx: jeng(p, vv, xx))(jpacked, v, x)
    enc_arrays, enc_struct = jax_fused.pack_encoder(v, jcfg)
    jenc = jax_fused.encoder_fused(jnp.asarray(x), enc_arrays, enc_struct,
                                   jcfg, interpret=True)

    sd = state_dict_from_variables(v)
    cfg = train_sh_config(resize=RESIZE, reg_ls=1.0)
    eng = FusedLaneNetEngine(cfg, device="cpu")
    packed = eng.prepare(sd)
    counts = [f.launches for f in (nb1d, downsampler, upsampler,
                                   head_rowsums)]
    out = eng(packed, torch.from_numpy(x))
    enc = encoder_fused(torch.from_numpy(x), packed["enc"])
    # the decoders of both packages on the same (port) features
    S = decoder_fused(enc, packed["dec"])
    dec_arrays, dec_struct = jax_fused.pack_decoder(v, jcfg, jeng.fitter)
    jS = jax_fused.decoder_fused(jnp.asarray(enc.float().numpy(),
                                             jnp.bfloat16),
                                 dec_arrays, dec_struct, jcfg, interpret=True)
    net = LaneNet(cfg, device="cpu")
    net.load_state_dict(sd)
    return {"ref": ref, "jout": [np.asarray(a) for a in jout],
            "out": [t.numpy() for t in out], "net": net(torch.from_numpy(x)),
            "enc": enc.float().numpy(), "jenc": np.asarray(jenc, np.float32),
            "S": S.numpy(), "jS": np.asarray(jS), "counts": counts}


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _check_serving(out, beta, line, hor):
    rel = _rel(out[0], np.asarray(beta))
    assert rel < 3e-2, rel
    np.testing.assert_allclose(out[1], np.asarray(line), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(out[2], np.asarray(hor), rtol=1e-2, atol=1e-2)


def test_engine_matches_jax_engine(run):
    _check_serving(run["out"], *run["jout"])


def test_engine_matches_jax_lanenet(run):
    ref = run["ref"]
    _check_serving(run["out"], ref.beta, ref.line_logits, ref.horizon_logits)


@pytest.mark.parametrize("field", ["beta", "line_logits", "horizon_logits",
                                   "encoder_features", "seg_logits",
                                   "weightmaps"])
def test_lanenet_matches_jax_lanenet_f32(run, field):
    got = getattr(run["net"], field).numpy()
    want = np.asarray(getattr(run["ref"], field))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_encoder_fused_matches_jax(run):
    assert run["enc"].shape == (BATCH, RESIZE // 8, RESIZE // 4, 128)
    assert _rel(run["enc"], run["jenc"]) < 2e-2


def test_decoder_fused_matches_jax(run):
    assert run["S"].shape == run["jS"].shape == (BATCH, RESIZE, 8)
    assert _rel(run["S"], run["jS"]) < 2e-2


def test_engine_outputs_and_no_kernel_launch_on_cpu(run):
    beta, line, hor = run["out"]
    assert beta.shape == (BATCH, 4, 4) and beta.dtype == np.float32
    assert line.shape == (BATCH, 4) and hor.shape == (BATCH, RESIZE)
    assert all(np.isfinite(a).all() for a in run["out"])
    # CPU tensors take the plain versions: no wrapper counted a launch
    assert [f.launches for f in (nb1d, downsampler, upsampler,
                                 head_rowsums)] == run["counts"]
