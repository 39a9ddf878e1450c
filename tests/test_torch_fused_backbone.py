"""The whole-encoder and whole-decoder kernels' host side on the CPU.

`models/fused_graph.py::pack_encoder` / `pack_decoder` lay every stage's
constants out once in a flat bf16 weight buffer, a flat f32 vector buffer
and an offset table (`ops/backbone_fused.py::flat_constants`); the tests
rebuild every stage's constants from them. The CUDA wrappers
(`encoder_fused_kernel`, `decoder_fused_kernel`) run here on CPU tensors
with the module's `kernel`, `launch` and `check_cuda` stubbed, as in
tests/test_torch_f32_fused.py: each asks for its C entry with as many
arguments as its signature spells (the device int the kernel counts its
grid barriers into among them), also for images wider than the NB1D row
tiles (which split such rows into segments), and refuses what the kernel
does not take before any launch. On the CPU `encoder_fused` /
`decoder_fused` take the plain versions, which equal the block sequences
exactly and match the JAX package's `encoder_fused` / `decoder_fused`
(Pallas in interpret mode) at the bars of tests/test_torch_engine.py:
max|diff| / max|JAX| < 2e-2, the bar the JAX package holds its own bf16
chains to. The kernels
themselves are held on the card by `chip_smoke.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.config import train_sh_config as jax_config
from lanedetection_end2end_tpu.models import LaneNet as JaxLaneNet
from lanedetection_end2end_tpu.models import fused_graph as jax_fused
from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.models import fused_graph as fg
from lanedetection_end2end_tpu_torch.models.lanenet import make_fitter
from lanedetection_end2end_tpu_torch.models.port import (
    state_dict_from_variables)
from lanedetection_end2end_tpu_torch.ops import backbone_fused as bf
from lanedetection_end2end_tpu_torch.ops.backbone import (
    downsampler, head_rowsums, upsampler)
from lanedetection_end2end_tpu_torch.ops.nb1d import nb1d
from test_torch_engine import _randomize_bn

RESIZE, BATCH = 64, 2
BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(0)
    jcfg = jax_config(resize=RESIZE, batch_size=BATCH, reg_ls=1.0)
    jnet = JaxLaneNet(jcfg, dtype=jnp.float32)
    v = _randomize_bn(jnet.init(jax.random.PRNGKey(0)), rng)
    x = rng.uniform(size=(BATCH, RESIZE, 2 * RESIZE, 3)).astype(np.float32)
    cfg = train_sh_config(resize=RESIZE, reg_ls=1.0)
    sd = state_dict_from_variables(v)
    return {"v": v, "jcfg": jcfg, "jfitter": jnet.fitter, "x": x,
            "enc": fg.pack_encoder(sd),
            "dec": fg.pack_decoder(sd, cfg, make_fitter(cfg, "cpu"))}


STAGES = ([("enc", i) for i in range(len(bf.ENC_STAGES))]
          + [("dec", i) for i in range(len(bf.DEC_STAGES))])


@pytest.mark.parametrize("part,i", STAGES,
                         ids=[f"{p}{i}" for p, i in STAGES])
def test_offset_table_rebuilds_each_stage(model, part, i):
    """Stage i's weights, vectors (mul / add, an NB1D block's six, the
    head's bias and column coordinate) and dilation, read back from the
    flat buffers at the table's offsets, equal the per-block dicts."""
    packed = model[part]
    stages = bf.ENC_STAGES if part == "enc" else bf.DEC_STAGES
    n = len(stages)
    table = list(packed["table"])
    assert len(table) == 3 * n
    key = stages[i]
    p = bf.stage(packed, key)
    wo, vo, d = table[i], table[n + i], table[2 * n + i]
    assert wo % 8 == 0 and vo % 4 == 0  # 16-byte aligned segments
    w = packed["wbuf"][wo:wo + p["w"].numel()].view(p["w"].shape)
    assert w.dtype == BF16 and torch.equal(w, p["w"])
    names = (["vec"] if "vec" in p else ["bias", "xs"] if "xs" in p
             else ["mul", "add"])
    off = vo
    for name in names:
        want = p[name]
        got = packed["vbuf"][off:off + want.numel()].view(want.shape)
        assert got.dtype == F32 and torch.equal(got, want.float()), name
        off += want.numel()
    assert d == p.get("dilation", 0)


@pytest.mark.parametrize("part", ["enc", "dec"])
def test_stage_lists_spell_the_block_sequence(model, part):
    """`run_stages` takes each stage once, in the networks' order, through
    the op of its kind on its own per-block dict: the encoder's initial
    block, down1, 5 NB1D-64 at d = 1, down2 and 8 NB1D-128 at d = 2, 4, 8,
    16 twice; the decoder's up1, 2 NB1D-64, up2, 2 NB1D-16 and the head."""
    packed = model[part]
    if part == "enc":
        stages = bf.ENC_STAGES
        want = ([("down", packed["initial"]), ("down", packed["down1"])]
                + [("nb1d", p) for p in packed["nb64"]]
                + [("down", packed["down2"])]
                + [("nb1d", p) for p in packed["nb128"]])
        dilations = [1] * 5 + [2, 4, 8, 16] * 2
    else:
        stages = bf.DEC_STAGES
        want = ([("up", packed["up1"])]
                + [("nb1d", p) for p in packed["nb64"]]
                + [("up", packed["up2"])]
                + [("nb1d", p) for p in packed["nb16"]]
                + [("head", packed["head"])])
        dilations = [1] * 4
    seen = []
    ops = {kind: (lambda kind: lambda x, p: seen.append((kind, p)) or x + 1)(
        kind) for kind in ("down", "up", "nb1d", "head")}
    assert bf.run_stages(0, packed, stages, ops) == len(stages)
    assert [k for k, _ in seen] == [k for k, _ in want]
    assert all(got is p for (_, got), (_, p) in zip(seen, want))
    assert [p["dilation"] for k, p in seen if k == "nb1d"] == dilations


class Stubs:
    """Stand-ins for `kernel`, `launch` and `check_cuda` of
    `ops/backbone_fused.py`; `calls` lists (library, symbol, arguments)."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def kernel(name, symbol, signature):
        return (name, symbol, signature)

    def launch(self, fn, device, *args):
        name, symbol, signature = fn
        assert len(args) + 1 == len(signature), (symbol, len(args))
        for ch, a in zip(signature, args):
            if ch == "p":  # a data pointer, or the host offset table
                assert isinstance(a, int) or hasattr(
                    a, "_length_"), (symbol, a)
            else:
                assert ch == "i" and isinstance(a, int), (symbol, ch, a)
        self.calls.append((name, symbol, args))

    @staticmethod
    def check_cuda(t, dtype, shape=None, name="tensor"):
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        return t.data_ptr()


@pytest.fixture
def stubs(monkeypatch):
    s = Stubs()
    for name in ("kernel", "launch", "check_cuda"):
        monkeypatch.setattr(bf, name, getattr(s, name))
    for f in (bf.encoder_fused_kernel, bf.decoder_fused_kernel):
        monkeypatch.setattr(f, "launches", 0)
        monkeypatch.setattr(f, "barriers", None)
    return s


def _images(B=BATCH, H=RESIZE, W=2 * RESIZE, dtype=BF16):
    g = torch.Generator().manual_seed(0)
    return torch.rand(B, H, W, 3, generator=g).to(dtype)


def _enc(B=BATCH, dtype=BF16):
    g = torch.Generator().manual_seed(1)
    return torch.randn(B, RESIZE // 8, RESIZE // 4, 128, generator=g).to(dtype)


def test_encoder_wrapper_asks_for_its_entry(stubs, model):
    out = bf.encoder_fused_kernel(_images(), model["enc"])
    assert [(n, s) for n, s, _ in stubs.calls] == [
        ("encoder_fused", "ld_encoder_fused")]
    args = stubs.calls[0][2]
    # images, wbuf, vbuf, table, n, scratch, out, barriers, B, H, W
    assert len(args) == 11
    assert args[4] == 3 * len(bf.ENC_STAGES)           # table entries
    barriers = bf.encoder_fused_kernel.barriers         # the kernel's count
    assert barriers.shape == (1,) and barriers.dtype == torch.int32
    assert args[7] == barriers.data_ptr()
    assert args[-3:] == (BATCH, RESIZE, 2 * RESIZE)     # B, H, W
    assert out.shape == (BATCH, RESIZE // 8, RESIZE // 4, 128)
    assert out.dtype == BF16
    assert bf.encoder_fused_kernel.launches == 1


def test_decoder_wrapper_asks_for_its_entry(stubs, model):
    S = bf.decoder_fused_kernel(_enc(), model["dec"])
    assert [(n, s) for n, s, _ in stubs.calls] == [
        ("decoder_fused", "ld_decoder_fused")]
    args = stubs.calls[0][2]
    head = model["dec"]["head"]
    # enc, wbuf, vbuf, table, n, scratch, S, barriers, B, h, w, C,
    # zero_rows, act
    assert len(args) == 14
    assert args[4] == 3 * len(bf.DEC_STAGES)
    barriers = bf.decoder_fused_kernel.barriers
    assert barriers.shape == (1,) and barriers.dtype == torch.int32
    assert args[7] == barriers.data_ptr()
    # B, h, w, C, zero_rows, activation code
    assert args[-6:] == (BATCH, RESIZE // 8, RESIZE // 4, 4,
                         head["zero_rows"], head["act"])
    assert S.shape == (BATCH, RESIZE, 8) and S.dtype == F32
    assert bf.decoder_fused_kernel.launches == 1


BAD = {
    "encoder float32": ("enc", lambda: _images(dtype=F32), TypeError),
    "encoder not contiguous": (
        "enc", lambda: _images(W=RESIZE).transpose(1, 2), ValueError),
    "encoder height not a multiple of 8": (
        "enc", lambda: _images(H=RESIZE - 4), ValueError),
    "encoder not 3 channels": (
        "enc", lambda: torch.zeros(BATCH, RESIZE, 2 * RESIZE, 4,
                                   dtype=BF16), ValueError),
    "decoder float32": ("dec", lambda: _enc(dtype=F32), TypeError),
    "decoder not contiguous": (
        "dec", lambda: _enc().transpose(1, 2).contiguous().transpose(1, 2),
        ValueError),
    "decoder width off the head's columns": (
        "dec", lambda: torch.zeros(BATCH, 8, 8, 128, dtype=BF16),
        ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_refuses_before_any_launch(stubs, model, case):
    part, make, err = BAD[case]
    wrapper = (bf.encoder_fused_kernel if part == "enc"
               else bf.decoder_fused_kernel)
    with pytest.raises(err):
        wrapper(make(), model[part])
    assert stubs.calls == [] and wrapper.launches == 0


# images of 1024 columns: NB1D-128 rows of 128 pixels on tiles of 64,
# NB1D-64 of 256 on 128, NB1D-16 of 512 on 256; refused before the
# column-split tile, launched now
WIDE = 1024


def _wide_decoder(model):
    """The decoder's constants with a head mapping WIDE columns, and its
    enc (1, 1, WIDE/8, 128)."""
    head = dict(model["dec"]["head"], xs=torch.zeros(WIDE))
    return (torch.zeros(1, 1, WIDE // 8, 128, dtype=BF16),
            dict(model["dec"], head=head))


@pytest.mark.parametrize("case", ["encoder wider than the row tiles",
                                  "decoder wider than the row tiles"])
def test_wrappers_take_images_wider_than_the_row_tiles(stubs, model, case):
    if case.startswith("encoder"):
        out = bf.encoder_fused_kernel(_images(B=1, H=8, W=WIDE),
                                      model["enc"])
        assert stubs.calls[0][2][-3:] == (1, 8, WIDE)      # B, H, W
        assert out.shape == (1, 1, WIDE // 8, 128)
    else:
        enc, dec = _wide_decoder(model)
        S = bf.decoder_fused_kernel(enc, dec)
        assert stubs.calls[0][2][-6:-3] == (1, 1, WIDE // 8)  # B, h, w
        assert S.shape == (1, 8, 2 * dec["head"]["bias"].shape[0])
    assert len(stubs.calls) == 1


@pytest.mark.parametrize("part", ["enc", "dec"])
def test_wrapper_refuses_a_cpu_tensor(model, part):
    """Without stubs a CPU tensor raises: the kernels run on the card only
    and have no fallback."""
    wrapper, x = ((bf.encoder_fused_kernel, _images()) if part == "enc"
                  else (bf.decoder_fused_kernel, _enc()))
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(x, model[part])
    assert wrapper.launches == before


@pytest.fixture(scope="module")
def cpu_run(model):
    counters = (nb1d, downsampler, upsampler, head_rowsums,
                bf.encoder_fused_kernel, bf.decoder_fused_kernel)
    before = [f.launches for f in counters]
    x = torch.from_numpy(model["x"])
    enc = fg.encoder_fused(x, model["enc"])
    enc_b = fg.encoder_blocks(x, model["enc"])
    S = fg.decoder_fused(enc, model["dec"])
    S_b = fg.decoder_blocks(enc, model["dec"])
    return {"enc": enc, "enc_b": enc_b, "S": S, "S_b": S_b,
            "launched": [f.launches for f in counters] != before}


def test_fused_equal_the_block_sequences_on_the_cpu(cpu_run):
    assert cpu_run["enc"].shape == (BATCH, RESIZE // 8, RESIZE // 4, 128)
    assert cpu_run["enc"].dtype == BF16
    assert torch.equal(cpu_run["enc"], cpu_run["enc_b"])
    assert cpu_run["S"].shape == (BATCH, RESIZE, 8)
    assert torch.equal(cpu_run["S"], cpu_run["S_b"])
    assert not cpu_run["launched"]  # CPU tensors launch nothing


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_encoder_fused_matches_jax(model, cpu_run):
    arrays, struct = jax_fused.pack_encoder(model["v"], model["jcfg"])
    jenc = jax_fused.encoder_fused(jnp.asarray(model["x"]), arrays, struct,
                                   model["jcfg"], interpret=True)
    assert _rel(cpu_run["enc"].float().numpy(),
                np.asarray(jenc, np.float32)) < 2e-2


def test_decoder_fused_matches_jax(model, cpu_run):
    """Both decoders on the same (port) features."""
    arrays, struct = jax_fused.pack_decoder(model["v"], model["jcfg"],
                                            model["jfitter"])
    enc = cpu_run["enc"].float().numpy()
    jS = jax_fused.decoder_fused(jnp.asarray(enc, jnp.bfloat16), arrays,
                                 struct, model["jcfg"], interpret=True)
    assert _rel(cpu_run["S"].numpy(), np.asarray(jS)) < 2e-2
