"""The deferred-copy debug build (`ops/_build.py` variant "defer"): the
switch -DLD_DEFER_CP_ASYNC reaches nvcc's flags for that variant only, the
variant builds into its own subdirectory of `_build/` and only on
request, `variant()` makes the wrappers load it, and every cp.async of the
kernel sources goes through the helpers the switch replaces. The compiler
is stubbed: this host has no nvcc."""

import re
import subprocess
from pathlib import Path

import pytest

from lanedetection_end2end_tpu_torch.ops import _build
from test_torch_threads import one_torch_thread  # noqa: F401

CSRC = Path(_build.CSRC)
SWITCH = "-DLD_DEFER_CP_ASYNC"


class FakeNvcc:
    """Stands in for subprocess.Popen: records the command and writes the
    `-o` file, as a successful nvcc would."""

    commands = []

    def __init__(self, cmd, **kw):
        FakeNvcc.commands.append(list(cmd))
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        self.returncode = 0

    def communicate(self):
        return "ptxas info: 0 bytes spill stores", None


@pytest.fixture
def stubbed(monkeypatch, tmp_path):
    FakeNvcc.commands = []
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    monkeypatch.setattr(subprocess, "Popen", FakeNvcc)
    return tmp_path / "_build"


def test_the_switch_reaches_only_the_defer_variant(stubbed):
    _build.build(["nb1d_chain", "nb_half_fwd"])
    normal = FakeNvcc.commands
    assert len(normal) == 2
    assert all(SWITCH not in cmd for cmd in normal)
    FakeNvcc.commands = []
    _build.build(["nb1d_chain", "nb_half_fwd"], "defer")
    defer = FakeNvcc.commands
    assert len(defer) == 2 and all(SWITCH in cmd for cmd in defer)
    for a, b in zip(normal, defer):
        # the same command but for the switch and the output path
        out_a, out_b = a[a.index("-o") + 1], b[b.index("-o") + 1]
        assert [x for x in b if x != SWITCH and x != out_b] == [
            x for x in a if x != out_a]
        assert Path(out_a).parent == stubbed
        assert Path(out_b).parent == stubbed / "defer"


def test_the_variant_builds_only_on_request(stubbed):
    _build.build()
    assert len(FakeNvcc.commands) == len(_build.SOURCES)
    assert not (stubbed / "defer").exists()
    FakeNvcc.commands = []
    _build.build()  # nothing is missing: nothing is built
    assert FakeNvcc.commands == []
    lib = _build._target("nb1d", "defer")
    assert lib.parent == stubbed / "defer" and not lib.exists()
    assert lib.name != _build._target("nb1d").name
    with pytest.raises(KeyError, match="unknown build variant"):
        _build.build(["nb1d"], "sanitize")


def test_variant_makes_kernel_load_the_debug_library(stubbed, monkeypatch):
    loaded = []

    class FakeLib:
        def __init__(self, path):
            loaded.append(path)

        def __getattr__(self, symbol):
            return type("Fn", (), {"__name__": symbol})()

    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    _build._library.cache_clear()
    _build._entry.cache_clear()
    try:
        _build.kernel("nb1d_chain", "ld_nb1d_chain", "pp")
        with _build.variant("defer"):
            _build.kernel("nb1d_chain", "ld_nb1d_chain", "pp")
        _build.kernel("nb1d_chain", "ld_nb1d_chain", "pp")
        assert [Path(p).parent for p in loaded] == [stubbed, stubbed / "defer"]
        assert [c for c in FakeNvcc.commands if SWITCH in c]
        assert _build._variant is None
        with pytest.raises(KeyError):
            with _build.variant("nope"):
                pass
    finally:
        _build._library.cache_clear()
        _build._entry.cache_clear()


def test_every_cp_async_goes_through_the_switched_helpers():
    """Only `csrc/tc_common.cuh` issues cp.async, and only outside the
    switch; its deferred helpers replace all four entry points."""
    for src in sorted(CSRC.glob("*.cu*")):
        text = src.read_text()
        asm = re.findall(r'"cp\.async[^"]*"', text)
        if src.name != "tc_common.cuh":
            assert not asm, src.name
    text = (CSRC / "tc_common.cuh").read_text()
    normal, deferred = text.split("#else  // LD_DEFER_CP_ASYNC")
    assert "#ifndef LD_DEFER_CP_ASYNC" in normal
    for fn in ("cp_async16(", "cp_async4(", "cp_async_commit(",
               "cp_async_wait("):
        assert fn in normal and fn in deferred, fn
    assert "cp.async" not in re.sub(r"//.*", "", deferred)
    assert "__trap()" in deferred


def test_chip_smoke_defers_libraries_that_exist():
    import chip_smoke
    assert set(chip_smoke.DEFER_SOURCES) <= set(_build.SOURCES)


def _includes(name, seen=None):
    """The headers `name` includes from csrc, transitively."""
    seen = set() if seen is None else seen
    for inc in re.findall(r'#include "([^"]+)"', (CSRC / name).read_text()):
        if inc not in seen:
            seen.add(inc)
            _includes(inc, seen)
    return seen


def test_the_defer_phase_reaches_every_ring_loop():
    """Every source that issues cp.async is built into a library of the
    deferred-copy phase, every library of the phase issues cp.async, and
    the train step's libraries (K6-K9), K11's and K12's (whose tiles that
    TMA cannot take arrive by cp.async) are among them."""
    import chip_smoke
    issuers = {src.name for src in CSRC.glob("*.cu*")
               if src.name != "tc_common.cuh"
               and re.search(r"\bcp_async(16|4)\(", src.read_text())}
    assert issuers == {"nb1d.cuh", "conv3tap_f32.cuh", "conv_s2_mma.cuh",
                       "conv3tap.cuh", "wgrad3tap.cuh", "wls_moments.cu"}
    reached = set()
    for lib in chip_smoke.DEFER_SOURCES:
        mine = (_includes(f"{lib}.cu") | {f"{lib}.cu"}) & issuers
        assert mine, lib
        reached |= mine
    assert reached == issuers
    assert {"nb_half_fwd", "nb_half_bwd", "downsampler_op",
            "lane_maps_op", "packed_conv",
            "wls_moments"} <= set(chip_smoke.DEFER_SOURCES)


@pytest.mark.parametrize("name", [
    "nb1d_first_wait", "conv3tap_f32_conv_first_wait",
    "conv3tap_f32_wgrad_first_wait", "conv_s2_mma_first_wait",
    "conv3tap_conv_first_wait", "wgrad3tap_first_wait"])
def test_each_mutation_skips_one_first_wait(name):
    """`tools/defer_mutations.py` still finds its text in the sources, and
    the mutated source differs from the original only in that one wait."""
    from lanedetection_end2end_tpu_torch.tools import defer_mutations as dm
    header, nth, old, new = dm.MUTATIONS[name]
    text = (CSRC / header).read_text()
    mutated = dm.mutate(text, nth, old, new)
    assert mutated.count("cp_async_wait<") == text.count("cp_async_wait<")
    assert "if (i > 0)" in mutated and "if (i > 0)" not in text
    assert mutated.replace(new, old, 1) == text
    with pytest.raises(ValueError):
        dm.mutate(text, text.count(old) + 1, old, new)


@pytest.mark.parametrize("name", [
    "conv3tap_prologue_on_padding", "wgrad3tap_prologue_on_padding",
    "conv3tap_tap_off_by_one"])
def test_each_tile_mutation_applies_once(name):
    """The tool's mutations of the bf16 tiles' index plan still find their
    text in the sources and change it, and run the bf16 tiles' checks
    (`--tiles-only`); the first-wait ones run the deferred-copy phase."""
    from lanedetection_end2end_tpu_torch.tools import defer_mutations as dm
    header, nth, old, new = dm.TILE_MUTATIONS[name]
    text = (CSRC / header).read_text()
    mutated = dm.mutate(text, nth, old, new)
    assert mutated != text
    assert len(mutated) - len(text) == len(new) - len(old)
    assert dm.FLAGS[name] == "--tiles-only"
    assert {dm.FLAGS[n] for n in dm.MUTATIONS} == {"--defer-only"}
    assert not set(dm.MUTATIONS) & set(dm.TILE_MUTATIONS)
