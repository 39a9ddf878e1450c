"""K12 `wls_moments`'s partition and order of sums, on the CPU.

The kernel (`csrc/wls_moments.cu`) streams N in tiles of TILE pixels, a
contiguous run of `stream_chunks` tiles a CTA; in a CTA warp j keeps the
sums of pixels j, j + 8, ... of each tile (a tile starts at a multiple of
128, so those are the pixels p = j mod 8 of its run), the 8 warps' sums
add in warp order, and the CTAs' rows of partials are folded by
`ops/fold.py::fold_rows`. `stream_order` writes that partition and order
in PyTorch (inside a warp's run by einsum: the kernel's fused multiply-
adds have no bit-exact counterpart on the CPU, so what is checked is the
partition and the order of the partials, not the kernel's float32
rounding, which `chip_smoke.py` holds on the card, bit for bit across
launches):

- in float64 it equals the plain version's contraction (the float64 sum
  that `wls_moments_plain` rounds once to float32) to 1e-12 of max, at
  the engine's shape (B 8, N 131,072, C 4, K 20), at the JAX package's
  three test shapes and at one whose N is no multiple of a tile;
- in float32 it holds `wls_moments_plain` at 1e-4 of max, the bar the card
  holds the kernel to.

Then the CUDA wrapper with `kernel`, `launch` and `check_cuda` stubbed: it
asks for its entry with the partials' scratch sized as the kernel needs
((chunks, B*C, K) floats) and no zero fill, and refuses a lane count that
does not divide 32 and K > 32 before any launch."""

import importlib

import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu_torch.ops.fold import fold_rows
from test_torch_f32_fused import Stubs
from test_torch_threads import one_torch_thread  # noqa: F401

# the module (the package exports its function under the same name)
wm = importlib.import_module("lanedetection_end2end_tpu_torch.ops.wls_moments")
F32, F64 = torch.float32, torch.float64
WARPS = 8


def stream_order(w: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """K12's moments in its kernel's partition and order of partial sums,
    in w's dtype: w (B, N, C) or (BC, N), basis (N, K) -> (B*C, K)."""
    w3 = wm._as_bnc(w)
    B, N, C = w3.shape
    K = basis.shape[1]
    chunks, tpc = wm.stream_chunks(B, N, C)
    run = tpc * wm.TILE                     # pixels a chunk, a multiple of 8
    pad = chunks * run - N
    w2 = torch.nn.functional.pad(w3 * w3, (0, 0, 0, pad))
    bas = torch.nn.functional.pad(basis, (0, 0, 0, pad))
    # pixel p = chunk * run + q * 8 + j: warp j's sums over q, per chunk
    w2 = w2.reshape(B, chunks, run // WARPS, WARPS, C)
    bas = bas.reshape(chunks, run // WARPS, WARPS, K)
    per_warp = torch.einsum("bsqjc,sqjk->sjbck", w2, bas)
    block = torch.zeros_like(per_warp[:, 0])
    for j in range(WARPS):                  # the warps in warp order
        block = block + per_warp[:, j]
    return fold_rows(block.reshape(chunks, B * C, K))


def _case(shape, K, seed, dtype):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    basis = torch.from_numpy(rng.standard_normal((shape[1], K))).to(dtype)
    return w, basis


# (w's shape, K): the engine's masked maps (B, N, C) at 256x512, batch 8,
# order 3; the JAX package's test shapes (BC, N) with their K
# (tests/test_pallas_wls.py); N = 1001, no multiple of a tile, C = 2
SHAPES = {"engine": ((8, 131072, 4), 20), "jax 8x1024": ((8, 1024), 12),
          "jax 3x4096": ((3, 4096), 30), "jax 32x2000": ((32, 2000), 6),
          "odd 3x1001x2": ((3, 1001, 2), 7)}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_order_equals_the_plain_contraction_in_float64(name):
    shape, K = SHAPES[name]
    w, basis = _case(shape, K, 0, F64)
    got = stream_order(w, basis)
    w3 = wm._as_bnc(w)
    want = torch.einsum("bnc,nk->bck", w3 * w3, basis).reshape(-1, K)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_order_holds_the_plain_version_in_float32(name):
    shape, K = SHAPES[name]
    w, basis = _case(shape, K, 1, F32)
    got = stream_order(w, basis)
    want = wm.wls_moments_plain(w, basis)
    assert got.dtype == F32
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_stream_chunks_cover_n_with_one_wave():
    """The engine's shape: 1024 tiles in 256 chunks of 4 (at most CTAS);
    many groups of rows share the CTAs; every chunk holds a tile."""
    assert wm.stream_chunks(8, 131072, 4) == (256, 4)
    assert wm.stream_chunks(40, 3000, 4) == (24, 1)   # 5 groups, 24 tiles
    for B, N, C in ((8, 131072, 4), (3, 1001, 2), (32, 2000, 1), (1, 1, 1),
                    (300, 5000, 8)):
        chunks, tpc = wm.stream_chunks(B, N, C)
        tiles = -(-N // wm.TILE)
        groups = -(-B * C // wm.ROWS)
        assert (chunks - 1) * tpc < tiles <= chunks * tpc
        assert chunks * groups <= max(wm.CTAS, groups)


@pytest.fixture
def stubs(monkeypatch):
    s = Stubs()
    allocated, zeroed = [], []
    empty, zeros = torch.empty, torch.zeros

    def watched_empty(*shape, **kw):
        t = empty(*shape, **kw)
        allocated.append(tuple(t.shape))
        return t

    def watched_zeros(*shape, **kw):
        t = zeros(*shape, **kw)
        zeroed.append(tuple(t.shape))
        return t
    for name in ("kernel", "launch", "check_cuda"):
        monkeypatch.setattr(wm, name, getattr(s, name))
    monkeypatch.setattr(torch, "empty", watched_empty)
    monkeypatch.setattr(torch, "zeros", watched_zeros)
    monkeypatch.setattr(wm.wls_moments, "launches", 0)
    s.allocated, s.zeroed = allocated, zeroed
    return s


def _meta(*shape):
    return torch.empty(*shape, dtype=F32, device="meta")


@pytest.mark.parametrize("shape,K", [((8, 131072, 4), 20), ((3, 4096), 30),
                                     ((3, 1001, 2), 7)])
def test_wrapper_asks_for_the_partials_and_no_zero_fill(stubs, shape, K):
    w, basis = _meta(*shape), _meta(shape[1], K)
    stubs.allocated.clear()
    out = wm.wls_moments_kernel(w, basis)
    w3 = wm._as_bnc(w)
    B, N, C = w3.shape
    chunks, _ = wm.stream_chunks(B, N, C)
    assert stubs.allocated == [(chunks, B * C, K), (B * C, K)]
    assert stubs.zeroed == []
    [(name, symbol, args)] = stubs.calls
    assert (name, symbol) == ("wls_moments", "ld_wls_moments")
    assert args[4:] == (B, N, C, K, chunks)
    assert out.shape == (B * C, K)
    assert wm.wls_moments.launches == 1


@pytest.mark.parametrize("shape,K", [((2, 64, 3), 4), ((2, 64, 64), 4),
                                     ((2, 64, 4), 33), ((2, 64), 40)])
def test_wrapper_refuses_before_any_launch(stubs, shape, K):
    with pytest.raises(ValueError, match="must divide 32"):
        wm.wls_moments_kernel(_meta(*shape), _meta(shape[1], K))
    assert stubs.calls == [] and wm.wls_moments.launches == 0
