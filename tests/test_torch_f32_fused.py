"""The fused training kernels K6-K10 (`nb_half_a`, `nb_half_b`,
`downsampler_op`, `lane_maps_op`, `head_rowsums_op`) take bf16 and float32
planes on the card: each dtype asks for its own C entry, with as many
arguments as that entry's signature string spells, and a call whose planes
mix dtypes raises before any launch.

This host has no card, so the tests call the CUDA wrappers on CPU tensors
with the module's `kernel`, `launch` and `check_cuda` stubbed: `kernel`
returns what was asked for, `launch` records the call, and `check_cuda`
validates dtype, shape and contiguity as the real one does, without the
device. The kernels themselves are held against their plain versions on
the card by `chip_smoke.py`."""

import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu_torch.ops import lanemaps as lm
from lanedetection_end2end_tpu_torch.ops import nb_block as nb
from test_torch_threads import one_torch_thread  # noqa: F401

BF16, F32 = torch.bfloat16, torch.float32
SUFFIX = {BF16: "", F32: "_f32"}


class Stubs:
    """Stand-ins for `kernel`, `launch` and `check_cuda` of a wrapper
    module; `calls` lists (library, symbol, arguments) of each launch."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def kernel(name, symbol, signature):
        return (name, symbol, signature)

    def launch(self, fn, device, *args):
        name, symbol, signature = fn
        # the stream is appended to `args`: one character each
        assert len(args) + 1 == len(signature), (symbol, len(args))
        for ch, a in zip(signature, args):
            if ch == "p":
                assert a is None or isinstance(a, int), (symbol, a)
            else:
                assert ch == "i" and isinstance(a, int), (symbol, ch, a)
        self.calls.append((name, symbol, args))

    @staticmethod
    def check_cuda(t, dtype, shape=None, name="tensor"):
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        return t.data_ptr()


@pytest.fixture
def stubs(monkeypatch):
    s = Stubs()
    for mod in (nb, lm):
        monkeypatch.setattr(mod, "kernel", s.kernel)
        monkeypatch.setattr(mod, "launch", s.launch)
        monkeypatch.setattr(mod, "check_cuda", s.check_cuda)
    for f in (nb.nb_half_a, nb.nb_half_b, lm.downsampler_op, lm.lane_maps_op,
              lm.head_rowsums_op):
        monkeypatch.setattr(f, "launches", 0)
        monkeypatch.setattr(f, "bwd_launches", 0)
    return s


def _rn(rng, *shape, dtype=F32):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype)


# (op, direction) -> a call of the CUDA wrapper on planes of `dt`; returns
# (library, symbol stem, the wrapper's counter, its planes with their dtypes)
def _nb_half(half, backward, dt, rng):
    B, H, W, C, d = 2, 4, 6, 16, 1 if half == "a" else 2
    x = _rn(rng, B, H, W, C, dtype=dt)
    kh, kw = _rn(rng, 3, C, C), _rn(rng, 3, C, C)
    bh, bw = _rn(rng, C), _rn(rng, C)
    mul = add = None
    if half == "b":
        mul, add = _rn(rng, C).abs(), _rn(rng, C)
    wrapper = nb.nb_half_a if half == "a" else nb.nb_half_b
    if not backward:
        yout, ymid, mom = nb._half_fwd_cuda(x, mul, add, kh, bh, kw, bw, d)
        return ("nb_half_fwd", "ld_nb_half_fwd", wrapper, "launches",
                [yout, ymid], [mom])
    ymid, yout, dyout = (_rn(rng, B, H, W, C, dtype=dt) for _ in range(3))
    out = nb.half_bwd_kernel(x, mul, add, ymid, yout, dyout,
                             _rn(rng, 2, C), kh, kw, d)
    return ("nb_half_bwd", "ld_nb_half_bwd", wrapper, "bwd_launches",
            [out[0]], [t for t in out[1:] if t is not None])


def _downsampler(backward, dt, rng):
    B, H, W, cin, cout = 2, 4, 6, 16, 64
    x = _rn(rng, B, H, W, cin, dtype=dt)
    weight, bias = _rn(rng, cout - cin, cin, 3, 3), _rn(rng, cout - cin)
    if not backward:
        y, mom = lm._downsampler_fwd_cuda(x, weight, bias)
        return ("downsampler_op", "ld_downsampler_op_fwd", lm.downsampler_op,
                "launches", [y], [mom])
    y, dy = (_rn(rng, B, H // 2, W // 2, cout, dtype=dt) for _ in range(2))
    dx, dweight, dbias = lm.downsampler_bwd_kernel(
        x, y, dy, _rn(rng, 2, cout), weight)
    return ("downsampler_op", "ld_downsampler_op_bwd", lm.downsampler_op,
            "bwd_launches", [dx], [dweight, dbias])


def _lane_maps(backward, dt, rng):
    B, H, W, cin, cout, k = 2, 3, 5, 64, 16, 3
    x = _rn(rng, B, H, W, cin, dtype=dt)
    weight, bias = _rn(rng, cin, cout, k, k), _rn(rng, cout)
    if not backward:
        y, mom = lm._lane_maps_fwd_cuda(x, weight, bias, k, dt, True)
        return ("lane_maps_op", "ld_lane_maps_op_fwd", lm.lane_maps_op,
                "launches", [y], [mom])
    y, dy = (_rn(rng, B, 2 * H, 2 * W, cout, dtype=dt) for _ in range(2))
    dx, dweight, dbias = lm.lane_maps_bwd_kernel(
        x, y, dy, _rn(rng, 2, cout), weight, k)
    return ("lane_maps_op", "ld_lane_maps_op_bwd", lm.lane_maps_op,
            "bwd_launches", [dx], [dweight, dbias])


def _head_rowsums(backward, dt, rng):
    B, Hh, Wh, cin, C = 2, 3, 5, 16, 4
    x = _rn(rng, B, Hh, Wh, cin, dtype=dt)
    weight, bias, xs = _rn(rng, cin, C, 2, 2), _rn(rng, C), _rn(rng, 2 * Wh)
    if not backward:
        S = lm._head_rowsums_fwd_cuda(x, weight, bias, xs, 1)
        return ("head_rowsums_op", "ld_head_rowsums_op_fwd",
                lm.head_rowsums_op, "launches", [], [S])
    dx, dweight, dbias = lm.head_rowsums_bwd_kernel(
        x, _rn(rng, B, 2 * Hh, 2 * C), weight, bias, xs, 1)
    return ("head_rowsums_op", "ld_head_rowsums_op_bwd", lm.head_rowsums_op,
            "bwd_launches", [dx], [dweight, dbias])


OPS = {"nb_half_a": lambda bwd, dt, rng: _nb_half("a", bwd, dt, rng),
       "nb_half_b": lambda bwd, dt, rng: _nb_half("b", bwd, dt, rng),
       "downsampler_op": _downsampler, "lane_maps_op": _lane_maps,
       "head_rowsums_op": _head_rowsums}


@pytest.mark.parametrize("dt", [F32, BF16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_each_dtype_launches_its_own_entry(stubs, op, backward, dt):
    """One launch of the dtype's own C entry, its arguments matching the
    signature; the planes it returns in the input's dtype, the sums in
    f32; the wrapper's counter up by one."""
    rng = np.random.default_rng(0)
    lib, stem, wrapper, counter, planes, sums = OPS[op](backward, dt, rng)
    assert [(n, s) for n, s, _ in stubs.calls] == [(lib, stem + SUFFIX[dt])]
    assert getattr(wrapper, counter) == 1
    assert all(t.dtype == dt for t in planes)
    assert all(t.dtype == F32 for t in sums)


def _mixed_nb_bwd(rng):
    x = _rn(rng, 2, 4, 6, 16)
    ymid, yout = _rn(rng, 2, 4, 6, 16, dtype=BF16), _rn(rng, 2, 4, 6, 16)
    k = _rn(rng, 3, 16, 16)
    nb.half_bwd_kernel(x, None, None, ymid, yout, _rn(rng, 2, 4, 6, 16),
                       _rn(rng, 2, 16), k, k, 1)


def _mixed_nb_dyout(rng):
    x = _rn(rng, 2, 4, 6, 16, dtype=BF16)
    ymid, yout = (_rn(rng, 2, 4, 6, 16, dtype=BF16) for _ in range(2))
    k, mul = _rn(rng, 3, 16, 16), _rn(rng, 16)
    nb.half_bwd_kernel(x, mul, mul, ymid, yout, _rn(rng, 2, 4, 6, 16),
                       _rn(rng, 2, 16), k, k, 2)


def _mixed_downsampler(rng):
    x = _rn(rng, 2, 4, 6, 16)
    lm.downsampler_bwd_kernel(x, _rn(rng, 2, 2, 3, 64, dtype=BF16),
                              _rn(rng, 2, 2, 3, 64), _rn(rng, 2, 64),
                              _rn(rng, 48, 16, 3, 3))


def _mixed_lane_maps_fwd(rng):
    lm._lane_maps_fwd_cuda(_rn(rng, 2, 3, 5, 64), _rn(rng, 64, 16, 3, 3),
                           _rn(rng, 16), 3, BF16, True)


def _mixed_lane_maps_bwd(rng):
    lm.lane_maps_bwd_kernel(_rn(rng, 2, 3, 5, 64), None,
                            _rn(rng, 2, 6, 10, 16, dtype=BF16), None,
                            _rn(rng, 64, 16, 3, 3), 3)


def _half_precision_plane(rng):
    lm._head_rowsums_fwd_cuda(_rn(rng, 2, 3, 5, 16, dtype=torch.float16),
                              _rn(rng, 16, 4, 2, 2), _rn(rng, 4),
                              _rn(rng, 10), 1)


@pytest.mark.parametrize("call", [
    _mixed_nb_bwd, _mixed_nb_dyout, _mixed_downsampler, _mixed_lane_maps_fwd,
    _mixed_lane_maps_bwd, _half_precision_plane])
def test_mixed_plane_dtypes_raise_before_any_launch(stubs, call):
    """A float32 call with a bf16 plane (or the reverse), a float32 plane
    asked for a bf16 output, or a plane of another dtype: TypeError, and
    nothing launched."""
    with pytest.raises(TypeError):
        call(np.random.default_rng(1))
    assert stubs.calls == []
