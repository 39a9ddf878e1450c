"""K12 wls_moments: the moments of the general-homography WLS fit.

Counterpart of `lanedetection_end2end_tpu/ops/pallas_wls.py::wls_moments`:

    m[b*C + c, k] = sum_n w[b, n, c]^2 * basis[n, k]        (float32)

with its gradient gw = 2 w (g @ basis^T); the basis gets none. `w` is taken
as (B, N, C) with the lanes innermost, the layout of the fit's masked weight
maps (B, H, W, C), or as (BC, N), which is C = 1; the moments come out as
(B*C, K) rows in JAX's order. `wls_moments` is a `torch.autograd.Function`:
its forward launches the CUDA kernel (`csrc/wls_moments.cu`) for a CUDA
tensor and takes `wls_moments_plain` only for a CPU tensor; its backward is
plain PyTorch on either device, as JAX leaves it to XLA. The plain version
contracts in float64 and rounds once to float32, so no TF32 setting can
touch it.
"""

from __future__ import annotations

import torch

from lanedetection_end2end_tpu_torch.ops._build import (
    check_cuda, kernel, launch)

F32 = torch.float32
CHUNK = 512  # pixels per CTA of the kernel's first pass


def _as_bnc(w: torch.Tensor) -> torch.Tensor:
    return w.unsqueeze(-1) if w.dim() == 2 else w


def wls_moments_plain(w: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """(B, N, C) or (BC, N) weights, (N, K) basis -> (B*C, K) float32."""
    w3 = _as_bnc(w).double()
    m = torch.einsum("bnc,nk->bck", w3 * w3, basis.double())
    return m.reshape(-1, basis.shape[1]).to(F32)


def wls_moments_bwd_plain(w: torch.Tensor, basis: torch.Tensor,
                          g: torch.Tensor) -> torch.Tensor:
    """d(sum g * m) / dw = 2 w (g @ basis^T), in w's shape and dtype."""
    w3 = _as_bnc(w)
    B, _, C = w3.shape
    gb = torch.einsum("bck,nk->bnc", g.double().reshape(B, C, -1),
                      basis.double())
    return (2.0 * w3.double() * gb).to(w.dtype).reshape(w.shape)


def wls_moments_kernel(w: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors: (B, N, C) or (BC, N) f32, (N, K) f32 ->
    (B*C, K) f32. C must divide 32 and K be at most 32."""
    w3 = _as_bnc(w)
    B, N, C = w3.shape
    K = basis.shape[1]
    if 32 % C or not 1 <= K <= 32:
        raise ValueError(f"wls_moments kernel: C={C} must divide 32 and "
                         f"K={K} lie in 1..32")
    wp = check_cuda(w3, F32, name="w")
    bp = check_cuda(basis, F32, (N, K), "basis")
    chunks = -(-N // CHUNK)
    partial = torch.empty(chunks, B * C, K, dtype=F32, device=w.device)
    out = torch.empty(B * C, K, dtype=F32, device=w.device)
    launch(kernel("wls_moments", "ld_wls_moments", "ppppiiiiip"), w.device,
           wp, bp, partial.data_ptr(), out.data_ptr(), B, N, C, K, chunks)
    wls_moments.launches += 1
    return out


class _WLSMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, basis):
        ctx.save_for_backward(w, basis)
        if w.device.type == "cpu":
            return wls_moments_plain(w, basis)
        return wls_moments_kernel(w, basis)

    @staticmethod
    def backward(ctx, g):
        w, basis = ctx.saved_tensors
        gw = wls_moments_bwd_plain(w, basis, g) if ctx.needs_input_grad[0] \
            else None
        return gw, None


def wls_moments(w: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Fused squared-weight moments sum_n w^2[., n, .] basis[n, .] ->
    (B*C, K) float32; differentiable in w."""
    return _WLSMoments.apply(w, basis)


wls_moments.launches = 0
