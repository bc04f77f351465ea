"""Fused encoder FFN: ``gelu(x·W1ᵀ + b1)·W2ᵀ + b2``.

Replaces the TPU kernel ``msa_tpu/ops/pallas/ffn.py:ffn_fused``
(``pl.pallas_call`` at :89, body :49-63). The CUDA kernel is
``msa_tpu_torch/csrc/ffn.cu`` (with the GEMM of ``csrc/gemm.cuh``); its
note says what bounds it on the card and what the design does about it.

Weights are in PyTorch's Linear layout: ``w1 [d_ff, d]``, ``w2 [d, d_ff]``.
Rounding points, shared by the kernel and :func:`ffn_plain`: both dots
accumulate in f32, bias and GELU run in f32 (A&S 7.1.26 erf, as on the
TPU), the hidden tile is rounded to the compute dtype before the second
dot, and the output is rounded once at the end.
"""

from __future__ import annotations

import math

import torch

from msa_tpu_torch.ops.kernels import build
from msa_tpu_torch.ops.kernels._common import require

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def erf_as(z: torch.Tensor) -> torch.Tensor:
    """erf by Abramowitz & Stegun 7.1.26 (max abs error 1.5e-7)."""
    za = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * za)
    poly = t * (
        0.254829592 + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429)))
    )
    return torch.sign(z) * (1.0 - poly * torch.exp(-za * za))


def gelu_as(x: torch.Tensor) -> torch.Tensor:
    """Exact-form GELU x·Φ(x) with the polynomial erf above."""
    return 0.5 * x * (1.0 + erf_as(x * _INV_SQRT2))


def ffn_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same rounding points)."""
    h = x.float() @ w1.float().t() + b1.float()
    h = gelu_as(h)
    o = h.to(w2.dtype).float() @ w2.float().t() + b2.float()
    return o.to(x.dtype)


def ffn_fused(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x [N, d] → [N, d]. CPU tensors take :func:`ffn_plain`; CUDA tensors
    launch the kernel (bf16 only; d and d_ff multiples of 128)."""
    if x.device.type == "cpu":
        return ffn_plain(x, w1, b1, w2, b2)
    n, d = x.shape
    f = w1.shape[0]
    if d % 128 or f % 128:
        raise ValueError(f"ffn_fused kernel needs d and d_ff multiples of 128, got {d}, {f}")
    bf16 = torch.bfloat16
    for name, t, shape in (
        ("x", x, (n, d)), ("w1", w1, (f, d)), ("b1", b1, (f,)), ("w2", w2, (d, f)), ("b2", b2, (d,))
    ):
        require(t, name, bf16, shape, x.device)
    hidden = torch.empty((n, f), dtype=bf16, device=x.device)
    out = torch.empty((n, d), dtype=bf16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = build.library().msa_ffn_fused(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        hidden.data_ptr(), out.data_ptr(), n, d, f, stream,
    )
    build.check(rc, "ffn_fused")
    ffn_fused.launches += 1
    return out


ffn_fused.launches = 0  # kernel launches since the last reset (the smoke reads it)
