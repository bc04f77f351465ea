"""Fused encoder FFN: ``gelu(x·W1ᵀ + b1)·W2ᵀ + b2``.

Replaces the TPU kernel ``msa_tpu/ops/pallas/ffn.py:ffn_fused``
(``pl.pallas_call`` at :89, body :49-63) in bf16 and in f32
(:func:`ffn_fused` on f32 x: the parity mode's encoders). The CUDA kernels
are ``msa_tpu_torch/csrc/ffn.cu`` (with the bf16 ``wgmma`` GEMM of
``csrc/gemm_bf16.cuh``, two launches a call on the plans of
:func:`gemm_plan.plan`, and the f32 GEMM of ``csrc/gemm_f32.cuh`` on the
stream-K plans of :func:`gemm_plan.plan_f32`); its
note says what bounds them on the card and what the design does about it.

Weights are in PyTorch's Linear layout: ``w1 [d_ff, d]``, ``w2 [d, d_ff]``.
Rounding points, shared by the kernel and :func:`ffn_plain`: both dots
accumulate in f32, bias and GELU run in f32 (A&S 7.1.26 erf, as on the
TPU), the hidden tile is rounded to the compute dtype before the second
dot, and the output is rounded once at the end.

:func:`ffn_fused_int8` is the W8A8 variant, replacing
``msa_tpu/ops/pallas/ffn.py:ffn_fused_int8`` (``pl.pallas_call`` at :166,
body ``_ffn_int8_kernel`` :106-133). Its weights come quantized per output
channel from the f32 masters (``w1_q [d_ff, d]`` int8 with ``s1 [d_ff]``,
``w2_q [d, d_ff]`` with ``s2 [d]``) and its biases are f32. x and the f32
GELU output are quantized per row; the dots dequantize as ``acc·xs·s1 +
b1`` and ``acc·hs·s2 + b2`` in f32 (``ffn.py:123,131``). The result is in
x's dtype: bf16, or f32 under f32 compute (``compute_dtype="float32",
quantize="int8"``), where the kernel quantizes the f32 rows of x.
"""

from __future__ import annotations

import math

import torch

from msa_tpu_torch.ops import quant as Q
from msa_tpu_torch.ops.kernels import build
from msa_tpu_torch.ops.kernels import gemm_bf16 as GB
from msa_tpu_torch.ops.kernels import gemm_f32 as GF
from msa_tpu_torch.ops.kernels import gemm_plan as GP
from msa_tpu_torch.ops.kernels import gemm_s8 as GS
from msa_tpu_torch.ops.kernels._common import require, zeroed
from msa_tpu_torch.ops.kernels.quant import quantize_rows

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


def _launch_ffn(entry: str, x, w1, b1, w2, b2, dtype: torch.dtype) -> torch.Tensor:
    n, d = x.shape
    f = w1.shape[0]
    if d % 128 or f % 128:
        raise ValueError(f"{entry} kernel needs d and d_ff multiples of 128, got {d}, {f}")
    for name, t, shape in (
        ("x", x, (n, d)), ("w1", w1, (f, d)), ("b1", b1, (f,)), ("w2", w2, (d, f)), ("b2", b2, (d,))
    ):
        require(t, name, dtype, shape, x.device)
    hidden = torch.empty((n, f), dtype=dtype, device=x.device)
    out = torch.empty((n, d), dtype=dtype, device=x.device)
    ptrs = [t.data_ptr() for t in (x, w1, b1, w2, b2, hidden, out)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # with the GEMM's split-K scratch and fc_in's and fc_out's plans
    ws, cnt, plan_in, plan_out = GP.launch_args(x.device, (n, f, d), (n, d, f), dtype=dtype)
    rc = getattr(build.library(), entry)(*ptrs, ws, cnt, n, d, f, plan_in, plan_out, stream)
    build.check(rc, entry)
    return out


def ffn_fused(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x [N, d] → [N, d]. CPU tensors take :func:`ffn_plain`; CUDA tensors
    launch the bf16 kernel (two launches of the bf16 GEMM, counted in
    ``gemm_bf16.launches``), or for f32 x ``msa_ffn_fused_f32`` (two
    launches of the f32 SIMT GEMM, exact FMA, no TF32, counted in
    ``gemm_f32.launches``); d and d_ff multiples of 128."""
    if x.device.type == "cpu":
        return ffn_plain(x, w1, b1, w2, b2)
    if x.dtype == torch.float32:
        out = _launch_ffn("msa_ffn_fused_f32", x, w1, b1, w2, b2, torch.float32)
        ffn_fused.launches_f32 += 1
        GF.gemm_f32.launches += 2  # fc_in and fc_out, launched from C
        return out
    out = _launch_ffn("msa_ffn_fused", x, w1, b1, w2, b2, torch.bfloat16)
    ffn_fused.launches += 1
    GB.gemm_bf16.launches += 2  # fc_in and fc_out, launched from C
    return out


# kernel launches since the last reset, bf16 and f32 (the smoke reads them)
ffn_fused.launches = ffn_fused.launches_f32 = 0


def ffn_int8_plain(x, w1_q, s1, b1, w2_q, s2, b2) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel (same rounding points)."""
    xq, xs = Q.quantize_rows(x)
    h = Q.int8_matmul(xq, w1_q) * xs * s1.float() + b1.float()
    hq, hs = Q.quantize_rows(gelu_as(h))
    o = Q.int8_matmul(hq, w2_q) * hs * s2.float() + b2.float()
    return o.to(x.dtype)


def ffn_fused_int8(x, w1_q, s1, b1, w2_q, s2, b2) -> torch.Tensor:
    """x [N, d] → [N, d], W8A8. CPU tensors take :func:`ffn_int8_plain`;
    CUDA tensors launch the kernel (d % 128 == 0, d_ff % 128 == 0): on bf16
    x ``msa_ffn_fused_int8``, on f32 x (f32 compute) ``msa_ffn_fused_int8_f32``,
    counted in ``launches_f32``; each GEMM on :func:`gemm_s8.plan`'s tile and
    K split. The entry launches its four kernels as one chain, the last
    three under programmatic dependent launch (``csrc/ffn.cu``)."""
    if x.device.type == "cpu":
        return ffn_int8_plain(x, w1_q, s1, b1, w2_q, s2, b2)
    n, d = x.shape
    f = w1_q.shape[0]
    if d % 128 or f % 128:
        raise ValueError(f"ffn_fused_int8 kernel needs d and d_ff multiples of 128, got {d}, {f}")
    dev, f32, i8 = x.device, torch.float32, torch.int8
    dt = f32 if x.dtype == f32 else torch.bfloat16
    for name, t, dtype, shape in (
        ("x", x, dt, (n, d)),
        ("w1_q", w1_q, i8, (f, d)),
        ("s1", s1, f32, (f,)),
        ("b1", b1, f32, (f,)),
        ("w2_q", w2_q, i8, (d, f)),
        ("s2", s2, f32, (d,)),
        ("b2", b2, f32, (d,)),
    ):
        require(t, name, dtype, shape, dev)
    xq = torch.empty((n, d), dtype=i8, device=dev)
    hidden = torch.empty((n, f), dtype=f32, device=dev)
    hq = torch.empty((n, f), dtype=i8, device=dev)
    xs, hs = (torch.empty((n,), dtype=f32, device=dev) for _ in range(2))
    out = torch.empty((n, d), dtype=dt, device=dev)
    entry = "msa_ffn_fused_int8_f32" if dt == f32 else "msa_ffn_fused_int8"
    ws, cnt, plan_in, plan_out = GP.launch_args(dev, (n, f, d), (n, d, f), dtype=i8)
    amax = zeroed("row_amax", dev, n).data_ptr()  # fc_in's epilogue reduces the hidden rows' amax here
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(build.library(), entry)(
        x.data_ptr(), w1_q.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2_q.data_ptr(), s2.data_ptr(),
        b2.data_ptr(), xq.data_ptr(), xs.data_ptr(), hidden.data_ptr(), hq.data_ptr(), hs.data_ptr(),
        out.data_ptr(), ws, cnt, amax, n, d, f, plan_in, plan_out, stream,
    )
    build.check(rc, entry)
    if dt == f32:
        ffn_fused_int8.launches_f32 += 1
    else:
        ffn_fused_int8.launches += 1
    quantize_rows.launches += 2  # x and the hidden tile (from fc_in's amax), launched from C
    GS.gemm_s8.launches += 2  # fc_in and fc_out, launched from C
    return out


# kernel launches since the last reset, bf16 and f32 x (the smoke reads them)
ffn_fused_int8.launches = ffn_fused_int8.launches_f32 = 0
