"""VALID stride-2 conv1d with an optional exact GELU, as one GEMM per batch
row.

Replaces the TPU kernel ``msa_tpu/ops/pallas/conv.py:conv_stride2_fused``
(``pl.pallas_call`` at :111, body ``_conv_kernel`` :54-75). The CUDA
kernel is ``msa_tpu_torch/csrc/conv_stride2.cu``; its note says why the
conv is a GEMM over the input read with a row stride of 2C, and what
bounds it on the card. In bf16 it is a persistent ``wgmma`` kernel fed by
TMA (one CTA an SM, the count passed in), the weight taken as ``wt [C',
k·C]`` (one strided copy a call, which is also the cast).

Layouts are JAX's: ``x [B, L, C]``, ``w [k, C, C']`` (``nn.Conv``'s
kernel), out ``[B, (L − k)//2 + 1, C']`` in x's dtype. The weight is cast
to x's dtype first. Products accumulate in f32, the GELU (the A&S erf form
of the TPU kernel) runs in f32 and the result is rounded once.

The audio extractor's ``extractor_impl="matmul"`` option runs its six
stride-2 layers through it at full width in serving on the card
(``models/audio.py``: ``strided_conv_gelu``), six launches a forward; it
has no backward, so training takes JAX's plain matmuls there. The default
extractor, ``"conv"``, convolves in cuDNN, as JAX's default convolves in
XLA.
"""

from __future__ import annotations

import torch

from msa_tpu_torch.ops.kernels import build
from msa_tpu_torch.ops.kernels import gemm_f32 as GF
from msa_tpu_torch.ops.kernels import gemm_plan as GP
from msa_tpu_torch.ops.kernels._common import require
from msa_tpu_torch.ops.kernels.ffn import gelu_as


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> int:
    """JAX's asserts (conv.py:98-99): → out_len."""
    b, length, c = x.shape
    k, cin, cout = w.shape
    if k not in (2, 3) or cin != c:
        raise ValueError(f"conv_stride2 takes w [k ∈ (2, 3), C, C'] with C = {c}, got {tuple(w.shape)}")
    if c % 128 or cout % 128:
        raise ValueError(f"conv_stride2 needs C and C' multiples of 128, got {c}, {cout}")
    if length < k:
        raise ValueError(f"conv_stride2 needs L ≥ k, got L={length}, k={k}")
    return (length - k) // 2 + 1


def conv_stride2_reference(x: torch.Tensor, w: torch.Tensor, apply_gelu: bool = True) -> torch.Tensor:
    """Plain version: the same GEMM over the same overlapping rows of x
    (row stride 2C), computed in f32 from the operands rounded to x's dtype,
    then the f32 GELU and one rounding."""
    out_len = _check_shapes(x, w)
    b, length, c = x.shape
    k, _, cout = w.shape
    xf = x.float().contiguous()
    taps = xf.as_strided((b, out_len, k * c), (length * c, 2 * c, 1))
    y = taps @ w.to(x.dtype).float().reshape(k * c, cout)
    if apply_gelu:
        y = gelu_as(y)
    return y.to(x.dtype)


def conv_stride2_fused(x: torch.Tensor, w: torch.Tensor, apply_gelu: bool = True) -> torch.Tensor:
    """x [B, L, C] (f32 or bf16), w [k, C, C'] → [B, (L − k)//2 + 1, C'] in
    x's dtype. CPU tensors take :func:`conv_stride2_reference`; CUDA
    tensors launch the kernel: bf16 ``msa_conv_stride2`` (on ``wt [C',
    k·C]``, the weight cast and transposed by one copy), f32 the f32 GEMM
    (``msa_gemm_f32`` on its w [K, N] path and the planner's plan, also
    counted in ``gemm_f32.launches``)."""
    if x.device.type == "cpu":
        return conv_stride2_reference(x, w, apply_gelu)
    out_len = _check_shapes(x, w)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv_stride2 kernel takes f32 or bf16, got {x.dtype}")
    b, length, c = x.shape
    k, _, cout = w.shape
    dev = x.device
    x = x.contiguous()
    require(x, "x", x.dtype, (b, length, c), dev)
    out = torch.empty((b, out_len, cout), dtype=x.dtype, device=dev)
    if x.dtype == torch.float32:  # output row i's taps start at input row 2i: A's row stride is 2C
        w = w.to(x.dtype).contiguous()
        require(w, "w", x.dtype, (k, c, cout), dev)
        p = GP.plan_f32(out_len, cout, k * c, batch=b, w_nk=False)
        GF.launch(x, w, None, out, out_len, cout, k * c, p, lda=2 * c, w_nk=False, batch=b, a_batch=length * c,
                  c_batch=out_len * cout, gelu=apply_gelu)
    else:  # wgmma reads B K-major: wt [C', k·C], cast and transposed by one copy
        wt = torch.empty((cout, k * c), dtype=x.dtype, device=dev).copy_(w.reshape(k * c, cout).t())
        sms = torch.cuda.get_device_properties(dev).multi_processor_count  # the persistent grid: one CTA an SM
        rc = build.library().msa_conv_stride2(
            x.data_ptr(), wt.data_ptr(), out.data_ptr(), b, length, c, cout, k, int(apply_gelu), sms,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        build.check(rc, "conv_stride2_fused")
    conv_stride2_fused.launches += 1
    return out


conv_stride2_fused.launches = 0  # kernel launches since the last reset (the smoke reads it)
