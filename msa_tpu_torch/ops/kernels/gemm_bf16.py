"""The bf16 GEMM under rows 8 and 10: the GEMM alone and its plain version.

``msa_tpu_torch/csrc/gemm_bf16.cuh`` computes ``act(A·Wᵀ + bias)`` for
``A [M, K]`` and ``W [N, K]`` bf16 with ``wgmma`` (f32 accumulation, bias
f32 or bf16, the A&S GELU or none, bf16 out) on the tile and K split that
:func:`msa_tpu_torch.ops.kernels.gemm_plan.plan` picks for bf16. A split
of K stores one f32 partial tile a split, and the tile's last CTA adds
them in split order, so two calls on the same inputs give the same bits
whatever CTA arrives last.

``attention_block`` (row 8: QKV and Wo) and ``ffn_fused`` (row 10: fc_in
with the GELU, fc_out) launch it from C, twice a call, and add those
launches to ``gemm_bf16.launches``. :func:`gemm_bf16` launches it alone:
the smoke holds it against an f32 product of the same bf16 operands and
times it beside ``torch.matmul``, which the port never calls.
"""

from __future__ import annotations

import torch

from msa_tpu_torch.ops.kernels import build
from msa_tpu_torch.ops.kernels import gemm_plan as GP
from msa_tpu_torch.ops.kernels._common import require
from msa_tpu_torch.ops.kernels.gemm_plan import Plan


def gemm_bf16_plain(a, w, bias, gelu: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the f32 product of the bf16 operands plus the
    bias in f32, then the A&S GELU (``gelu``), rounded to bf16 once — the
    rounding points of ``ffn_plain``'s and ``attention_block_plain``'s
    projections."""
    out = a.float() @ w.float().t() + bias.float()
    if gelu:
        from msa_tpu_torch.ops.kernels.ffn import gelu_as

        out = gelu_as(out)
    return out.to(torch.bfloat16)


def gemm_bf16(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, p: Plan | None = None,
              gelu: bool = False) -> torch.Tensor:
    """a [M, K] bf16, w [N, K] bf16, bias [N] f32 or bf16 → [M, N] bf16.
    CPU tensors take :func:`gemm_bf16_plain`; CUDA tensors launch the
    kernel on ``p`` or :func:`gemm_plan.plan`'s tile and split (N % 128 ==
    0, K % 8 == 0; a plan the kernel is not built for raises)."""
    if a.device.type == "cpu":
        return gemm_bf16_plain(a, w, bias, gelu)
    m, k = a.shape
    n = w.shape[0]
    p = p or GP.plan(m, n, k, torch.bfloat16)
    GP.validate(p, m, n, k, torch.bfloat16)
    dev, bf16 = a.device, torch.bfloat16
    if bias.dtype not in (torch.float32, bf16):
        raise TypeError(f"bias: dtype {bias.dtype}, the kernel takes float32 or bfloat16")
    for name, t, dtype, shape in (("a", a, bf16, (m, k)), ("w", w, bf16, (n, k)), ("bias", bias, bias.dtype, (n,))):
        require(t, name, dtype, shape, dev)
    out = torch.empty((m, n), dtype=bf16, device=dev)
    ws, cnt, code = GP.launch_args(dev, (m, n, k), dtype=bf16, plans=[p])
    rc = build.library().msa_gemm_bf16(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), int(bias.dtype == bf16), out.data_ptr(), ws, cnt, m, n, k, code,
        int(gelu), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(rc, "gemm_bf16")
    gemm_bf16.launches += 1
    return out


gemm_bf16.launches = 0  # kernel launches since the last reset, rows 8 and 10's two a call included
