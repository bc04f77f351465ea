"""The f32 GEMM under rows 10, 8 and 11 in f32: the GEMM alone and its plain version.

``msa_tpu_torch/csrc/gemm_f32.cuh`` computes ``act(A·Wᵀ + bias)`` for
``A [M, K]`` and ``W [N, K]`` f32 with exact FMA on the CUDA cores (no
TF32), the bias f32 or none, the A&S GELU or none, on the tile and
stream-K grid that :func:`msa_tpu_torch.ops.kernels.gemm_plan.plan_f32`
picks. A tile cut between CTAs is summed in k order by its last CTA to
arrive, so two calls on the same inputs give the same bits whatever CTA
arrives last.

``attention_block`` (row 8 in f32: QKV and Wo) and ``ffn_fused`` (row 10
in f32: fc_in with the GELU, fc_out) launch it from C, twice a call, and
add those launches to ``gemm_f32.launches``; ``conv_stride2_fused`` on f32
(row 11) launches it once through :func:`launch`, its weight ``[K, N]``
and its rows overlapping. :func:`gemm_f32` launches it alone: the smoke
holds it against :func:`gemm_f32_plain` and times it beside
``torch.addmm``, which the port never calls.
"""

from __future__ import annotations

import torch

from msa_tpu_torch.ops.kernels import build
from msa_tpu_torch.ops.kernels import gemm_plan as GP
from msa_tpu_torch.ops.kernels._common import require, scratch, zeroed
from msa_tpu_torch.ops.kernels.gemm_plan import StreamPlan


def gemm_f32_plain(a, w, bias=None, gelu: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the f32 product plus the bias, then the A&S
    GELU (``gelu``) — the product ``ffn_plain`` and
    ``attention_block_plain`` take on f32 operands (TF32 off on the card:
    ``exact_fp32``)."""
    out = a.float() @ w.float().t()
    if bias is not None:
        out = out + bias.float()
    if gelu:
        from msa_tpu_torch.ops.kernels.ffn import gelu_as

        out = gelu_as(out)
    return out


def launch(a: torch.Tensor, w: torch.Tensor, bias, out: torch.Tensor, m: int, n: int, k: int, p: StreamPlan, *,
           lda: int, w_nk: bool = True, batch: int = 1, a_batch: int = 0, c_batch: int = 0, gelu: bool = False) -> None:
    """One launch of the kernel on the caller's checked f32 tensors: out
    [batch][m, n] = act(a [batch][m rows of stride lda] · w + bias), w
    ``[n, k]`` (``w_nk``) or ``[k, n]``; counted in ``gemm_f32.launches``."""
    dev = a.device
    GP.validate(p, m, n, k, torch.float32, batch, w_nk)
    ws = scratch("gemm_f32_ws", dev, p.partial_elems(m, n, batch), torch.float32).data_ptr()
    cnt = zeroed("gemm_f32_counters", dev, p.tiles(m, n, batch)).data_ptr()
    rc = build.library().msa_gemm_f32(
        a.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(), ws, cnt, m, n, k, lda,
        int(w_nk), batch, a_batch, c_batch, p.code, int(gelu), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(rc, "gemm_f32")
    gemm_f32.launches += 1


def gemm_f32(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, p: StreamPlan | None = None,
             gelu: bool = False) -> torch.Tensor:
    """a [M, K] f32, w [N, K] f32, bias [N] f32 or None → [M, N] f32. CPU
    tensors take :func:`gemm_f32_plain`; CUDA tensors launch the kernel on
    ``p`` or :func:`gemm_plan.plan_f32`'s tile and grid (N % 128 == 0, K %
    4 == 0; a plan the kernel is not built for raises)."""
    if a.device.type == "cpu":
        return gemm_f32_plain(a, w, bias, gelu)
    m, k = a.shape
    n = w.shape[0]
    p = p or GP.plan_f32(m, n, k)
    f32, dev = torch.float32, a.device
    for name, t, shape in (("a", a, (m, k)), ("w", w, (n, k))) + ((("bias", bias, (n,)),) if bias is not None else ()):
        require(t, name, f32, shape, dev)
    out = torch.empty((m, n), dtype=f32, device=dev)
    launch(a, w, bias, out, m, n, k, p, lda=k, gelu=gelu)
    return out


gemm_f32.launches = 0  # kernel launches since the last reset, rows 8 and 10's two a call and row 11's one included
