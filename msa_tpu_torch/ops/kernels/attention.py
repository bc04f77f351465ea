"""Fused attention block: fused QKV projection → masked per-head softmax
attention → output projection, for one encoder layer.

Replaces the TPU kernel ``msa_tpu/ops/pallas/attention.py:attention_block``
in its bf16/f32 form (``pl.pallas_call`` at :819, body
``_attn_block_body`` :574-695). The CUDA kernel is
``msa_tpu_torch/csrc/attention.cu`` (with the GEMM of ``csrc/gemm.cuh``);
its note says what bounds it on the card and what the design does about it.

Layouts: ``x [B, T, dm]`` in the compute dtype; ``w_qkv [3·dm, dm]`` and
``w_out [dm, dm]`` in PyTorch's Linear layout and the compute dtype;
``b_qkv``/``b_out`` float32; ``key_mask [B, T]`` float32, 1 = attend. T is
padded to a multiple of 128 inside, as the TPU wrapper does, and must be
≤ 512 after padding (longer inputs took the TPU's flash kernel, which is
not ported yet).

Rounding points, shared by the kernel and :func:`attention_block_plain`:
q, k and v are projected in f32 (+ f32 bias) and rounded to the compute
dtype; the score dot accumulates in f32; masked keys add −1e9 (not −inf: a
row with no valid key stays finite); P = exp(s − rowmax) is summed in f32
and rounded for P·V; o/denom is rounded before the f32-accumulated output
projection; the result is rounded once.

:func:`attention_block_int8` is the W8A8 variant, replacing
``attention_block(int8=True)`` (``pl.pallas_call`` at :779, wrapper
:760-815). Its weights come quantized per output channel
(:mod:`msa_tpu_torch.ops.quant`, from the f32 masters): ``w_qkv_q
[3·dm, dm]`` int8 with ``s_qkv [3·dm]`` f32 scales, ``w_out_q [dm, dm]``
int8 with ``s_out [dm]``. x and the attention output are quantized per row;
the projections dequantize in f32 in the TPU kernel's order of products,
``acc·xs·s + b`` for q and v and ``acc·s·xs + b`` for k (``:605-657``),
``acc·as·so + bo`` for the output; the attention core is the bf16 one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from msa_tpu_torch.ops import quant as Q
from msa_tpu_torch.ops.kernels import build
from msa_tpu_torch.ops.kernels._common import require
from msa_tpu_torch.ops.kernels.quant import quantize_rows

LANE = 128
SINGLE_PASS_MAX_T = 512
KERNEL_HEAD_DIM = 64


def _pad_t(x: torch.Tensor, key_mask: torch.Tensor):
    t = x.shape[1]
    t_pad = -(-t // LANE) * LANE
    if t_pad > SINGLE_PASS_MAX_T:
        raise NotImplementedError(
            f"attention_block covers T ≤ {SINGLE_PASS_MAX_T}; longer inputs need the flash kernel"
        )
    if t_pad != t:
        x = F.pad(x, (0, 0, 0, t_pad - t))
        key_mask = F.pad(key_mask, (0, t_pad - t))
    return x, key_mask, t_pad


def _kernel_inputs(x: torch.Tensor, key_mask: torch.Tensor, num_heads: int, what: str):
    """Check the head layout the kernels take and pad T: → (x, key_mask,
    T_pad, head dim), contiguous."""
    dm = x.shape[-1]
    dh = dm // num_heads
    if dh != KERNEL_HEAD_DIM or dh * num_heads != dm or dm % LANE:
        raise ValueError(f"{what} kernel needs head dim {KERNEL_HEAD_DIM} and dm % 128 == 0, got {dm}/{num_heads}")
    xp, mask_p, t_pad = _pad_t(x, key_mask)
    return xp.contiguous(), mask_p.contiguous(), t_pad, dh


def _scale(dh: int) -> float:
    return float(np.float32(1.0 / np.sqrt(dh)))


def _attend(qkv: torch.Tensor, key_mask: torch.Tensor, num_heads: int, dt: torch.dtype) -> torch.Tensor:
    """The attention core of both variants: qkv [b, t, 3·dm] (f32 values
    already rounded to ``dt``) → o/denom rounded to ``dt``, [b, t, dm]."""
    b, t, dm3 = qkv.shape
    dm = dm3 // 3
    dh = dm // num_heads
    q, k, v = qkv.view(b, t, 3, num_heads, dh).unbind(dim=2)  # [b, t, h, dh] each
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    bias = torch.where(key_mask > 0, 0.0, -1e9).float()
    s = s * _scale(dh) + bias[:, None, None, :]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(dt).float(), v)
    return (o / denom).to(dt).permute(0, 2, 1, 3).reshape(b, t, dm)


def attention_block_plain(x, w_qkv, b_qkv, w_out, b_out, key_mask, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same rounding points)."""
    t = x.shape[1]
    dt = x.dtype
    x, key_mask, _ = _pad_t(x, key_mask)
    qkv = x.float() @ w_qkv.float().t() + b_qkv.float()
    attn = _attend(qkv.to(dt).float(), key_mask, num_heads, dt)
    out = attn.float() @ w_out.float().t() + b_out.float()
    return out.to(dt)[:, :t]


def attention_block(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    w_out: torch.Tensor,
    b_out: torch.Tensor,
    key_mask: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """[B, T, dm] → [B, T, dm] (pre-residual). CPU tensors take
    :func:`attention_block_plain`; CUDA tensors launch the kernel (bf16,
    head dim 64)."""
    if x.device.type == "cpu":
        return attention_block_plain(x, w_qkv, b_qkv, w_out, b_out, key_mask, num_heads)
    b, t, dm = x.shape
    xp, mask_p, t_pad, dh = _kernel_inputs(x, key_mask, num_heads, "attention_block")
    dev, bf16 = x.device, torch.bfloat16
    for name, tens, dtype, shape in (
        ("x", xp, bf16, (b, t_pad, dm)),
        ("w_qkv", w_qkv, bf16, (3 * dm, dm)),
        ("b_qkv", b_qkv, torch.float32, (3 * dm,)),
        ("w_out", w_out, bf16, (dm, dm)),
        ("b_out", b_out, torch.float32, (dm,)),
        ("key_mask", mask_p, torch.float32, (b, t_pad)),
    ):
        require(tens, name, dtype, shape, dev)
    qkv = torch.empty((b * t_pad, 3 * dm), dtype=bf16, device=dev)
    attn = torch.empty((b * t_pad, dm), dtype=bf16, device=dev)
    out = torch.empty((b, t_pad, dm), dtype=bf16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = build.library().msa_attention_block(
        xp.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
        mask_p.data_ptr(), qkv.data_ptr(), attn.data_ptr(), out.data_ptr(),
        b, t_pad, dm, num_heads, _scale(dh), stream,
    )
    build.check(rc, "attention_block")
    attention_block.launches += 1
    return out[:, :t]


attention_block.launches = 0  # kernel launches since the last reset (the smoke reads it)


def attention_block_int8_plain(x, w_qkv_q, s_qkv, b_qkv, w_out_q, s_out, b_out, key_mask, num_heads: int):
    """Plain PyTorch version of the int8 kernel (same rounding points; the
    int32 sums are exact, see :func:`msa_tpu_torch.ops.quant.int8_matmul`)."""
    b, t, dm = x.shape
    dt = x.dtype
    x, key_mask, t_pad = _pad_t(x, key_mask)
    xq, xs = Q.quantize_rows(x.reshape(b * t_pad, dm))
    acc = Q.int8_matmul(xq, w_qkv_q)  # [M, 3·dm]
    s = s_qkv.float()
    bias = b_qkv.float()
    q = acc[:, :dm] * xs * s[:dm] + bias[:dm]
    k = acc[:, dm : 2 * dm] * s[dm : 2 * dm] * xs + bias[dm : 2 * dm]
    v = acc[:, 2 * dm :] * xs * s[2 * dm :] + bias[2 * dm :]
    qkv = torch.cat([q, k, v], dim=-1).to(dt).float().view(b, t_pad, 3 * dm)
    attn = _attend(qkv, key_mask, num_heads, dt).reshape(b * t_pad, dm)
    aq, as_ = Q.quantize_rows(attn)
    out = Q.int8_matmul(aq, w_out_q) * as_ * s_out.float() + b_out.float()
    return out.to(dt).view(b, t_pad, dm)[:, :t]


def attention_block_int8(
    x: torch.Tensor,
    w_qkv_q: torch.Tensor,
    s_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    w_out_q: torch.Tensor,
    s_out: torch.Tensor,
    b_out: torch.Tensor,
    key_mask: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """[B, T, dm] → [B, T, dm] (pre-residual), W8A8. CPU tensors take
    :func:`attention_block_int8_plain`; CUDA tensors launch the kernel
    (bf16 x, head dim 64)."""
    if x.device.type == "cpu":
        return attention_block_int8_plain(x, w_qkv_q, s_qkv, b_qkv, w_out_q, s_out, b_out, key_mask, num_heads)
    b, t, dm = x.shape
    xp, mask_p, t_pad, dh = _kernel_inputs(x, key_mask, num_heads, "attention_block_int8")
    dev, bf16, f32, i8 = x.device, torch.bfloat16, torch.float32, torch.int8
    for name, tens, dtype, shape in (
        ("x", xp, bf16, (b, t_pad, dm)),
        ("w_qkv_q", w_qkv_q, i8, (3 * dm, dm)),
        ("s_qkv", s_qkv, f32, (3 * dm,)),
        ("b_qkv", b_qkv, f32, (3 * dm,)),
        ("w_out_q", w_out_q, i8, (dm, dm)),
        ("s_out", s_out, f32, (dm,)),
        ("b_out", b_out, f32, (dm,)),
        ("key_mask", mask_p, f32, (b, t_pad)),
    ):
        require(tens, name, dtype, shape, dev)
    m = b * t_pad
    xq, aq = (torch.empty((m, dm), dtype=i8, device=dev) for _ in range(2))
    xs, as_ = (torch.empty((m,), dtype=f32, device=dev) for _ in range(2))
    qkv = torch.empty((m, 3 * dm), dtype=bf16, device=dev)
    attn = torch.empty((m, dm), dtype=bf16, device=dev)
    out = torch.empty((b, t_pad, dm), dtype=bf16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = build.library().msa_attention_block_int8(
        xp.data_ptr(), w_qkv_q.data_ptr(), s_qkv.data_ptr(), b_qkv.data_ptr(), w_out_q.data_ptr(),
        s_out.data_ptr(), b_out.data_ptr(), mask_p.data_ptr(), xq.data_ptr(), xs.data_ptr(), qkv.data_ptr(),
        attn.data_ptr(), aq.data_ptr(), as_.data_ptr(), out.data_ptr(), b, t_pad, dm, num_heads, _scale(dh), stream,
    )
    build.check(rc, "attention_block_int8")
    attention_block_int8.launches += 1
    quantize_rows.launches += 2  # x and the attention output, launched from C
    return out[:, :t]


attention_block_int8.launches = 0  # kernel launches since the last reset (the smoke reads it)
