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
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from msa_tpu_torch.ops.kernels import build
from msa_tpu_torch.ops.kernels._common import require

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


def _scale(dh: int) -> float:
    return float(np.float32(1.0 / np.sqrt(dh)))


def attention_block_plain(x, w_qkv, b_qkv, w_out, b_out, key_mask, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same rounding points)."""
    b, t, dm = x.shape
    dt = x.dtype
    dh = dm // num_heads
    x, key_mask, t_pad = _pad_t(x, key_mask)
    qkv = x.float() @ w_qkv.float().t() + b_qkv.float()
    qkv = qkv.to(dt).float().view(b, t_pad, 3, num_heads, dh)
    q, k, v = qkv.unbind(dim=2)  # [b, t, h, dh] each
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    bias = torch.where(key_mask > 0, 0.0, -1e9).float()
    s = s * _scale(dh) + bias[:, None, None, :]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(dt).float(), v)
    attn = (o / denom).to(dt).permute(0, 2, 1, 3).reshape(b, t_pad, dm)
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
    dh = dm // num_heads
    if dh != KERNEL_HEAD_DIM or dh * num_heads != dm or dm % LANE:
        raise ValueError(f"attention_block kernel needs head dim {KERNEL_HEAD_DIM} and dm % 128 == 0, got {dm}/{num_heads}")
    xp, mask_p, t_pad = _pad_t(x, key_mask)
    xp, mask_p = xp.contiguous(), mask_p.contiguous()
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
