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

Two attention-only kernels serve the shapes ``attention_block`` does not
take (the encoder then projects QKV and the output in plain PyTorch, as
JAX does in XLA). Both read ``qkv [B, T, 3, H, D]``, the free view of the
fused projection, and return ``(o [B, T, H·D], lse [B, H, T])``:

- :func:`packed_qkv_attention` (``d_model % 128 ≠ 0`` at T ≤ 512) replaces
  ``_packed_qkv_attention_lse`` (``pl.pallas_call`` at :489, kernel
  :425-462); CUDA in ``csrc/attention_packed.cu``. Exact row max over all
  keys, P normalised *before* P·V: ``(p/denom)`` is rounded to qkv's dtype.
- :func:`flash_attention` (T > 512) replaces ``_flash_attention_lse``
  (``pl.pallas_call`` at :948, kernel :880-926), which JAX's encoder reaches
  through ``attention_with_vjp``; CUDA in ``csrc/attention_flash.cu``.
  Online softmax over 128-key blocks: the *unnormalised* p is rounded for
  P·V, ``acc = acc·α + pv``, and ``o = acc / max(l, 1e-30)`` at the end.

Both pad T to a multiple of 128 with zero rows under masked keys, so a row
with no valid key averages V over all padded rows, as on the TPU; the lse
is ``max + log(denom)`` in f32.
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


# --- attention on the packed QKV projection (rows 5 and 6) ---------------------

FLASH_BLOCK_K = 128  # the TPU kernel's key block: the online softmax rescales per block


def _pad_packed(qkv: torch.Tensor, key_mask: torch.Tensor):
    """Pad T of qkv [B, T, 3, H, D] and key_mask [B, T] to a multiple of 128
    with zero rows under masked keys. → (qkv, key_mask, T_pad)."""
    t = qkv.shape[1]
    t_pad = -(-t // LANE) * LANE
    if t_pad != t:
        qkv = F.pad(qkv, (0, 0, 0, 0, 0, 0, 0, t_pad - t))
        key_mask = F.pad(key_mask, (0, t_pad - t))
    return qkv, key_mask, t_pad


def _mask_bias(key_mask: torch.Tensor) -> torch.Tensor:
    return torch.where(key_mask > 0, 0.0, -1e9).float()


def packed_qkv_attention_plain(qkv: torch.Tensor, key_mask: torch.Tensor):
    """Plain PyTorch version of the row-5 kernel (same rounding points)."""
    b, t, _, h, d = qkv.shape
    dt = qkv.dtype
    qkv, key_mask, t_pad = _pad_packed(qkv, key_mask)
    q, k, v = qkv.float().unbind(dim=2)  # [b, t_pad, h, d]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * _scale(d) + _mask_bias(key_mask)[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", (p / denom).to(dt).float(), v).to(dt)
    lse = (m + torch.log(denom))[..., 0]
    return o.reshape(b, t_pad, h * d)[:, :t], lse[:, :, :t]


def flash_attention_plain(qkv: torch.Tensor, key_mask: torch.Tensor):
    """Plain PyTorch version of the row-6 kernel: the same online softmax
    over the same 128-key blocks, in the same order of operations."""
    b, t, _, h, d = qkv.shape
    dt = qkv.dtype
    qkv, key_mask, t_pad = _pad_packed(qkv, key_mask)
    q, k, v = qkv.float().permute(2, 0, 3, 1, 4).unbind(0)  # [b, h, t_pad, d]
    bias = _mask_bias(key_mask)
    m = torch.full((b, h, t_pad, 1), -1e30, device=qkv.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, t_pad, d), device=qkv.device)
    for k0 in range(0, t_pad, FLASH_BLOCK_K):
        kb = slice(k0, k0 + FLASH_BLOCK_K)
        s = q @ k[:, :, kb].transpose(-1, -2) * _scale(d) + bias[:, None, None, kb]
        m_cur = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(dt).float() @ v[:, :, kb]
        m = m_cur
    l = torch.clamp_min(l, 1e-30)
    o = (acc / l).to(dt).permute(0, 2, 1, 3).reshape(b, t_pad, h * d)
    return o[:, :t], (m + torch.log(l))[..., 0][:, :, :t]


def _launch_packed(entry: str, what: str, qkv: torch.Tensor, key_mask: torch.Tensor):
    """Check the inputs of a packed-QKV kernel and launch it on the card."""
    b, t, three, h, d = qkv.shape
    if three != 3 or d % 8 or not 8 <= d <= 128:
        raise ValueError(f"{what} kernel needs qkv [B, T, 3, H, D] with D % 8 == 0 and D ≤ 128, got {tuple(qkv.shape)}")
    dev = qkv.device
    require(qkv, "qkv", torch.bfloat16, (b, t, 3, h, d), dev)
    require(key_mask, "key_mask", torch.float32, (b, t), dev)
    o = torch.empty((b, t, h * d), dtype=torch.bfloat16, device=dev)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(build.library(), entry)(
        qkv.data_ptr(), key_mask.data_ptr(), o.data_ptr(), lse.data_ptr(), b, t, h, d, _scale(d), stream
    )
    build.check(rc, what)
    return o, lse


def packed_qkv_attention(qkv: torch.Tensor, key_mask: torch.Tensor):
    """qkv [B, T ≤ 512, 3, H, D], key_mask [B, T] f32 (1 = attend) →
    (o [B, T, H·D] in qkv's dtype, lse [B, H, T] f32). CPU tensors take
    :func:`packed_qkv_attention_plain`; CUDA tensors launch the kernel
    (bf16, D % 8 == 0, D ≤ 128)."""
    if qkv.device.type == "cpu":
        return packed_qkv_attention_plain(qkv, key_mask)
    if qkv.shape[1] > SINGLE_PASS_MAX_T:
        raise ValueError(f"packed_qkv_attention covers T ≤ {SINGLE_PASS_MAX_T}, got {qkv.shape[1]}")
    out = _launch_packed("msa_packed_qkv_attention", "packed_qkv_attention", qkv, key_mask)
    packed_qkv_attention.launches += 1
    return out


packed_qkv_attention.launches = 0  # kernel launches since the last reset (the smoke reads it)


def flash_attention(qkv: torch.Tensor, key_mask: torch.Tensor):
    """Blockwise attention for any T: qkv [B, T, 3, H, D], key_mask [B, T]
    → (o [B, T, H·D], lse [B, H, T]). CPU tensors take
    :func:`flash_attention_plain`; CUDA tensors launch the kernel (bf16,
    D % 8 == 0, D ≤ 128)."""
    if qkv.device.type == "cpu":
        return flash_attention_plain(qkv, key_mask)
    out = _launch_packed("msa_flash_attention", "flash_attention", qkv, key_mask)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches since the last reset (the smoke reads it)
