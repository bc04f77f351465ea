"""Shared transformer encoder (port of ``msa_tpu/models/transformer.py``).

One encoder backs the BERT-style text trunk and the wav2vec2-style audio
encoder: post-LN layers with flax's LayerNorm numerics (fast variance
E[x²]−E[x]², eps 1e-12), an additive −1e9 key mask, matmuls in
``compute_dtype`` with f32 LayerNorm/softmax.

``attention_impl``/``ffn_impl`` pick the path, as in JAX: ``"kernel"`` (the
JAX ``"pallas"``) runs the hand-written CUDA kernels of
:mod:`msa_tpu_torch.ops.kernels` — their plain versions on the CPU — and
``"einsum"``/``"dense"`` the plain PyTorch path. The kernel paths dispatch
as JAX's (``msa_tpu/models/transformer.py:86-156``, ``:204-239``):

- attention: ``attention_block`` (``attention_block_int8`` under
  ``quantize="int8"``) where ``d_model % 128 == 0`` and T ≤ 512; otherwise
  a dense QKV projection in the compute dtype (never int8, as JAX's
  ``nn.Dense`` ignores ``quantize``), the packed-QKV attention kernel at
  T ≤ 512 or the flash kernel beyond, and a dense output projection;
- FFN: ``ffn_fused`` (``ffn_fused_int8``) where ``d_model`` and ``d_ff``
  are multiples of 128, at any T; otherwise dense → exact GELU → dense in
  the compute dtype.

The encoder matrices are f32 masters, as flax's params are. Each layer
derives what its paths consume (int8 codes and scales, compute-dtype
copies) in ``derive_weights_``, which :mod:`msa_tpu_torch.weights` and
:mod:`msa_tpu_torch.flax_init` run after a load or an init. Parameter names
follow the flax tree (``qkv``, ``attn_out``, ``fc_in``, ``fc_out``,
``attn_ln``, ``ffn_ln``, ``layer_{i}``) so :mod:`msa_tpu_torch.weights`
maps them one to one. Inference only: there is no dropout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from msa_tpu_torch.ops.kernels.attention import (
    SINGLE_PASS_MAX_T,
    attention_block,
    attention_block_int8,
    flash_attention,
    packed_qkv_attention,
)
from msa_tpu_torch.ops.kernels.ffn import ffn_fused, ffn_fused_int8
from msa_tpu_torch.ops.quant import quantize_weight_axis

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    d_ff: int = 3072
    layer_norm_eps: float = 1e-12  # BERT default
    compute_dtype: str = "float32"
    attention_impl: str = "einsum"  # "einsum" | "kernel"
    ffn_impl: str = "dense"  # "dense" | "kernel"
    # "none" | "int8": W8A8 projections and FFN on the kernel paths (the
    # plain paths ignore it, as in JAX); attention's own dots stay bf16
    quantize: str = "none"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def block_kernel(self) -> bool:
        """Whether the kernel attention path can take ``attention_block``
        (at T ≤ 512)."""
        return self.attention_impl == "kernel" and self.d_model % 128 == 0

    @property
    def ffn_kernel(self) -> bool:
        """Whether the FFN runs ``ffn_fused[_int8]``."""
        return self.ffn_impl == "kernel" and self.d_model % 128 == 0 and self.d_ff % 128 == 0

    @classmethod
    def tiny(cls) -> "EncoderConfig":
        """Small config for tests (``msa_tpu/models/transformer.py:67-70``)."""
        return cls(num_layers=2, d_model=32, num_heads=2, d_ff=64)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` numerics over the last axis, computed in f32:
    ``fast=True`` is flax's default E[x²]−E[x]² variance (clipped at 0),
    ``fast=False`` the two-pass variance. Output is f32."""

    def __init__(self, dim: int, eps: float, fast: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps, self.fast = eps, fast

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        if self.fast:
            var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        else:
            var = (xf - mean).square().mean(dim=-1, keepdim=True)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean) * mul + self.bias


@torch.no_grad()
def _derive(module: nn.Module, linears, int8: bool, dense: bool, dt: torch.dtype) -> None:
    """Register what the paths consume from each named f32 master Linear as
    non-persistent buffers: with ``int8``, ``w_{name}_q`` int8 codes and
    ``s_{name}`` f32 per-output-channel scales (JAX quantizes its f32 params
    alike on every call); with ``dense``, ``w_{name}_c`` and ``b_{name}_c``
    in the compute dtype."""
    for name, lin in linears:
        if int8:
            w_q, s = quantize_weight_axis(lin.weight, axis=1)
            module.register_buffer(f"w_{name}_q", w_q, persistent=False)
            module.register_buffer(f"s_{name}", s[:, 0].contiguous(), persistent=False)
        if dense:
            module.register_buffer(f"w_{name}_c", lin.weight.detach().to(dt), persistent=False)
            module.register_buffer(f"b_{name}_c", lin.bias.detach().to(dt), persistent=False)


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        # f32 masters (flax's param dtype); what a path consumes is derived
        # from them by derive_weights_()
        self.qkv = nn.Linear(d, 3 * d)
        self.attn_out = nn.Linear(d, d)
        self.derive_weights_()

    def derive_weights_(self) -> None:
        """Derive the weights the paths consume from the f32 masters: int8
        for ``attention_block_int8``, and compute-dtype copies for every
        other path (the dense projections around rows 5 and 6 included,
        which even the int8 recipe takes at T > 512). Run after the masters
        change."""
        cfg = self.cfg
        int8 = cfg.block_kernel and cfg.quantize == "int8"
        _derive(self, (("qkv", self.qkv), ("out", self.attn_out)), int8, True, cfg.dtype)

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        b, t, d = x.shape
        h, dh = cfg.num_heads, cfg.head_dim
        if cfg.attention_impl == "kernel":
            key_mask = (
                torch.ones((b, t), dtype=torch.float32, device=x.device)
                if attention_mask is None
                else (attention_mask > 0).float()
            )
            if cfg.block_kernel and t <= SINGLE_PASS_MAX_T:
                if cfg.quantize == "int8":
                    return attention_block_int8(
                        x.to(dt), self.w_qkv_q, self.s_qkv, self.qkv.bias, self.w_out_q, self.s_out,
                        self.attn_out.bias, key_mask, h,
                    )
                return attention_block(x.to(dt), self.w_qkv_c, self.qkv.bias, self.w_out_c, self.attn_out.bias, key_mask, h)
            qkv = F.linear(x.to(dt), self.w_qkv_c, self.b_qkv_c).view(b, t, 3, h, dh)
            attend = packed_qkv_attention if t <= SINGLE_PASS_MAX_T else flash_attention
            out, _ = attend(qkv, key_mask)
            return F.linear(out, self.w_out_c, self.b_out_c)
        qkv = F.linear(x.to(dt), self.w_qkv_c, self.b_qkv_c).view(b, t, 3, h, dh)
        q, k, v = qkv.unbind(dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (1.0 / float(dh) ** 0.5)
        if attention_mask is not None:
            logits = logits + torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9).float()
        probs = torch.softmax(logits, dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, d)
        return F.linear(out, self.w_out_c, self.b_out_c)


class EncoderLayer(nn.Module):
    """Post-LN transformer layer (BERT convention)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = SelfAttention(cfg)
        self.attn_ln = LayerNorm(cfg.d_model, cfg.layer_norm_eps, fast=True)
        self.fc_in = nn.Linear(cfg.d_model, cfg.d_ff)  # f32 masters, as in SelfAttention
        self.fc_out = nn.Linear(cfg.d_ff, cfg.d_model)
        self.ffn_ln = LayerNorm(cfg.d_model, cfg.layer_norm_eps, fast=True)
        self.derive_weights_()

    def derive_weights_(self) -> None:
        """The FFN's counterpart of :meth:`SelfAttention.derive_weights_`.
        The int8 kernel adds the f32 biases; every other path adds them in
        the compute dtype, as JAX does."""
        cfg = self.cfg
        int8 = cfg.ffn_kernel and cfg.quantize == "int8"
        _derive(self, (("in", self.fc_in), ("out", self.fc_out)), int8, not int8, cfg.dtype)

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        attn = self.attention(x, attention_mask)
        x = self.attn_ln(x + attn).to(dt)
        b, t, d = x.shape
        if cfg.ffn_kernel:
            if cfg.quantize == "int8":
                h = ffn_fused_int8(
                    x.reshape(b * t, d), self.w_in_q, self.s_in, self.fc_in.bias, self.w_out_q, self.s_out,
                    self.fc_out.bias,
                )
            else:
                h = ffn_fused(x.reshape(b * t, d), self.w_in_c, self.b_in_c, self.w_out_c, self.b_out_c)
            h = h.reshape(b, t, d)
        else:
            h = F.gelu(F.linear(x, self.w_in_c, self.b_in_c))
            h = F.linear(h, self.w_out_c, self.b_out_c)
        return self.ffn_ln(x + h).to(dt)


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg))

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [b, t, d_model]; attention_mask [b, t], 1 = attend."""
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, attention_mask)
        return x


def mean_pool(x: torch.Tensor, attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Masked mean over time: [b, t, d] → [b, d]."""
    if attention_mask is None:
        return x.mean(dim=1)
    m = attention_mask[..., None].to(x.dtype)
    return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


class AttentiveStatsPool(nn.Module):
    """Attentive statistics pooling, [b, t, d] → [b, 2d] (mean ‖ std under a
    learned softmax over time). The score MLP runs in f32; the weighted
    statistics in the input dtype, as in JAX."""

    def __init__(self, d: int, hidden: int = 128):
        super().__init__()
        self.attn_hidden = nn.Linear(d, hidden)
        self.attn_score = nn.Linear(hidden, 1)

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        scores = self.attn_score(torch.tanh(self.attn_hidden(x.float())))  # [b, t, 1]
        if attention_mask is not None:
            scores = torch.where(attention_mask[..., None] > 0, scores, -1e9)
        w = torch.softmax(scores.float(), dim=1).to(x.dtype)
        mean = (w * x).sum(dim=1)
        var = (w * (x - mean[:, None, :]).square()).sum(dim=1)
        std = torch.sqrt(torch.clamp(var, min=1e-6))
        return torch.cat([mean, std], dim=-1)
