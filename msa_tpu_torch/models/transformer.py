"""Shared transformer encoder (port of ``msa_tpu/models/transformer.py``).

One encoder backs the BERT-style text trunk and the wav2vec2-style audio
encoder: post-LN layers with flax's LayerNorm numerics (fast variance
E[x²]−E[x]², eps 1e-12), an additive −1e9 key mask, matmuls in
``compute_dtype`` with f32 LayerNorm/softmax.

``attention_impl``/``ffn_impl`` pick the path, as in JAX: ``"kernel"`` (the
JAX ``"pallas"``) runs the hand-written CUDA kernels of
:mod:`msa_tpu_torch.ops.kernels` — their plain versions on the CPU — and
needs ``d_model`` and ``d_ff`` to be multiples of 128: otherwise it raises
(JAX falls back to its packed-QKV kernel and a dense FFN there, which are
not ported); ``"einsum"``/``"dense"`` is the plain PyTorch path. With
``quantize="int8"`` the kernel paths run the W8A8 kernels.

The encoder matrices are f32 masters, as flax's params are. Each layer
derives what its path consumes (int8 codes and scales, or compute-dtype
copies) in ``derive_weights_``, which :mod:`msa_tpu_torch.weights` runs
after a load or a random draw. Parameter names
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

from msa_tpu_torch.ops.kernels.attention import attention_block, attention_block_int8
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
def _derive(module: nn.Module, linears, int8: bool, dt: torch.dtype, biases: bool = False) -> None:
    """Register what a path consumes from each named f32 master Linear as
    non-persistent buffers: ``w_{name}_q`` int8 codes and ``s_{name}`` f32
    per-output-channel scales (JAX quantizes its f32 params alike on every
    call), else ``w_{name}_c`` (and ``b_{name}_c``) in the compute dtype."""
    for name, lin in linears:
        if int8:
            w_q, s = quantize_weight_axis(lin.weight, axis=1)
            module.register_buffer(f"w_{name}_q", w_q, persistent=False)
            module.register_buffer(f"s_{name}", s[:, 0].contiguous(), persistent=False)
        else:
            module.register_buffer(f"w_{name}_c", lin.weight.detach().to(dt), persistent=False)
            if biases:
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
        """Derive the weights this path consumes from the f32 masters: int8
        on the int8 kernel path, else the compute dtype. Run after the
        masters change."""
        cfg = self.cfg
        int8 = cfg.attention_impl == "kernel" and cfg.quantize == "int8"
        _derive(self, (("qkv", self.qkv), ("out", self.attn_out)), int8, cfg.dtype)

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        b, t, d = x.shape
        if cfg.attention_impl == "kernel":
            if d % 128:
                raise NotImplementedError("kernel attention needs d_model % 128 == 0 (the packed-QKV kernel is not ported)")
            key_mask = (
                torch.ones((b, t), dtype=torch.float32, device=x.device)
                if attention_mask is None
                else (attention_mask > 0).float()
            )
            if cfg.quantize == "int8":
                return attention_block_int8(
                    x.to(dt), self.w_qkv_q, self.s_qkv, self.qkv.bias, self.w_out_q, self.s_out,
                    self.attn_out.bias, key_mask, cfg.num_heads,
                )
            return attention_block(
                x.to(dt), self.w_qkv_c, self.qkv.bias, self.w_out_c, self.attn_out.bias, key_mask, cfg.num_heads
            )
        h, dh = cfg.num_heads, cfg.head_dim
        qkv = F.linear(x.to(dt), self.w_qkv_c, self.qkv.bias.to(dt)).view(b, t, 3, h, dh)
        q, k, v = qkv.unbind(dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (1.0 / float(dh) ** 0.5)
        if attention_mask is not None:
            logits = logits + torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9).float()
        probs = torch.softmax(logits, dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, d)
        return F.linear(out, self.w_out_c, self.attn_out.bias.to(dt))


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
        int8 = cfg.ffn_impl == "kernel" and cfg.quantize == "int8"
        _derive(self, (("in", self.fc_in), ("out", self.fc_out)), int8, cfg.dtype, biases=True)

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        attn = self.attention(x, attention_mask)
        x = self.attn_ln(x + attn).to(dt)
        b, t, d = x.shape
        if cfg.ffn_impl == "kernel":
            if cfg.d_model % 128 or cfg.d_ff % 128:
                raise NotImplementedError("kernel FFN needs d_model % 128 == 0 and d_ff % 128 == 0")
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
