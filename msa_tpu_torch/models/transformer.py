"""Shared transformer encoder (port of ``msa_tpu/models/transformer.py``).

One encoder backs the BERT-style text trunk and the wav2vec2-style audio
encoder: post-LN layers with flax's LayerNorm numerics (fast variance
E[x²]−E[x]², eps 1e-12), an additive −1e9 key mask, matmuls in
``compute_dtype`` with f32 LayerNorm/softmax.

``attention_impl``/``ffn_impl`` pick the path, as in JAX: ``"kernel"`` (the
JAX ``"pallas"``) runs the hand-written CUDA kernels of
:mod:`msa_tpu_torch.ops.kernels` — their plain versions on the CPU — and
``"einsum"``/``"dense"`` the plain PyTorch path. In serving (the default,
``deterministic=True``) the kernel paths dispatch as JAX's
(``msa_tpu/models/transformer.py:86-156``, ``:204-239``):

- attention: ``attention_block`` (``attention_block_int8`` under
  ``quantize="int8"``) where ``d_model % 128 == 0`` and T ≤ 512, at any
  head dim, with no cap (weights padded once, in ``derive_weights_``, to
  the kernel's head dim: 32, 64, 128, or above 128 a multiple of 128, as
  JAX pads D); otherwise a dense QKV projection in the compute
  dtype (never int8, as JAX's ``nn.Dense`` ignores ``quantize``), the
  packed-QKV attention kernel at T ≤ 512 or the flash kernel beyond, and a
  dense output projection;
- FFN: ``ffn_fused`` (``ffn_fused_int8``) where ``d_model`` and ``d_ff``
  are multiples of 128, at any T; otherwise dense → exact GELU → dense in
  the compute dtype.

``compute_dtype="float32"`` with the kernel paths is JAX's f32 parity mode
(imported trunks): the same dispatch through the kernels' f32 variants,
with no bf16 cast anywhere; the compute-dtype weights are then the f32
masters themselves.

The encoder matrices are f32 masters, as flax's params are. Each layer
derives what its serving paths consume (int8 codes and scales,
compute-dtype copies) in ``derive_weights_``, which
:mod:`msa_tpu_torch.weights` and :mod:`msa_tpu_torch.flax_init` run after a
load or an init; after an optimizer step, run
:func:`msa_tpu_torch.weights.derive_weights_` again before serving.
Parameter names follow the flax tree (``qkv``, ``attn_out``, ``fc_in``,
``fc_out``, ``attn_ln``, ``ffn_ln``, ``layer_{i}``) so
:mod:`msa_tpu_torch.weights` maps them one to one.

Training (``forward(..., deterministic=False)``) takes JAX's training
dispatch with ``dropout=0.0``: every matmul casts the f32 masters inside
the graph (as flax's ``nn.Dense(dtype=…)`` casts its params), so gradients
land on the masters; the kernel attention path runs a dense QKV projection
→ :func:`packed_qkv_attention` (its forward is the packed-QKV
kernel at T ≤ 512 and the flash kernel beyond, as JAX's
``attention_with_vjp`` there) → a dense Wo at every ``d_model``, never
``attention_block``; the FFN is dense and ``quantize`` is ignored
(``msa_tpu/models/transformer.py:86-90``, ``:130-156``, ``:204-208``).
In f32 (``compute_dtype="float32"``, the parity mode's imported trunks
fine-tuned) the same path trains on the card with no bf16 anywhere: the
f32 masters go straight into the dense projections (the cast is the
identity), rows 5/6 run their f32 forward and rows 3 and 4 their f32
backward (``csrc/attention_bwd_f32.cu``), and the dense FFN takes cuBLAS's
f32 GEMMs, with TF32 off under :func:`msa_tpu_torch.precision.exact_fp32`.
Head dims above 128 train as well (in bf16 on the tensor-core backward of
``csrc/attention_bwd_wide.cu``, in f32 in the one pass of
``csrc/attention_bwd_f32.cu``).
``remat=True`` recomputes each layer in the backward pass, as ``nn.remat``.

Dropout (``deterministic=False`` with ``dropout > 0``) is flax's
``nn.Dropout``, bit for bit, at JAX's three sites in a layer (the
attention probabilities, the attention output, the FFN output; the text
embeddings add a fourth): the keys come from :class:`DropoutRng`, which
rebuilds ``make_rng("dropout")`` from the seed of JAX's
``rngs={"dropout": PRNGKey(seed)}`` and the flax module path, and each
mask is drawn on the tensor's device (:func:`dropout_mask`). As in JAX,
dropout sends the attention to the einsum path, so no attention kernel
runs; with ``dropout=0.0`` training keeps the kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from msa_tpu_torch import flax_init
from msa_tpu_torch.ops.kernels.attention import (
    SINGLE_PASS_MAX_T,
    attention_block,
    attention_block_int8,
    flash_attention_lse,
    pad_block_weights,
    packed_qkv_attention,
    packed_qkv_attention_lse,
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
    # read only in training (deterministic=False), as flax's nn.Dropout
    dropout: float = 0.1
    layer_norm_eps: float = 1e-12  # BERT default
    compute_dtype: str = "float32"
    attention_impl: str = "einsum"  # "einsum" | "kernel"
    ffn_impl: str = "dense"  # "dense" | "kernel"
    # "none" | "int8": W8A8 projections and FFN on the kernel paths (the
    # plain paths and training ignore it, as in JAX); attention's own dots
    # stay bf16
    quantize: str = "none"
    # recompute each layer in the backward pass (nn.remat in JAX)
    remat: bool = False

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


_MASK_CHUNK = 1 << 24  # mask elements per pass of the threefry stream


def keep_mask(key: Tuple[int, int], start: int, count: int, rate: float, device) -> torch.Tensor:
    """Flat elements ``start … start+count-1`` of
    ``jax.random.bernoulli(key, 1 − rate, shape)`` on ``device``: element i
    keeps where ``uniform < keep`` in f32, the uniform from the 23 high
    bits of ``threefry2x32(key, (0, i))`` (x0 ^ x1, JAX's partitionable
    stream) as JAX forms it."""
    bits = flax_init.random_bits(key, start, count, device)
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return u < torch.tensor(np.float32(1.0 - rate), device=device)


def dropout_mask(key: Tuple[int, int], shape, rate: float, device) -> torch.Tensor:
    """The whole mask of ``shape`` (row-major), drawn on ``device``."""
    n = int(np.prod(shape))
    mask = torch.empty(n, dtype=torch.bool, device=device)
    for start in range(0, n, _MASK_CHUNK):
        count = min(_MASK_CHUNK, n - start)
        mask[start : start + count] = keep_mask(key, start, count, rate, device)
    return mask.view(shape)


@dataclasses.dataclass(frozen=True)
class DropoutRng:
    """flax's ``make_rng("dropout")`` for the modules under ``path``: the
    root key (``PRNGKey(seed)`` of JAX's ``rngs={"dropout": …}``) folded
    with the module path and the scope's count of ``make_rng`` calls, as
    flax's ``LazyRng`` does. Paths are the flax tree's; each
    ``nn.Dropout`` is auto-named ``Dropout_0``, ``Dropout_1``, … in the
    order its parent creates them, and draws once (count 1)."""

    key: Tuple[int, int]
    path: Tuple[str, ...] = ()

    @classmethod
    def of(cls, rng: "Union[int, Tuple[int, int], DropoutRng, None]") -> "Optional[DropoutRng]":
        """A seed → the root of its stream (``PRNGKey(seed)``); a key pair
        (e.g. one of :func:`msa_tpu_torch.flax_init.split`) → the root it
        is; a DropoutRng or None as given."""
        if isinstance(rng, int):
            return cls(flax_init.prng_key(rng))
        if isinstance(rng, tuple):
            return cls(rng)
        return rng

    def child(self, name: str) -> "DropoutRng":
        return DropoutRng(self.key, self.path + (name,))

    def dropout_key(self, index: Union[int, str], count: int = 1) -> Tuple[int, int]:
        """The key of the ``count``-th draw of this scope's ``Dropout_{index}``,
        or of the dropout module named ``index`` where it is a string (one
        that ``setup`` names, as the fusion MLP's ``drop``: flax counts the
        ``make_rng`` calls of that one scope, so its n-th call draws with
        count n)."""
        name = index if isinstance(index, str) else f"Dropout_{index}"
        return flax_init.fold_in_names(self.key, *self.path, name, count)


def dropout(
    x: torch.Tensor, rate: float, deterministic: bool, rng: Optional[DropoutRng], index: Union[int, str], count: int = 1,
) -> torch.Tensor:
    """flax's ``nn.Dropout(rate)`` named ``Dropout_{index}`` (or ``index``)
    under ``rng``'s scope, at its ``count``-th call
    (:meth:`DropoutRng.dropout_key`): the identity when ``deterministic``
    or ``rate == 0``; else
    ``x / keep`` (keep = 1 − rate in x's dtype) where the mask keeps and 0
    elsewhere, as ``lax.select`` does."""
    if deterministic or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if rng is None:
        raise ValueError(
            f"dropout={rate} in training needs a dropout key: pass dropout_rng (a seed, as JAX's "
            "rngs={'dropout': PRNGKey(seed)}) or set dropout=0.0"
        )
    mask = dropout_mask(rng.dropout_key(index, count), tuple(x.shape), rate, x.device)
    return torch.where(mask, x / torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device), 0.0)


def _dense(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    """flax's ``nn.Dense(dtype=dt)`` on the f32 master ``lin``: the input,
    kernel and bias cast to ``dt`` inside the graph, the product rounded to
    ``dt`` before the bias is added, as flax adds it."""
    return F.linear(x.to(dt), lin.weight.to(dt)) + lin.bias.to(dt)


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
        which even the int8 recipe takes at T > 512). The attention-block
        kernels' weights are padded to their head dim (``pad_block_weights``:
        ``w_qkv_blk``, ``b_qkv_blk``, ``w_out_blk``, or the int8 codes after
        quantization), once, here. Run after the masters change, an
        optimizer step included: serving reads these copies, training the
        masters."""
        cfg = self.cfg
        int8 = cfg.block_kernel and cfg.quantize == "int8"
        _derive(self, (("qkv", self.qkv), ("out", self.attn_out)), int8, True, cfg.dtype)
        if cfg.block_kernel:
            self._derive_block(int8)

    @torch.no_grad()
    def _derive_block(self, int8: bool) -> None:
        h, bias = self.cfg.num_heads, self.qkv.bias.detach()
        if int8:  # int8 codes and scales padded after quantization (scale 1.0 on padded channels)
            blk = pad_block_weights(self.w_qkv_q, bias, self.w_out_q, h, self.s_qkv)
        else:
            blk = pad_block_weights(self.w_qkv_c, bias, self.w_out_c, h)
        names = ("w_qkv_q", "b_qkv_blk", "w_out_q", "s_qkv") if int8 else ("w_qkv_blk", "b_qkv_blk", "w_out_blk", None)
        for name, tensor in zip(names, blk):
            if name is not None:
                self.register_buffer(name, tensor.contiguous(), persistent=False)

    def _project(self, y: torch.Tensor, name: str, deterministic: bool) -> torch.Tensor:
        """The QKV (``name="qkv"``) or output (``"out"``) projection: serving
        reads the derived compute-dtype copy, training casts the f32 master
        in the graph."""
        if deterministic:
            return F.linear(y.to(self.cfg.dtype), getattr(self, f"w_{name}_c"), getattr(self, f"b_{name}_c"))
        return _dense(y, self.qkv if name == "qkv" else self.attn_out, self.cfg.dtype)

    def forward(
        self, x: torch.Tensor, attention_mask: Optional[torch.Tensor], deterministic: bool = True,
        dropout_rng: Optional[DropoutRng] = None,
    ) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        b, t, d = x.shape
        h, dh = cfg.num_heads, cfg.head_dim
        # dropout on the probabilities takes the einsum path, as JAX's
        if cfg.attention_impl == "kernel" and (deterministic or cfg.dropout == 0.0):
            key_mask = (
                torch.ones((b, t), dtype=torch.float32, device=x.device)
                if attention_mask is None
                else (attention_mask > 0).float()
            )
            if deterministic and cfg.block_kernel and t <= SINGLE_PASS_MAX_T:
                if cfg.quantize == "int8":
                    return attention_block_int8(
                        x.to(dt), self.w_qkv_q, self.s_qkv, self.b_qkv_blk, self.w_out_q, self.s_out,
                        self.attn_out.bias, key_mask, h, dh,
                    )
                return attention_block(
                    x.to(dt), self.w_qkv_blk, self.b_qkv_blk, self.w_out_blk, self.attn_out.bias, key_mask, h, dh
                )
            qkv = self._project(x, "qkv", deterministic).view(b, t, 3, h, dh)
            if deterministic:
                attend = packed_qkv_attention_lse if t <= SINGLE_PASS_MAX_T else flash_attention_lse
                out, _ = attend(qkv, key_mask)
            else:
                out = packed_qkv_attention(qkv, key_mask)
            return self._project(out, "out", deterministic)
        qkv = self._project(x, "qkv", deterministic).view(b, t, 3, h, dh)
        q, k, v = qkv.unbind(dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (1.0 / float(dh) ** 0.5)
        if attention_mask is not None:
            logits = logits + torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9).float()
        probs = dropout(torch.softmax(logits, dim=-1).to(dt), cfg.dropout, deterministic, dropout_rng, 0)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, d)
        return self._project(out, "out", deterministic)


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

    def forward(
        self, x: torch.Tensor, attention_mask: Optional[torch.Tensor], deterministic: bool = True,
        dropout_rng: Optional[DropoutRng] = None,
    ) -> torch.Tensor:
        """In training, ``Dropout_0`` on the attention output and
        ``Dropout_1`` on the FFN output, as JAX's layer creates them."""
        cfg = self.cfg
        dt = cfg.dtype
        attn = self.attention(x, attention_mask, deterministic, dropout_rng and dropout_rng.child("attention"))
        attn = dropout(attn, cfg.dropout, deterministic, dropout_rng, 0)
        x = self.attn_ln(x + attn).to(dt)
        b, t, d = x.shape
        if not deterministic:  # training takes the dense FFN on the masters
            h = _dense(F.gelu(_dense(x, self.fc_in, dt)), self.fc_out, dt)
        elif cfg.ffn_kernel:
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
        h = dropout(h, cfg.dropout, deterministic, dropout_rng, 1)
        return self.ffn_ln(x + h).to(dt)


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg))

    def forward(
        self, x: torch.Tensor, attention_mask: Optional[torch.Tensor] = None, deterministic: bool = True,
        dropout_rng: "Union[int, DropoutRng, None]" = None,
    ) -> torch.Tensor:
        """x [b, t, d_model]; attention_mask [b, t], 1 = attend.
        ``deterministic=False`` is training mode; with ``dropout > 0`` it
        needs ``dropout_rng``: a seed (this encoder applied alone, JAX's
        ``rngs={"dropout": PRNGKey(seed)}``) or its parent's scope."""
        rng = DropoutRng.of(dropout_rng)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for i in range(self.cfg.num_layers):
            layer = getattr(self, f"layer_{i}")
            layer_rng = rng and rng.child(f"layer_{i}")
            if remat:  # the recomputation draws the same masks: the keys are pure functions of the path
                x = torch.utils.checkpoint.checkpoint(layer, x, attention_mask, deterministic, layer_rng, use_reentrant=False)
            else:
                x = layer(x, attention_mask, deterministic, layer_rng)
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
