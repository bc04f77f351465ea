"""Audio emotion encoder, wav2vec2-style (port of ``msa_tpu/models/audio.py``):

conv extractor (7 convs, GroupNorm after conv0, exact GELU) →
``post_extract_ln`` → ``proj`` → positions → transformer encoder (no mask)
→ attentive-stats pool → 4-class head, whose probabilities are duplicated
to the 8-dim contract (D7). Positions are ``x + pos_conv(x)`` then
``encoder_pre_ln`` under ``positional="conv"`` (the serving graph's), or a
fixed sinusoidal table added to x under ``positional="sinusoidal"`` (the
tiny test config's).

The convs run in the encoder's compute dtype with f32 GroupNorm/LayerNorm,
as in JAX; tensors are NCW inside the convs and [B, T, C] elsewhere. Their
weights are f32 masters cast to the compute dtype in the forward, as
flax's ``nn.Conv(dtype=…)`` casts its f32 params, so an optimizer steps the
f32 values as JAX's does.

``extractor_impl="matmul"`` (JAX's option, ``msa_tpu/models/audio.py:
98-126``, ``:165-170``) runs each layer after the first with stride 2 and
kernel 2 or 3 as a GEMM over the input read in pairs of rows, with the
GELU: in serving on the card, where C and C′ are multiples of 128 (the
kernel's contract, the full-width 512 channels), the hand-written kernel
``conv_stride2_fused`` (PERF.md row 11) with the GELU fused; elsewhere
JAX's pair-reshaped matmuls in plain PyTorch, in JAX's order: on the CPU,
at narrower widths, and in training, since row 11 has no backward (as
training takes the dense FFN). The GEMM layers take [B, L, C], one layout
change after layer 0. The parameter tree is the same as under ``"conv"``
(the default, cuDNN on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from msa_tpu_torch.core.emotions import duplicate_4_to_8
from msa_tpu_torch.ops.kernels.conv import conv_stride2_fused
from msa_tpu_torch.models.transformer import (
    AttentiveStatsPool,
    DropoutRng,
    EncoderConfig,
    LayerNorm,
    TransformerEncoder,
)


@dataclasses.dataclass(frozen=True)
class AudioModelConfig:
    conv_channels: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernels: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_strides: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    num_classes: int = 4
    pool_hidden: int = 128
    positional: str = "conv"  # "conv" | "sinusoidal"
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    # "conv" (cuDNN) | "matmul": the stride-2 layers after the first as
    # GEMMs, in serving on the card through conv_stride2_fused where C and
    # C' are multiples of 128
    extractor_impl: str = "conv"
    # prosody-trained pool + head over the JAX package's deterministic trunk
    head_weights: Optional[str] = "checkpoints/audio_emotion_head.msgpack"
    encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)

    @classmethod
    def tiny(cls) -> "AudioModelConfig":
        """Small config for tests (``msa_tpu/models/audio.py:68``); no head
        checkpoint, which would not fit the tiny trunk."""
        return cls(
            conv_channels=(8, 8),
            conv_kernels=(10, 8),
            conv_strides=(5, 4),
            pool_hidden=8,
            positional="sinusoidal",
            head_weights=None,
            encoder=EncoderConfig.tiny(),
        )


def sinusoidal_positions(t: int, d: int) -> np.ndarray:
    """[t, d] f32 table: sin on even, cos on odd columns (float64 inside)."""
    pos = np.arange(t)[:, None]
    dim = np.arange(d // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * dim / d)
    out = np.zeros((t, d), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], dt: torch.dtype, **kw) -> torch.Tensor:
    """flax's ``nn.Conv(dtype=dt)`` on f32 masters: input, kernel and bias
    cast to ``dt`` in the graph. On the card cuDNN convolves in ``dt``. On
    the CPU a sub-f32 conv is computed in f32 from the rounded operands and
    rounded once, then the bias is added in ``dt``, as XLA's CPU conv and
    flax do it: oneDNN's bf16 conv1d on the CPU is wrong at some shapes
    (8 channels with kernel 8 reads an error as large as the output)."""
    w = weight.to(dt)
    b = None if bias is None else bias.to(dt)
    if x.device.type != "cpu" or dt == torch.float32:
        return F.conv1d(x.to(dt), w, b, **kw)
    y = F.conv1d(x.to(dt).float(), w.float(), **kw).to(dt)
    return y if b is None else y + b[:, None]


class ConvFeatureExtractor(nn.Module):
    def __init__(self, cfg: AudioModelConfig):
        super().__init__()
        self.cfg = cfg
        cin = 1
        for i, (ch, k, s) in enumerate(zip(cfg.conv_channels, cfg.conv_kernels, cfg.conv_strides)):
            self.add_module(f"conv_{i}", nn.Conv1d(cin, ch, k, stride=s, bias=False))
            cin = ch
        # wav2vec2: per-channel GroupNorm after conv0, exact variance, f32
        self.gn = nn.GroupNorm(cfg.conv_channels[0], cfg.conv_channels[0], eps=1e-5)

    def as_matmul(self, i: int) -> bool:
        """Whether layer ``i`` runs as a GEMM (JAX's gate, audio.py:165)."""
        c = self.cfg
        return c.extractor_impl == "matmul" and i > 0 and c.conv_strides[i] == 2 and c.conv_kernels[i] in (2, 3)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, T] → [B, T', C] in the compute dtype."""
        dt = self.cfg.encoder.dtype
        x, nwc = wav[:, None, :].to(dt), False  # NCW through cuDNN; [B, L, C] for the GEMM layers
        for i in range(len(self.cfg.conv_channels)):
            conv = getattr(self, f"conv_{i}")
            if self.as_matmul(i):
                if not nwc:
                    x, nwc = x.transpose(1, 2).contiguous(), True
                x = strided_conv_gelu(x, conv.weight.permute(2, 1, 0))
                continue
            if nwc:
                x, nwc = x.transpose(1, 2), False
            x = conv1d(x, conv.weight, None, dt, stride=conv.stride)
            if i == 0:
                x = self.gn(x.float()).to(dt)
            x = F.gelu(x)
        return x if nwc else x.transpose(1, 2)


def strided_conv_as_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """JAX's ``_strided_conv_as_matmul`` (``msa_tpu/models/audio.py:
    98-126``): the VALID stride-2 conv of x [B, L, C] with w [k ∈ (2, 3),
    C, C'] (both in the compute dtype) as matmuls over x read in pairs of
    rows [B, L//2, 2C]: taps 0 and 1 against the stacked [2C, C'], tap 2
    against the next pair's first half; f32 sums rounded once to x's
    dtype."""
    k, cin, cout = w.shape
    b, length, _ = x.shape
    out_len = (length - k) // 2 + 1
    need = 2 * (out_len + 1)  # padded rows reach only discarded outputs or tap 2's zero tail
    if need > length:
        x = F.pad(x, (0, 0, 0, need - length))
    pairs = x[:, :need].reshape(b, out_len + 1, 2 * cin).float()
    out = pairs[:, :out_len] @ w[:2].reshape(2 * cin, cout).float()
    if k == 3:
        out = out + pairs[:, 1:, :cin] @ w[2].float()
    return out.to(x.dtype)


def strided_conv_gelu(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A GEMM layer of the matmul extractor with its exact GELU: x [B, L,
    C], w [k, C, C'] (the f32 master, cast to x's dtype) → [B, (L − k)//2 +
    1, C']. ``conv_stride2_fused`` serves CUDA tensors at C and C'
    multiples of 128 (its contract) when no gradient is wanted, since it
    has no backward; everywhere else JAX's matmuls, then the GELU in x's
    dtype."""
    wants_grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if x.is_cuda and x.shape[2] % 128 == 0 and w.shape[2] % 128 == 0 and not wants_grad:
        return conv_stride2_fused(x, w)
    return F.gelu(strided_conv_as_matmul(x, w.to(x.dtype)))


class ConvPositionalEmbedding(nn.Module):
    """Grouped conv over time (kernel 128, 16 groups, padding k/2; an even
    kernel yields one extra frame, which is trimmed) + exact GELU."""

    def __init__(self, d_model: int, kernel: int, groups: int, dtype: torch.dtype):
        super().__init__()
        self.kernel, self.dtype = kernel, dtype
        self.conv = nn.Conv1d(d_model, d_model, kernel, padding=kernel // 2, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, dt = self.conv, self.dtype
        h = conv1d(x.transpose(1, 2), c.weight, c.bias, dt, padding=c.padding, groups=c.groups).transpose(1, 2)
        if self.kernel % 2 == 0:
            h = h[:, :-1, :]
        return F.gelu(h)


class AudioEmotionModel(nn.Module):
    def __init__(self, cfg: AudioModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.encoder.d_model
        self.feature_extractor = ConvFeatureExtractor(cfg)
        self.post_extract_ln = LayerNorm(cfg.conv_channels[-1], 1e-5, fast=False)
        self.proj = nn.Linear(cfg.conv_channels[-1], d)
        if cfg.positional == "conv":
            self.pos_conv = ConvPositionalEmbedding(d, cfg.pos_conv_kernel, cfg.pos_conv_groups, cfg.encoder.dtype)
            self.encoder_pre_ln = LayerNorm(d, 1e-5, fast=False)
        elif cfg.positional != "sinusoidal":
            raise ValueError(f"positional={cfg.positional!r}: expected 'conv' or 'sinusoidal'")
        self.encoder = TransformerEncoder(cfg.encoder)
        self.pool = AttentiveStatsPool(d, cfg.pool_hidden)
        self.emotion_head = nn.Linear(2 * d, cfg.num_classes)

    def forward(
        self, wav: torch.Tensor, deterministic: bool = True, dropout_rng: "int | DropoutRng | None" = None
    ) -> Dict[str, torch.Tensor]:
        """``deterministic=False`` is training mode; with ``dropout > 0`` it
        needs ``dropout_rng``, the seed of JAX's ``rngs={"dropout":
        PRNGKey(seed)}`` (the encoder's masks)."""
        feats = self.post_extract_ln(self.feature_extractor(wav))  # f32
        x = self.proj(feats)
        if self.cfg.positional == "conv":
            x = self.encoder_pre_ln(x + self.pos_conv(x))
        else:
            x = x + torch.from_numpy(sinusoidal_positions(x.shape[1], x.shape[2])).to(x.device)
        rng = DropoutRng.of(dropout_rng)
        hidden = self.encoder(x, None, deterministic, rng and rng.child("encoder"))
        pooled = self.pool(hidden)
        logits = self.emotion_head(pooled.float())
        probs4 = torch.softmax(logits, dim=-1)
        return {
            "hidden": hidden,
            "pooled": pooled,
            "logits": logits,
            "probs4": probs4,
            "emotion_probs": duplicate_4_to_8(probs4),
        }


# --- HF weight import ---------------------------------------------------------


def _numpy(x) -> np.ndarray:
    """A torch tensor (any device) or array-like → numpy."""
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def _weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """torch's weight norm, w = g · v/‖v‖, the norm over the axes where g is
    singleton (wav2vec2's positional conv uses dim=2)."""
    axes = tuple(i for i, s in enumerate(g.shape) if s == 1)
    norm = np.sqrt((v**2).sum(axis=axes, keepdims=True))
    return g * v / norm


def params_from_hf_wav2vec2(state_dict: Dict[str, Any], cfg: AudioModelConfig) -> Dict[str, Any]:
    """A ``transformers`` Wav2Vec2Model state dict (torch tensors or numpy
    arrays under HF's names) → the audio trunk's flax tree with numpy leaves
    (extractor, projection, conv positional embedding, transformer), which
    :func:`msa_tpu_torch.weights.load_flax_tree` reads. A copy of the JAX
    package's ``msa_tpu/models/audio.py:288``: the positional conv's
    weight norm is folded in (``weight_g``/``weight_v``, or the
    ``parametrizations.weight.original0/1`` names of newer torch), q, k and
    v are concatenated into the fused projection. The pool and head stay
    unpopulated, as the reference's classifier over a pretrained trunk."""
    sd = state_dict

    def g(name):
        return _numpy(sd[name])

    p: Dict[str, Any] = {"feature_extractor": {}, "encoder": {}}
    for i in range(len(cfg.conv_channels)):
        # torch conv1d [out, in, k] → flax [k, in, out]
        p["feature_extractor"][f"conv_{i}"] = {"kernel": g(f"feature_extractor.conv_layers.{i}.conv.weight").transpose(2, 1, 0)}
    p["feature_extractor"]["gn"] = {
        "scale": g("feature_extractor.conv_layers.0.layer_norm.weight"),
        "bias": g("feature_extractor.conv_layers.0.layer_norm.bias"),
    }
    p["post_extract_ln"] = {"scale": g("feature_projection.layer_norm.weight"), "bias": g("feature_projection.layer_norm.bias")}
    p["proj"] = {"kernel": g("feature_projection.projection.weight").T, "bias": g("feature_projection.projection.bias")}
    pc = "encoder.pos_conv_embed.conv."
    if pc + "weight_g" in sd:
        w = _weight_norm(g(pc + "weight_g"), g(pc + "weight_v"))
    elif pc + "parametrizations.weight.original0" in sd:
        w = _weight_norm(g(pc + "parametrizations.weight.original0"), g(pc + "parametrizations.weight.original1"))
    else:
        w = g(pc + "weight")
    p["pos_conv"] = {"conv": {"kernel": w.transpose(2, 1, 0), "bias": g(pc + "bias")}}
    p["encoder_pre_ln"] = {"scale": g("encoder.layer_norm.weight"), "bias": g("encoder.layer_norm.bias")}
    for i in range(cfg.encoder.num_layers):
        hf = f"encoder.layers.{i}."
        p["encoder"][f"layer_{i}"] = {
            "attention": {
                "qkv": {
                    "kernel": np.concatenate([g(hf + f"attention.{n}_proj.weight").T for n in ("q", "k", "v")], axis=1),
                    "bias": np.concatenate([g(hf + f"attention.{n}_proj.bias") for n in ("q", "k", "v")]),
                },
                "attn_out": {"kernel": g(hf + "attention.out_proj.weight").T, "bias": g(hf + "attention.out_proj.bias")},
            },
            "attn_ln": {"scale": g(hf + "layer_norm.weight"), "bias": g(hf + "layer_norm.bias")},
            "fc_in": {
                "kernel": g(hf + "feed_forward.intermediate_dense.weight").T,
                "bias": g(hf + "feed_forward.intermediate_dense.bias"),
            },
            "fc_out": {
                "kernel": g(hf + "feed_forward.output_dense.weight").T,
                "bias": g(hf + "feed_forward.output_dense.bias"),
            },
            "ffn_ln": {"scale": g(hf + "final_layer_norm.weight"), "bias": g(hf + "final_layer_norm.bias")},
        }
    return p
