"""Whisper-style speech-to-text: encoder-decoder with a KV-cached greedy
decode (port of ``msa_tpu/models/whisper.py``).

- encoder: conv1 (k3, pad 1) → GELU → conv2 (k3, stride 2, pad 1) → GELU,
  sinusoidal positions, pre-LN blocks, a final LayerNorm;
- decoder: token embedding + learned positions, pre-LN blocks with causal
  self-attention and cross-attention, logits tied to the token embedding.

Numerics as flax runs them: f32 throughout; every LayerNorm is eps 1e-5
with the two-pass variance (``use_fast_variance=False``); ``k_proj`` has no
bias; both convs and the MLPs use the exact GELU; masked scores add −1e9.
Attention is plain matmuls, as JAX computes it in einsum outside any Pallas
kernel. On the card the f32 products must run without TF32
(``torch.backends.{cuda.matmul,cudnn}.allow_tf32 = False``).

Module and parameter names are the flax tree's, so :func:`load_asr` and
:func:`msa_tpu_torch.weights.load_flax_tree` load a JAX parameter tree
directly; :func:`init_whisper` rebuilds JAX's init, and
:func:`params_from_hf_whisper` turns a ``transformers`` WhisperModel state
dict into that tree.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from msa_tpu_torch import flax_init, weights
from msa_tpu_torch.checkpoints import flax_msgpack
from msa_tpu_torch.models.transformer import LayerNorm
from msa_tpu_torch.ops.audio_features import mel_filterbank, power_spectrogram

SAMPLE_RATE = 16_000  # whisper's mel convention (inputs are resampled upstream)


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    d_model: int = 512  # whisper-base
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 8
    d_ff: int = 2048
    vocab_size: int = 51865
    max_source_positions: int = 1500
    max_target_positions: int = 448
    eos_token_id: int = 50257
    decoder_start_token_id: int = 50258

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @classmethod
    def tiny(cls) -> "WhisperConfig":
        return cls(
            n_mels=8,
            d_model=32,
            encoder_layers=2,
            decoder_layers=2,
            num_heads=2,
            d_ff=64,
            vocab_size=100,
            max_source_positions=64,
            max_target_positions=16,
            eos_token_id=3,
            decoder_start_token_id=2,
        )


def window_samples(cfg: WhisperConfig) -> int:
    """Static waveform window: mel hop 160 × 2 frames per encoder position."""
    return 2 * cfg.max_source_positions * 160


def log_mel_window(x: torch.Tensor, cfg: WhisperConfig) -> torch.Tensor:
    """Log-mel of window-padded waveforms [B, window_samples] → [B, frames,
    n_mels]: n_fft 400, hop 160, log10 with the per-clip clamp at max − 8,
    then (x + 4) / 4."""
    t_max = 2 * cfg.max_source_positions
    power = power_spectrogram(x, n_fft=400, hop=160)  # [B, freq, frames]
    fb = torch.as_tensor(mel_filterbank(201, cfg.n_mels, SAMPLE_RATE, 0.0, SAMPLE_RATE / 2), device=x.device)
    mel = torch.einsum("bft,fm->bmt", power, fb)[:, :, :t_max]
    log_mel = torch.log10(torch.clamp(mel, min=1e-10))
    clip_max = log_mel.amax(dim=(1, 2), keepdim=True)
    log_mel = torch.maximum(log_mel, clip_max - 8.0)
    return ((log_mel + 4.0) / 4.0).transpose(1, 2)


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoidal position table (log-scale timescales)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def _ln(d: int) -> LayerNorm:
    return LayerNorm(d, eps=1e-5, fast=False)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


class Attention(nn.Module):
    """Whisper attention: q, v and out have biases, k does not."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def kv(self, kv_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.k_proj(kv_in), self.v_proj(kv_in)

    def attend(self, q_in, k, v, mask_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        b, tq, tk = q_in.shape[0], q_in.shape[1], k.shape[1]
        q = self.q_proj(q_in).reshape(b, tq, c.num_heads, c.head_dim)
        kh = k.reshape(b, tk, c.num_heads, c.head_dim)
        vh = v.reshape(b, tk, c.num_heads, c.head_dim)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kh) / np.float32(np.sqrt(c.head_dim))
        if mask_bias is not None:
            s = s + mask_bias
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(b, tq, c.d_model)
        return self.out_proj(out)

    def forward(self, q_in, kv_in=None, mask_bias=None):
        k, v = self.kv(q_in if kv_in is None else kv_in)
        return self.attend(q_in, k, v, mask_bias)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.self_attn = Attention(cfg)
        self.self_attn_layer_norm = _ln(cfg.d_model)
        self.fc1 = nn.Linear(cfg.d_model, cfg.d_ff)
        self.fc2 = nn.Linear(cfg.d_ff, cfg.d_model)
        self.final_layer_norm = _ln(cfg.d_model)

    def forward(self, x):
        x = x + self.self_attn(self.self_attn_layer_norm(x))
        return x + self.fc2(_gelu(self.fc1(self.final_layer_norm(x))))


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv1d(cfg.n_mels, cfg.d_model, 3, padding=1)
        self.conv2 = nn.Conv1d(cfg.d_model, cfg.d_model, 3, stride=2, padding=1)
        for i in range(cfg.encoder_layers):
            self.add_module(f"layer_{i}", EncoderBlock(cfg))
        self.layer_norm = _ln(cfg.d_model)
        self.register_buffer("pos", torch.from_numpy(_sinusoids(cfg.max_source_positions, cfg.d_model)), persistent=False)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T_frames, n_mels] → [B, ceil(T/2), d_model]."""
        x = _gelu(self.conv1(mel.transpose(1, 2)))
        x = _gelu(self.conv2(x)).transpose(1, 2)
        x = x + self.pos[: x.shape[1]][None]
        for i in range(self.cfg.encoder_layers):
            x = getattr(self, f"layer_{i}")(x)
        return self.layer_norm(x)


class DecoderBlock(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.self_attn = Attention(cfg)
        self.self_attn_layer_norm = _ln(cfg.d_model)
        self.encoder_attn = Attention(cfg)
        self.encoder_attn_layer_norm = _ln(cfg.d_model)
        self.fc1 = nn.Linear(cfg.d_model, cfg.d_ff)
        self.fc2 = nn.Linear(cfg.d_ff, cfg.d_model)
        self.final_layer_norm = _ln(cfg.d_model)

    def _mlp(self, x):
        return x + self.fc2(_gelu(self.fc1(self.final_layer_norm(x))))

    def forward(self, x, cross_k, cross_v, causal_bias):
        x = x + self.self_attn(self.self_attn_layer_norm(x), mask_bias=causal_bias)
        x = x + self.encoder_attn.attend(self.encoder_attn_layer_norm(x), cross_k, cross_v)
        return self._mlp(x)

    def step(self, x, cache_k, cache_v, step_idx: int, cross_k, cross_v):
        """One cached decode step: x [B, 1, d]; the step's k and v are
        written into the caches [B, T_max, d] in place at ``step_idx``."""
        h = self.self_attn_layer_norm(x)
        new_k, new_v = self.self_attn.kv(h)
        cache_k[:, step_idx] = new_k[:, 0]
        cache_v[:, step_idx] = new_v[:, 0]
        valid = torch.arange(cache_k.shape[1], device=x.device) <= step_idx  # attend to ≤ the current step
        bias = torch.where(valid, 0.0, -1e9)[None, None, None, :]
        x = x + self.self_attn.attend(h, cache_k, cache_v, bias)
        x = x + self.encoder_attn.attend(self.encoder_attn_layer_norm(x), cross_k, cross_v)
        return self._mlp(x)


class WhisperDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.embed_positions = nn.Parameter(torch.zeros(cfg.max_target_positions, cfg.d_model))
        for i in range(cfg.decoder_layers):
            self.add_module(f"layer_{i}", DecoderBlock(cfg))
        self.layer_norm = _ln(cfg.d_model)

    def blocks(self) -> List[DecoderBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.decoder_layers)]

    def forward(self, tokens: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        """Teacher-forced: tokens [B, T] → logits [B, T, vocab]."""
        t = tokens.shape[1]
        x = self.embed_tokens(tokens) + self.embed_positions[:t][None]
        causal = torch.tril(torch.ones(t, t, dtype=torch.bool, device=tokens.device))
        causal = torch.where(causal, 0.0, -1e9)[None, None]
        for layer in self.blocks():
            x = layer(x, *layer.encoder_attn.kv(enc_out), causal)
        return self.layer_norm(x) @ self.embed_tokens.weight.t()

    def decode_step(self, token: torch.Tensor, step_idx: int, caches, cross_kvs) -> torch.Tensor:
        """token [B] → logits [B, vocab]; ``caches`` (per layer k and v [B,
        T_max, d]) take the step's keys and values in place."""
        x = self.embed_tokens(token[:, None]) + self.embed_positions[step_idx][None, None]
        for layer, (ck, cv), (xk, xv) in zip(self.blocks(), caches, cross_kvs):
            x = layer.step(x, ck, cv, step_idx, xk, xv)
        return (self.layer_norm(x) @ self.embed_tokens.weight.t())[:, 0, :]


class WhisperModel(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = WhisperEncoder(cfg)
        self.decoder = WhisperDecoder(cfg)

    def forward(self, mel, tokens):
        """Teacher-forced forward → logits [B, T, vocab]."""
        return self.decoder(tokens, self.encoder(mel))

    @torch.no_grad()
    def greedy_decode(self, mel: torch.Tensor, max_len: int, valid: Optional[torch.Tensor] = None):
        """Greedy decode, a Python loop that stops the step every row has
        emitted EOS (JAX's ``lax.while_loop``). Rows with ``valid`` false
        start done. A row freezes at EOS. → (tokens [B, max_len] int32,
        EOS-filled past the end, lengths [B]: the tokens before the first
        EOS)."""
        c = self.cfg
        enc_out = self.encoder(mel)
        blocks = self.decoder.blocks()
        cross_kvs = [layer.encoder_attn.kv(enc_out) for layer in blocks]
        b, dev = mel.shape[0], mel.device
        caches = [
            tuple(torch.zeros(b, c.max_target_positions, c.d_model, dtype=enc_out.dtype, device=dev) for _ in range(2))
            for _ in blocks
        ]
        token = torch.full((b,), c.decoder_start_token_id, dtype=torch.int64, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev) if valid is None else ~valid.to(dev, torch.bool)
        tokens = torch.full((b, max_len), c.eos_token_id, dtype=torch.int64, device=dev)
        for i in range(max_len):
            if bool(done.all()):
                break
            logits = self.decoder.decode_step(token, i, caches, cross_kvs)
            nxt = torch.where(done, c.eos_token_id, logits.argmax(dim=-1))
            done = done | (nxt == c.eos_token_id)
            tokens[:, i] = nxt
            token = nxt
        lengths = torch.cumprod((tokens != c.eos_token_id).int(), dim=1).sum(dim=1)
        return tokens.int(), lengths.int()


def load_asr(asset_dir: "str | Path", device="cuda") -> Optional[Tuple[WhisperConfig, WhisperModel]]:
    """(cfg, model on ``device`` in eval mode) from an ASR directory of
    ``config.json`` + ``params.msgpack`` (as JAX's ``save_asr`` writes
    them), or None when either file is missing."""
    d = Path(asset_dir)
    cfg_path, params_path = d / "config.json", d / "params.msgpack"
    if not (cfg_path.exists() and params_path.exists()):
        return None
    cfg = WhisperConfig(**json.loads(cfg_path.read_text()))
    return cfg, whisper_from_flax(cfg, flax_msgpack.load(params_path), device)


def init_whisper(cfg: WhisperConfig, seed: int = 0, device="cuda") -> WhisperModel:
    """A :class:`WhisperModel` on ``device`` in eval mode with JAX's
    ``init_params(cfg, seed)`` (:mod:`msa_tpu_torch.flax_init`)."""
    return flax_init.init_module_(WhisperModel(cfg).to(device).eval(), seed)


def whisper_from_flax(cfg: WhisperConfig, params, device="cuda") -> WhisperModel:
    """A :class:`WhisperModel` on ``device`` in eval mode with a JAX
    parameter tree (numpy leaves) loaded."""
    model = WhisperModel(cfg).to(device).eval()
    weights.load_flax_tree(model, params)
    return model


# --- HF weight import -----------------------------------------------------------


def _t(x) -> np.ndarray:
    """A torch tensor (any device) or array-like → numpy."""
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def _attn(sd, p):
    return {
        "q_proj": {"kernel": _t(sd[p + "q_proj.weight"]).T, "bias": _t(sd[p + "q_proj.bias"])},
        "k_proj": {"kernel": _t(sd[p + "k_proj.weight"]).T},
        "v_proj": {"kernel": _t(sd[p + "v_proj.weight"]).T, "bias": _t(sd[p + "v_proj.bias"])},
        "out_proj": {"kernel": _t(sd[p + "out_proj.weight"]).T, "bias": _t(sd[p + "out_proj.bias"])},
    }


def _lnp(sd, p):
    return {"scale": _t(sd[p + "weight"]), "bias": _t(sd[p + "bias"])}


def _mlp(sd, p):
    return {"fc1": {"kernel": _t(sd[p + "fc1.weight"]).T, "bias": _t(sd[p + "fc1.bias"])},
            "fc2": {"kernel": _t(sd[p + "fc2.weight"]).T, "bias": _t(sd[p + "fc2.bias"])}}


def params_from_hf_whisper(state_dict, cfg: WhisperConfig) -> dict:
    """A ``transformers`` WhisperModel state dict (torch tensors or numpy
    arrays under HF's names) → this model's flax tree with numpy leaves
    (the encoder's conv stem and blocks, the decoder's embeddings and
    blocks), which :func:`whisper_from_flax` loads. A copy of
    ``msa_tpu/models/whisper.py:381-421``: torch conv weights ``[out, in,
    k]`` become flax's ``[k, in, out]``, Linear weights are transposed, and
    ``k_proj`` has no bias."""
    sd = state_dict
    enc = {
        "conv1": {"kernel": _t(sd["encoder.conv1.weight"]).transpose(2, 1, 0), "bias": _t(sd["encoder.conv1.bias"])},
        "conv2": {"kernel": _t(sd["encoder.conv2.weight"]).transpose(2, 1, 0), "bias": _t(sd["encoder.conv2.bias"])},
        "layer_norm": _lnp(sd, "encoder.layer_norm."),
    }
    for i in range(cfg.encoder_layers):
        p = f"encoder.layers.{i}."
        enc[f"layer_{i}"] = {
            "self_attn": _attn(sd, p + "self_attn."),
            "self_attn_layer_norm": _lnp(sd, p + "self_attn_layer_norm."),
            **_mlp(sd, p),
            "final_layer_norm": _lnp(sd, p + "final_layer_norm."),
        }
    dec = {
        "embed_tokens": {"embedding": _t(sd["decoder.embed_tokens.weight"])},
        "embed_positions": _t(sd["decoder.embed_positions.weight"]),
        "layer_norm": _lnp(sd, "decoder.layer_norm."),
    }
    for i in range(cfg.decoder_layers):
        p = f"decoder.layers.{i}."
        dec[f"layer_{i}"] = {
            "self_attn": _attn(sd, p + "self_attn."),
            "self_attn_layer_norm": _lnp(sd, p + "self_attn_layer_norm."),
            "encoder_attn": _attn(sd, p + "encoder_attn."),
            "encoder_attn_layer_norm": _lnp(sd, p + "encoder_attn_layer_norm."),
            **_mlp(sd, p),
            "final_layer_norm": _lnp(sd, p + "final_layer_norm."),
        }
    return {"encoder": enc, "decoder": dec}
