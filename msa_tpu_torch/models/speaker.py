"""Speaker-embedding net, the learned half of multi-speaker diarization
(port of ``msa_tpu/models/speaker.py``: ``SpeakerConfig``, ``log_mel``,
``SpeakerEmbeddingNet`` and its loader).

A fixed log-mel window ``[B, frames, n_mels]`` goes through ``conv_i``
(kernel 5, SAME padding) → GELU → LayerNorm per conv stage, attentive
statistics pooling and a Dense projection, and comes out L2-normalised
``[B, embed_dim]``. f32 throughout. Numerics as flax runs them:

- ``nn.gelu(x)`` at ``speaker.py:100`` is the **tanh** approximation
  (every other GELU of the system is exact);
- ``nn.LayerNorm()`` takes flax's defaults, eps 1e-6 with the fast
  variance E[x²] − E[x]²;
- ``log_mel`` normalises by the mean and the population std over the whole
  window, and the embedding by its L2 norm + 1e-8.

The loss, the voice synthesis and the trainer are training code and are
not ported here.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from msa_tpu_torch import weights
from msa_tpu_torch.checkpoints import flax_msgpack
from msa_tpu_torch.models.transformer import AttentiveStatsPool, LayerNorm
from msa_tpu_torch.ops.audio_features import mel_filterbank, power_spectrogram


@dataclasses.dataclass(frozen=True)
class SpeakerConfig:
    sample_rate: int = 16_000
    window_seconds: float = 1.2  # embedding window (static shape)
    n_fft: int = 400
    hop: int = 200
    n_mels: int = 40
    conv_channels: Tuple[int, ...] = (64, 64, 64)
    kernel: int = 5
    embed_dim: int = 64
    pool_hidden: int = 64

    @property
    def window_samples(self) -> int:
        return int(self.window_seconds * self.sample_rate)

    @property
    def frames(self) -> int:
        return self.window_samples // self.hop + 1

    @classmethod
    def tiny(cls) -> "SpeakerConfig":
        return cls(window_seconds=0.8, n_mels=24, conv_channels=(16, 16), embed_dim=16, pool_hidden=16)


def log_mel(wav: torch.Tensor, cfg: SpeakerConfig) -> torch.Tensor:
    """[B, T] waveform → [B, frames, n_mels] log-mel, normalised per window."""
    power = power_spectrogram(wav, cfg.n_fft, cfg.hop)  # [B, freq, frames]
    fb = torch.as_tensor(
        mel_filterbank(cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate, 0.0, cfg.sample_rate / 2), device=wav.device
    )
    mel = torch.einsum("bft,fm->btm", power, fb)
    logm = torch.log(torch.clamp(mel, min=1e-8))
    mu = logm.mean(dim=(-2, -1), keepdim=True)
    sd = logm.std(dim=(-2, -1), keepdim=True, unbiased=False)
    return (logm - mu) / (sd + 1e-5)


class SpeakerEmbeddingNet(nn.Module):
    """log-mel window [B, frames, n_mels] → L2-normalised [B, embed_dim].
    Module and parameter names are the flax tree's."""

    def __init__(self, cfg: SpeakerConfig):
        super().__init__()
        self.cfg = cfg
        cin = cfg.n_mels
        for i, ch in enumerate(cfg.conv_channels):
            self.add_module(f"conv_{i}", nn.Conv1d(cin, ch, cfg.kernel, padding=cfg.kernel // 2))
            self.add_module(f"ln_{i}", LayerNorm(ch, eps=1e-6, fast=True))
            cin = ch
        self.pool = AttentiveStatsPool(cin, hidden=cfg.pool_hidden)
        self.proj = nn.Linear(2 * cin, cfg.embed_dim)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats
        for i in range(len(self.cfg.conv_channels)):
            x = getattr(self, f"conv_{i}")(x.transpose(1, 2)).transpose(1, 2)
            x = getattr(self, f"ln_{i}")(F.gelu(x, approximate="tanh"))
        emb = self.proj(self.pool(x))
        return emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-8)

    def embed_windows(self, wav_windows: torch.Tensor) -> torch.Tensor:
        """[B, window_samples] raw audio → [B, embed_dim]."""
        return self(log_mel(wav_windows, self.cfg))


def load_speaker_net(path: "str | Path", cfg: SpeakerConfig = SpeakerConfig(), device="cuda") -> SpeakerEmbeddingNet:
    """The net of ``cfg`` on ``device``, in eval mode, with the weights of
    a flax checkpoint (``{"params": …}``, as ``save_params`` writes it)."""
    net = SpeakerEmbeddingNet(cfg).to(device).eval()
    weights.load_flax_tree(net, flax_msgpack.load(path)["params"])
    return net
