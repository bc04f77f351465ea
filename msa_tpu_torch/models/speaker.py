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

The training half: :func:`ge2e_loss` (GE2E's softmax loss, its gradient
from autograd), the procedural voices (:class:`VoiceSpec`,
:func:`random_voice`, :func:`synth_voice`: numpy, byte-equal to JAX's from
the same generator), JAX's init and msgpack files (:func:`init_params`,
:func:`save_params`, :func:`load_params`; a file either package writes
loads in the other) and :func:`train_speaker_embedder`, which trains on
fresh voices every step on the card, f32 with TF32 off.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from msa_tpu_torch import flax_init, weights
from msa_tpu_torch.checkpoints import flax_msgpack
from msa_tpu_torch.precision import exact_fp32
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


def init_params(model: SpeakerEmbeddingNet, seed: int = 0) -> SpeakerEmbeddingNet:
    """Fill ``model`` with JAX's ``init_params(model, seed)``
    (``model.init(PRNGKey(seed), …)``), rebuilt by
    :mod:`msa_tpu_torch.flax_init`; returns it."""
    return flax_init.init_module_(model, seed)


def save_params(params: Mapping[str, Any], path: str) -> None:
    """JAX's file: ``msgpack_serialize({"params": tree})`` of the flax tree
    ``params``, keys sorted."""
    flax_msgpack.dump(path, {"params": params})


def load_params(model: SpeakerEmbeddingNet, path: str) -> SpeakerEmbeddingNet:
    """Load a file of :func:`save_params` (or JAX's) into ``model``, every
    leaf at its shape; returns it (the module carries the params JAX
    returns)."""
    tree = flax_msgpack.load(path)["params"]
    missing = weights.missing_leaves(model, tree)
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} leaves of the model, e.g. {missing[:3]}")
    weights.load_flax_tree(model, tree)
    return model


# --- GE2E contrastive objective ------------------------------------------------


def ge2e_loss(emb: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Generalized end-to-end softmax loss (``msa_tpu/models/speaker.py:152``).

    emb: [N_speakers, M_utts, D] L2-normalised. The own-speaker column
    takes the leave-one-out centroid; the [N·M, N] scaled cosines
    ``|w|·sim + b`` feed a cross-entropy to the true speaker."""
    n, m, _ = emb.shape
    centroids = emb.mean(dim=1)
    loo = (emb.sum(dim=1, keepdim=True) - emb) / (m - 1)
    loo = loo / (torch.linalg.vector_norm(loo, dim=-1, keepdim=True) + 1e-8)
    cents = centroids / (torch.linalg.vector_norm(centroids, dim=-1, keepdim=True) + 1e-8)
    sim = torch.einsum("nmd,kd->nmk", emb, cents)
    own = (emb * loo).sum(dim=-1)
    eye = torch.eye(n, dtype=emb.dtype, device=emb.device)[:, None, :]
    sim = sim * (1 - eye) + own[..., None] * eye
    sim = torch.abs(w) * sim + b
    labels = torch.arange(n, device=emb.device)[:, None, None].expand(n, m, 1)
    return -F.log_softmax(sim, dim=-1).gather(-1, labels).mean()


# --- procedural voice synthesis (numpy, JAX's draws in JAX's order) -------------


@dataclasses.dataclass(frozen=True)
class VoiceSpec:
    """A synthetic speaker identity: pitch + vocal-tract resonances."""

    f0: float  # fundamental, Hz
    formants: Tuple[float, ...]  # resonance centers, Hz
    bandwidth: float = 120.0  # resonance width, Hz
    tilt: float = 1.0  # spectral tilt exponent (harmonic rolloff)
    breathiness: float = 0.02  # aspiration-noise level


def random_voice(rng: np.random.Generator) -> VoiceSpec:
    return VoiceSpec(
        f0=float(rng.uniform(85, 300)),
        formants=(
            float(rng.uniform(300, 900)),
            float(rng.uniform(900, 2400)),
            float(rng.uniform(2400, 3500)),
        ),
        bandwidth=float(rng.uniform(80, 180)),
        tilt=float(rng.uniform(0.6, 1.4)),
        breathiness=float(rng.uniform(0.01, 0.05)),
    )


def synth_voice(
    rng: np.random.Generator,
    spec: VoiceSpec,
    seconds: float,
    sample_rate: int = 16_000,
) -> np.ndarray:
    """Speech-like signal: a harmonic stack at f0 (vibrato, drift) shaped
    by the voice's formant envelope, syllabic amplitude modulation and
    aspiration noise; distinct formants give distinct timbre at one pitch."""
    n = int(seconds * sample_rate)
    t = np.arange(n) / sample_rate
    vibrato = 1.0 + 0.02 * np.sin(2 * np.pi * rng.uniform(4.5, 6.5) * t)
    drift = 1.0 + 0.03 * rng.standard_normal() * np.sin(
        2 * np.pi * rng.uniform(0.3, 0.8) * t + rng.uniform(0, 2 * np.pi)
    )
    f0 = spec.f0 * vibrato * drift
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate

    sig = np.zeros(n)
    n_harm = max(3, int((sample_rate / 2 - 200) / spec.f0))
    for h in range(1, min(n_harm, 40) + 1):
        fh = spec.f0 * h
        env = sum(1.0 / (1.0 + ((fh - fc) / spec.bandwidth) ** 2) for fc in spec.formants)
        amp = env / (h ** spec.tilt)
        sig += amp * np.sin(h * phase + rng.uniform(0, 2 * np.pi))

    syll = 0.55 + 0.45 * np.clip(
        np.sin(2 * np.pi * rng.uniform(2.5, 5.0) * t + rng.uniform(0, 2 * np.pi)),
        0.0,
        None,
    )
    sig = sig * syll
    sig += spec.breathiness * rng.standard_normal(n) * np.max(np.abs(sig))
    peak = np.max(np.abs(sig)) + 1e-8
    return (0.3 * sig / peak).astype(np.float32)


# --- training recipe ------------------------------------------------------------


def train_speaker_embedder(
    cfg: Optional[SpeakerConfig] = None,
    steps: int = 300,
    n_speakers: int = 8,
    n_utts: int = 4,
    lr: float = 2e-3,
    seed: int = 0,
    log_every: int = 0,
    device: "str | torch.device" = "cuda",
) -> Tuple[SpeakerEmbeddingNet, Dict[str, Any], Dict[str, List[float]]]:
    """JAX's recipe (``msa_tpu/models/speaker.py:256``) on ``device``: new
    voice identities every step, ``log_mel`` of the [N, M] windows, the
    net and :func:`ge2e_loss` with its learnable scale ``w`` (10.0) and
    bias ``b`` (−5.0), Adam (optax's defaults) over the net and both.
    → (the trained net, its flax tree, ``{"loss": [...]}``)."""
    from msa_tpu_torch.training.encoders import adam

    cfg = cfg or SpeakerConfig()
    with torch.device(device):
        model = init_params(SpeakerEmbeddingNet(cfg), seed).requires_grad_(True)
        w = nn.Parameter(torch.tensor(10.0))
        b = nn.Parameter(torch.tensor(-5.0))
    optimizer = adam([*model.parameters(), w, b], lr)

    rng = np.random.default_rng(seed)
    history: Dict[str, List[float]] = {"loss": []}
    ws = cfg.window_samples
    for i in range(steps):
        voices = [random_voice(rng) for _ in range(n_speakers)]
        windows = np.stack(
            [
                np.stack([synth_voice(rng, v, cfg.window_seconds, cfg.sample_rate)[:ws] for _ in range(n_utts)])
                for v in voices
            ]
        )  # [N, M, ws]
        x = torch.from_numpy(windows).to(w.device).reshape(-1, ws)
        with exact_fp32():
            optimizer.zero_grad(set_to_none=True)
            emb = model(log_mel(x, cfg)).reshape(n_speakers, n_utts, -1)
            loss = ge2e_loss(emb, w, b)
            loss.backward()
            optimizer.step()
        history["loss"].append(float(loss.detach()))
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}/{steps} ge2e_loss={history['loss'][-1]:.4f}")
    model.eval().requires_grad_(False)
    return model, weights.flax_tree(model), history
