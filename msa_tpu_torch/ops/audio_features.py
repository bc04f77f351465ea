"""Audio DSP feature ops, batched over a leading axis (port of
``msa_tpu/ops/audio_features.py``). Every function takes ``[B, T]``
float32 waveforms where the JAX version took one ``[T]`` waveform under
``vmap``; statistics that JAX took over "all elements" of one waveform are
taken per row here. All math is float32.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000


def windowed_energy(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """Σ x² per sliding window: [B, T] → [B, frames]."""
    return (x * x).unfold(-1, frame_len, hop).sum(dim=-1)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    n_freqs: int, n_mels: int, sample_rate: int, f_min: float, f_max: float
) -> np.ndarray:
    """HTK triangular mel filterbank [n_freqs, n_mels] (torchaudio
    melscale_fbanks defaults)."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def dct_matrix_ortho(n_mfcc: int, n_mels: int) -> np.ndarray:
    """DCT-II with 'ortho' norm, [n_mels, n_mfcc]."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    dct = np.cos(math.pi / n_mels * (n[:, None] + 0.5) * k[None, :]) * 2.0
    dct[:, 0] *= 1.0 / math.sqrt(2.0)
    dct *= math.sqrt(1.0 / (2.0 * n_mels))
    return dct.astype(np.float32)


def power_spectrogram(x: torch.Tensor, n_fft: int = 400, hop: int = 200) -> torch.Tensor:
    """Power STFT with a periodic hann window and reflect centre padding:
    [B, T] → [B, n_fft//2+1, frames]."""
    pad = n_fft // 2
    x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)  # [B, frames, n_fft]
    window = torch.as_tensor(
        np.hanning(n_fft + 1)[:-1].astype(np.float32), device=x.device
    )
    spec = torch.fft.rfft(frames * window, dim=-1)
    return (spec.abs() ** 2).transpose(-1, -2)


def amplitude_to_db(power: torch.Tensor, top_db: float = 80.0) -> torch.Tensor:
    """10·log10 with a 1e-10 floor, then a top_db clamp against each row's
    own maximum."""
    db = 10.0 * torch.log10(torch.clamp(power, min=1e-10))
    peak = db.flatten(1).max(dim=1).values.reshape((-1,) + (1,) * (db.dim() - 1))
    return torch.maximum(db, peak - top_db)


def mfcc(
    x: torch.Tensor,
    sample_rate: int = SAMPLE_RATE,
    n_mfcc: int = 13,
    n_fft: int = 400,
    hop: int = 200,
    n_mels: int = 128,
) -> torch.Tensor:
    """torchaudio MFCC defaults: [B, T] → [B, n_mfcc, frames]."""
    power = power_spectrogram(x, n_fft, hop)
    fb = torch.as_tensor(
        mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, 0.0, sample_rate / 2),
        device=x.device,
    )
    mel = torch.einsum("bft,fm->bmt", power, fb)
    mel_db = amplitude_to_db(mel)
    dct = torch.as_tensor(dct_matrix_ortho(n_mfcc, n_mels), device=x.device)
    return torch.einsum("bmt,mk->bkt", mel_db, dct)


def zscore(x: torch.Tensor, ndim: int = 1, ddof: int = 1, eps: float = 1e-6) -> torch.Tensor:
    """(x − mean)/(std + eps) over the last ``ndim`` axes, unbiased std."""
    dims = tuple(range(-ndim, 0))
    n = math.prod(x.shape[-ndim:])
    mean = x.mean(dim=dims, keepdim=True)
    var = (x - mean).square().sum(dim=dims, keepdim=True) / max(n - ddof, 1)
    return (x - mean) / (torch.sqrt(var) + eps)


def pitch_acf(
    x: torch.Tensor, sample_rate: int = SAMPLE_RATE, f_min: float = 60.0, f_max: float = 400.0
) -> torch.Tensor:
    """Autocorrelation F0 (D8 repair mode) → [B] in [0, 1] as f0/f_max."""
    x = x - x.mean(dim=-1, keepdim=True)
    n = x.shape[-1]
    fft_len = int(2 ** math.ceil(math.log2(2 * n - 1)))
    spec = torch.fft.rfft(x, fft_len)
    acf = torch.fft.irfft(spec * spec.conj(), fft_len)[:, :n]
    acf = acf / torch.clamp(acf[:, :1], min=1e-9)
    lag_min = int(sample_rate / f_max)
    lag_max = min(int(sample_rate / f_min), n - 1)
    window = acf[:, lag_min:lag_max]
    best = window.argmax(dim=-1) + lag_min
    f0 = sample_rate / best.float()
    voiced = window.max(dim=-1).values > 0.3
    return torch.where(voiced, f0 / f_max, torch.zeros_like(f0))


def intensity_windowed(x: torch.Tensor, frame_len: int = 400, hop: int = 160) -> torch.Tensor:
    return zscore(windowed_energy(x, frame_len, hop)).mean(dim=-1)


def speech_rate_framed(x: torch.Tensor, frame_len: int = 400, hop: int = 160) -> torch.Tensor:
    energy = windowed_energy(x, frame_len, hop)
    return (energy > 0.1 * energy.mean(dim=-1, keepdim=True)).float().mean(dim=-1)


def speech_rate_reference(x: torch.Tensor) -> torch.Tensor:
    """Silence gate: 1.0 for any nonzero clip (the reference formula)."""
    return ((x * x).sum(dim=-1) > 0).float()


def timbre_mfcc(x: torch.Tensor, sample_rate: int = SAMPLE_RATE) -> torch.Tensor:
    """13 MFCCs z-scored over the whole [13, frames] block, time-averaged."""
    return zscore(mfcc(x, sample_rate), ndim=2).mean(dim=-1)


def _unbiased_std(e: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    n = e.shape[-1]
    return torch.sqrt((e - mean[:, None]).square().sum(dim=-1) / max(n - 1, 1))


def rhythm(
    x: torch.Tensor,
    sample_rate: int = SAMPLE_RATE,
    window_size: float = 0.025,
    hop_length: float = 0.010,
) -> torch.Tensor:
    """[mean, unbiased std, frames/sr] of windowed energies → [B, 3]."""
    energy = windowed_energy(x, int(window_size * sample_rate), int(hop_length * sample_rate))
    n = energy.shape[-1]
    mean = energy.mean(dim=-1)
    std = _unbiased_std(energy, mean)
    dur = torch.full_like(mean, n / sample_rate)
    return torch.stack([mean, std, dur], dim=-1)


def signal_noise_ratio(x: torch.Tensor) -> torch.Tensor:
    k = int(0.05 * x.shape[-1])
    noise = torch.cat([x[:, :k], x[:, -k:]], dim=-1)
    noise_power = noise.square().mean(dim=-1)
    signal_power = x.square().mean(dim=-1)
    snr = 10.0 * torch.log10(signal_power / (noise_power + 1e-6))
    return torch.clamp(snr / 30.0, 0.0, 1.0)


def clarity(x: torch.Tensor, sample_rate: int = SAMPLE_RATE) -> torch.Tensor:
    m = mfcc(x, sample_rate)
    high = m[:, 6:].abs().flatten(1).mean(dim=-1)
    low = m[:, :6].abs().flatten(1).mean(dim=-1)
    return torch.clamp(high / (low + 1e-6), 0.0, 1.0)


def consistency(x: torch.Tensor, sample_rate: int = SAMPLE_RATE) -> torch.Tensor:
    seg = int(0.1 * sample_rate)
    n = x.shape[-1] // seg
    energy = windowed_energy(x[:, : n * seg], seg, seg) / seg
    mean = energy.mean(dim=-1)
    cv = _unbiased_std(energy, mean) / (mean + 1e-6)
    return 1.0 - torch.clamp(cv, max=1.0)


def audio_feature_stack(
    x: torch.Tensor, sample_rate: int = SAMPLE_RATE, pitch_mode: str = "reference"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T] → (dsp [B, 19] = pitch, intensity, timbre 13, rate, rhythm 3;
    quality [B, 4] = overall, snr, clarity, consistency)."""
    x = x.float()
    zeros = x.new_zeros(x.shape[0])
    if pitch_mode == "acf":
        pitch, intens, rate = pitch_acf(x, sample_rate), intensity_windowed(x), speech_rate_framed(x)
    else:
        pitch, intens, rate = zeros, zeros, speech_rate_reference(x)
    timbre = timbre_mfcc(x, sample_rate)
    rhy = rhythm(x, sample_rate)
    snr = signal_noise_ratio(x)
    clr = clarity(x, sample_rate)
    cons = consistency(x, sample_rate)
    dsp = torch.cat([pitch[:, None], intens[:, None], timbre, rate[:, None], rhy], dim=-1)
    overall = 0.4 * snr + 0.3 * clr + 0.3 * cons
    quality = torch.stack([overall, snr, clr, cons], dim=-1)
    return dsp, quality
