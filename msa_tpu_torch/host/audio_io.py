"""Host-side audio ingest: WAV IO and resampling (port of
``msa_tpu/host/audio_io.py``). numpy, scipy and the standard library; the
fixed-shape float32 windows go to the device pipeline."""

from __future__ import annotations

import wave
from math import gcd
from pathlib import Path
from typing import Tuple

import numpy as np


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file → (float32 mono waveform in [-1, 1], sample
    rate). Multi-channel audio is averaged to mono."""
    with wave.open(str(path), "rb") as wf:
        sr = wf.getframerate()
        n = wf.getnframes()
        ch = wf.getnchannels()
        width = wf.getsampwidth()
        raw = wf.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def save_wav(path: str, x: np.ndarray, sample_rate: int) -> None:
    """Write a float32 mono waveform as 16-bit PCM."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    pcm = np.clip(np.asarray(x) * 32768.0, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm.tobytes())


def pcm16_bytes_to_float(data: bytes) -> np.ndarray:
    """Streaming int16 byte buffer → float32 waveform (JAX's numpy
    fallback of the native conversion)."""
    return np.frombuffer(data, np.int16).astype(np.float32) / 32768.0


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling (scipy's resample_poly); identity when the
    rates match."""
    if sr_in == sr_out:
        return np.asarray(x, np.float32)
    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(x, sr_out // g, sr_in // g).astype(np.float32)


def fixed_window(x: np.ndarray, samples: int) -> np.ndarray:
    """Zero-pad or truncate a waveform to the static window size."""
    x = np.asarray(x, np.float32)
    if x.shape[0] >= samples:
        return x[:samples]
    return np.pad(x, (0, samples - x.shape[0]))
