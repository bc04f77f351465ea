"""Transcription (port of ``msa_tpu/host/transcription.py``).

:func:`make_transcriber` resolves names as JAX's factory does. The default,
"auto", serves whisper assets under :func:`whisper_assets_dir` when both a
BPE vocabulary and weights are there; else, for full-scale pipelines, the
shipped ASR (``msa_tpu/checkpoints/whisper_asr``, trained on synthetic
Portuguese speech over the text heads' lexicon) if its recorded held-out
eval (``eval.json``) passes :data:`SHIPPED_WER_BAR`; else the stub, whose
transcripts are empty. Any other name is an HF model: :class:`HFTranscriber`
builds a ``transformers`` ASR pipeline for it on the port's device, and
where that cannot be built (no ``transformers``, no weights in the local
cache and no network) the factory takes JAX's fallback, the stub.

:class:`WhisperTranscriber` is the counterpart of ``JaxWhisperTranscriber``
(the factory gives that name as an alias): int16 windows padded to the
model's static window, the log-mel, the greedy decode, and the packed
``[B, max_len + 1]`` tokens+lengths result, on the model's device.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Callable, List, Optional, Protocol, Tuple

import numpy as np
import torch

from msa_tpu_torch.host.bpe import ByteLevelBPE, load_whisper_tokenizer
from msa_tpu_torch.host.fetch import to_host_async
from msa_tpu_torch.models import whisper as W
from msa_tpu_torch.precision import exact_fp32

logger = logging.getLogger(__name__)

#: Held-out WER a shipped ASR checkpoint must have recorded (eval.json) for
#: make_transcriber("auto") to serve it.
SHIPPED_WER_BAR = 0.1


class Transcriber(Protocol):
    def transcribe(self, waveform: np.ndarray, sample_rate: int) -> str: ...


class StubTranscriber:
    """Always "": the text modality then takes its default analysis."""

    def transcribe(self, waveform: np.ndarray, sample_rate: int) -> str:
        return ""


class HFTranscriber:
    """A ``transformers`` ASR pipeline, built once on ``device``
    (``msa_tpu/host/transcription.py:51-68``); a failed transcription gives
    "". ``transformers`` is imported here, not with the module. ``language``
    is taken for JAX's signature; its pipeline does not read it either."""

    def __init__(self, model: str = "openai/whisper-medium", language: str = "pt", device="cuda"):
        from transformers import pipeline

        self._pipe = pipeline("automatic-speech-recognition", model=model, device=torch.device(device))

    def transcribe(self, waveform: np.ndarray, sample_rate: int) -> str:
        try:
            out = self._pipe({"raw": np.asarray(waveform, np.float32), "sampling_rate": sample_rate})
            return out.get("text", "")
        except Exception:
            return ""


class SyllableTokenizer:
    """Deterministic id → pseudo-word decoder for tiny test vocabularies
    (too small for the byte-direct BPE fallback)."""

    _SYL = ("ba", "de", "ki", "lo", "mu", "na", "pe", "ri", "so", "tu")

    def decode(self, ids) -> str:
        words, word = [], []
        for i in ids:
            word.append(self._SYL[int(i) % len(self._SYL)])
            if len(word) == 2:
                words.append("".join(word))
                word = []
        if word:
            words.append("".join(word))
        return " ".join(words)

    def encode(self, text: str):
        raise NotImplementedError("decode-only test tokenizer")


def whisper_assets_dir() -> str:
    """MSA_WHISPER_ASSETS, else ``data/assets/whisper``."""
    return os.environ.get("MSA_WHISPER_ASSETS", "data/assets/whisper")


def _auto_tokenizer(cfg: W.WhisperConfig):
    """BPE assets → byte-direct BPE fallback → syllable decoder (tiny vocabs)."""
    tok = load_whisper_tokenizer(whisper_assets_dir())
    if tok is not None:
        return tok
    if cfg.vocab_size >= 1256:
        return ByteLevelBPE(vocab_size=cfg.vocab_size)
    if cfg.vocab_size >= 512:
        return ByteLevelBPE(vocab_size=cfg.vocab_size, byte_offset=cfg.vocab_size - 256)
    return SyllableTokenizer()


def _shipped_asr_passes_bar(asset_dir) -> bool:
    """True iff ``asset_dir/eval.json`` records a held-out WER under
    :data:`SHIPPED_WER_BAR`; missing or unreadable metrics fail."""
    try:
        metrics = json.loads((Path(asset_dir) / "eval.json").read_text())
        return float(metrics["wer"]) < SHIPPED_WER_BAR
    except (OSError, ValueError, KeyError, TypeError):
        return False


Handle = Tuple[Optional[Callable[[], np.ndarray]], int]


class WhisperTranscriber:
    """Log-mel + encoder-decoder + KV-cached greedy decode on the model's
    device, ``_BATCH`` clips per call. Per-clip failures degrade to "" and
    are logged."""

    # fixed decode batch: segment lists pad up to it (the offline
    # processor's batch)
    _BATCH = 8

    def __init__(self, cfg: Optional[W.WhisperConfig] = None, model: Optional[W.WhisperModel] = None,
                 tokenizer="auto", max_len: int = 64, device="cuda"):
        """``cfg`` defaults to ``WhisperConfig.tiny()`` and ``model`` to
        JAX's init of it from seed 0, on ``device``."""
        cfg = cfg or W.WhisperConfig.tiny()
        self.cfg = cfg
        self.model = model if model is not None else W.init_whisper(cfg, 0, device)
        self.tokenizer = _auto_tokenizer(cfg) if tokenizer == "auto" else tokenizer
        self.max_len = min(max_len, cfg.max_target_positions)

    @property
    def device(self) -> torch.device:
        return self.model.decoder.embed_positions.device

    def _pad_waveform(self, waveform) -> np.ndarray:
        """The waveform zero-padded or cut to the static window (padding the
        waveform, not the mel, so padded frames carry the silence value), as
        int16 PCM."""
        n = W.window_samples(self.cfg)
        x = np.asarray(waveform, np.float32)
        x = np.pad(x, (0, n - x.shape[0])) if x.shape[0] < n else x[:n]
        return np.clip(x * 32768.0, -32768, 32767).astype(np.int16)

    def graph(self, waves_i16: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """int16 [B, samples] on the model's device (any length: padded with
        silence or cut to the window) → packed int32 [B, max_len + 1]: the
        tokens, then the length."""
        n = W.window_samples(self.cfg)
        if waves_i16.shape[1] < n:
            waves_i16 = torch.nn.functional.pad(waves_i16, (0, n - waves_i16.shape[1]))
        with torch.inference_mode(), exact_fp32():
            waves = waves_i16[:, :n].float() / 32768.0
            tokens, lengths = self.model.greedy_decode(W.log_mel_window(waves, self.cfg), self.max_len, valid)
            return torch.cat([tokens, lengths[:, None]], dim=1)

    def _detok(self, packed: np.ndarray, count: int) -> List[str]:
        """The text of ``count`` rows of a packed result ("" without a tokenizer)."""
        if not self.tokenizer:
            return [""] * count
        return [self.tokenizer.decode([int(t) for t in row[: int(row[-1])]]) for row in packed[:count]]

    def _dispatch(self, waves_i16: torch.Tensor, count: int) -> Handle:
        valid = torch.arange(waves_i16.shape[0], device=waves_i16.device) < count
        return to_host_async(self.graph(waves_i16, valid)), count

    def transcribe(self, waveform, sample_rate: int) -> str:
        """One clip, decoded at B=1; a failure gives "" and is logged."""
        try:
            fetch, _ = self._dispatch(torch.from_numpy(self._pad_waveform(waveform)[None]).to(self.device), 1)
            return self._detok(fetch(), 1)[0]
        except Exception:
            logger.exception("whisper transcription failed")
            return ""

    def dispatch_batch(self, waveforms, sample_rate: int) -> List[Handle]:
        """Pad, upload and launch one decode per ``_BATCH`` clips (the
        chunk padded with silent rows marked invalid); the packed results
        start back to the host without blocking. → handles for
        :meth:`collect_batch`; a chunk that fails carries None."""
        handles: List[Handle] = []
        for lo in range(0, len(waveforms), self._BATCH):
            chunk = waveforms[lo : lo + self._BATCH]
            try:
                waves = np.stack([self._pad_waveform(w) for w in chunk])
                waves = np.pad(waves, [(0, self._BATCH - len(chunk)), (0, 0)])
                handles.append(self._dispatch(torch.from_numpy(waves).to(self.device), len(chunk)))
            except Exception:  # a failed chunk degrades to "" rows; the batch goes on
                logger.exception("whisper dispatch failed for %d clips", len(chunk))
                handles.append((None, len(chunk)))
        return handles

    def dispatch_resident(self, audio_dev: torch.Tensor, count: int) -> List[Handle]:
        """Launch the decode on an int16 [B, samples] batch already on the
        model's device (the offline processor's segment upload): no host
        preparation, no second upload."""
        try:
            return [self._dispatch(audio_dev, count)]
        except Exception:
            logger.exception("whisper dispatch failed for a resident batch of %d", count)
            return [(None, count)]

    def collect_batch(self, handles: List[Handle]) -> List[str]:
        """Wait for the results of :meth:`dispatch_batch` and detokenize."""
        out: List[str] = []
        for fetch, count in handles:
            try:
                out.extend(self._detok(fetch(), count) if fetch is not None else [""] * count)
            except Exception:
                logger.exception("whisper collect failed for %d clips", count)
                out.extend([""] * count)
        return out

    def transcribe_batch(self, waveforms, sample_rate: int) -> List[str]:
        """One decode per ``_BATCH`` clips."""
        return self.collect_batch(self.dispatch_batch(waveforms, sample_rate))


JaxWhisperTranscriber = WhisperTranscriber  # the JAX package's name


def make_transcriber(name: str, language: str = "pt", scale: str = "full", device="cuda") -> Transcriber:
    """Build a Transcriber by config name (TranscriptionConfig.model), with
    its model on ``device``. ``scale`` is the pipeline's model scale:
    "auto" serves the shipped ASR only for full-scale pipelines.

    - "stub": always "";
    - "auto": whisper assets (vocab + weights) → the shipped ASR if its
      recorded eval passes the bar (full scale) → the stub;
    - "jax-whisper"/"whisper-jax": the tiny whisper from JAX's init
      (random weights; text still flows);
    - anything else: an HF model name, served by :class:`HFTranscriber` on
      ``device``, or the stub where that pipeline cannot be built.
    """
    if name in ("stub", "", None):
        return StubTranscriber()
    if name == "auto":
        assets = Path(whisper_assets_dir())
        tok = load_whisper_tokenizer(str(assets))
        params_path = assets / "params.msgpack"
        if tok is not None and params_path.exists():
            from msa_tpu_torch.checkpoints import flax_msgpack

            cfg = W.WhisperConfig()
            return WhisperTranscriber(cfg, W.whisper_from_flax(cfg, flax_msgpack.load(params_path), device), tok)
        if scale == "full":
            shipped = _shipped_asr(device)
            if shipped is not None:
                return shipped
        return StubTranscriber()
    if name in ("jax-whisper", "whisper-jax"):
        return WhisperTranscriber(device=device)
    try:
        return HFTranscriber(name, language, device)
    except Exception:
        return StubTranscriber()


def _shipped_asr(device) -> Optional[WhisperTranscriber]:
    """The transcriber on ``checkpoints/whisper_asr``, or None where it is
    missing or its recorded eval fails the bar."""
    from msa_tpu_torch.assets import resolve_asset

    try:
        asset_dir = resolve_asset("checkpoints/whisper_asr/config.json").parent
    except FileNotFoundError:
        return None
    if not _shipped_asr_passes_bar(asset_dir):
        return None
    loaded = W.load_asr(asset_dir, device)
    if loaded is None:
        return None
    cfg, model = loaded
    return WhisperTranscriber(cfg, model, _auto_tokenizer(cfg))
