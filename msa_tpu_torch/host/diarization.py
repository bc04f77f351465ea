"""Speaker diarization (port of ``msa_tpu/host/diarization.py``).

Output contract: ``[{"start": s, "end": e, "speaker": id}]`` sorted by
start. Three host-side diarizers are numpy copies of JAX's (the k-means
seed included): fixed windows, energy VAD, and VAD spans clustered by
their MFCC signature. :class:`NeuralDiarizer`, the default, embeds every
window of every VAD span in one batch with the speaker net on the card and
clusters the spans agglomeratively.

:func:`make_diarizer` resolves names as JAX's factory does. The pyannote
adapter needs a download, so "pyannote…" takes JAX's fallback branch, the
neural diarizer.
"""

from __future__ import annotations

from typing import Dict, List, Protocol

import numpy as np
import torch

from msa_tpu_torch.host.fetch import to_host_async
from msa_tpu_torch.ops.audio_features import dct_matrix_ortho, mel_filterbank
from msa_tpu_torch.precision import exact_fp32


class Diarizer(Protocol):
    def diarize(self, waveform: np.ndarray, sample_rate: int) -> List[Dict]:
        """→ [{"start", "end", "speaker"}] sorted by start."""
        ...


class FixedWindowDiarizer:
    """Single speaker, fixed windows of ``segment_duration`` seconds."""

    def __init__(self, segment_duration: float = 5.0, speaker: str = "SPEAKER_00"):
        self.segment_duration = segment_duration
        self.speaker = speaker

    def diarize(self, waveform: np.ndarray, sample_rate: int) -> List[Dict]:
        total = len(waveform) / sample_rate
        out = []
        t = 0.0
        while t < total:
            end = min(t + self.segment_duration, total)
            if end - t > 1e-3:
                out.append({"start": t, "end": end, "speaker": self.speaker})
            t = end
        return out


class EnergyVADDiarizer:
    """Energy-threshold voice activity detection with speech/pause
    hysteresis; spans capped at ``segment_duration``; one speaker."""

    def __init__(
        self,
        segment_duration: float = 5.0,
        min_speech_duration: float = 0.5,
        min_pause_duration: float = 0.5,
        frame_ms: float = 30.0,
        threshold_ratio: float = 0.5,
        speaker: str = "SPEAKER_00",
    ):
        self.segment_duration = segment_duration
        self.min_speech = min_speech_duration
        self.min_pause = min_pause_duration
        self.frame_ms = frame_ms
        self.threshold_ratio = threshold_ratio
        self.speaker = speaker

    def diarize(self, waveform: np.ndarray, sample_rate: int) -> List[Dict]:
        x = np.asarray(waveform, np.float32)
        frame = max(1, int(sample_rate * self.frame_ms / 1000))
        n = len(x) // frame
        if n == 0:
            return []
        energies = (x[: n * frame].reshape(n, frame) ** 2).mean(axis=1)
        # adaptive threshold between the noise floor and mean energy
        floor = np.percentile(energies, 10)
        spread = energies.mean() - floor
        if spread <= 1e-9 * max(energies.mean(), 1.0):
            # flat energy: no contrast to threshold on
            active = energies > 1e-8
        else:
            thresh = floor + self.threshold_ratio * spread
            active = energies > thresh

        # merge gaps shorter than min_pause, drop bursts shorter than min_speech
        sec_per_frame = frame / sample_rate
        spans: List[List[float]] = []
        start = None
        gap = 0.0
        for i, a in enumerate(active):
            t = i * sec_per_frame
            if a:
                if start is None:
                    start = t
                gap = 0.0
            elif start is not None:
                gap += sec_per_frame
                if gap >= self.min_pause:
                    spans.append([start, t - gap + sec_per_frame])
                    start = None
        if start is not None:
            spans.append([start, n * sec_per_frame])
        spans = [s for s in spans if s[1] - s[0] >= self.min_speech]

        # split long spans to the fixed segment duration
        out: List[Dict] = []
        for s, e in spans:
            t = s
            while t < e:
                end = min(t + self.segment_duration, e)
                out.append({"start": t, "end": end, "speaker": self.speaker})
                t = end
        return out


class ClusteringDiarizer:
    """Energy-VAD spans clustered by their mean+std MFCC signature with
    k-means, k ∈ [min_speakers, max_speakers], the smallest k that explains
    ≥ 90% of the embedding variance."""

    def __init__(
        self,
        segment_duration: float = 5.0,
        min_speech_duration: float = 0.5,
        min_pause_duration: float = 0.5,
        min_speakers: int = 1,
        max_speakers: int = 4,
    ):
        self._vad = EnergyVADDiarizer(segment_duration, min_speech_duration, min_pause_duration)
        self.min_speakers = min_speakers
        self.max_speakers = max_speakers

    def _embedding(self, clip: np.ndarray, sample_rate: int) -> np.ndarray:
        """Time-mean + std of 13 MFCCs, L2-normalised (host numpy)."""
        n_fft, hop, n_mels = 400, 200, 64
        if len(clip) < n_fft:
            clip = np.pad(clip, (0, n_fft - len(clip)))
        n = 1 + (len(clip) - n_fft) // hop
        idx = np.arange(n)[:, None] * hop + np.arange(n_fft)[None, :]
        frames = clip[idx] * np.hanning(n_fft + 1)[:-1]
        power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2  # [n, freq]
        fb = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, 0.0, sample_rate / 2)
        mel = np.log10(np.maximum(power @ fb, 1e-10))
        mfcc = mel @ dct_matrix_ortho(13, n_mels)  # [n, 13]
        emb = np.concatenate([mfcc.mean(0), mfcc.std(0)])
        norm = np.linalg.norm(emb)
        return emb / (norm + 1e-8)

    @staticmethod
    def _kmeans(x: np.ndarray, k: int, iters: int = 25, seed: int = 0):
        rng = np.random.default_rng(seed)
        centers = x[rng.choice(len(x), size=k, replace=False)]
        labels = np.zeros(len(x), np.int64)
        for _ in range(iters):
            d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
            labels = d.argmin(1)
            for j in range(k):
                sel = labels == j
                if sel.any():
                    centers[j] = x[sel].mean(0)
        inertia = float(((x - centers[labels]) ** 2).sum())
        return labels, inertia

    def diarize(self, waveform: np.ndarray, sample_rate: int) -> List[Dict]:
        segments = self._vad.diarize(waveform, sample_rate)
        if not segments:
            return segments
        if self.max_speakers <= 1 or len(segments) < 2:
            return segments

        embs = np.stack(
            [
                self._embedding(waveform[int(s["start"] * sample_rate) : int(s["end"] * sample_rate)], sample_rate)
                for s in segments
            ]
        )
        k_max = min(self.max_speakers, len(segments))
        _, base_inertia = self._kmeans(embs, 1)
        best_labels = None
        # same-voice spans have ~0 spread → single speaker
        if base_inertia / len(segments) > 1e-3:
            for k in range(max(self.min_speakers, 2), k_max + 1):
                labels, inertia = self._kmeans(embs, k)
                if inertia <= 0.1 * base_inertia and len(set(labels.tolist())) == k:
                    best_labels = labels
                    break
        if best_labels is None:
            return segments
        # stable label order: first appearance gets SPEAKER_00
        remap: Dict[int, str] = {}
        for lbl in best_labels:
            if int(lbl) not in remap:
                remap[int(lbl)] = f"SPEAKER_{len(remap):02d}"
        for seg, lbl in zip(segments, best_labels):
            seg["speaker"] = remap[int(lbl)]
        return segments


class NeuralDiarizer:
    """Energy-VAD spans → the speaker net's embeddings of every window of
    every span in one batch on the net's device → per-span mean →
    average-linkage agglomerative clustering on cosine similarity, bounded
    to [min_speakers, max_speakers] and stopped below ``threshold``."""

    def __init__(
        self,
        model,
        segment_duration: float = 5.0,
        min_speech_duration: float = 0.5,
        min_pause_duration: float = 0.5,
        min_speakers: int = 1,
        max_speakers: int = 4,
        threshold: float = 0.6,
    ):
        self._vad = EnergyVADDiarizer(segment_duration, min_speech_duration, min_pause_duration)
        self.model = model  # a SpeakerEmbeddingNet in eval mode; its device runs the embedding
        self.min_speakers = min_speakers
        self.max_speakers = max_speakers
        self.threshold = threshold

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _span_windows(self, waveform: np.ndarray, segments: List[Dict], sample_rate: int) -> tuple:
        """→ ([n_windows, window_samples] f32, owner span index per window):
        half-overlapping windows over each span, zero-padded to one window."""
        ws = self.model.cfg.window_samples
        hop = ws // 2
        windows: List[np.ndarray] = []
        owners: List[int] = []
        for i, seg in enumerate(segments):
            lo = int(seg["start"] * sample_rate)
            hi = int(seg["end"] * sample_rate)
            clip = waveform[lo:hi]
            if len(clip) < ws:
                clip = np.pad(clip, (0, ws - len(clip)))
            for off in range(0, max(len(clip) - ws, 0) + 1, hop):
                windows.append(clip[off : off + ws])
                owners.append(i)
        return np.stack(windows).astype(np.float32), owners

    def embed(self, windows: np.ndarray) -> torch.Tensor:
        """[n_windows, window_samples] → [n_windows, D] on the net's device
        (one upload, one forward in exact f32, no sync)."""
        with torch.inference_mode(), exact_fp32():
            return self.model.embed_windows(torch.from_numpy(windows).to(self.device))

    @staticmethod
    def _reduce_spans(embs: np.ndarray, owners: List[int], n_spans: int) -> np.ndarray:
        """Window embeddings → per-span mean, L2-normalised [n_spans, D]."""
        out = np.zeros((n_spans, embs.shape[1]), np.float32)
        counts = np.zeros(n_spans, np.int64)
        for e, i in zip(embs, owners):
            out[i] += e
            counts[i] += 1
        out /= np.maximum(counts[:, None], 1)
        out /= np.linalg.norm(out, axis=1, keepdims=True) + 1e-8
        return out

    @staticmethod
    def _agglomerate(embs: np.ndarray, threshold: float, min_k: int, max_k: int) -> np.ndarray:
        """Average-linkage agglomerative clustering on cosine similarity:
        merges the most similar pair while its similarity ≥ threshold (or
        while over max_k); stops at min_k clusters."""
        n = len(embs)
        labels = np.arange(n)
        active = np.ones(n, bool)
        sizes = np.ones(n, np.float64)
        cent = embs.astype(np.float64).copy()

        def _unit(v: np.ndarray) -> np.ndarray:
            return v / (np.linalg.norm(v) + 1e-8)

        # the similarity matrix once, then one row/column update per merge
        normed = cent / (np.linalg.norm(cent, axis=1, keepdims=True) + 1e-8)
        sim_m = normed @ normed.T
        np.fill_diagonal(sim_m, -2.0)
        k = n
        while k > max(min_k, 1):
            masked = np.where(np.outer(active, active), sim_m, -2.0)
            a, b = divmod(int(np.argmax(masked)), n)
            sim = float(masked[a, b])
            if sim <= -2.0:
                break
            if sim < threshold and k <= max_k:
                break
            a, b = min(a, b), max(a, b)
            total = sizes[a] + sizes[b]
            cent[a] = (cent[a] * sizes[a] + cent[b] * sizes[b]) / total
            sizes[a] = total
            active[b] = False
            labels[labels == b] = a
            normed[a] = _unit(cent[a])
            sim_m[a, :] = normed @ normed[a]
            sim_m[:, a] = sim_m[a, :]
            sim_m[a, a] = -2.0
            sim_m[b, :] = -2.0
            sim_m[:, b] = -2.0
            k -= 1
        # compact to 0..k-1 by first appearance
        remap: Dict[int, int] = {}
        out = np.empty(n, np.int64)
        for i, lbl in enumerate(labels):
            out[i] = remap.setdefault(int(lbl), len(remap))
        return out

    def _label(self, segments: List[Dict], embs: np.ndarray, owners: List[int]) -> List[Dict]:
        spans = self._reduce_spans(embs, owners, len(segments))
        labels = self._agglomerate(spans, self.threshold, self.min_speakers, self.max_speakers)
        for seg, lbl in zip(segments, labels):
            seg["speaker"] = f"SPEAKER_{int(lbl):02d}"
        return segments

    def segment_boundaries(self, waveform: np.ndarray, sample_rate: int) -> List[Dict]:
        """Phase 1 (host only): the VAD spans, with placeholder labels."""
        return self._vad.diarize(waveform, sample_rate)

    def label_segments(self, waveform: np.ndarray, segments: List[Dict], sample_rate: int) -> List[Dict]:
        """Phase 2 (device embedding + clustering): labels assigned in place."""
        return self.label_segments_async(waveform, segments, sample_rate)()

    def label_segments_async(self, waveform: np.ndarray, segments: List[Dict], sample_rate: int):
        """Phase 2 split for overlap: the embedding is launched now and its
        result starts back to the host without blocking; the returned
        ``finalize()`` waits for it, clusters and labels ``segments`` in
        place, and returns them."""
        if len(segments) < 2 or self.max_speakers <= 1:
            return lambda: segments
        windows, owners = self._span_windows(waveform, segments, sample_rate)
        fetch = to_host_async(self.embed(windows))
        return lambda: self._label(segments, fetch(), owners)

    def diarize_async(self, waveform: np.ndarray, sample_rate: int):
        """``diarize`` split for overlap: VAD and the embedding launch now;
        ``finalize()`` yields the labelled segments."""
        return self.label_segments_async(waveform, self.segment_boundaries(waveform, sample_rate), sample_rate)

    def diarize(self, waveform: np.ndarray, sample_rate: int) -> List[Dict]:
        return self.label_segments(waveform, self.segment_boundaries(waveform, sample_rate), sample_rate)


def make_diarizer(name: str, processing_config, diarization_config=None, device="cuda") -> Diarizer:
    """Factory keyed by DiarizationConfig.model, as JAX's. "neural" with
    the speaker checkpoint on disk builds a :class:`NeuralDiarizer` whose
    net runs on ``device``; without it, clustering. "pyannote…" takes JAX's
    fallback to "neural" (the adapter needs a download)."""
    if name.startswith("pyannote"):
        name = "neural"
    if name in ("neural", "speaker-embedding"):
        from msa_tpu_torch.assets import resolve_asset
        from msa_tpu_torch.models.speaker import SpeakerConfig, load_speaker_net

        try:
            weights = resolve_asset(diarization_config.speaker_weights) if diarization_config else None
        except FileNotFoundError:
            weights = None
        if weights is not None:
            return NeuralDiarizer(
                load_speaker_net(weights, SpeakerConfig(), device),
                segment_duration=processing_config.segment_duration,
                min_speech_duration=processing_config.min_speech_duration,
                min_pause_duration=processing_config.min_pause_duration,
                min_speakers=diarization_config.min_speakers,
                max_speakers=diarization_config.max_speakers,
                threshold=diarization_config.clustering_threshold,
            )
        name = "clustering"  # no checkpoint on disk
    if name in ("fixed-window", "fixed"):
        return FixedWindowDiarizer(processing_config.segment_duration)
    if name in ("clustering", "cluster", "multi-speaker"):
        kwargs = {}
        if diarization_config is not None:
            # the configured speaker bounds apply to the fallback too
            kwargs = dict(min_speakers=diarization_config.min_speakers, max_speakers=diarization_config.max_speakers)
        return ClusteringDiarizer(
            segment_duration=processing_config.segment_duration,
            min_speech_duration=processing_config.min_speech_duration,
            min_pause_duration=processing_config.min_pause_duration,
            **kwargs,
        )
    # "energy-vad", "vad" and any other name
    return EnergyVADDiarizer(
        segment_duration=processing_config.segment_duration,
        min_speech_duration=processing_config.min_speech_duration,
        min_pause_duration=processing_config.min_pause_duration,
    )
