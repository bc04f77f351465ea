"""Offline video processor (port of ``msa_tpu/processors/offline.py``).

``OfflineProcessor(config).process_video(path)`` returns the reference's
per-speaker result list: segments grouped by speaker, the dominant emotion
(the mode), runs of three equal emotions, and the per-segment analysis
dicts. As in JAX:

- the audio is read once and the segment windows are sliced from the
  waveform in memory (:func:`msa_tpu_torch.runtime.slice_windows`);
- the mid-segment frames are read in one ordered pass, a batch ahead on a
  worker thread;
- speaker labelling is dispatched after the VAD boundaries and finalised
  before the results are read;
- each batch of segments goes to the card as one int16 PCM upload, shared
  by the pipeline and the resident whisper decode, and one
  :meth:`~msa_tpu_torch.pipeline.graph.SegmentPipeline.run_host` at the
  video's static batch and the shortest sufficient token bucket;
- the landmark carry stays on the device, and each batch's hostpack starts
  back to the host without blocking.

The port runs on one device with no mesh: ``device`` takes the place of
JAX's ``mesh``. Two defects of the JAX reference are kept, not fixed: an
error in dispatching the speaker labelling aborts the video (only its
finalisation degrades to the VAD's placeholder labels), and the resident
whisper decode hears each segment's window as the pipeline cuts it, at
``segment_samples``.
"""

from __future__ import annotations

import concurrent.futures
import functools
import logging
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from msa_tpu_torch.core import emotions
from msa_tpu_torch.core.config import SystemConfig
from msa_tpu_torch.host.diarization import FixedWindowDiarizer, make_diarizer
from msa_tpu_torch.host.fetch import to_host_async
from msa_tpu_torch.host.transcription import make_transcriber
from msa_tpu_torch.host.video import VideoReader, extract_audio_track, preprocess_frame
from msa_tpu_torch.models.text import completeness as text_completeness
from msa_tpu_torch.models.text import relevance as text_relevance
from msa_tpu_torch.pipeline.graph import PipelineModels, SegmentInputs, SegmentPipeline, pad_segment_inputs, unpack_hostpack
from msa_tpu_torch.runtime import slice_windows
from msa_tpu_torch.utils.profiling import StageTimer

logger = logging.getLogger(__name__)


def _upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``; to the card through pinned memory without
    blocking, so the copy overlaps the host work that follows."""
    t = torch.from_numpy(x)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class OfflineProcessor:
    def __init__(
        self,
        config: Optional[SystemConfig] = None,
        models: Optional[PipelineModels] = None,
        device: "str | torch.device" = "cuda",
        diarizer=None,
        transcriber=None,
        batch_size: Optional[int] = None,
    ):
        """The models, diarizer and transcriber default to those the
        config names, built on ``device``; ``models`` given must be on it."""
        self.config = config or SystemConfig.from_env()
        self.config.ensure_directories()
        self.device = torch.device(device)
        if models is None:
            models = (
                PipelineModels.tiny(seed=self.config.seed, device=self.device)
                if self.config.pipeline.model_scale == "tiny"
                else PipelineModels.initialize(
                    seed=self.config.seed, fusion_checkpoint=self.config.model.fusion_checkpoint, device=self.device
                )
            )
        if models.device != self.device:
            raise ValueError(f"the models are on {models.device}, the processor on {self.device}")
        self.models = models
        self.diarizer = diarizer or make_diarizer(
            self.config.diarization.model, self.config.processing, self.config.diarization, device=self.device
        )
        self.transcriber = transcriber or make_transcriber(
            self.config.transcription.model,
            self.config.transcription.language,
            scale=self.config.pipeline.model_scale,
            device=self.device,
        )
        self.batch_size = batch_size or self.config.pipeline.batch_size
        # static token-length buckets: the shortest sufficient one wins per batch
        self.token_buckets = (32, 128, 512)
        # one device, no mesh: the batch pads to a multiple of 1
        self._n_data = 1
        self._pipeline: Optional[SegmentPipeline] = None
        self._frame_hw = (480, 640)
        self._warm_batch: Optional[int] = None
        self.timer = StageTimer()

    def _pipeline_for(self, frame_hw) -> SegmentPipeline:
        if self._pipeline is None or self._frame_hw != frame_hw:
            self._frame_hw = frame_hw
            self._pipeline = SegmentPipeline(self.models, self.config, original_frame_hw=frame_hw)
            if self.config.pipeline.should_precompile():
                # every shape this video will dispatch runs once up front
                with self.timer.stage("precompile"):
                    self._pipeline.warmup(
                        batch_sizes=(self._warm_batch or self.batch_size,),
                        token_buckets=self.token_buckets,
                        samples=self.config.pipeline.segment_samples,
                    )
        return self._pipeline

    def _video_padded_batch(self, n_segments: int) -> int:
        """The static padded batch of one video: the next power of two
        covering its segment count (at least 8), capped at the configured
        batch."""
        p = 8
        while p < n_segments:
            p *= 2
        return min(self.batch_size, p)

    # ------------------------------------------------------------------

    def process_video(
        self,
        video_path: str,
        on_result: Optional[Callable[[Dict], None]] = None,
        on_error: Optional[Callable[[Exception], None]] = None,
        on_progress: Optional[Callable[[float], None]] = None,
    ) -> List[Dict]:
        """Analyse a whole video → the per-speaker result list (person,
        segments, dominant_emotion, emotion_segments, patterns,
        raw_analysis). A failure goes to ``on_error`` (and gives []) when
        one is given, else it raises."""
        t0 = time.perf_counter()
        try:
            results = self._process(video_path, on_progress)
        except Exception as e:  # surface to the caller's handler, don't crash
            logger.error("process_video failed: %s", e, exc_info=True)
            if on_error:
                on_error(e)
                return []
            raise
        if on_result:
            for seg in results:
                on_result(seg)
        grouped = group_by_speaker(results)
        logger.info(
            "processed %s: %d segments, %d speakers in %.2fs",
            video_path, len(results), len(grouped), time.perf_counter() - t0,
        )
        self.timer.log_summary()
        return grouped

    # ------------------------------------------------------------------

    def _process(self, video_path: str, on_progress) -> List[Dict]:
        cfg = self.config
        sr = cfg.audio.sample_rate
        samples = cfg.pipeline.segment_samples

        with VideoReader(video_path) as video:
            frame_hw = (video.height, video.width)

            with self.timer.stage("audio_extract"):
                audio = extract_audio_track(video_path, cfg.dirs.temp_dir, sr)
            audio_avail = audio is not None
            waveform = audio[0] if audio_avail else np.zeros(0, np.float32)

            label_finalize = None
            if audio_avail and len(waveform) > 0:
                if hasattr(self.diarizer, "segment_boundaries") and hasattr(self.diarizer, "label_segments"):
                    # two-phase diarization: the VAD boundaries now (all the
                    # batch loop needs); the labelling's device embedding is
                    # dispatched here and finalised before the results phase
                    with self.timer.stage("diarize"):
                        segments = self.diarizer.segment_boundaries(waveform, sr)
                    if segments:
                        if hasattr(self.diarizer, "label_segments_async"):
                            label_finalize = self.diarizer.label_segments_async(waveform, segments, sr)
                        else:
                            label_finalize = functools.partial(self.diarizer.label_segments, waveform, segments, sr)
                else:
                    with self.timer.stage("diarize"):
                        segments = self.diarizer.diarize(waveform, sr)
                if not segments:
                    # no speech turns: analyse the video in fixed windows
                    # all the same (never nothing for non-empty media)
                    segments = FixedWindowDiarizer(cfg.processing.segment_duration).diarize(waveform, sr)
            else:
                # no audio track: fixed windows over the video's timeline
                segments = FixedWindowDiarizer(cfg.processing.segment_duration).diarize(
                    np.zeros(int(video.duration * sr), np.float32), sr
                )
            if not segments:
                return []

            mid_times = [(s["start"] + s["end"]) / 2 for s in segments]

            self._warm_batch = self._video_padded_batch(len(segments))
            pipeline = self._pipeline_for(frame_hw)
            size = self.models.landmark.cfg.frame_size
            token_cap = min(cfg.text.max_length, self.models.text.cfg.max_positions)

            n = len(segments)
            seg_results: List[Dict] = []
            pending: List[tuple] = []  # (batch, transcripts, hostpack fetch)
            prev_landmarks = np.zeros((self.models.landmark.cfg.landmark_count, 3), np.float32)
            has_prev = np.asarray(False)

            # one-batch-ahead frame decode: every batch's frames are queued
            # up front on one worker (ordered passes over ascending times)
            batch_ranges = list(range(0, n, self.batch_size))

            def _decode(lo: int):
                return video.frames_at(mid_times[lo : min(lo + self.batch_size, n)])

            video_padded = self._video_padded_batch(n)
            with concurrent.futures.ThreadPoolExecutor(max_workers=1) as decode_pool:
                decode_futures = [decode_pool.submit(_decode, lo) for lo in batch_ranges]
                for bi, lo in enumerate(batch_ranges):
                    batch = segments[lo : lo + self.batch_size]
                    b = len(batch)

                    # 1) the audio windows → ONE int16 upload, padded to the
                    # video's static batch, shared by the pipeline and whisper
                    audio_dev = None
                    if audio_avail:
                        with self.timer.stage("audio_window"):
                            starts = np.asarray([int(s["start"] * sr) for s in batch], np.int64)
                            ends = np.asarray([int(s["end"] * sr) for s in batch], np.int64)
                            windows = slice_windows(waveform, starts, ends, samples)
                            pcm = np.clip(windows * 32768.0, -32768, 32767).astype(np.int16)
                            if pcm.shape[0] < video_padded:
                                pcm = np.pad(pcm, [(0, video_padded - pcm.shape[0]), (0, 0)])
                            audio_dev = _upload(pcm, self.device)

                    # 2) dispatch the transcription: the resident decode reads
                    # the upload above, its result starts back at once
                    asr_handles = None
                    clips: List = []
                    if audio_avail and hasattr(self.transcriber, "dispatch_resident"):
                        with self.timer.stage("transcribe_dispatch"):
                            asr_handles = self.transcriber.dispatch_resident(audio_dev, b)
                    elif audio_avail:
                        clips = [waveform[int(s["start"] * sr) : int(s["end"] * sr)] for s in batch]
                        if hasattr(self.transcriber, "dispatch_batch"):
                            try:
                                with self.timer.stage("transcribe_dispatch"):
                                    asr_handles = self.transcriber.dispatch_batch(clips, sr)
                            except Exception as e:
                                logger.warning("ASR dispatch failed: %s", e)
                                asr_handles = None

                    # 3) the frames, while the decode and the upload run
                    with self.timer.stage("decode_wait"):
                        frames = decode_futures[bi].result()
                    with self.timer.stage("frame_preprocess"):
                        pre_frames = [preprocess_frame(f, size) for f in frames]

                    # 4) the transcripts
                    transcripts: List[str] = []
                    if audio_avail and asr_handles is not None:
                        try:
                            with self.timer.stage("transcribe"):
                                transcripts = list(self.transcriber.collect_batch(asr_handles))
                        except Exception as e:
                            logger.warning("batched transcription failed: %s", e)
                            transcripts = [""] * b
                    elif audio_avail and hasattr(self.transcriber, "transcribe_batch"):
                        try:
                            with self.timer.stage("transcribe"):
                                transcripts = list(self.transcriber.transcribe_batch(clips, sr))
                        except Exception as e:
                            logger.warning("batched transcription failed: %s", e)
                            transcripts = [""] * b
                    elif audio_avail:
                        for clip in clips:
                            try:
                                with self.timer.stage("transcribe"):
                                    transcripts.append(self.transcriber.transcribe(clip, sr))
                            except Exception as e:
                                # a failed transcript → "" → the default text analysis
                                logger.warning("transcription failed: %s", e)
                                transcripts.append("")
                    else:
                        transcripts = [""] * b
                    encodings = [
                        self.models.tokenizer.encode(text, token_cap) if text and text.strip() else None
                        for text in transcripts
                    ]
                    # the shortest token bucket that holds every transcript
                    needed = max((int(m.sum()) for _, m in filter(None, encodings)), default=1)
                    tokens = next((t for t in self.token_buckets if needed <= t <= token_cap), token_cap)

                    inp = SegmentInputs.zeros(self.models, b, samples=samples, tokens=tokens)
                    if audio_dev is not None:
                        inp.audio = audio_dev
                    for i in range(b):
                        if not audio_avail:
                            inp.audio_avail[i] = False
                        text = transcripts[i]
                        if encodings[i] is not None:
                            ids, mask = encodings[i]
                            inp.token_ids[i] = ids[:tokens]
                            inp.token_mask[i] = mask[:tokens]
                            inp.completeness[i] = text_completeness(text)
                            inp.relevance[i] = text_relevance(text)
                        else:
                            # an empty transcript: the default text analysis
                            # takes part in the fusion
                            inp.text_avail[i] = False
                        inp.frames[i] = pre_frames[i]
                    inp.prev_landmarks = prev_landmarks
                    inp.has_prev = has_prev

                    inp_padded, real = pad_segment_inputs(inp, self._n_data, to=video_padded)
                    with self.timer.stage("dispatch"):
                        out, _carry = pipeline.run_host(inp_padded)
                    # the movement carry stays on the device, taken from the
                    # last REAL row (padded rows must not feed the history)
                    prev_landmarks = out["landmarks"][real - 1]
                    has_prev = out["detected"][real - 1]
                    # ONE [B, 1715] array per batch starts back to the host now
                    pending.append((batch, transcripts, to_host_async(out["hostpack"])))
                    if on_progress:
                        on_progress(0.5 * min((lo + b) / n, 1.0))

        # finalise the overlapped speaker labelling before the results
        if label_finalize is not None:
            with self.timer.stage("diarize_label_wait"):
                try:
                    label_finalize()
                except Exception as e:
                    # the labels stay at the VAD placeholder
                    logger.warning("speaker labeling failed: %s", e)

        # results phase: the hostpacks in dispatch order
        for batch, transcripts, fetch in pending:
            b = len(batch)
            with self.timer.stage("fetch"):
                cols = unpack_hostpack(fetch()[:b])
            fused, f27 = cols["fused"], cols["face27"]
            a31, t783 = cols["audio31"], cols["text783"]
            fp, ap = cols["face_probs_raw"], cols["audio_probs_raw"]
            tp, combo = cols["text_probs_raw"], cols["combo"][:, 0]
            for i, seg in enumerate(batch):
                fused_vec = fused[i]
                if int(combo[i]) == 0:
                    # nothing available: 'neutro', the evaluator's unknown default
                    label = "neutro"
                elif int(combo[i]) in (0b100, 0b010, 0b001):
                    # one modality: fused_vec is that modality's post-LN
                    # slice, not the fused head's taxonomy; label from its
                    # probabilities in the UI order
                    single = {0b100: fp, 0b010: ap, 0b001: tp}[int(combo[i])]
                    label = emotions.PT_UI[int(np.argmax(np.take(single[i], emotions.CANONICAL_TO_PT_UI)))]
                else:
                    label = emotions.PT_UI[int(np.argmax(fused_vec))]
                seg_results.append(
                    {
                        "start": seg["start"],
                        "end": seg["end"],
                        "speaker": seg["speaker"],
                        "face_vec": f27[i].tolist(),
                        "audio_vec": a31[i].tolist(),
                        "text_vec": t783[i].tolist(),
                        # each modality's probabilities, canonical order
                        "face_probs": fp[i].tolist(),
                        "audio_probs": ap[i].tolist(),
                        "text_probs": tp[i].tolist(),
                        "transcript": transcripts[i],
                        "fused_vec": fused_vec.tolist(),
                        "fused_emotion": label,
                        # the modality bitmask (face 4, audio 2, text 1)
                        "modalities": int(combo[i]),
                    }
                )
            if on_progress:
                on_progress(0.5 + 0.5 * min(len(seg_results) / n, 1.0))
        return seg_results


def export_speaker_analysis(speaker: Dict, weights: Optional[Dict] = None) -> Dict:
    """One grouped speaker result in the JSON schema of the reference's
    README: segments with per-modality analysis dicts, a fused analysis
    with confidence and modality weights, average_confidence and an
    emotion_timeline."""
    weights = weights or {"face": 0.4, "audio": 0.3, "text": 0.3}

    def _softmax(v):
        v = np.asarray(v, np.float64)
        e = np.exp(v - v.max())
        return e / e.sum()

    segments = []
    confidences = []
    timeline = []
    for r in speaker["raw_analysis"]:
        face = np.asarray(r["face_vec"])
        audio = np.asarray(r["audio_vec"])
        text = np.asarray(r["text_vec"])
        fused_probs = _softmax(r["fused_vec"])
        conf = float(fused_probs.max())
        confidences.append(conf)
        timeline.append({"time": r["start"], "emotion": r["fused_emotion"], "confidence": conf})
        segments.append(
            {
                "start_time": r["start"],
                "end_time": r["end"],
                "face_analysis": {
                    "emotion_probs": face[:7].tolist(),
                    "micro_expressions": face[7:12].tolist(),
                    "gaze_direction": face[12:15].tolist(),
                    "muscle_tension": face[15:19].tolist(),
                    "movement_patterns": face[19:23].tolist(),
                },
                "audio_analysis": {
                    "emotion_probs": audio[:8].tolist(),
                    "pitch": float(audio[8]),
                    "intensity": float(audio[9]),
                    "timbre": audio[10:23].tolist(),
                    "speech_rate": float(audio[23]),
                    "rhythm": audio[24:27].tolist(),
                },
                "text_analysis": {
                    "emotion_probs": text[:7].tolist(),
                    "sarcasm_score": float(text[7]),
                    "humor_score": float(text[8]),
                    "polarity": float(text[9]),
                    "intensity": float(text[10]),
                    "context_embedding": text[11:779].tolist(),
                },
                "fused_analysis": {
                    "emotion_probs": fused_probs.tolist(),
                    "confidence": conf,
                    "face_weight": weights["face"],
                    "audio_weight": weights["audio"],
                    "text_weight": weights["text"],
                },
                "transcript": r["transcript"],
                "confidence": conf,
                "dominant_emotion": r["fused_emotion"],
            }
        )
    return {
        "speaker_id": speaker["person"],
        "segments": segments,
        "dominant_emotion": speaker["dominant_emotion"],
        "emotion_patterns": speaker["patterns"],
        "average_confidence": float(np.mean(confidences)) if confidences else 0.0,
        "emotion_timeline": timeline,
    }


def group_by_speaker(results: List[Dict]) -> List[Dict]:
    """Per-segment results grouped by speaker, the reference's aggregation:
    dominant = the modal emotion, patterns = three equal emotions in a row
    with the reference's Portuguese string."""
    speakers: Dict[str, Dict] = {}
    for r in results:
        s = speakers.setdefault(
            r["speaker"],
            {
                "person": r["speaker"],
                "segments": [],
                "dominant_emotion": None,
                "emotion_segments": [],
                "patterns": [],
                "raw_analysis": [],
            },
        )
        s["segments"].append({"start": r["start"], "end": r["end"]})
        s["emotion_segments"].append({"time": [r["start"], r["end"]], "emotion": r["fused_emotion"], "vector": r["fused_vec"]})
        s["raw_analysis"].append(r)

    for s in speakers.values():
        emos = [e["emotion"] for e in s["emotion_segments"]]
        s["dominant_emotion"] = max(set(emos), key=emos.count)
        for i in range(len(emos) - 2):
            if emos[i] == emos[i + 1] == emos[i + 2]:
                s["patterns"].append(f"Emoção consistente '{emos[i]}' nos segmentos {i + 1}-{i + 3}")
    return list(speakers.values())
