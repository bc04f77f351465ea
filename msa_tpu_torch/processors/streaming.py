"""Streaming processor (port of ``msa_tpu/processors/streaming.py``).

``StreamingProcessor(config).run(duration, callback)`` is the reference's
capture loop: buffer at most 30 video frames, drain the audio every
``duration`` seconds, process the window, draw the overlay, call the
callback.

``process_segment(video_frames, audio_data, text)`` returns the reference's
output dict (:func:`~msa_tpu_torch.core.schema.build_streaming_output`),
with its fallback chain for ``fused_emotion`` (the fused vector with two
modalities or more, else the raw vector of the face, the audio or the text,
in that order) and the empty dict on any failure. One window is one packed
upload and one :meth:`~msa_tpu_torch.pipeline.graph.SegmentPipeline.run_stream`
at B=1; a failed packed dispatch falls back once, for good, to
:meth:`~msa_tpu_torch.pipeline.graph.SegmentPipeline.run`. The movement
carry (the last landmarks and whether a face was found) stays on the
device between windows.

Capture is injectable: the ``FrameSource`` / ``AudioSource`` protocols,
with cv2 and PyAudio adapters and synthetic sources, so that ``run()`` runs
headless. The port runs on one device, ``device``; JAX's device lock and
calls through ``utils/device_sync.py`` work around its TPU tunnel and have
no counterpart here.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Protocol

import numpy as np
import torch

from msa_tpu_torch.core.config import SystemConfig
from msa_tpu_torch.core.schema import EMPTY_STREAMING_OUTPUT, AudioAnalysis, FaceAnalysis, TextAnalysis, build_streaming_output
from msa_tpu_torch.host.audio_io import fixed_window, pcm16_bytes_to_float
from msa_tpu_torch.host.diarization import make_diarizer
from msa_tpu_torch.host.fetch import to_host_async
from msa_tpu_torch.host.video import preprocess_frame
from msa_tpu_torch.models.text import completeness as text_completeness
from msa_tpu_torch.models.text import relevance as text_relevance
from msa_tpu_torch.pipeline.graph import PipelineModels, SegmentInputs, SegmentPipeline, pack_stream_inputs, unpack_hostpack
from msa_tpu_torch.utils.profiling import StageTimer

logger = logging.getLogger(__name__)


class FrameSource(Protocol):
    def read(self) -> Optional[np.ndarray]:
        """Next BGR frame, or None when exhausted/unavailable."""
        ...

    def close(self) -> None: ...


class AudioSource(Protocol):
    def start(self) -> None: ...

    def drain(self) -> bytes:
        """All PCM16 bytes captured since the last drain."""
        ...

    def close(self) -> None: ...


class SyntheticFrameSource:
    """Deterministic frames for headless runs and tests."""

    def __init__(self, num_frames: int, height: int = 480, width: int = 640, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._left = num_frames
        self._hw = (height, width)

    def read(self) -> Optional[np.ndarray]:
        if self._left <= 0:
            return None
        self._left -= 1
        h, w = self._hw
        return self._rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)

    def close(self) -> None:
        pass


class SyntheticAudioSource:
    """Sine + noise PCM16 chunks for headless runs and tests."""

    def __init__(self, sample_rate: int = 16000, chunk_seconds: float = 1.0, seed: int = 0):
        self._sr = sample_rate
        self._chunk = chunk_seconds
        self._rng = np.random.default_rng(seed)
        self._t = 0.0

    def start(self) -> None:
        pass

    def drain(self) -> bytes:
        n = int(self._sr * self._chunk)
        t = self._t + np.arange(n) / self._sr
        self._t += self._chunk
        x = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.02 * self._rng.normal(size=n)
        return (np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes()

    def close(self) -> None:
        pass


class Cv2FrameSource:
    """Webcam adapter."""

    def __init__(self, source: int = 0):
        import cv2

        self._cap = cv2.VideoCapture(source)

    def read(self) -> Optional[np.ndarray]:
        ret, frame = self._cap.read()
        return frame if ret else None

    def close(self) -> None:
        self._cap.release()


class PyAudioSource:
    """Microphone adapter: the PortAudio callback thread pushes into the
    native lock-free ring buffer, bounded at 60 s of audio; overflow drops
    the oldest samples."""

    def __init__(self, sample_rate: int = 16000, channels: int = 1, chunk_size: int = 1024):
        import pyaudio  # optional dependency

        from msa_tpu_torch.runtime import NativeRingBuffer, pcm16_to_f32

        self._pcm16_to_f32 = pcm16_to_f32
        self._ring = NativeRingBuffer(sample_rate * 60)
        self._pa = pyaudio.PyAudio()
        self._stream = self._pa.open(
            format=pyaudio.paInt16,
            channels=channels,
            rate=sample_rate,
            input=True,
            frames_per_buffer=chunk_size,
            stream_callback=self._cb,
        )

    def _cb(self, in_data, frame_count, time_info, status):
        import pyaudio

        self._ring.push(self._pcm16_to_f32(np.frombuffer(in_data, np.int16)))
        return (in_data, pyaudio.paContinue)

    def start(self) -> None:
        self._stream.start_stream()

    def drain(self) -> bytes:
        samples = self._ring.drain()
        return np.clip(samples * 32768.0, -32768, 32767).astype(np.int16).tobytes()

    def close(self) -> None:
        self._stream.stop_stream()
        self._stream.close()
        self._pa.terminate()


class StreamingProcessor:
    MAX_VIDEO_BUFFER = 30  # frames a window holds at most

    def __init__(
        self,
        config: Optional[SystemConfig] = None,
        models: Optional[PipelineModels] = None,
        frame_source: Optional[FrameSource] = None,
        audio_source: Optional[AudioSource] = None,
        visualizer=None,
        diarizer=None,
        transcriber=None,
        show_window: bool = False,
        device: "str | torch.device" = "cuda",
    ):
        """The models and the diarizer default to those the config names,
        built on ``device``; ``models`` given must be on it. The
        transcriber is built at the first window that needs it (with
        ``StreamingConfig.live_transcription``). Where the config asks for
        warmup, a background thread starts it now."""
        self.config = config or SystemConfig.from_env()
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
        self.frame_source = frame_source
        self.audio_source = audio_source
        self.diarizer = diarizer or make_diarizer(
            self.config.diarization.model, self.config.processing, self.config.diarization, device=self.device
        )
        self.transcriber = transcriber
        if visualizer is None:
            from msa_tpu_torch.visualizers.overlay import StreamingVisualizer

            visualizer = StreamingVisualizer()
        self.visualizer = visualizer
        self.show_window = show_window
        self.is_running = False
        self._pipeline: Optional[SegmentPipeline] = None
        self._frame_hw = (480, 640)
        self._reset_carry()
        self._pipeline_lock = threading.Lock()
        self._use_packed = True  # one-buffer dispatch; falls back to run() on failure
        # per-stage wall clock of the streaming path; read with timer.summary()
        self.timer = StageTimer()
        self._warmup_thread: Optional[threading.Thread] = None
        if self.config.pipeline.should_precompile():
            # warm the window's shapes now, in the background: the first
            # window arrives only after `duration` seconds of capture, and
            # the lock makes an earlier caller wait for the warmup
            self._warmup_thread = threading.Thread(target=lambda: self._pipeline_for(self._frame_hw), daemon=True)
            self._warmup_thread.start()

    def _reset_carry(self) -> None:
        """No previous window: zero landmarks, no face, on the device."""
        lc = self.models.landmark.cfg.landmark_count
        self._prev_landmarks = torch.zeros((lc, 3), dtype=torch.float32, device=self.device)
        self._has_prev = torch.zeros((), dtype=torch.bool, device=self.device)

    # ------------------------------------------------------------------

    def _pipeline_for(self, frame_hw) -> SegmentPipeline:
        with self._pipeline_lock:
            if self._pipeline is None or self._frame_hw != frame_hw:
                self._frame_hw = frame_hw
                self._pipeline = SegmentPipeline(self.models, self.config, original_frame_hw=frame_hw)
                if self.config.pipeline.should_precompile():
                    # the B=1 window at every token bucket, so that the first
                    # window with a transcript meets no first-call cost
                    with self.timer.stage("precompile"):
                        n = self._pipeline.warmup(
                            batch_sizes=(1,),
                            token_buckets=(32, 128, 512),
                            samples=self.config.pipeline.segment_samples,
                            stream=self._use_packed,
                        )
                    logger.info("warmed %d window shapes in %.1fs", n, self.timer.totals["precompile"])
            return self._pipeline

    def _match_speaker_async(self, waveform: np.ndarray, sr: int):
        """Overlapped speaker match: the diarizer's device embedding starts
        now (``diarize_async``) and the returned ``finalize()`` applies the
        reference's match condition to the labelled turns. A diarizer
        without the async API runs in full at ``finalize()``."""
        if hasattr(self.diarizer, "diarize_async"):
            try:
                fin = self.diarizer.diarize_async(waveform, sr)
            except Exception as e:
                logger.warning("diarization dispatch failed: %s", e)
                return lambda: "unknown"

            def finalize() -> str:
                try:
                    clip_len = len(waveform) / sr
                    for seg in fin():
                        if seg["start"] <= 0 and seg["end"] >= clip_len:
                            return seg["speaker"]
                    return "unknown"
                except Exception as e:
                    logger.warning("diarization failed: %s", e)
                    return "unknown"

            return finalize
        return lambda: self._match_speaker(waveform, sr)

    def _match_speaker(self, waveform: np.ndarray, sr: int) -> str:
        """The reference's speaker-match condition, kept as it is: the first
        diarized turn that covers the whole clip, else "unknown"."""
        try:
            clip_len = len(waveform) / sr
            for seg in self.diarizer.diarize(waveform, sr):
                if seg["start"] <= 0 and seg["end"] >= clip_len:
                    return seg["speaker"]
            return "unknown"
        except Exception as e:
            logger.warning("diarization failed: %s", e)
            return "unknown"

    # ------------------------------------------------------------------

    def process_segment(self, video_frames: List[np.ndarray], audio_data: bytes, text: str) -> Dict:
        """One streaming window → the reference's output dict."""
        try:
            cfg = self.config
            sr = cfg.streaming.sample_rate
            samples = cfg.pipeline.segment_samples

            try:
                with self.timer.stage("pcm_convert"):
                    waveform = pcm16_bytes_to_float(audio_data)
            except Exception as e:
                logger.error("audio conversion failed: %s", e)
                return dict(EMPTY_STREAMING_OUTPUT)

            face_avail = len(video_frames) > 0
            audio_avail = waveform.size > 0
            text_avail = bool(text and text.strip())

            frame = video_frames[0] if face_avail else np.zeros((480, 640, 3), np.uint8)
            # the pipeline first: a warmup still running in the background
            # finishes before this window's device work starts (the f32
            # precision switches are process-wide)
            pipeline = self._pipeline_for(frame.shape[:2])

            # the speaker match overlaps the window's dispatch and fetch: its
            # embedding starts now and is finalised before the output is built
            speaker_finalize = self._match_speaker_async(waveform, sr) if waveform.size else None

            size = self.models.landmark.cfg.frame_size
            token_cap = min(cfg.text.max_length, self.models.text.cfg.max_positions)

            # the shortest sufficient token bucket
            with self.timer.stage("tokenize"):
                encoding = self.models.tokenizer.encode(text, token_cap) if text_avail else None
            needed = int(encoding[1].sum()) if encoding is not None else 1
            tokens = next((t for t in (32, 128, 512) if needed <= t <= token_cap), token_cap)

            with self.timer.stage("frame_preprocess"):
                frames_u8 = preprocess_frame(frame, size)
            # raw PCM16, padded or cut to the static window: the graph divides
            # by the same 32768 as pcm16_bytes_to_float
            pcm = np.frombuffer(audio_data, np.int16)[:samples]
            if pcm.shape[0] < samples:
                pcm = np.pad(pcm, (0, samples - pcm.shape[0]))
            if encoding is not None:
                ids, mask = encoding
                ids, mask = ids[:tokens], mask[:tokens]
                completeness = text_completeness(text)
                relevance = text_relevance(text)
            else:
                ids = np.zeros(tokens, np.int32)
                mask = np.zeros(tokens, np.int32)
                completeness = relevance = 0.0

            if self._use_packed:
                # one host→device copy per window
                with self.timer.stage("pack"):
                    packed = pack_stream_inputs(
                        frames_u8, pcm, ids, mask, face_avail, audio_avail, text_avail, completeness, relevance
                    )
                try:
                    with self.timer.stage("dispatch"):
                        out, carry = pipeline.run_stream(packed, self._prev_landmarks, self._has_prev)
                except Exception as e:
                    logger.warning("packed dispatch failed (%s); falling back to run()", e)
                    self._use_packed = False
            if not self._use_packed:
                inp = SegmentInputs.zeros(self.models, 1, samples=samples, tokens=tokens)
                inp.frames[0] = frames_u8
                inp.audio[0] = fixed_window(waveform, samples)
                inp.face_avail[0] = face_avail
                inp.audio_avail[0] = audio_avail
                inp.text_avail[0] = text_avail
                if encoding is not None:
                    inp.token_ids[0] = ids
                    inp.token_mask[0] = mask
                    inp.completeness[0] = completeness
                    inp.relevance[0] = relevance
                inp.prev_landmarks = self._prev_landmarks
                inp.has_prev = self._has_prev
                with self.timer.stage("dispatch"):
                    out, carry = pipeline.run(inp)
            # the carry stays on the device: the next window's dispatch
            # takes it without a round trip through the host
            self._prev_landmarks, self._has_prev = carry

            # the hostpack first (the window's device wait), the speaker after
            with self.timer.stage("fetch"):
                cols = unpack_hostpack(to_host_async(out["hostpack"])())
            with self.timer.stage("speaker_wait"):
                speaker_id = speaker_finalize() if speaker_finalize is not None else "unknown"
            with self.timer.stage("build_output"):
                return self._build_output(cols, face_avail, audio_avail, text_avail, speaker_id)
        except Exception as e:
            logger.error("segment processing failed: %s", e, exc_info=True)
            return dict(EMPTY_STREAMING_OUTPUT)

    def _build_output(self, cols, face_avail, audio_avail, text_avail, speaker_id):
        """The reference's output dict from the hostpack's host columns."""
        # the fallback chain: the fused 7-vector with two modalities or
        # more, else the raw vector of the one there is
        n_avail = int(face_avail) + int(audio_avail) + int(text_avail)
        fused_key = (
            "fused"
            if n_avail >= 2
            else "face27"
            if face_avail
            else "audio31"
            if audio_avail
            else "text783"
            if text_avail
            else None
        )

        face = None
        if face_avail:
            f27, q = cols["s_face27"][0], cols["s_face_quality"][0]
            pos = f27[23:27]
            face = FaceAnalysis(
                speaker_id=speaker_id,
                emotion_probs=f27[0:7],
                micro_expressions=f27[7:12],
                gaze_direction=f27[12:15],
                muscle_tension=f27[15:19],
                movement_patterns=f27[19:23],
                face_position={"x": int(pos[0]), "y": int(pos[1]), "w": int(pos[2]), "h": int(pos[3])},
                detection_confidence=float(q[0]),
                landmark_quality=float(q[1]),
                expression_quality=float(q[2]),
                movement_quality=float(q[3]),
            )
        audio = None
        if audio_avail:
            a31 = cols["s_audio31"][0]
            q = a31[27:31]
            audio = AudioAnalysis(
                speaker_id=speaker_id,
                emotion_probs=a31[0:8],
                pitch=a31[8:9],
                intensity=a31[9:10],
                timbre=a31[10:23],
                speech_rate=a31[23:24],
                rhythm=a31[24:27],
                audio_quality=float(q[0]),
                signal_noise_ratio=float(q[1]),
                clarity=float(q[2]),
                consistency=float(q[3]),
            )
        text = None
        if text_avail:
            t783 = cols["s_text783"][0]
            q = t783[779:783]
            text = TextAnalysis(
                speaker_id=speaker_id,
                emotion_probs=t783[0:7],
                sarcasm_score=t783[7:8],
                humor_score=t783[8:9],
                polarity=t783[9:10],
                intensity=t783[10:11],
                context_embedding=t783[11:779],
                text_quality=float(q[0]),
                coherence=float(q[1]),
                completeness=float(q[2]),
                relevance=float(q[3]),
            )

        fused_vector = cols[fused_key][0] if fused_key else None
        weights = self._pipeline.weights() if self._pipeline else None
        return build_streaming_output(face, audio, text, fused_vector, weights, speaker_id)

    # ------------------------------------------------------------------

    def _live_text(self, audio_bytes: bytes) -> str:
        """The window's transcript with ``live_transcription`` on, else ""
        (the reference's live text). A failed transcription gives "": the
        text modality then takes its default vector."""
        if not self.config.streaming.live_transcription:
            return ""
        try:
            if self.transcriber is None:
                from msa_tpu_torch.host.transcription import make_transcriber

                self.transcriber = make_transcriber(
                    self.config.transcription.model,
                    self.config.transcription.language,
                    scale=self.config.pipeline.model_scale,
                    device=self.device,
                )
            waveform = pcm16_bytes_to_float(audio_bytes)
            return self.transcriber.transcribe(waveform, self.config.streaming.sample_rate)
        except Exception as e:
            logger.warning("live transcription failed: %s", e)
            return ""

    def start_capture(self):
        if self.frame_source is None:
            self.frame_source = Cv2FrameSource(self.config.streaming.video_source)
        if self.audio_source is None:
            try:
                self.audio_source = PyAudioSource(
                    self.config.streaming.sample_rate, self.config.streaming.channels, self.config.streaming.chunk_size
                )
            except Exception as e:
                logger.warning("no microphone available (%s); synthetic silence", e)
                self.audio_source = SyntheticAudioSource(self.config.streaming.sample_rate)
        self.audio_source.start()
        self.is_running = True
        logger.info("capture started")

    def stop_capture(self):
        self.is_running = False
        if self.frame_source:
            self.frame_source.close()
        if self.audio_source:
            self.audio_source.close()
        logger.info("capture stopped")

    def run(
        self,
        duration: float = 5.0,
        callback: Optional[Callable[[Dict], None]] = None,
        max_segments: Optional[int] = None,
        time_fn: Callable[[], float] = time.monotonic,
        record_path: Optional[str] = None,
        warmup: bool = True,
    ):
        """The capture loop. ``max_segments`` stops after that many windows;
        ``time_fn`` makes the pacing injectable; a synthetic frame source
        ends the loop when it is exhausted, and makes a window of every
        ``MAX_VIDEO_BUFFER`` frames. ``record_path`` writes the captured
        video (cv2). With ``warmup``, one window on the first frame runs
        before the loop at the capture's resolution (its result is
        dropped and the carry reset)."""
        self.start_capture()
        start = time_fn()
        video_buffer: List[np.ndarray] = []
        segments_done = 0
        writer = None
        if warmup:
            first = self.frame_source.read()
            if first is not None:
                video_buffer.append(first)  # the peeked frame stays in the buffer
                try:
                    pcm = np.zeros(1600, np.int16).tobytes()
                    self.process_segment([first], pcm, "")
                    self._reset_carry()
                except Exception as e:
                    logger.warning("warmup failed: %s", e)
                start = time_fn()  # the warmup is not billed to the window
        try:
            while self.is_running:
                frame = self.frame_source.read()
                if frame is None:
                    if isinstance(self.frame_source, SyntheticFrameSource):
                        break
                    logger.warning("frame capture failed")
                    continue
                if record_path:
                    if writer is None:
                        import cv2

                        h, w = frame.shape[:2]
                        writer = cv2.VideoWriter(record_path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (w, h))
                    writer.write(frame)
                if len(video_buffer) >= self.MAX_VIDEO_BUFFER:
                    video_buffer.pop(0)
                video_buffer.append(frame)

                synthetic = isinstance(self.frame_source, SyntheticFrameSource)
                due = (time_fn() - start >= duration) or (synthetic and len(video_buffer) >= self.MAX_VIDEO_BUFFER)
                if due:
                    audio_bytes = self.audio_source.drain()
                    if audio_bytes:
                        # text="" live, as the reference; live_transcription
                        # runs the window through the configured ASR
                        text = self._live_text(audio_bytes)
                        result = self.process_segment(video_buffer, audio_bytes, text)
                        vis = self.visualizer.visualize(frame, result)
                        if self.show_window:
                            import cv2

                            cv2.imshow(self.visualizer.window_name, vis)
                            if cv2.waitKey(1) & 0xFF == ord("q"):
                                break
                        if callback:
                            callback(result)
                        segments_done += 1
                        if max_segments and segments_done >= max_segments:
                            break
                    video_buffer = []
                    start = time_fn()
        except KeyboardInterrupt:
            logger.info("interrupted by user")
        finally:
            if writer is not None:
                writer.release()
            self.stop_capture()
