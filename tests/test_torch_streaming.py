"""The streaming slice: the result schema, the overlay, the streaming
processor and the command line of the port against the JAX package's on
the CPU.

- the eight result dataclasses (fields and order), ``build_streaming_output``
  and ``EMPTY_STREAMING_OUTPUT`` equal to JAX's; ``to_dict``, ``get`` and
  ``[]`` agree;
- ``SyntheticFrameSource`` and ``SyntheticAudioSource`` byte-equal to
  JAX's over several reads and drains, and at exhaustion;
- ``StreamingVisualizer.visualize`` and ``draw_emotion_bars`` bit-equal to
  JAX's images on the same result (one process: the speaker colour comes
  from ``hash()``), and the frame as it is without cv2;
- ``process_segment`` over four windows that carry the movement state
  (face + audio + text, face + audio, audio only, face only) and a headless
  ``run()``, with and without live transcription, against JAX's processor
  fed the same windows, on JAX's tiny models carried across (the plain f32
  path): every key equal, every vector within 1e-3 (the BASELINE.json
  contract), ``weights`` within 1e-7, the same speaker ids and the fallback
  chain's vector lengths;
- the failure contract (JAX's ``tests/test_failure_injection.py``): a
  failing graph gives the empty dict, a failing diarizer "unknown", a
  failing packed dispatch the ``run`` path, once and for good;
- warmup in the constructor's background thread;
- the CLI's offline mode on a frame archive against JAX's CLI on the mp4,
  and its streaming mode on synthetic capture.
"""

import dataclasses
import itertools
import json
import logging

import numpy as np
import pytest

from msa_tpu import main as JMain
from msa_tpu.core import schema as JS
from msa_tpu.processors import streaming as JSP
from msa_tpu.visualizers import overlay as JOv
from msa_tpu_torch import main as PMain
from msa_tpu_torch.core import schema as PS
from msa_tpu_torch.host.diarization import NeuralDiarizer
from msa_tpu_torch.pipeline import graph as PG
from msa_tpu_torch.processors import streaming as PSP
from msa_tpu_torch.visualizers import overlay as POv
from test_torch_offline import SAMPLES, VEC_ATOL, _configs, media, port_tiny  # noqa: F401 (media, port_tiny: fixtures)

import torch_parity  # noqa: F401  (its import shares the CPU among xdist workers)

cv2 = pytest.importorskip("cv2")

WEIGHTS_ATOL = 1e-7  # the fusion's softmaxed modality weights, host floats on both sides
SCHEMA_KEYS = {"face", "audio", "text", "fused_emotion", "weights", "speaker_id"}


# --- the schema ----------------------------------------------------------------

DATACLASSES = [
    "FaceAnalysis",
    "AudioAnalysis",
    "TextAnalysis",
    "SegmentAnalysis",
    "SpeakerAnalysis",
    "VideoAnalysis",
    "StreamingAnalysis",
    "CompleteAnalysisResult",
]


@pytest.mark.parametrize("name", DATACLASSES)
def test_dataclass_fields_match_jax(name):
    want, got = getattr(JS, name), getattr(PS, name)
    assert [(f.name, f.default) for f in dataclasses.fields(got)] == [(f.name, f.default) for f in dataclasses.fields(want)]


def _analyses(S, rng):
    face = S.FaceAnalysis(
        speaker_id="SPEAKER_01",
        emotion_probs=rng.random((1, 7)).astype(np.float32),
        micro_expressions=rng.random(5).astype(np.float32),
        gaze_direction=rng.random(3).astype(np.float32),
        muscle_tension=rng.random(4).astype(np.float32),
        movement_patterns=rng.random(4).astype(np.float32),
        face_position={"x": 3, "y": 4, "w": 20, "h": 22},
        detection_confidence=0.9,
        landmark_quality=0.8,
        expression_quality=0.7,
        movement_quality=0.6,
    )
    audio = S.AudioAnalysis(
        speaker_id="SPEAKER_01",
        emotion_probs=rng.random(8).astype(np.float32),
        pitch=rng.random(1).astype(np.float32),
        intensity=rng.random(1).astype(np.float32),
        timbre=rng.random(13).astype(np.float32),
        speech_rate=rng.random(1).astype(np.float32),
        rhythm=rng.random(3).astype(np.float32),
        audio_quality=0.5,
        signal_noise_ratio=12.0,
        clarity=0.4,
        consistency=0.3,
    )
    text = S.TextAnalysis(
        speaker_id="SPEAKER_01",
        emotion_probs=rng.random(7).astype(np.float32),
        sarcasm_score=rng.random(1).astype(np.float32),
        humor_score=rng.random(1).astype(np.float32),
        polarity=rng.random(1).astype(np.float32),
        intensity=rng.random(1).astype(np.float32),
        context_embedding=rng.random(768).astype(np.float32),
        text_quality=0.2,
        coherence=0.1,
        completeness=0.05,
        relevance=0.0,
    )
    return face, audio, text


def _assert_same_tree(got, want, path=""):
    """Equal structure and values, arrays bit for bit."""
    assert type(got) is type(want), f"{path}: {type(got)} != {type(want)}"
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("present", ["fat", "fa", "f", "a", "t", ""])
def test_build_streaming_output_matches_jax(present):
    j = _analyses(JS, np.random.default_rng(7))
    p = _analyses(PS, np.random.default_rng(7))
    keep = [m in present for m in "fat"]
    jargs = [x if k else None for x, k in zip(j, keep)]
    pargs = [x if k else None for x, k in zip(p, keep)]
    fused = np.random.default_rng(8).random(7 if len(present) >= 2 else 27).astype(np.float32) if present else None
    weights = {"face": 0.4, "audio": 0.3, "text": 0.3}
    want = JS.build_streaming_output(*jargs, fused, weights, "SPEAKER_01")
    got = PS.build_streaming_output(*pargs, fused, weights, "SPEAKER_01")
    _assert_same_tree(got, want)
    assert PS.EMPTY_STREAMING_OUTPUT == JS.EMPTY_STREAMING_OUTPUT and list(PS.EMPTY_STREAMING_OUTPUT) == list(got)
    for pj, pp in zip(j, p):  # DictMixin
        _assert_same_tree(pp.to_dict(), pj.to_dict())
        assert pp["speaker_id"] == pj["speaker_id"] and pp.get("absent", 5) == pj.get("absent", 5) == 5


# --- the sources ---------------------------------------------------------------


@pytest.mark.parametrize("n,hw,seed", [(5, (48, 64), 0), (3, (480, 640), 25), (0, (8, 8), 1)])
def test_synthetic_frame_source_matches_jax(n, hw, seed):
    j, p = JSP.SyntheticFrameSource(n, *hw, seed=seed), PSP.SyntheticFrameSource(n, *hw, seed=seed)
    for _ in range(n + 2):  # two reads past the end
        a, b = p.read(), j.read()
        assert (a is None) == (b is None)
        if b is not None:
            assert a.dtype == b.dtype == np.uint8 and a.tobytes() == b.tobytes()
    assert p.read() is None
    p.close()


@pytest.mark.parametrize("chunk,seed", [(0.25, 0), (1.0, 3), (0.3, 9)])
def test_synthetic_audio_source_matches_jax(chunk, seed):
    j, p = JSP.SyntheticAudioSource(chunk_seconds=chunk, seed=seed), PSP.SyntheticAudioSource(chunk_seconds=chunk, seed=seed)
    p.start()
    for _ in range(4):
        a, b = p.drain(), j.drain()
        assert len(a) == 2 * int(16000 * chunk) and a == b
    p.close()


def test_cv2_frame_source_matches_jax(media):
    """The camera adapter on a file (cv2.VideoCapture takes a path too)."""
    j, p = JSP.Cv2FrameSource(str(media / "clip.mp4")), PSP.Cv2FrameSource(str(media / "clip.mp4"))
    n = 0
    while True:
        a, b = p.read(), j.read()
        assert (a is None) == (b is None)
        if b is None:
            break
        np.testing.assert_array_equal(a, b)
        n += 1
    assert n == 30
    p.close()
    j.close()


class _FakeStream:
    def __init__(self, callback):
        self.callback = callback
        self.state = "open"

    def start_stream(self):
        self.state = "started"

    def stop_stream(self):
        self.state = "stopped"

    def close(self):
        self.state = "closed"


class _FakePyAudio:
    """Just the surface of pyaudio the microphone adapter uses."""

    paInt16, paContinue = 8, 0

    class PyAudio:
        def open(self, **kw):
            assert kw["input"] and kw["format"] == _FakePyAudio.paInt16
            self.stream = _FakeStream(kw["stream_callback"])
            return self.stream

        def terminate(self):
            self.stream.state = "terminated"


def test_pyaudio_source_matches_jax(monkeypatch):
    """The microphone adapter: PortAudio's callback pushes into the native
    ring buffer; a drain gives back PCM16, as JAX's."""
    import sys

    monkeypatch.setitem(sys.modules, "pyaudio", _FakePyAudio)
    j, p = JSP.PyAudioSource(sample_rate=100), PSP.PyAudioSource(sample_rate=100)  # 6000 samples of ring
    p.start()
    assert p._stream.state == "started"
    rng = np.random.default_rng(4)
    for n in (1024, 3000, 4000):  # the last push overflows the ring: the oldest samples go
        chunk = rng.integers(-32768, 32768, n).astype(np.int16).tobytes()
        assert p._cb(chunk, n, None, 0) == j._cb(chunk, n, None, 0) == (chunk, _FakePyAudio.paContinue)
        if n == 3000:
            a, b = p.drain(), j.drain()
            assert len(a) == 2 * 4024 and a == b
    a, b = p.drain(), j.drain()
    assert len(a) == 2 * 4000 and a == b
    assert p.drain() == j.drain() == b""
    p.close()
    assert p._stream.state == "terminated"


# --- the processors ----------------------------------------------------------


@pytest.fixture(scope="module")
def procs(tiny_models, port_tiny, tmp_path_factory):
    """JAX's streaming processor and the port's (``device="cpu"``) on the
    tiny config and JAX's tiny models; each test resets their state."""
    jcfg, pcfg = _configs(tmp_path_factory.mktemp("stream"))
    j = JSP.StreamingProcessor(config=jcfg, models=tiny_models)
    p = PSP.StreamingProcessor(config=pcfg, models=port_tiny, device="cpu")
    assert isinstance(p.diarizer, NeuralDiarizer) and p.diarizer.device.type == "cpu"
    assert j._warmup_thread is None and p._warmup_thread is None  # the tiny scale asks for no warmup
    return j, p


def _reset(j, p):
    lc = j.models.landmark.cfg.landmark_count
    j._prev_landmarks, j._has_prev = np.zeros((lc, 3), np.float32), np.asarray(False)
    p._reset_carry()


def _assert_same_output(got, want, tag=""):
    """The port's window dict against JAX's: the same keys and Nones, every
    vector and quality within VEC_ATOL, weights within WEIGHTS_ATOL, the
    speaker id and the face box equal."""
    assert set(got) == set(want) == SCHEMA_KEYS, tag
    assert got["speaker_id"] == want["speaker_id"], tag
    for m in ("face", "audio", "text"):
        assert (got[m] is None) == (want[m] is None), f"{tag} {m}"
        if want[m] is None:
            continue
        assert list(got[m]) == list(want[m]), f"{tag} {m}"
        for k, w in want[m].items():
            g = got[m][k]
            if k == "face_position":
                assert g == w, f"{tag} face_position {g} != {w}"
            elif isinstance(w, dict):  # the quality floats
                assert list(g) == list(w) and all(abs(g[q] - w[q]) <= VEC_ATOL for q in w), f"{tag} {m}.{k}: {g} != {w}"
            else:
                assert g.shape == np.asarray(w).shape, f"{tag} {m}.{k}"
                err = np.abs(g - np.asarray(w)).max()
                assert err <= VEC_ATOL, f"{tag} {m}.{k}: {err:.3e}"
    assert (got["fused_emotion"] is None) == (want["fused_emotion"] is None), tag
    if want["fused_emotion"] is not None:
        assert got["fused_emotion"].shape == want["fused_emotion"].shape, tag
        err = np.abs(got["fused_emotion"] - np.asarray(want["fused_emotion"])).max()
        assert err <= VEC_ATOL, f"{tag} fused_emotion: {err:.3e}"
    assert (got["weights"] is None) == (want["weights"] is None), tag
    if want["weights"] is not None:
        assert list(got["weights"]) == list(want["weights"])
        assert all(abs(got["weights"][k] - want["weights"][k]) <= WEIGHTS_ATOL for k in want["weights"]), tag
        assert abs(sum(got["weights"].values()) - 1.0) <= 1e-6


def _tone() -> bytes:
    """0.96 s of a 200 Hz tone: 32 VAD frames of 30 ms, each the same
    samples, so that the VAD's one turn covers the whole clip and the
    reference's match condition names its speaker."""
    t = np.arange(15_360) / 16_000
    return (0.3 * 32767 * np.sin(2 * np.pi * 200.0 * t)).astype(np.int16).tobytes()


def _windows():
    """Four windows: face + audio + text, face + audio, audio only (no
    frames), face only (no audio)."""
    frames = PSP.SyntheticFrameSource(4, 48, 64, seed=5)
    audio = PSP.SyntheticAudioSource(chunk_seconds=1.0, seed=6)
    return [
        ([frames.read()], _tone(), "Eu estou muito feliz com esta reação!"),
        ([frames.read(), frames.read()], audio.drain(), ""),
        ([], _tone(), "   "),
        ([frames.read()], b"", ""),
    ]


def test_process_segment_carries_state_as_jax(procs):
    j, p = procs
    _reset(j, p)
    outs = []
    for i, window in enumerate(_windows()):
        want, got = j.process_segment(*window), p.process_segment(*window)
        _assert_same_output(got, want, f"window {i}")
        outs.append(got)
        # the carry: the previous window's landmarks and detection, as JAX's
        np.testing.assert_allclose(p._prev_landmarks.numpy(), np.asarray(j._prev_landmarks), atol=VEC_ATOL)
        assert bool(p._has_prev) == bool(j._has_prev)
    assert [o["fused_emotion"].shape[0] for o in outs] == [7, 7, 31, 27]
    assert [o["text"] is not None for o in outs] == [True, False, False, False]
    assert outs[2]["face"] is None and outs[3]["audio"] is None
    assert [o["speaker_id"] for o in outs] == ["SPEAKER_00", "unknown", "SPEAKER_00", "unknown"]
    assert p._use_packed and j._use_packed
    assert set(p.timer.summary()) >= {"pcm_convert", "tokenize", "frame_preprocess", "pack", "dispatch", "fetch", "speaker_wait", "build_output"}


def _run(proc, max_segments=2):
    """One headless run() on the package's own synthetic capture, paced by
    a clock that advances a second a read, so that the windows do not
    depend on the machine's speed."""
    sources = JSP if isinstance(proc, JSP.StreamingProcessor) else PSP
    proc.frame_source = sources.SyntheticFrameSource(40, 48, 64)
    proc.audio_source = sources.SyntheticAudioSource(chunk_seconds=0.25)
    outputs = []
    proc.run(duration=0.01, callback=outputs.append, max_segments=max_segments, time_fn=itertools.count().__next__)
    assert not proc.is_running
    return outputs


def test_run_headless_matches_jax(procs):
    j, p = procs
    want, got = _run(j), _run(p)
    assert len(got) == len(want) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same_output(g, w, f"window {i}")
        assert g["text"] is None and g["fused_emotion"].shape == (7,)  # text="" live, as the reference


class _FakeTranscriber:
    def transcribe(self, waveform, sample_rate):
        return "que bom ver você hoje"


class _ExplodingTranscriber:
    def transcribe(self, waveform, sample_rate):
        raise RuntimeError("asr down")


@pytest.mark.parametrize("transcriber", [_FakeTranscriber, _ExplodingTranscriber])
def test_run_live_transcription_matches_jax(procs, transcriber):
    j, p = procs
    live = {"streaming": None}
    saved = (j.config, p.config, j.transcriber, p.transcriber)
    try:
        for proc in (j, p):
            live["streaming"] = dataclasses.replace(proc.config.streaming, live_transcription=True)
            proc.config = dataclasses.replace(proc.config, streaming=live["streaming"])
            proc.transcriber = transcriber()
        want, got = _run(j, max_segments=1), _run(p, max_segments=1)
    finally:
        j.config, p.config, j.transcriber, p.transcriber = saved
    assert len(got) == len(want) == 1
    _assert_same_output(got[0], want[0])
    assert (got[0]["text"] is not None) == (transcriber is _FakeTranscriber)


def test_overlay_matches_jax(procs):
    _, p = procs
    p._reset_carry()
    frame = np.random.default_rng(0).integers(0, 255, (48, 64, 3), dtype=np.uint8)
    result = p.process_segment([frame], PSP.SyntheticAudioSource(chunk_seconds=0.25).drain(), "tudo bem")
    assert result["text"] is not None
    jv, pv = JOv.StreamingVisualizer(), POv.StreamingVisualizer()
    for res in (result, dict(result, face=dict(result["face"], face_position={"x": 5, "y": 6, "w": 30, "h": 20})),
                dict(result, speaker_id="SPEAKER_03"), PS.EMPTY_STREAMING_OUTPUT):
        got, want = pv.visualize(frame, res), jv.visualize(frame, res)
        assert got.dtype == want.dtype and got.shape == frame.shape
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(pv.visualize(frame, result), frame)
    assert pv.visualize(frame, None) is frame
    big = np.zeros((200, 200, 3), np.uint8)
    probs = np.asarray([0.5, 0.1, 0.1, 0.1, 0.1, 0.05, 0.05])
    np.testing.assert_array_equal(pv.draw_emotion_bars(big, probs), jv.draw_emotion_bars(big, probs))
    np.testing.assert_array_equal(pv.draw_emotion_bars(big, probs, (20, 30), 50, 6), jv.draw_emotion_bars(big, probs, (20, 30), 50, 6))
    assert (pv.draw_emotion_bars(big, probs) != big).any()
    assert POv.PT_COLORS == JOv.PT_COLORS and POv.PT_EMOTIONS == JOv.PT_EMOTIONS
    pv._cv2 = None  # headless: the frame as it is
    assert pv.visualize(frame, result) is frame and pv.draw_emotion_bars(big, probs) is big


# --- the failure contract -------------------------------------------------------


def _port(port_tiny, tmp_path, **kw):
    return PSP.StreamingProcessor(config=_configs(tmp_path)[1], models=port_tiny, device="cpu", **kw)


def test_failing_graph_gives_the_empty_dict(port_tiny, tmp_path, monkeypatch):
    proc = _port(port_tiny, tmp_path)

    def boom(self, *args):
        raise RuntimeError("device graph exploded")

    monkeypatch.setattr(PG.SegmentPipeline, "run", boom)
    monkeypatch.setattr(PG.SegmentPipeline, "run_stream", boom)
    frame = np.zeros((48, 64, 3), np.uint8)
    out = proc.process_segment([frame], PSP.SyntheticAudioSource(chunk_seconds=0.25).drain(), "")
    assert out == PS.EMPTY_STREAMING_OUTPUT and out is not PS.EMPTY_STREAMING_OUTPUT
    assert not proc._use_packed  # the packed dispatch failed, then run() did


class _ExplodingDiarizer:
    def diarize(self, waveform, sample_rate):
        raise RuntimeError("diarizer exploded")


class _ExplodingAsyncDiarizer:
    def diarize_async(self, waveform, sample_rate):
        raise RuntimeError("dispatch exploded")


@pytest.mark.parametrize("diarizer", [_ExplodingDiarizer, _ExplodingAsyncDiarizer])
def test_failing_diarizer_gives_unknown(port_tiny, tmp_path, diarizer):
    proc = _port(port_tiny, tmp_path, diarizer=diarizer())
    frame = np.zeros((48, 64, 3), np.uint8)
    out = proc.process_segment([frame], PSP.SyntheticAudioSource(chunk_seconds=0.25).drain(), "")
    assert out["speaker_id"] == "unknown"
    assert out["fused_emotion"] is not None and out["face"] is not None  # the analysis still ran


def test_failed_packed_dispatch_falls_back_to_run(port_tiny, tmp_path, monkeypatch):
    windows = _windows()
    packed = _port(port_tiny, tmp_path)
    want = [packed.process_segment(*w) for w in windows]
    proc = _port(port_tiny, tmp_path)
    real = PG.SegmentPipeline.run_stream
    calls = []

    def once(self, *args):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("packed upload refused")
        return real(self, *args)

    monkeypatch.setattr(PG.SegmentPipeline, "run_stream", once)
    got = [proc.process_segment(*w) for w in windows]
    assert len(calls) == 1 and not proc._use_packed  # the fallback holds for the windows after
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) and g["speaker_id"] == w["speaker_id"]
        for m in ("face", "audio", "text"):
            assert (g[m] is None) == (w[m] is None)
            for k, v in (w[m] or {}).items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_allclose(g[m][k], v, atol=1e-6, rtol=0, err_msg=f"window {i} {m}.{k}")
        np.testing.assert_allclose(g["fused_emotion"], w["fused_emotion"], atol=1e-6, rtol=0)


def test_the_card_is_asked_for(port_tiny, tmp_path):
    with pytest.raises(ValueError, match="the models are on cpu"):
        PSP.StreamingProcessor(config=_configs(tmp_path)[1], models=port_tiny, device="cuda")
    import inspect

    assert inspect.signature(PSP.StreamingProcessor).parameters["device"].default == "cuda"


# --- warmup ----------------------------------------------------------------------


def test_constructor_warms_every_bucket_in_the_background(port_tiny, tmp_path, monkeypatch):
    pcfg = _configs(tmp_path)[1]
    pcfg = dataclasses.replace(pcfg, pipeline=dataclasses.replace(pcfg.pipeline, precompile=True))
    real = PG.SegmentPipeline.run_stream
    shapes = []

    def counting(self, packed, *carry):
        shapes.append(len(packed))
        return real(self, packed, *carry)

    monkeypatch.setattr(PG.SegmentPipeline, "run_stream", counting)
    proc = PSP.StreamingProcessor(config=pcfg, models=port_tiny, device="cpu")
    assert proc._warmup_thread is not None
    proc._warmup_thread.join(timeout=120)
    assert not proc._warmup_thread.is_alive(), "warmup did not finish"
    # the tiny text model has 64 positions: buckets 32 and the cap, 64, once each
    s = port_tiny.landmark.cfg.frame_size
    assert shapes == [s * s * 3 + 2 * SAMPLES + 8 * t + 20 for t in (32, 64)]
    assert proc.timer.counts["precompile"] == 1 and proc._pipeline.original_frame_hw == (480, 640)
    out = proc.process_segment([np.zeros((480, 640, 3), np.uint8)], np.zeros(SAMPLES, np.int16).tobytes(), "")
    assert out["fused_emotion"] is not None and len(shapes) == 3 and proc.timer.counts["precompile"] == 1


# --- the command line ------------------------------------------------------------


@pytest.fixture
def root_logging():
    """setup_logging replaces the root logger's handlers: put them back."""
    root = logging.getLogger()
    saved = (list(root.handlers), root.level)
    yield
    root.handlers[:] = saved[0]
    root.setLevel(saved[1])


def _cli(main, video, cwd, device, monkeypatch, capsys):
    monkeypatch.chdir(cwd)
    argv = ["--mode", "offline", "--video", str(video), "--output-dir", str(cwd / "out")] + (["--device", device] if device else [])
    assert main(argv) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    lines = (cwd / "out" / "results.json").read_text().splitlines()
    return printed, [json.loads(line) for line in lines]


def test_cli_offline_matches_jax(media, tiny_models, tmp_path, monkeypatch, capsys, root_logging):
    """Both CLIs at MSA_MODEL_SCALE=tiny build the tiny models from the same
    flax init: JAX's takes the shared ``tiny_models`` fixture (PipelineModels.tiny
    at seed 0), the port's rebuilds them in torch. Warmup is off here (JAX
    would compile two more B=8 graphs); test_cli_defaults holds the default."""
    from msa_tpu.pipeline import graph as JG

    def jax_tiny(seed=0):
        assert seed == 0
        return tiny_models

    monkeypatch.setattr(JG.PipelineModels, "tiny", staticmethod(jax_tiny))
    monkeypatch.setenv("MSA_MODEL_SCALE", "tiny")
    monkeypatch.setenv("MSA_PRECOMPILE", "0")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jprinted, want = _cli(JMain.main, media / "clip.mp4", tmp_path / "jax", None, monkeypatch, capsys)
    pprinted, got = _cli(PMain.main, media / "clip.npz", tmp_path / "port", "cpu", monkeypatch, capsys)
    assert pprinted["speakers"] == jprinted["speakers"] >= 1
    assert pprinted["results"] == str(tmp_path / "port" / "out" / "results.json")
    assert want and len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("start", "end", "speaker", "transcript", "modalities"):
            assert g[key] == w[key], key
        for key in ("face_vec", "audio_vec", "text_vec", "fused_vec", "face_probs", "audio_probs", "text_probs"):
            assert np.abs(np.asarray(g[key]) - np.asarray(w[key])).max() <= VEC_ATOL, key
    # the CLI's working directories and log, under the working directory
    assert all((tmp_path / "port" / d).is_dir() for d in ("data", "checkpoints", "output", "temp", "logs"))
    assert list((tmp_path / "port" / "logs").glob("analysis_*.log"))


def test_cli_streaming_on_synthetic_capture(tmp_path, monkeypatch, capsys, root_logging):
    """--mode streaming with the camera and the microphone replaced: no
    camera gives synthetic frames, no PyAudio synthetic silence; the CLI's
    default warmup runs in the constructor's thread."""
    monkeypatch.setenv("MSA_MODEL_SCALE", "tiny")
    monkeypatch.delenv("MSA_PRECOMPILE", raising=False)
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.setattr(PSP, "Cv2FrameSource", lambda source: PSP.SyntheticFrameSource(70, 48, 64))
    monkeypatch.chdir(tmp_path)
    argv = ["--mode", "streaming", "--duration", "3600", "--max-segments", "2", "--output-dir", "res", "--device", "cpu"]
    assert PMain.main(argv) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"results": "res/results.json"}
    lines = [json.loads(line) for line in (tmp_path / "res" / "results.json").read_text().splitlines()]
    assert len(lines) == 2 and all(set(r) == SCHEMA_KEYS and len(r["fused_emotion"]) == 7 for r in lines)


def test_cli_defaults(monkeypatch, tmp_path, root_logging):
    """--device defaults to the card; MSA_PRECOMPILE unset turns warmup on."""
    seen = {}

    class Probe:
        def __init__(self, config, device):
            seen.update(precompile=config.pipeline.precompile, device=device)

        def process_video(self, *a, **k):
            return []

    import msa_tpu_torch.processors.offline as PO

    monkeypatch.setattr(PO, "OfflineProcessor", Probe)
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("MSA_PRECOMPILE", raising=False)
    assert PMain.main(["--mode", "offline", "--video", "absent.npz"]) == 0
    assert seen == {"precompile": True, "device": "cuda"}
    monkeypatch.setenv("MSA_PRECOMPILE", "0")
    assert PMain.main(["--mode", "offline", "--video", "absent.npz"]) == 0
    assert seen == {"precompile": False, "device": "cuda"}
    assert PMain._json_default(np.float32(2.5)) == JMain._json_default(np.float32(2.5)) == 2.5
    assert PMain._json_default(np.arange(3)) == [0, 1, 2] and PMain._json_default(tmp_path) == str(tmp_path)
