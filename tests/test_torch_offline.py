"""The offline processor slice: the port's host inputs and
``OfflineProcessor.process_video`` against the JAX package's on the CPU.

- ``preprocess_frame`` bit-equal to ``cv2.resize(cv2.cvtColor(...),
  INTER_LINEAR)`` over frame sizes up and down, the exact 2× case and odd
  widths;
- a frame archive decoded by cv2 from the JAX tests' mp4, read by the
  port's ``VideoReader``, equal to JAX's ``VideoReader`` on the mp4 at
  times past the end too (cv2's black frame), and the port's cv2 backend on
  the mp4 itself;
- ``slice_windows`` and ``pcm16_to_f32``, native and numpy, equal to JAX's;
- ``WordPieceTokenizer.encode``, ``completeness`` and ``relevance`` equal
  to JAX's;
- ``group_by_speaker`` and ``export_speaker_analysis`` equal to JAX's;
- ``SegmentPipeline.weights`` and ``warmup``;
- the slice as a whole: JAX's ``OfflineProcessor`` and the port's
  (``device="cpu"``) on the JAX tests' synthetic mp4 with its sidecar WAV,
  on JAX's tiny models carried across (the plain f32 path), the shipped
  speaker net, and the stub or the tiny whisper carried across. Segments,
  speakers, transcripts and modalities equal; every vector within 1e-3;
  labels equal except where JAX's top two fused values are within 1e-3;
  callbacks and progress; and a video without audio.
"""

import dataclasses

import jax
import numpy as np
import pytest

from msa_tpu.core import config as JC
from msa_tpu.host import video as JV
from msa_tpu.models import text as JText
from msa_tpu.pipeline import graph as JG
from msa_tpu.processors import offline as JO
from msa_tpu.runtime import native_lib as JN
from msa_tpu_torch.core import config as PC
from msa_tpu_torch.host import video as PV
from msa_tpu_torch.host.audio_io import save_wav
from msa_tpu_torch.models import text as PText
from msa_tpu_torch.models.audio import AudioModelConfig
from msa_tpu_torch.models.face import FaceModelConfig
from msa_tpu_torch.models.text import TextModelConfig
from msa_tpu_torch.pipeline import graph as PG
from msa_tpu_torch.processors import offline as PO
from msa_tpu_torch.runtime import native_lib as PN

import torch_parity  # noqa: F401  (its import shares the CPU among xdist workers)

cv2 = pytest.importorskip("cv2")

SAMPLES = 4000  # the JAX processor tests' tiny window
VEC_ATOL = 1e-3  # the plain f32 path against JAX's (the BASELINE.json contract)
VECTORS = ("face_vec", "audio_vec", "text_vec", "fused_vec", "face_probs", "audio_probs", "text_probs")


# --- frames ----------------------------------------------------------------


@pytest.mark.parametrize(
    "hw,size",
    [
        ((48, 64), 192),  # the JAX tests' frames, up to the landmark net's input
        ((480, 640), 192),  # the black frame's size, down
        ((384, 384), 192),  # exactly 2× down
        ((96, 96), 192),  # exactly 2× up
        ((1080, 1920), 192),
        ((33, 57), 192),  # odd widths
        ((101, 33), 32),  # the tiny models' input
        ((48, 64), 32),
    ],
)
def test_preprocess_frame_is_cv2_bit_for_bit(hw, size):
    frame = np.random.default_rng(hw[0] * 7 + hw[1]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    want = cv2.resize(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB), (size, size), interpolation=cv2.INTER_LINEAR)
    got = PV.preprocess_frame(frame, size)
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, JV.preprocess_frame(frame, size))


def _write_mp4(path, frames, fps=10.0):
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (frames.shape[2], frames.shape[1]))
    for f in frames:
        w.write(f)
    w.release()


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """The JAX processor tests' clip (3 s at 10 fps, 64×48, with a sidecar
    WAV: 0.5 s of quiet, then a tone), its frames as cv2 decodes them in a
    frame archive, and the mute clip."""
    d = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(0)
    _write_mp4(d / "clip.mp4", np.stack([rng.integers(0, 255, size=(48, 64, 3), dtype=np.uint8) for _ in range(30)]))
    sr = 16000
    t = np.arange(3 * sr) / sr
    x = 0.4 * np.sin(2 * np.pi * 220 * t)
    x[: sr // 2] = 0.001 * rng.normal(size=sr // 2)
    save_wav(str(d / "clip.wav"), x, sr)
    _write_mp4(d / "mute.mp4", np.full((20, 48, 64, 3), 128, np.uint8))
    # an 18 s two-voice meeting: several VAD spans, two batches of 4
    _write_mp4(d / "meeting.mp4", rng.integers(0, 255, size=(180, 48, 64, 3), dtype=np.uint8))
    save_wav(str(d / "meeting.wav"), _meeting(18.0, sr), sr)

    for name in ("clip", "meeting"):
        cap = cv2.VideoCapture(str(d / f"{name}.mp4"))
        decoded = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            decoded.append(frame)
        np.savez(d / f"{name}.npz", frames=np.stack(decoded), fps=cap.get(cv2.CAP_PROP_FPS))
        cap.release()
    return d


def _meeting(seconds: float, sr: int) -> np.ndarray:
    """Two harmonic voices (120 and 240 Hz) taking turns of 1.6-2.6 s with
    0.8 s pauses over a quiet noise floor."""
    rng = np.random.default_rng(1)
    n = int(seconds * sr)
    out = 3e-4 * rng.standard_normal(n)
    pos, turn = int(0.3 * sr), 0
    while True:
        m = int(rng.uniform(1.6, 2.6) * sr)
        if pos + m > n:
            return out.astype(np.float32)
        t = np.arange(m) / sr
        f0 = (120.0, 240.0)[turn % 2]
        x = sum(a * np.sin(2 * np.pi * f0 * (h + 1) * t) for h, a in enumerate((1.0, 0.6, 0.3, 0.15)))
        out[pos : pos + m] += 0.25 * x * (1 + 0.4 * np.sin(2 * np.pi * 3.5 * t))
        pos, turn = pos + m + int(0.8 * sr), turn + 1


SEEKS = [-0.5, 0.0, 0.04, 0.05, 0.06, 0.149, 0.15, 0.25, 1.234, 2.84, 2.85, 2.9, 2.949, 2.95, 3.0, 3.5, 10.0]


def test_frame_archive_reads_as_jax_reads_the_mp4(media):
    times = SEEKS + list(np.round(np.arange(0.0, 3.2, 0.07), 4))
    with JV.VideoReader(str(media / "clip.mp4")) as jv, PV.VideoReader(str(media / "clip.npz")) as pv:
        for attr in ("fps", "frame_count", "width", "height", "duration"):
            assert getattr(pv, attr) == getattr(jv, attr), attr
        want, got = jv.frames_at(times), pv.frames_at(times)
    assert len(got) == len(times)
    for t, w, g in zip(times, want, got):
        np.testing.assert_array_equal(g, w, err_msg=f"t={t}")
    black = [t for t, g in zip(times, got) if g.shape == (480, 640, 3)]
    assert black and min(black) >= 2.95  # past the end: cv2's black frame


def test_container_backend_is_jax_reader(media):
    with JV.VideoReader(str(media / "clip.mp4")) as jv, PV.VideoReader(str(media / "clip.mp4")) as pv:
        assert (pv.fps, pv.frame_count, pv.width, pv.height) == (jv.fps, jv.frame_count, jv.width, jv.height)
        for w, g in zip(jv.frames_at(SEEKS), pv.frames_at(SEEKS)):
            np.testing.assert_array_equal(g, w)


def test_container_without_cv2_names_the_file(media, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises ImportError
    with pytest.raises(ImportError, match="clip.mp4"):
        PV.VideoReader(str(media / "clip.mp4"))
    with PV.VideoReader(str(media / "clip.npz")) as pv:  # the archive needs no cv2
        assert pv.frame_count == 30


def test_extract_audio_track_reads_the_sidecar(media, tmp_path):
    want = JV.extract_audio_track(str(media / "clip.mp4"), str(tmp_path), 16000)
    got = PV.extract_audio_track(str(media / "clip.npz"), str(tmp_path), 16000)
    assert got[1] == want[1] == 16000
    np.testing.assert_array_equal(got[0], want[0])
    mute = str(media / "mute.mp4")  # no sidecar: ffmpeg where installed, else None, as JAX's
    assert (PV.extract_audio_track(mute, str(tmp_path), 16000) is None) == (JV.extract_audio_track(mute, str(tmp_path), 16000) is None)


# --- native runtime ----------------------------------------------------------


def test_native_runtime_builds_outside_the_jax_package():
    assert PN.native_available()
    assert PN.BUILD_DIR.name == "_build" and PN.BUILD_DIR.parent.name == "msa_tpu_torch"
    assert PN.SOURCE.exists() and PN.SOURCE.name == "msa_runtime.cpp"


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_slice_windows_and_pcm_match_jax(impl):
    rng = np.random.default_rng(3)
    wave = rng.standard_normal(10_000).astype(np.float32)
    starts = np.array([-100, 0, 2500, 9000, 5000, 7000], np.int64)
    ends = np.array([300, 4000, 2400, 12_000, 5000, 13_000], np.int64)  # clamped, empty, cut and padded ranges
    slice_fn = PN.slice_windows if impl == "native" else PN.slice_windows_numpy
    pcm_fn = PN.pcm16_to_f32 if impl == "native" else PN.pcm16_to_f32_numpy
    np.testing.assert_array_equal(slice_fn(wave, starts, ends, 3000), JN.slice_windows(wave, starts, ends, 3000))
    pcm = rng.integers(-32768, 32768, 5000).astype(np.int16)
    np.testing.assert_array_equal(pcm_fn(pcm), JN.pcm16_to_f32(pcm))


def test_ring_buffer_matches_jax():
    j, p = JN.NativeRingBuffer(1000), PN.NativeRingBuffer(1000)
    x = np.arange(1700, dtype=np.float32)
    assert p.push(x[:900]) == j.push(x[:900]) and p.push(x[900:]) == j.push(x[900:])
    assert len(p) == len(j) == 1000
    np.testing.assert_array_equal(p.pop(333), j.pop(333))
    np.testing.assert_array_equal(p.drain(), j.drain())


# --- text --------------------------------------------------------------------

TEXTS = [
    "Eu estou muito feliz com esta reação!",
    "A emoção e o sentimento: expressão, reação e comportamento.",
    "Ação, coração, não — você está bem? Olá, São Paulo.",
    "",
    "   ",
    "123 abc-def l'água ##sub",
    " ".join(f"palavra{i} falar" for i in range(400)),  # over the 512 cap
]


@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_tokenizer_and_heuristics_match_jax(text, tmp_path):
    for max_length in (32, 512):
        j = JText.WordPieceTokenizer(vocab_size=29794).encode(text, max_length)
        p = PText.WordPieceTokenizer(vocab_size=29794).encode(text, max_length)
        for a, b in zip(p, j):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    small = (PText.WordPieceTokenizer(vocab_size=128).encode(text, 64), JText.WordPieceTokenizer(vocab_size=128).encode(text, 64))
    np.testing.assert_array_equal(small[0][0], small[1][0])
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "Eu", "est", "##ou", "feliz", "a", "##ção", "Ação", "##s"]))
    np.testing.assert_array_equal(
        PText.WordPieceTokenizer(str(vocab)).encode(text, 64)[0], JText.WordPieceTokenizer(str(vocab)).encode(text, 64)[0]
    )
    assert PText.completeness(text) == JText.completeness(text)
    assert PText.relevance(text) == JText.relevance(text)
    assert PText.text_quality(0.5, 0.4, 0.2) == JText.text_quality(0.5, 0.4, 0.2)


# --- grouping and export -----------------------------------------------------


def _segment_dicts():
    rng = np.random.default_rng(5)
    emos = ["feliz", "feliz", "feliz", "triste", "raiva", "raiva", "raiva", "raiva", "neutro"]
    spk = ["SPEAKER_00", "SPEAKER_01", "SPEAKER_00", "SPEAKER_00", "SPEAKER_01", "SPEAKER_01", "SPEAKER_01", "SPEAKER_00", "SPEAKER_00"]
    return [
        {
            "start": float(i),
            "end": float(i) + 0.9,
            "speaker": s,
            "face_vec": rng.random(27).tolist(),
            "audio_vec": rng.random(31).tolist(),
            "text_vec": rng.random(783).tolist(),
            "fused_vec": rng.standard_normal(7).tolist(),
            "fused_emotion": e,
            "transcript": f"texto {i}",
        }
        for i, (e, s) in enumerate(zip(emos, spk))
    ]


def test_grouping_and_export_match_jax():
    segs = _segment_dicts()
    want, got = JO.group_by_speaker(segs), PO.group_by_speaker(segs)
    assert got == want
    assert [g["patterns"] for g in got] == [[], ["Emoção consistente 'raiva' nos segmentos 2-4"]]
    for g, w in zip(got, want):
        assert PO.export_speaker_analysis(g) == JO.export_speaker_analysis(w)
        weights = {"face": 0.5, "audio": 0.25, "text": 0.25}
        assert PO.export_speaker_analysis(g, weights) == JO.export_speaker_analysis(w, weights)
    assert PO.group_by_speaker([]) == JO.group_by_speaker([]) == []


# --- the slice as a whole ----------------------------------------------------


@pytest.fixture(scope="module")
def port_tiny(tiny_models):
    """JAX's tiny models carried into the port."""
    return PG.PipelineModels.from_flax(
        jax.tree_util.tree_map(np.asarray, tiny_models.params_tree()),
        FaceModelConfig.tiny(),
        AudioModelConfig.tiny(),
        TextModelConfig.tiny(),
        {"hidden_dim": 64},
        device="cpu",
    )


def test_pipeline_weights_tokenizer_and_warmup(tiny_models, port_tiny):
    want = JG.SegmentPipeline(tiny_models).weights()
    pipe = PG.SegmentPipeline(port_tiny)
    got = pipe.weights()
    assert list(got) == list(want) and all(abs(got[k] - want[k]) <= 1e-7 for k in want)
    assert pipe.weights() is got  # cached
    assert port_tiny.tokenizer.vocab_size == tiny_models.tokenizer.vocab_size == 128
    # the tiny text model has 64 positions: buckets 32 and the cap, 64
    assert pipe.warmup(batch_sizes=(1, 3), samples=SAMPLES) == 4
    stream = PG.SegmentPipeline(port_tiny, PC.SystemConfig(pipeline=PC.PipelineConfig(segment_samples=SAMPLES)))
    assert stream.warmup(batch_sizes=(1,), samples=SAMPLES, stream=True) == 2


def _configs(tmp_path):
    """The JAX processor tests' tiny config, in each package's classes."""

    def make(C):
        return C.SystemConfig(
            pipeline=C.PipelineConfig(segment_samples=SAMPLES, batch_size=4, model_scale="tiny"),
            dirs=C.DirectoryConfig(*(str(tmp_path / k) for k in ("data", "ckpt", "out", "tmp"))),
        )

    return make(JC), make(PC)


def _transcribers(kind):
    if kind != "whisper":
        return None, None  # the tiny scale's "auto": the stub
    from msa_tpu.host import transcription as JT
    from msa_tpu.models import whisper as JW
    from msa_tpu_torch.host import transcription as PT
    from msa_tpu_torch.models import whisper as PW

    params = JW.init_params(JW.WhisperConfig.tiny(), 0)
    model = PW.whisper_from_flax(PW.WhisperConfig.tiny(), jax.tree_util.tree_map(np.asarray, params), "cpu")
    return JT.JaxWhisperTranscriber(params=params, max_len=8), PT.WhisperTranscriber(model=model, max_len=8, device="cpu")


def _run(proc, path):
    per_segment, progress, errors = [], [], []
    grouped = proc.process_video(path, on_result=per_segment.append, on_error=errors.append, on_progress=progress.append)
    assert not errors, errors
    return grouped, per_segment, progress


@pytest.fixture(scope="module", params=["stub", "whisper", "meeting"])
def runs(request, media, tiny_models, port_tiny, tmp_path_factory):
    """JAX's processor on the mp4 and the port's on its frame archive, with
    the stub or the tiny whisper; "meeting" is the two-voice clip (stub)."""
    jcfg, pcfg = _configs(tmp_path_factory.mktemp("dirs"))
    jt, pt = _transcribers(request.param)
    jproc = JO.OfflineProcessor(config=jcfg, models=tiny_models, transcriber=jt)
    pproc = PO.OfflineProcessor(config=pcfg, models=port_tiny, device="cpu", transcriber=pt)
    name = "meeting" if request.param == "meeting" else "clip"
    return request.param, _run(jproc, str(media / f"{name}.mp4")), _run(pproc, str(media / f"{name}.npz")), pproc


def _flat(grouped):
    return sorted((s for g in grouped for s in g["raw_analysis"]), key=lambda s: s["start"])


def test_process_video_matches_jax(runs):
    kind, (jgrouped, jsegs, _), (pgrouped, psegs, _), _ = runs
    want, got = _flat(jgrouped), _flat(pgrouped)
    assert want and len(got) == len(want)
    assert [g["person"] for g in pgrouped] == [g["person"] for g in jgrouped]
    assert [(g["dominant_emotion"], g["patterns"]) for g in pgrouped] == [(g["dominant_emotion"], g["patterns"]) for g in jgrouped] or any(
        a["fused_emotion"] != b["fused_emotion"] for a, b in zip(got, want)
    )
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("start", "end", "speaker", "transcript", "modalities"):
            assert g[key] == w[key], key
        for key in VECTORS:
            err = np.abs(np.asarray(g[key]) - np.asarray(w[key])).max()
            assert err <= VEC_ATOL, f"{kind} {key}: {err:.3e}"
        assert np.isfinite(g["fused_vec"]).all()
        if g["fused_emotion"] != w["fused_emotion"]:
            top2 = np.sort(np.asarray(w["fused_vec"]))[-2:]
            assert top2[1] - top2[0] <= VEC_ATOL, f"{kind}: label {g['fused_emotion']} != {w['fused_emotion']}"
        for key in ("face_probs", "audio_probs", "text_probs"):
            assert abs(sum(g[key]) - 1.0) <= 1e-5
    if kind == "meeting":  # two batches: the landmark carry crosses a batch, the speaker net labels
        assert len(got) > 4 and len({s["speaker"] for s in got}) >= 2
    if kind == "whisper":  # the transcripts flow into the text branch
        assert any(s["transcript"] for s in got)
        live = [s for s in got if s["transcript"]]
        assert all(s["modalities"] & 1 for s in live) and np.abs(np.asarray(live[0]["text_vec"][11:779])).sum() > 0


def test_process_video_callbacks(runs):
    _, (_, jsegs, jprog), (pgrouped, psegs, pprog), proc = runs
    assert len(psegs) == len(jsegs) == sum(len(g["raw_analysis"]) for g in pgrouped)
    assert pprog == jprog and pprog[-1] == pytest.approx(1.0)
    assert set(proc.timer.summary()) >= {"audio_extract", "diarize", "audio_window", "dispatch", "fetch", "frame_preprocess"}


def test_process_video_errors_reach_on_error(port_tiny, tmp_path):
    _, pcfg = _configs(tmp_path)
    proc = PO.OfflineProcessor(config=pcfg, models=port_tiny, device="cpu")
    errors = []
    assert proc.process_video(str(tmp_path / "absent.npz"), on_error=errors.append) == []
    assert len(errors) == 1 and isinstance(errors[0], OSError)
    with pytest.raises(ValueError, match="the models are on cpu"):
        PO.OfflineProcessor(config=pcfg, models=port_tiny, device="meta")


def test_process_video_without_audio_matches_jax(media, tiny_models, port_tiny, tmp_path):
    jcfg, pcfg = _configs(tmp_path)
    jres = JO.OfflineProcessor(config=jcfg, models=tiny_models).process_video(str(media / "mute.mp4"))
    pres = PO.OfflineProcessor(config=pcfg, models=port_tiny, device="cpu").process_video(str(media / "mute.mp4"))
    want, got = _flat(jres), _flat(pres)
    assert want and [(s["start"], s["end"], s["modalities"]) for s in got] == [(s["start"], s["end"], s["modalities"]) for s in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["audio_vec"][:8], 1 / 8, atol=1e-6)
        np.testing.assert_allclose(g["audio_vec"][8:], 0.0, atol=1e-6)
        for key in VECTORS:
            assert np.abs(np.asarray(g[key]) - np.asarray(w[key])).max() <= VEC_ATOL, key
