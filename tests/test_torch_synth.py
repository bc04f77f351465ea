"""The port's synthetic-supervision generators against the JAX package's,
on the CPU, from the same numpy generators.

Byte-equal: the voices (``random_voice``, ``synth_voice``), the four text
tasks and the OOV context (``text_synth``), the phones, utterances, knot
arrays and spoken clips (``speech_synth``), the template, the landmark and
expression batches (``train_landmarks``, ``face_synth``), the audio-emotion
dataset (``make_dataset``) and a synthetic meeting's frames and WAV
(``synth_av``: the uint8 frames handed to ``cv2.VideoWriter.write``, caught
by a stand-in writer on both sides, and the port's frame archive).

The crops (``render_crop_batch``, ``adversarial_crop_batch``) go through
the port's grayscale, landmark box and bilinear crop, f32 on both sides.
XLA contracts the sample position ``y0 + grid·h − 0.5`` into a fused
multiply-add where torch rounds twice, which moves a bilinear weight by up
to an ulp of the position (2⁻¹⁷ at the 96-pixel frame) and the pixel (in
[0, 1]) by as much: ``CROP_ATOL`` is two such ulps. The adversarial
batch's gamma (0.5–1.9) steepens the map near 0 and its lighting gradient
scales by up to 1.35: ``ADV_ATOL`` is four times ``CROP_ATOL``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from msa_tpu.models import speaker as JS
from msa_tpu.training import face_synth as JFS
from msa_tpu.training import speech_synth as JSS
from msa_tpu.training import synth_av as JAV
from msa_tpu.training import text_synth as JTS
from msa_tpu.training import train_audio_emotion as JAE
from msa_tpu.training import train_landmarks as JTL
from msa_tpu_torch.host.video import VideoReader
from msa_tpu_torch.models import speaker as PS
from msa_tpu_torch.training import face_synth as PFS
from msa_tpu_torch.training import speech_synth as PSS
from msa_tpu_torch.training import synth_av as PAV
from msa_tpu_torch.training import text_synth as PTS
from msa_tpu_torch.training import train_audio_emotion as PAE
from msa_tpu_torch.training import train_landmarks as PTL

import torch_parity  # noqa: F401  (its import shares the CPU among xdist workers)

CROP_ATOL = 2 * 2.0**-17
ADV_ATOL = 4 * CROP_ATOL


def rng(seed=0):
    return np.random.default_rng(seed)


def same_arrays(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_voices_are_byte_equal(seed):
    jv, pv = JS.random_voice(rng(seed)), PS.random_voice(rng(seed))
    assert dataclasses.astuple(jv) == dataclasses.astuple(pv)
    r1, r2 = rng(seed + 10), rng(seed + 10)
    same_arrays(JS.synth_voice(r1, jv, 0.4), PS.synth_voice(r2, pv, 0.4))
    assert r1.integers(1 << 30) == r2.integers(1 << 30)  # the generators end in the same state


@pytest.mark.parametrize("holdout", [False, True])
@pytest.mark.parametrize("task", ["emotion_sentences", "sentiment_sentences", "sarcasm_sentences", "humor_sentences"])
def test_text_tasks_are_equal(task, holdout):
    jt, jl = getattr(JTS, task)(rng(3), 40, holdout=holdout)
    pt, pl = getattr(PTS, task)(rng(3), 40, holdout=holdout)
    assert jt == pt
    same_arrays(jl, pl)


def test_oov_context_and_holdout_split_are_equal():
    texts, _ = JTS.emotion_sentences(rng(4), 30)
    assert JTS.with_oov_context(rng(5), texts) == PTS.with_oov_context(rng(5), texts)
    assert [JTS.oov_word(rng(s)) for s in range(20)] == [PTS.oov_word(rng(s)) for s in range(20)]
    keys = [w for pool in JTS.EMOTION_WORDS for w in pool] + list(JTS.SARCASM_MARKERS)
    assert [JTS._holdout_templates(k) for k in keys] == [PTS._holdout_templates(k) for k in keys]


def test_phones_and_spoken_sentences_are_equal():
    words = [w for pool in JTS.EMOTION_WORDS for w in pool] + ["nhoque", "quero", "guerra", "chá", "ação", "hoje"]
    for w in words:
        assert [dataclasses.astuple(p) for p in JSS.word_to_phones(w)] == [
            dataclasses.astuple(p) for p in PSS.word_to_phones(w)
        ], w
    assert [JSS.spoken_sentence(rng(s), "feliz") for s in range(10)] == [
        PSS.spoken_sentence(rng(s), "feliz") for s in range(10)
    ]


@pytest.mark.parametrize("prosody", [None, 1, 3])
def test_utterances_are_byte_equal(prosody):
    voice = JS.random_voice(rng(6))
    jp = None if prosody is None else JAE.CLASS_PROSODY[prosody]
    pp = None if prosody is None else PAE.CLASS_PROSODY[prosody]
    same_arrays(
        JSS.synth_utterance(rng(7), voice, "estou muito feliz hoje", prosody=jp),
        PSS.synth_utterance(rng(7), PS.VoiceSpec(*dataclasses.astuple(voice)), "estou muito feliz hoje", prosody=pp),
    )


def test_spoken_clip_and_knots_are_byte_equal():
    voice = JS.random_voice(rng(8))
    pvoice = PS.VoiceSpec(*dataclasses.astuple(voice))
    texts = ["me sinto triste", "que dia ótimo"]
    same_arrays(
        JSS.synth_spoken_clip(rng(9), voice, texts, 1.5, prosody=JAE.CLASS_PROSODY[2]),
        PSS.synth_spoken_clip(rng(9), pvoice, texts, 1.5, prosody=PAE.CLASS_PROSODY[2]),
    )
    jk = [JSS.utterance_knots(rng(s), voice, "ele foi tão bravo", 32000) for s in range(3)]
    pk = [PSS.utterance_knots(rng(s), pvoice, "ele foi tão bravo", 32000) for s in range(3)]
    jpack, ppack = JSS.pack_knots(JSS.stack_knots(jk)), PSS.pack_knots(PSS.stack_knots(pk))
    same_arrays(jpack, ppack)
    ju, pu = JSS.unpack_knots(jpack), PSS.unpack_knots(ppack)
    assert list(ju) == list(pu)
    for k in ju:
        same_arrays(ju[k], pu[k])


def test_template_and_landmark_batches_are_byte_equal():
    same_arrays(JTL.make_template(), PTL.make_template())
    tmpl = JTL.make_template()
    j, p = JTL.render_batch(rng(10), 6, 32, tmpl, p_negative=0.4), PTL.render_batch(rng(10), 6, 32, tmpl, p_negative=0.4)
    for f in ("frames", "landmarks", "present"):
        same_arrays(getattr(j, f), getattr(p, f))


@pytest.mark.parametrize("p_negative", [0.0, 0.3])
def test_expression_batches_are_byte_equal(p_negative):
    j = JFS.render_expression_batch(rng(11), 8, 48, p_negative=p_negative, jitter_scale=1.5)
    p = PFS.render_expression_batch(rng(11), 8, 48, p_negative=p_negative, jitter_scale=1.5)
    for f in ("frames", "landmarks", "labels", "present"):
        same_arrays(getattr(j, f), getattr(p, f))
    e = JFS.sample_expression(rng(12), 3)
    assert dataclasses.astuple(e) == dataclasses.astuple(PFS.sample_expression(rng(12), 3))
    same_arrays(JFS.deform_template(JTL.make_template(), e), PFS.deform_template(JTL.make_template(), PFS.Expression(*dataclasses.astuple(e))))


@pytest.mark.parametrize("adversarial", [False, True])
def test_crop_batches_hold_jax_crops(adversarial):
    tmpl = JTL.make_template()
    fn, atol = ("adversarial_crop_batch", ADV_ATOL) if adversarial else ("render_crop_batch", CROP_ATOL)
    r1, r2 = rng(13), rng(13)
    jc, jl = getattr(JFS, fn)(r1, 6, template=tmpl)
    pc, pl = getattr(PFS, fn)(r2, 6, template=tmpl, device="cpu")
    same_arrays(jl, pl)
    assert pc.dtype == np.float32 and pc.shape == jc.shape == (6, 48, 48, 1)
    assert float(np.abs(pc - jc).max()) <= atol
    assert r1.integers(1 << 30) == r2.integers(1 << 30)


@pytest.mark.parametrize("speech_fraction", [0.0, 0.5])
def test_audio_emotion_dataset_is_byte_equal(speech_fraction):
    jw, jl = JAE.make_dataset(rng(14), 4, seconds=0.8, samples=12_000, speech_fraction=speech_fraction)
    pw, pl = PAE.make_dataset(rng(14), 4, seconds=0.8, samples=12_000, speech_fraction=speech_fraction)
    same_arrays(jw, pw)
    same_arrays(jl, pl)


class _Writer:
    """A stand-in for cv2.VideoWriter that keeps what it is handed."""

    made: list = []

    def __init__(self, path, fourcc, fps, size):
        self.args, self.frames = (fourcc, fps, size), []
        _Writer.made.append(self)

    def write(self, frame):
        self.frames.append(np.array(frame, copy=True))

    def release(self):
        pass


MEETING = dict(n_segments=3, segment_seconds=1.0, pause_seconds=0.5, fps=4.0, p_face_only=0.5)


@pytest.mark.parametrize("seed", [0, 3])
def test_meeting_frames_and_wav_are_byte_equal(tmp_path, monkeypatch, seed):
    import cv2

    monkeypatch.setattr(cv2, "VideoWriter", _Writer)
    _Writer.made.clear()
    JAV.make_meeting(rng(seed), tmp_path / "jax", **MEETING)
    path = PAV.make_meeting(rng(seed), tmp_path / "port", video="mp4", **MEETING)
    archive = PAV.make_meeting(rng(seed), tmp_path / "archive", video="npz", **MEETING)
    jw, pw = _Writer.made
    assert path.name == "meeting.mp4" and archive.name == "meeting.npz"
    assert jw.args == pw.args and len(jw.frames) == len(pw.frames) == 3 * 6
    for a, b in zip(jw.frames, pw.frames):
        same_arrays(a, b)
    wav = (tmp_path / "jax" / "meeting.wav").read_bytes()
    assert wav == (tmp_path / "port" / "meeting.wav").read_bytes() == (tmp_path / "archive" / "meeting.wav").read_bytes()
    with np.load(archive) as z:
        same_arrays(z["frames"], np.stack(jw.frames))
        assert float(z["fps"]) == MEETING["fps"]
    reader = VideoReader(str(archive))
    assert (reader.frame_count, reader.fps, reader.height, reader.width) == (18, 4.0, 240, 320)
