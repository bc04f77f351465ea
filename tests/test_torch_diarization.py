"""The port's diarizers against ``msa_tpu/host/diarization.py`` on the same
synthesized waveforms: the clips of tests/test_diarization.py:22-80 (speech
islands, silence, two alternating harmonic voices, one steady voice) and
meetings of ``msa_tpu.models.speaker.synth_voice`` voices, two of which
share their pitch.

Segments and labels must be equal: the host diarizers are numpy on both
sides, and the neural one clusters embeddings that agree to ≤ 1e-4 (f32 on
both sides; the log-mel's FFTs differ in the last bits). The speaker net
is also held to JAX's at ``SpeakerConfig.tiny()`` from one init.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tpu.core.config import DiarizationConfig as JDiarCfg
from msa_tpu.core.config import ProcessingConfig as JProcCfg
from msa_tpu.host import diarization as JD
from msa_tpu.models import speaker as JS
from msa_tpu_torch import weights
from msa_tpu_torch.core.config import DiarizationConfig, ProcessingConfig
from msa_tpu_torch.host import diarization as PD
from msa_tpu_torch.models import speaker as PS
from torch_parity import to_numpy

SR = 16_000
EMB_ATOL = 1e-4


def _islands():
    """speech (2 s) – silence (2 s) – speech (2 s)."""
    rng = np.random.default_rng(1)
    t = np.arange(2 * SR) / SR
    speech = (0.5 * np.sin(2 * np.pi * 150 * t) * (1 + 0.5 * np.sin(2 * np.pi * 4 * t))).astype(np.float32)
    silence = (0.001 * rng.normal(size=2 * SR)).astype(np.float32)
    return np.concatenate([speech, silence, speech])


def _silence():
    return (1e-5 * np.random.default_rng(2).normal(size=3 * SR)).astype(np.float32)


def _harmonic_voices():
    """Alternating low- and high-pitch harmonic stacks with pauses."""

    def voice(f0, seed):
        r = np.random.default_rng(seed)
        t = np.arange(2 * SR) / SR
        x = np.zeros_like(t)
        for h, amp in ((1, 1.0), (2, 0.6), (3, 0.3), (5, 0.15)):
            x += amp * np.sin(2 * np.pi * f0 * h * t)
        x *= 0.3 * (1 + 0.4 * np.sin(2 * np.pi * 3.1 * t))
        return (x + 0.01 * r.normal(size=len(t))).astype(np.float32)

    gap = (0.0005 * np.random.default_rng(3).normal(size=SR)).astype(np.float32)
    return np.concatenate([c for i, who in enumerate("ABAB") for c in (voice(110 if who == "A" else 340, i), gap)])


def _steady():
    t = np.arange(6 * SR) / SR
    return (0.3 * np.sin(2 * np.pi * 160 * t) * (1 + 0.3 * np.sin(2 * np.pi * 2 * t))).astype(np.float32)


def _meeting(order):
    """synth_voice spans in ``order`` with 0.8 s pauses; B and C share F0."""
    rng = np.random.default_rng(4)
    voices = {
        "A": JS.VoiceSpec(f0=120, formants=(650, 1100, 2600)),
        "B": JS.VoiceSpec(f0=210, formants=(450, 1600, 2900)),
        "C": JS.VoiceSpec(f0=210, formants=(850, 2100, 3300)),
    }
    gap = (0.0003 * rng.normal(size=int(0.8 * SR))).astype(np.float32)
    return np.concatenate([c for who in order for c in (JS.synth_voice(rng, voices[who], 2.0, SR), gap)])


CLIPS = {
    "islands": _islands,
    "silence": _silence,
    "harmonic_voices": _harmonic_voices,
    "steady": _steady,
    "two_voices": lambda: _meeting("ABAB"),
    "three_voices": lambda: _meeting("ABCABC"),
}


def _segments(segs):
    return [(s["start"], s["end"], s["speaker"]) for s in segs]


@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("name", ["fixed", "vad", "clustering"])
def test_host_diarizers_match_jax(name, clip):
    x = CLIPS[clip]()
    want = JD.make_diarizer(name, JProcCfg(), JDiarCfg()).diarize(x, SR)
    got = PD.make_diarizer(name, ProcessingConfig(), DiarizationConfig(), device="cpu").diarize(x, SR)
    assert _segments(got) == _segments(want)


@pytest.fixture(scope="module")
def neural():
    """JAX's and the port's default diarizer on the shipped speaker net."""
    j = JD.make_diarizer("neural", JProcCfg(), JDiarCfg())
    p = PD.make_diarizer("neural", ProcessingConfig(), DiarizationConfig(), device="cpu")
    assert isinstance(j, JD.NeuralDiarizer) and isinstance(p, PD.NeuralDiarizer)
    return j, p


@pytest.mark.parametrize("clip", ["two_voices", "three_voices", "harmonic_voices", "islands"])
def test_neural_diarizer_matches_jax(neural, clip):
    j, p = neural
    x = CLIPS[clip]()
    want = j.diarize(x, SR)
    got = p.diarize(x, SR)
    assert _segments(got) == _segments(want)
    windows, _ = p._span_windows(x, p.segment_boundaries(x, SR), SR)
    emb_j = np.asarray(j._embed(j.params, windows))
    emb_p = p.embed(windows).numpy()
    assert emb_p.shape == emb_j.shape
    np.testing.assert_allclose(emb_p, emb_j, atol=EMB_ATOL)


def test_neural_diarizer_separates_the_meeting(neural):
    """Three voices, two of one pitch: the labels follow the turns."""
    _, p = neural
    labels = [s["speaker"] for s in p.diarize(CLIPS["three_voices"](), SR)]
    assert len(labels) == 6 and labels[0] == "SPEAKER_00"
    assert labels[:3] == labels[3:] and len(set(labels)) == 3, labels


def test_neural_two_phase_and_async_match_one_shot(neural):
    _, p = neural
    x = CLIPS["two_voices"]()
    want = _segments(p.diarize(x, SR))
    assert _segments(p.label_segments(x, p.segment_boundaries(x, SR), SR)) == want
    assert _segments(p.diarize_async(x, SR)()) == want


@pytest.mark.parametrize(
    "name,diar",
    [
        ("neural", {}),
        ("neural", {"clustering_threshold": 0.42, "min_speakers": 2, "max_speakers": 3}),
        ("neural", {"speaker_weights": "checkpoints/no_such_file.msgpack"}),
        ("neural", None),
        ("speaker-embedding", {}),
        ("pyannote/speaker-diarization", {}),
        ("fixed-window", {}),
        ("energy-vad", {}),
        ("clustering", {"max_speakers": 2}),
        ("clustering", None),
        ("something-else", {}),
    ],
)
def test_make_diarizer_resolves_like_jax(name, diar):
    proc = dict(segment_duration=4.0, min_speech_duration=0.4, min_pause_duration=0.6)
    j = JD.make_diarizer(name, JProcCfg(**proc), None if diar is None else JDiarCfg(**diar))
    p = PD.make_diarizer(name, ProcessingConfig(**proc), None if diar is None else DiarizationConfig(**diar), device="cpu")
    assert type(p).__name__ == type(j).__name__
    for attr in ("segment_duration", "min_speakers", "max_speakers", "threshold"):
        assert getattr(p, attr, None) == getattr(j, attr, None), attr
    vad_j, vad_p = getattr(j, "_vad", j), getattr(p, "_vad", p)
    for attr in ("segment_duration", "min_speech", "min_pause"):
        assert getattr(vad_p, attr, None) == getattr(vad_j, attr, None), attr


@pytest.mark.parametrize("cfg", [JS.SpeakerConfig.tiny(), JS.SpeakerConfig()], ids=["tiny", "full"])
def test_speaker_net_from_one_init(cfg):
    params = JS.init_params(JS.SpeakerEmbeddingNet(cfg), seed=5)
    net = PS.SpeakerEmbeddingNet(PS.SpeakerConfig(**dataclasses.asdict(cfg))).eval()
    weights.load_flax_tree(net, to_numpy(params))
    rng = np.random.default_rng(6)
    wav = np.stack([JS.synth_voice(rng, JS.random_voice(rng), cfg.window_seconds, SR)[: cfg.window_samples] for _ in range(3)])
    want = np.asarray(jax.jit(JS.SpeakerEmbeddingNet(cfg).embed_windows)(params, jnp.asarray(wav)))
    with torch.no_grad():
        got = net.embed_windows(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, want, atol=EMB_ATOL)
    np.testing.assert_allclose(
        PS.log_mel(torch.from_numpy(wav), net.cfg).numpy(), np.asarray(JS.log_mel(jnp.asarray(wav), cfg)), atol=1e-4
    )
