"""The port's whisper transcriber against the JAX package's on the CPU.

- the byte-level BPE (with assets and byte-direct) and the syllable
  tokenizer: ids and text equal to JAX's;
- ``log_mel_window`` within 1e-3 of JAX's (f32 on both sides; the FFTs
  differ in the last bits);
- ``WhisperConfig.tiny()`` from one JAX init: teacher-forced logits within
  1e-3, ``greedy_decode`` tokens and lengths equal; the port's rebuilt init
  (``init_whisper``) against ``init_params``;
- the shipped ASR through ``make_transcriber("auto", scale="full")``: the
  same text as JAX's ``JaxWhisperTranscriber`` on 5 s clips of
  ``msa_tpu.training.speech_synth`` speech. The clips are also committed as
  ``tests/data/asr_clips.npz`` (int16, with JAX's transcripts) for the
  card's smoke run, which has no JAX: this test regenerates them and holds
  the file to them byte for byte. Rewrite it with
  ``PYTHONPATH=. python tests/test_torch_whisper.py``.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tpu.host import bpe as JB
from msa_tpu.host import transcription as JT
from msa_tpu.models import whisper as JW
from msa_tpu_torch.host import bpe as PB
from msa_tpu_torch.host import transcription as PT
from msa_tpu_torch.models import whisper as PW

import torch_parity  # noqa: F401  (its import shares the CPU among xdist workers)

FIXTURE = Path(__file__).resolve().parent / "data" / "asr_clips.npz"
CLIP_SEED, N_CLIPS = 777_003, 8  # a seed neither the trainer nor tests/test_shipped_assets.py uses
LOGITS_ATOL = 1e-3
TEXTS = ["", "olá mundo", "estou muito feliz hoje", "ação é ótima!", "it's 42 — ok?\n  tabs\tand  spaces", "ñ 日本"]


def make_asr_clips():
    """(int16 [N, 80000] windows as the transcriber uploads them, reference
    texts): ``make_clip`` speech over the ASR's training words."""
    from msa_tpu.training.train_whisper_asr import TRAIN_WORDS, make_clip

    rng = np.random.default_rng(CLIP_SEED)
    window = JW.window_samples(JW.WhisperConfig(max_source_positions=250))
    clips, refs = zip(*(make_clip(rng, TRAIN_WORDS, window) for _ in range(N_CLIPS)))
    return np.stack([np.clip(c * 32768.0, -32768, 32767).astype(np.int16) for c in clips]), list(refs)


@pytest.fixture
def bpe_assets(tmp_path):
    """A small GPT-2-format vocab (every byte + a few merges) and its
    merges, as load_whisper_tokenizer reads them."""
    byte_tokens = list(JB.bytes_to_unicode().values())
    merges = [("e", "s"), ("es", "t"), ("o", "u"), ("Ġ", "m"), ("Ġm", "u"), ("Ã", "§"), ("a", "Ã§")]
    vocab = {tok: i for i, tok in enumerate(byte_tokens + [a + b for a, b in merges] + ["<|endoftext|>"])}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    return tmp_path


def test_bpe_with_assets_matches_jax(bpe_assets):
    j, p = JB.load_whisper_tokenizer(str(bpe_assets)), PB.load_whisper_tokenizer(str(bpe_assets))
    for text in TEXTS:
        ids = p.encode(text)
        assert ids == j.encode(text)
        assert p.decode(ids) == j.decode(ids) == text
    assert p.decode([len(p.vocab) - 1, 5]) == j.decode([len(j.vocab) - 1, 5])  # special ids drop out
    assert PB.load_whisper_tokenizer(str(bpe_assets / "absent")) is None


@pytest.mark.parametrize("vocab_size,offset", [(51865, 1000), (512, 256)])
def test_byte_direct_bpe_matches_jax(vocab_size, offset):
    j, p = JB.ByteLevelBPE(vocab_size=vocab_size, byte_offset=offset), PB.ByteLevelBPE(vocab_size=vocab_size, byte_offset=offset)
    for text in TEXTS:
        assert p.encode(text) == j.encode(text)
        assert p.decode(p.encode(text)) == text
    assert p.decode([0, offset + 65, vocab_size - 1]) == j.decode([0, offset + 65, vocab_size - 1])


def test_syllable_tokenizer_matches_jax():
    ids = list(range(0, 37, 3))
    assert PT.SyllableTokenizer().decode(ids) == JT.SyllableTokenizer().decode(ids)


@pytest.fixture(scope="module")
def tiny():
    cfg = JW.WhisperConfig.tiny()
    params = JW.init_params(cfg, 0)
    model = PW.whisper_from_flax(PW.WhisperConfig.tiny(), jax.tree_util.tree_map(np.asarray, params), "cpu")
    return cfg, params, model


def _waves(cfg, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((n, JW.window_samples(cfg)))).astype(np.float32)


@pytest.mark.parametrize("shipped", [False, True], ids=["tiny", "shipped"])
def test_log_mel_window_matches_jax(shipped):
    cfg = JW.WhisperConfig(max_source_positions=250) if shipped else JW.WhisperConfig.tiny()
    wav = _waves(cfg)
    wav[1, : wav.shape[1] // 2] = 0.0  # half a window of silence
    want = np.asarray(jax.vmap(lambda x: JW.log_mel_window(x, cfg))(jnp.asarray(wav)))
    got = PW.log_mel_window(torch.from_numpy(wav), PW.WhisperConfig(**cfg.__dict__)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_teacher_forced_logits_match_jax(tiny):
    cfg, params, model = tiny
    mel = np.array(jax.vmap(lambda x: JW.log_mel_window(x, cfg))(jnp.asarray(_waves(cfg))))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(3, 10)).astype(np.int32)
    want = np.asarray(JW.WhisperModel(cfg).apply({"params": params}, jnp.asarray(mel), jnp.asarray(tokens)))
    with torch.no_grad():
        got = model(torch.from_numpy(mel), torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL)


@pytest.mark.parametrize("valid", [None, (True, False, True)])
def test_greedy_decode_matches_jax(tiny, valid):
    cfg, params, model = tiny
    mel = np.array(jax.vmap(lambda x: JW.log_mel_window(x, cfg))(jnp.asarray(_waves(cfg, seed=2))))
    jvalid = None if valid is None else jnp.asarray(valid)
    want_t, want_n = JW.WhisperModel(cfg).apply({"params": params}, jnp.asarray(mel), 12, jvalid, method=JW.WhisperModel.greedy_decode)
    got_t, got_n = model.greedy_decode(torch.from_numpy(mel), 12, None if valid is None else torch.tensor(valid))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


def test_rebuilt_init_matches_jax(tiny):
    _, _, from_jax = tiny
    rebuilt = PW.init_whisper(PW.WhisperConfig.tiny(), 0, "cpu")
    for (name, got), (_, want) in zip(rebuilt.named_parameters(), from_jax.named_parameters()):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def shipped():
    j = JT.make_transcriber("auto", scale="full")
    p = PT.make_transcriber("auto", scale="full", device="cpu")
    assert isinstance(j, JT.JaxWhisperTranscriber) and isinstance(p, PT.WhisperTranscriber)
    return j, p


def test_shipped_asr_matches_jax_and_the_fixture(shipped):
    j, p = shipped
    waves, refs = make_asr_clips()
    fixture = np.load(FIXTURE)
    assert fixture["waves"].dtype == np.int16 and fixture["waves"].tobytes() == waves.tobytes()
    assert list(fixture["refs"]) == refs
    clips = list(waves.astype(np.float32) / 32768.0)
    want = j.transcribe_batch(clips, 16_000)
    assert list(fixture["transcripts"]) == want
    assert p.transcribe_batch(clips, 16_000) == want
    assert p.collect_batch(p.dispatch_resident(torch.from_numpy(waves), N_CLIPS)) == want
    assert p.transcribe(clips[0], 16_000) == want[0]  # B=1
    assert sum(a == b for a, b in zip(want, refs)) >= N_CLIPS - 1  # the shipped ASR's WER is 0.016


def _stand_in_transformers(monkeypatch, pipeline):
    """``transformers`` replaced in ``sys.modules`` by a module holding only
    ``pipeline``: both transcribers import it in their constructor, and no
    code of the real library (or of the hub) runs."""
    import sys
    import types

    module = types.ModuleType("transformers")
    module.pipeline = pipeline
    monkeypatch.setitem(sys.modules, "transformers", module)


@pytest.fixture
def hub_offline(monkeypatch):
    """The hub offline (``HF_HUB_OFFLINE=1``), a stand-in ``transformers``
    whose pipeline fails as an offline one does for a model that is not in
    the local cache, and name lookups and socket connects refused: no test
    waits on the network."""
    import socket

    def refuse(*args, **kwargs):
        raise OSError("no network in the tests")

    def offline_pipeline(task, model, device=None):
        raise OSError(f"{model} is not in the local cache and the hub is offline")

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    for name in ("getaddrinfo", "create_connection"):
        monkeypatch.setattr(socket, name, refuse)
    monkeypatch.setattr(socket.socket, "connect", refuse)
    _stand_in_transformers(monkeypatch, offline_pipeline)


def test_make_transcriber_resolves_like_jax(monkeypatch, tmp_path, hub_offline):
    monkeypatch.setenv("MSA_WHISPER_ASSETS", str(tmp_path / "absent"))
    assert isinstance(PT.make_transcriber("auto", scale="tiny", device="cpu"), PT.StubTranscriber)
    assert isinstance(JT.make_transcriber("auto", scale="tiny"), JT.StubTranscriber)
    for name in ("stub", "", None):
        assert isinstance(PT.make_transcriber(name, device="cpu"), PT.StubTranscriber)
    # an HF model name: both try the transformers pipeline, which cannot
    # load offline, and fall back to the stub
    assert isinstance(PT.make_transcriber("openai/whisper-medium", device="cpu"), PT.StubTranscriber)
    assert isinstance(JT.make_transcriber("openai/whisper-medium"), JT.StubTranscriber)
    rand = PT.make_transcriber("jax-whisper", device="cpu")
    assert isinstance(rand, PT.JaxWhisperTranscriber) and rand.cfg == PW.WhisperConfig.tiny()
    assert isinstance(rand.tokenizer, PT.SyllableTokenizer)
    # the shipped ASR serves only because its recorded eval passes the bar
    monkeypatch.setattr(PT, "_shipped_asr_passes_bar", lambda d: False)
    assert isinstance(PT.make_transcriber("auto", scale="full", device="cpu"), PT.StubTranscriber)


@pytest.mark.parametrize("record", [None, {"wer": 0.5}, {"exact": 1.0}, {"wer": 0.1}, {"wer": 0.099}, "not json"])
def test_shipped_bar_matches_jax(tmp_path, record):
    if record is not None:
        (tmp_path / "eval.json").write_text(record if isinstance(record, str) else json.dumps(record))
    assert PT._shipped_asr_passes_bar(tmp_path) == JT._shipped_asr_passes_bar(tmp_path)
    assert PT.SHIPPED_WER_BAR == JT.SHIPPED_WER_BAR


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    waves, refs = make_asr_clips()
    transcripts = JT.make_transcriber("auto", scale="full").transcribe_batch(list(waves.astype(np.float32) / 32768.0), 16_000)
    np.savez_compressed(FIXTURE, waves=waves, refs=np.array(refs), transcripts=np.array(transcripts))
    print(f"wrote {FIXTURE}: {transcripts}")


class _Pipe:
    """A stand-in ``transformers.pipeline``: records its arguments and
    answers with the clip's length, or raises from the call."""

    def __init__(self, task, model, device=None, fail=False):
        self.args, self.fail = (task, model, device), fail

    def __call__(self, inputs):
        if self.fail:
            raise RuntimeError("decode failed")
        return {"text": f"{inputs['raw'].dtype} {inputs['raw'].shape[0]} @ {inputs['sampling_rate']}"}


def test_hf_transcriber_serves_an_hf_name_like_jax(monkeypatch, hub_offline):
    """An HF name reaches a transformers ASR pipeline built once on the
    port's device (JAX's ``HFTranscriber``, which the factory tries before
    the stub); a failed transcription gives "", as JAX's."""
    built = []

    def pipeline(task, model, device=None):
        built.append(_Pipe(task, model, device))
        return built[-1]

    _stand_in_transformers(monkeypatch, pipeline)
    port = PT.make_transcriber("some/asr-model", language="en", device="cpu")
    jax_side = JT.make_transcriber("some/asr-model", language="en")
    assert isinstance(port, PT.HFTranscriber) and isinstance(jax_side, JT.HFTranscriber)
    assert built[0].args == ("automatic-speech-recognition", "some/asr-model", torch.device("cpu"))
    wave = np.zeros(1600, np.float64)
    assert port.transcribe(wave, 16_000) == jax_side.transcribe(wave, 16_000) == "float32 1600 @ 16000"
    for t in built:
        t.fail = True
    assert port.transcribe(wave, 16_000) == jax_side.transcribe(wave, 16_000) == ""


def test_hf_pipeline_that_cannot_be_built_gives_the_stub(hub_offline):
    assert isinstance(PT.make_transcriber("some/asr-model", device="cpu"), PT.StubTranscriber)
    assert isinstance(JT.make_transcriber("some/asr-model"), JT.StubTranscriber)
    with pytest.raises(OSError, match="local cache"):
        PT.HFTranscriber("some/asr-model", device="cpu")
