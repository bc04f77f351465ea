"""The AMI preprocessor against the JAX package's on the CPU.

- ``pseudo_label`` equal to JAX's;
- the placeholder path: the same ``{split}/data.json`` bytes as JAX's;
- the real extraction on the JAX processor tests' tiny config over one
  short meeting: JAX's ``AMIPreprocessor`` on the clip's mp4 and the port's
  (``device="cpu"``) on its frame archive, the same tiny models on both
  sides (the plain f32 path): the same split counts, every record within
  1e-3 of JAX's and each target numpy's ``pseudo_label`` of the record's
  probabilities.
"""

import json

import numpy as np
import pytest

from msa_tpu.core import config as JC
from msa_tpu.training import preprocess_ami as JP
from msa_tpu_torch.core import config as PC
from msa_tpu_torch.host.audio_io import save_wav
from msa_tpu_torch.pipeline import graph as PG
from msa_tpu_torch.training import preprocess_ami as PP
from torch_parity import jax_tiny_models

SAMPLES = 4000  # the JAX processor tests' tiny window
VEC_ATOL = 1e-3


def test_pseudo_label_is_jax(rng):
    f, a, t = rng.random(7), rng.random(7), rng.random(7)
    np.testing.assert_array_equal(PP.pseudo_label(f, a, t), JP.pseudo_label(f, a, t))


def test_placeholder_path_writes_jax_bytes(tmp_path):
    ami = tmp_path / "ami_raw"
    for meeting, n in (("m1", 10), ("m2", 7)):
        d = ami / meeting
        d.mkdir(parents=True)
        for i in range(n):
            (d / f"seg{i}.wav").write_bytes(b"")
    (ami / "m3").mkdir()  # an empty meeting: one record
    want = JP.AMIPreprocessor(str(ami), str(tmp_path / "j"), models=None, seed=3).process()
    got = PP.AMIPreprocessor(str(ami), str(tmp_path / "p"), models=None, seed=3).process()
    assert got == want == {"train": 12, "val": 2, "test": 4}
    for split in want:
        assert (tmp_path / "p" / split / "data.json").read_bytes() == (tmp_path / "j" / split / "data.json").read_bytes()


def _voices(seconds: float, sr: int) -> np.ndarray:
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


@pytest.fixture(scope="module")
def meeting(tmp_path_factory):
    """One meeting: a 9 s clip at 10 fps, 64×48, with a sidecar WAV of two
    voices taking turns (the offline tests' meeting); JAX's copy an mp4,
    the port's the frames cv2 decodes from it in a frame archive."""
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("ami")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, size=(90, 48, 64, 3), dtype=np.uint8)
    sr = 16000
    x = _voices(9.0, sr)
    for side in ("jax", "port"):
        (root / side / "m1").mkdir(parents=True)
        save_wav(str(root / side / "m1" / "clip.wav"), x, sr)
    mp4 = root / "jax" / "m1" / "clip.mp4"
    w = cv2.VideoWriter(str(mp4), cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (64, 48))
    for f in frames:
        w.write(f)
    w.release()
    cap = cv2.VideoCapture(str(mp4))
    decoded = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        decoded.append(frame)
    np.savez(root / "port" / "m1" / "clip.npz", frames=np.stack(decoded), fps=cap.get(cv2.CAP_PROP_FPS))
    cap.release()
    return root


def _config(C, tmp_path):
    return C.SystemConfig(
        pipeline=C.PipelineConfig(segment_samples=SAMPLES, batch_size=4, model_scale="tiny"),
        dirs=C.DirectoryConfig(*(str(tmp_path / k) for k in ("data", "ckpt", "out", "tmp"))),
    )


def test_real_extraction_matches_jax(meeting, tmp_path):
    port_models = PG.PipelineModels.tiny(seed=0, device="cpu")
    want = JP.AMIPreprocessor(str(meeting / "jax"), str(tmp_path / "j"), models=jax_tiny_models(port_models),
                              config=_config(JC, tmp_path / "jd")).process()
    got = PP.AMIPreprocessor(str(meeting / "port"), str(tmp_path / "p"), models=port_models,
                             config=_config(PC, tmp_path / "pd"), device="cpu").process()
    assert got == want and sum(want.values()) >= 3
    for split in want:
        jrecs = json.loads((tmp_path / "j" / split / "data.json").read_text())
        precs = json.loads((tmp_path / "p" / split / "data.json").read_text())
        assert len(precs) == len(jrecs)
        for g, w in zip(precs, jrecs):
            assert set(g) == set(w) == {"face_vec", "audio_vec", "text_vec", "target"}
            for k in w:
                assert len(g[k]) == len(w[k]) and np.abs(np.asarray(g[k]) - np.asarray(w[k])).max() <= VEC_ATOL, k
            assert abs(sum(g["target"]) - 1.0) <= 1e-6


def test_target_is_pseudo_label_of_the_probabilities(meeting, tmp_path, monkeypatch):
    """Each record's target is ``pseudo_label`` of its segment's face, audio
    and text probabilities (read from the processor's own output)."""
    from msa_tpu_torch.processors import offline as PO

    seen = []
    real = PO.OfflineProcessor.process_video

    def spy(self, path, *a, **k):
        out = real(self, path, *a, **k)
        seen.extend(s for sp in out for s in sp["raw_analysis"])
        return out

    monkeypatch.setattr(PO.OfflineProcessor, "process_video", spy)
    port_models = PG.PipelineModels.tiny(seed=1, device="cpu")
    PP.AMIPreprocessor(str(meeting / "port"), str(tmp_path / "p"), models=port_models, split_ratios=(1.0, 0.0, 0.0),
                       config=_config(PC, tmp_path / "pd"), device="cpu").process()
    recs = json.loads((tmp_path / "p" / "train" / "data.json").read_text())
    assert len(recs) == len(seen) > 0
    def key(r):
        return tuple(np.float32(r["face_vec"] + r["audio_vec"]).tolist())

    by_key = {key(s): s for s in seen}
    assert len(by_key) == len(seen)
    for r in recs:
        s = by_key[key(r)]
        want = PP.pseudo_label(*(np.asarray(s[f"{m}_probs"], np.float32) for m in ("face", "audio", "text")))
        assert np.abs(np.asarray(r["target"]) - want).max() <= 1e-6
