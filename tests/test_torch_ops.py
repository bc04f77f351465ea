"""Parity of the port's feature ops (normalization, audio DSP, landmark
geometry) with the JAX package, on the inputs of the JAX golden tests
(tests/test_normalization.py, test_audio_features.py,
test_face_features.py). Tolerance ≤ 1e-3 on these f32 outputs (the
BASELINE parity contract); most agree to ~1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import np_layer_norm
from msa_tpu.ops import audio_features as JA
from msa_tpu.ops import face_features as JF
from msa_tpu.ops import normalization as JN
from msa_tpu_torch.ops import audio_features as PA
from msa_tpu_torch.ops import face_features as PF
from msa_tpu_torch.ops import normalization as PN

import torch_parity  # noqa: F401  (its import shares the CPU among xdist workers)

SR = 16_000


@pytest.mark.parametrize(
    "raw_dim,target_dim,name",
    [(25, 27, "normalize_face"), (27, 31, "normalize_audio"), (779, 783, "normalize_text")],
)
def test_pad_then_layernorm(rng, raw_dim, target_dim, name):
    x = rng.normal(size=(3, raw_dim)).astype(np.float32)
    golden = np_layer_norm(np.pad(x, [(0, 0), (0, target_dim - raw_dim)]))
    got = getattr(PN, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, golden, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(getattr(JN, name)(x)), atol=1e-5)


def test_truncation_keeps_leading_features(rng):
    x = rng.normal(size=(2, 40)).astype(np.float32)
    got = PN.normalize_features(torch.from_numpy(x), 31).numpy()
    np.testing.assert_allclose(got, np_layer_norm(x[:, :31]), atol=1e-5)


@pytest.fixture(scope="module")
def speech_batch():
    """The golden tests' 1 s AM tone + noise, a quieter copy, and silence."""
    rng = np.random.default_rng(7)
    tt = np.arange(SR) / SR
    x = 0.4 * np.sin(2 * np.pi * 180 * tt) * (1 + 0.5 * np.sin(2 * np.pi * 3 * tt))
    x += 0.05 * rng.normal(size=SR)
    x = x.astype(np.float32)
    return np.stack([x, 0.1 * x[::-1], np.zeros_like(x)]).astype(np.float32)


@pytest.mark.parametrize("pitch_mode", ["reference", "acf"])
def test_audio_feature_stack_matches_jax(speech_batch, pitch_mode):
    want_dsp, want_q = jax.vmap(lambda w: JA.audio_feature_stack(w, SR, pitch_mode))(speech_batch)
    dsp, q = PA.audio_feature_stack(torch.from_numpy(speech_batch), SR, pitch_mode)
    assert dsp.shape == (3, 19) and q.shape == (3, 4)
    np.testing.assert_allclose(dsp.numpy(), np.asarray(want_dsp), atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(q.numpy(), np.asarray(want_q), atol=1e-3)


def test_mfcc_and_rhythm_match_jax_and_golden(speech_batch):
    x = speech_batch[:2]
    m = PA.mfcc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(m, np.asarray(jax.vmap(JA.mfcc)(x)), atol=1e-3, rtol=1e-4)
    got = PA.rhythm(torch.from_numpy(x)).numpy()[0]
    frame_len, hop = 400, 160
    n = 1 + (SR - frame_len) // hop
    e = np.array([np.sum(x[0, i * hop : i * hop + frame_len].astype(np.float64) ** 2) for i in range(n)])
    np.testing.assert_allclose(got, [e.mean(), e.std(ddof=1), n / SR], rtol=1e-4)


@pytest.fixture
def landmark_batch(rng):
    """Synthetic faces as in tests/test_face_features.py, three frames."""
    lm = rng.uniform(0.2, 0.8, size=(3, 478, 3)).astype(np.float32)
    lm[..., 2] = rng.normal(scale=0.05, size=(3, 478))
    return lm


def test_face_feature_stack_matches_jax(rng, landmark_batch):
    prev = (landmark_batch + rng.normal(scale=0.01, size=landmark_batch.shape)).astype(np.float32)
    present = np.array([True, True, False])
    has_prev = np.array([True, False, True])
    want = jax.vmap(lambda lm, pl, fp, hp: JF.face_feature_stack(lm, pl, fp, hp, 480, 640))(
        landmark_batch, prev, present, has_prev
    )
    got = PF.face_feature_stack(
        torch.from_numpy(landmark_batch), torch.from_numpy(prev), torch.from_numpy(present),
        torch.from_numpy(has_prev), 480, 640,
    )
    for g, w, name in zip(got, want, ("geometry", "position", "quality")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, err_msg=name)
    assert not got[0][2].any() and not got[1][2].any()  # no face → zero geometry/position


def test_bbox_and_micro_expressions_golden(landmark_batch):
    lm = landmark_batch[0]
    bb = PF.bbox(torch.from_numpy(landmark_batch), 480, 640).numpy()[0]
    x, y = np.floor(lm[:, 0].min() * 640), np.floor(lm[:, 1].min() * 480)
    np.testing.assert_allclose(bb[:2], [x, y])
    d = np.array([np.linalg.norm(lm[i] - lm[j]) for i, j in ((10, 151), (105, 334), (33, 133), (1, 4), (61, 291))])
    golden = (d - d.mean()) / (d.std(ddof=1) + 1e-6)
    got = PF.micro_expressions(torch.from_numpy(landmark_batch)).numpy()[0]
    np.testing.assert_allclose(got, golden, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(JF.micro_expressions(jnp.asarray(lm))), atol=1e-5)
