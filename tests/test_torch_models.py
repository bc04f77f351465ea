"""Parity of the port's models with the JAX modules, on the same weights
(moved by msa_tpu_torch.weights) and the same numpy inputs.

Encoders are 128 wide so the JAX side reaches its Pallas kernels
(interpret mode on the CPU). Tolerances: ≤ 1e-3 on f32 outputs (most agree
to ~1e-5), ≤ 1e-4 for the fusion MLP (as tests/test_fusion.py), and the
bf16 bound of torch_parity.bf16_bound for bf16 encoders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tpu.models import audio as JAud
from msa_tpu.models import face as JFace
from msa_tpu.models import fusion as JFus
from msa_tpu.models import text as JText
from msa_tpu.models.transformer import TransformerEncoder as JEncoder
from msa_tpu.models.transformer import mean_pool as jax_mean_pool
from msa_tpu_torch import weights
from msa_tpu_torch.models import audio as PAud
from msa_tpu_torch.models import face as PFace
from msa_tpu_torch.models import fusion as PFus
from msa_tpu_torch.models import text as PText
from msa_tpu_torch.models.transformer import TransformerEncoder as PEncoder
from msa_tpu_torch.models.transformer import mean_pool
from torch_parity import AUDIO, FACE, TEXT, bf16_bound, f32, jax_encoder_cfg, port_encoder_cfg, to_numpy


def _assert_close(got, want, dtype, atol=1e-3):
    got, want = f32(got), f32(want)
    assert np.isfinite(got).all()
    bound = atol if dtype == "float32" else bf16_bound(want)
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(), bound)


@pytest.mark.parametrize(
    "dtype,kernels", [("float32", True), ("float32", False), ("bfloat16", True), ("bfloat16", False)]
)
def test_encoder_matches_jax(rng, dtype, kernels):
    x = rng.normal(size=(2, 50, 128)).astype(np.float32)
    mask = np.ones((2, 50), np.int32)
    mask[1, 30:] = 0
    jcfg = jax_encoder_cfg(dtype, kernels)
    jenc = JEncoder(jcfg)
    params = jenc.init(jax.random.PRNGKey(0), x, mask)["params"]
    want = jenc.apply({"params": params}, x, mask)
    penc = PEncoder(port_encoder_cfg(dtype, kernels))
    weights.load_flax_tree(penc, to_numpy(params))
    got = penc(torch.from_numpy(x), torch.from_numpy(mask))
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_model_matches_jax(rng, dtype):
    jm = JText.TextModel(JText.TextModelConfig(encoder=jax_encoder_cfg(dtype), **TEXT))
    ids = rng.integers(1, 128, size=(3, 32)).astype(np.int32)
    mask = np.ones((3, 32), np.int32)
    mask[1, 12:] = 0
    mask[2, :] = 0  # empty transcript: an all-masked row stays finite
    params = jm.init(jax.random.PRNGKey(3), ids, mask)["params"]
    want = jm.apply({"params": params}, ids, mask)
    pm = PText.TextModel(PText.TextModelConfig(encoder=port_encoder_cfg(dtype), **TEXT))
    weights.load_flax_tree(pm, to_numpy(params))
    got = pm(torch.from_numpy(ids), torch.from_numpy(mask))
    for k in ("context_embedding", "emotion_probs", "polarity", "intensity", "coherence"):
        _assert_close(got[k], want[k], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_audio_model_matches_jax(rng, dtype):
    jcfg = JAud.AudioModelConfig(positional="conv", encoder=jax_encoder_cfg(dtype), **AUDIO)
    jm = JAud.AudioEmotionModel(jcfg)
    wav = (0.1 * rng.normal(size=(2, 4000))).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(2), wav)["params"]
    want = jm.apply({"params": params}, wav)
    pm = PAud.AudioEmotionModel(PAud.AudioModelConfig(encoder=port_encoder_cfg(dtype), **AUDIO))
    weights.load_flax_tree(pm, to_numpy(params))
    got = pm(torch.from_numpy(wav))
    assert got["hidden"].shape == (2, 198, 128)
    for k in ("pooled", "probs4", "emotion_probs"):
        _assert_close(got[k], want[k], dtype)


def test_face_models_and_crop_match_jax(rng):
    jcfg = JFace.FaceModelConfig(**FACE)
    pcfg = PFace.FaceModelConfig(**FACE)
    frames = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    jl = JFace.FaceLandmarkNet(jcfg)
    lp = jl.init(jax.random.PRNGKey(0), frames)["params"]
    pl = PFace.FaceLandmarkNet(pcfg)
    weights.load_flax_tree(pl, to_numpy(lp))
    want, got = jl.apply({"params": lp}, frames), pl(torch.from_numpy(frames))
    _assert_close(got["landmarks"], want["landmarks"], "float32")
    _assert_close(got["presence"], want["presence"], "float32")

    gray = JFace.rgb_to_gray(frames)
    np.testing.assert_allclose(PFace.rgb_to_gray(torch.from_numpy(frames)).numpy(), np.asarray(gray), atol=1e-6)
    boxes = np.array([[3.0, 5.0, 20.0, 17.5], [0.0, 0.0, 1.0, 9.0]], np.float32)  # 2nd: degenerate → whole frame
    want_crop = jax.vmap(lambda im, bb: JFace.bilinear_crop_resize(im, bb, 48))(gray, boxes)
    got_crop = PFace.bilinear_crop_resize(torch.from_numpy(np.array(gray)), torch.from_numpy(boxes), 48)
    _assert_close(got_crop, want_crop, "float32", atol=1e-5)

    jc = JFace.FaceEmotionCNN(jcfg)
    cp = jc.init(jax.random.PRNGKey(1), np.asarray(want_crop))["params"]
    pc = PFace.FaceEmotionCNN(pcfg)
    weights.load_flax_tree(pc, to_numpy(cp))
    _assert_close(pc(got_crop), jc.apply({"params": cp}, np.asarray(want_crop)), "float32", atol=1e-5)


def test_shipped_fusion_fuse_combo_matches_jax(rng):
    from msa_tpu_torch.pipeline.graph import resolve_asset
    from msa_tpu_torch.checkpoints import flax_msgpack

    jm, jp, _ = JFus.load_checkpoint(str(resolve_asset("checkpoints/fusion.msgpack")), create_if_missing=False)
    pm = PFus.FusionMLP()
    weights.load_flax_tree(pm, flax_msgpack.load(resolve_asset("checkpoints/fusion.msgpack"))["params"])
    b = 8
    f = rng.normal(size=(b, 27)).astype(np.float32)
    a = rng.normal(size=(b, 31)).astype(np.float32)
    tx = rng.normal(size=(b, 783)).astype(np.float32)
    combo = np.arange(b, dtype=np.int32)  # every modality subset once
    want = jax.vmap(
        lambda f_, a_, t_, c_: jm.apply({"params": jp}, f_[None], a_[None], t_[None], c_, method=JFus.FusionMLP.fuse_combo)[0]
    )(f, a, tx, combo)
    got = pm.fuse_combo(*(torch.from_numpy(v) for v in (f, a, tx, combo)))
    np.testing.assert_allclose(f32(got), np.asarray(want), atol=1e-4)
    w = {k: float(v.detach()) for k, v in pm.weights_dict().items()}
    assert w == pytest.approx(JFus.get_weights(jm, jp), abs=1e-6)


def test_mean_pool_matches_jax(rng):
    x = rng.normal(size=(3, 10, 16)).astype(np.float32)
    mask = np.ones((3, 10), np.int32)
    mask[1, 4:] = 0
    mask[2, :] = 0  # nothing valid: the JAX denominator floor of 1 keeps it finite
    for m in (mask, None):
        want = jax_mean_pool(x, m)
        got = mean_pool(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
        _assert_close(got, want, "float32", atol=1e-6)


@pytest.mark.parametrize(
    "impl,d_model,d_ff,quantize",
    [
        ("attention_impl", 96, 256, "none"),
        ("ffn_impl", 128, 192, "none"),
        ("ffn_impl", 96, 256, "none"),
        ("attention_impl", 96, 256, "int8"),
        ("ffn_impl", 128, 192, "int8"),
    ],
)
def test_kernel_paths_refuse_widths_they_cannot_take(impl, d_model, d_ff, quantize):
    """A kernel path asked for at widths its kernel cannot take raises; it
    never gives way to the plain version."""
    from msa_tpu_torch.models.transformer import EncoderConfig

    cfg = EncoderConfig(num_layers=1, d_model=d_model, num_heads=4, d_ff=d_ff, quantize=quantize, **{impl: "kernel"})
    enc = PEncoder(cfg)
    with pytest.raises(NotImplementedError):
        enc(torch.zeros(1, 8, d_model), torch.ones(1, 8))
