"""The model options of ``msa_tpu/models/`` in the port, against the JAX
package on the CPU.

- ``cnn_arch="deepface"``: ``params_from_keras_fer`` (nested and flat npz
  keys) gives JAX's tree; ``DeepFaceEmotionCNN`` on those Keras-form
  weights gives JAX's probabilities within 1e-5 (f32; the convs sum in
  another order); ``load_emotion_weights`` reads an npz and a flax-msgpack
  file and raises on a misfit; ``PipelineModels.initialize`` loads both
  face assets as JAX's does (tests/test_face_training.py:113-160), and a
  misfit keeps the init. Its init leaves are held in
  ``tests/test_torch_flax_init.py``.
- ``extractor_impl="matmul"``: the extractor against JAX's on JAX's
  odd-length config (tests/test_audio_face_models.py:152-175) within 2e-5
  in f32 and torch_parity.bf16_bound in bf16, and against the port's own
  ``"conv"``; at 128 channels, the kernel's contract, too: on the CPU
  every width takes JAX's matmuls in JAX's order (``conv_stride2_fused``
  serves only CUDA tensors). Training through it gives JAX's gradients
  (f32), as the GEMM layers then take the differentiable matmuls on any
  device: row 11 has no backward.
"""

import dataclasses

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tpu.models import audio as JAud
from msa_tpu.models import face as JFace
from msa_tpu.models.transformer import EncoderConfig as JEncCfg
from msa_tpu_torch import flax_init, weights
from msa_tpu_torch.models import audio as PAud
from msa_tpu_torch.models import face as PFace
from msa_tpu_torch.models.transformer import EncoderConfig as PEncCfg
from msa_tpu_torch.ops.kernels import conv as KC
from msa_tpu_torch.pipeline import graph as PG
from torch_parity import bf16_bound, f32, same_tree, to_numpy

KERAS_SHAPES = {
    "conv2d": (5, 5, 1, 64),
    "conv2d_1": (3, 3, 64, 64),
    "conv2d_2": (3, 3, 64, 64),
    "conv2d_3": (3, 3, 64, 128),
    "conv2d_4": (3, 3, 128, 128),
    "dense": (128, 1024),
    "dense_1": (1024, 1024),
    "dense_2": (1024, 7),
}


def keras_state(seed: int = 0):
    """A Keras FER state dict from a numpy seed (layer → kernel, bias)."""
    rng = np.random.default_rng(seed)
    return {
        name: {
            "kernel": (rng.normal(size=shape) * 0.05).astype(np.float32),
            "bias": (rng.normal(size=shape[-1]) * 0.01).astype(np.float32),
        }
        for name, shape in KERAS_SHAPES.items()
    }


def flat(state):
    return {f"{name}/{part}": a for name, layer in state.items() for part, a in layer.items()}


@pytest.mark.parametrize("form", ["nested", "flat"])
def test_keras_fer_importer_matches_jax(form):
    state = keras_state()
    arg = state if form == "nested" else flat(state)
    same_tree(PFace.params_from_keras_fer(arg), JFace.params_from_keras_fer(arg))


def test_deepface_cnn_matches_jax():
    """The same Keras-form weights through both clones, f32: the
    probabilities within 1e-5, rows summing to 1; another crop size
    raises, as in JAX."""
    params = PFace.params_from_keras_fer(keras_state())
    cfg = PFace.FaceModelConfig(cnn_arch="deepface")
    model = PFace.make_emotion_cnn(cfg)
    assert isinstance(model, PFace.DeepFaceEmotionCNN)
    assert isinstance(PFace.make_emotion_cnn(PFace.FaceModelConfig()), PFace.FaceEmotionCNN)
    weights.load_flax_tree(model, params)
    crops = np.random.default_rng(1).random((3, 48, 48, 1)).astype(np.float32)
    want = np.asarray(JFace.DeepFaceEmotionCNN(JFace.FaceModelConfig(cnn_arch="deepface")).apply({"params": params}, crops))
    with torch.no_grad():
        got = model(torch.from_numpy(crops)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got.sum(axis=-1), 1.0, atol=1e-6)
    with pytest.raises(ValueError, match="48x48"):
        model(torch.zeros(1, 32, 32, 1))


def test_load_emotion_weights_reads_npz_and_msgpack_and_checks_shapes(tmp_path):
    state = keras_state()
    np.savez(tmp_path / "fer.npz", **flat(state))
    deepface = PFace.DeepFaceEmotionCNN(PFace.FaceModelConfig(cnn_arch="deepface"))
    native = PFace.FaceEmotionCNN(PFace.FaceModelConfig())
    got = PFace.load_emotion_weights(deepface, str(tmp_path / "fer.npz"))
    want = JFace.load_emotion_weights(JFace.DeepFaceEmotionCNN(JFace.FaceModelConfig(cnn_arch="deepface")), str(tmp_path / "fer.npz"))
    same_tree(got, to_numpy(want))
    with pytest.raises(ValueError, match="cnn_arch='deepface'"):
        PFace.load_emotion_weights(native, str(tmp_path / "fer.npz"))
    # flax-msgpack: JAX's native init written by flax, read back into each arch
    net, s = JFace.FaceEmotionCNN(JFace.FaceModelConfig()), JFace.FaceModelConfig().crop_size
    jparams = jax.jit(net.init)(jax.random.PRNGKey(1), jnp.zeros((1, s, s, 1)))["params"]  # init_emotion_params, jitted
    (tmp_path / "native.msgpack").write_bytes(flax.serialization.to_bytes(jparams))
    same_tree(PFace.load_emotion_weights(native, str(tmp_path / "native.msgpack")), to_numpy(jparams))
    with pytest.raises(ValueError, match="conv_0/kernel"):
        PFace.load_emotion_weights(deepface, str(tmp_path / "native.msgpack"))
    bad = flat(state)
    bad["dense_1/kernel"] = bad["dense_1/kernel"][:, :512]
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(ValueError, match="fc_1/kernel"):
        PFace.load_emotion_weights(deepface, str(tmp_path / "bad.npz"))


def _tiny_models(face_cfg):
    from msa_tpu_torch.models.audio import AudioModelConfig
    from msa_tpu_torch.models.text import TextModelConfig

    return PG.PipelineModels.initialize(
        seed=0, face_cfg=face_cfg, audio_cfg=AudioModelConfig.tiny(), text_cfg=TextModelConfig.tiny(),
        fusion={"hidden_dim": 32}, device="cpu",
    )


def test_initialize_loads_deepface_and_landmark_assets(tmp_path, monkeypatch):
    """tests/test_face_training.py:113-160 in the port: a Keras FER npz and
    a landmark msgpack configured on a tiny face config with
    cnn_arch="deepface" both load; the default shipped emotion checkpoint
    (the native arch) does not fit the DeepFace CNN and leaves JAX's init
    from seed + 1 (the same ``_init_then_load`` call, on the loaded CNN;
    the init is the one ``initialize`` drew before the npz loaded)."""
    inits = []
    real_init = flax_init.init_module_

    def recording_init(module, seed):
        real_init(module, seed)
        if isinstance(module, PFace.DeepFaceEmotionCNN):
            inits.append((seed, {n: p.clone() for n, p in module.named_parameters()}))
        return module

    monkeypatch.setattr(flax_init, "init_module_", recording_init)
    state = keras_state()
    np.savez(tmp_path / "fer.npz", **flat(state))
    lm_net, s = JFace.FaceLandmarkNet(JFace.FaceModelConfig.tiny()), JFace.FaceModelConfig.tiny().frame_size
    lm_params = jax.jit(lm_net.init)(jax.random.PRNGKey(7), jnp.zeros((1, s, s, 3)))["params"]  # init_landmark_params, jitted
    (tmp_path / "lm.msgpack").write_bytes(flax.serialization.to_bytes(lm_params))
    cfg = dataclasses.replace(
        PFace.FaceModelConfig.tiny(), cnn_arch="deepface", crop_size=48,
        emotion_weights=str(tmp_path / "fer.npz"), landmark_weights=str(tmp_path / "lm.msgpack"),
    )
    models = _tiny_models(cfg)
    assert isinstance(models.face_cnn, PFace.DeepFaceEmotionCNN)
    assert models.loaded["face_cnn"] == str(tmp_path / "fer.npz")
    np.testing.assert_array_equal(weights.flax_tree(models.face_cnn)["conv_0"]["kernel"], state["conv2d"]["kernel"])
    np.testing.assert_array_equal(
        weights.flax_tree(models.landmark)["conv_0"]["kernel"], np.asarray(lm_params["conv_0"]["kernel"])
    )

    del models.loaded["face_cnn"]
    PG._init_then_load(models, "face_cnn", models.face_cnn, 1, "checkpoints/face_emotion_cnn.msgpack",
                       read=lambda path: PFace.load_emotion_weights(models.face_cnn, path))
    assert "face_cnn" not in models.loaded
    seed, init = inits[0]
    assert seed == 1 and len(inits) == 3  # initialize's; the misfit's, and its re-init after the failed load
    for name, got in models.face_cnn.named_parameters():
        assert torch.equal(got, init[name]), name


# --- extractor_impl="matmul" -------------------------------------------------------

ODD = dict(conv_channels=(16, 16, 16, 16), conv_kernels=(10, 3, 3, 2), conv_strides=(5, 2, 2, 2))
WIDE = dict(conv_channels=(128, 128, 128, 128), conv_kernels=(10, 3, 3, 2), conv_strides=(5, 2, 2, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("widths", ["odd", "wide"])
def test_matmul_extractor_matches_jax_and_conv(widths, dtype, monkeypatch):
    """JAX's ``extractor_impl="matmul"`` extractor and the port's on one
    init, wav of 4003 samples (odd lengths at every layer, both kernel
    sizes), and the port's matmul against its own cuDNN-form "conv"; on
    the CPU no width reaches conv_stride2_fused, 128 channels (its
    contract) included: the GEMM layers follow JAX's order."""
    dims = ODD if widths == "odd" else WIDE
    jcfg = JAud.AudioModelConfig(**dims, extractor_impl="matmul", encoder=dataclasses.replace(JEncCfg.tiny(), compute_dtype=dtype))
    pcfg = PAud.AudioModelConfig(**dims, extractor_impl="matmul", encoder=dataclasses.replace(PEncCfg.tiny(), compute_dtype=dtype))
    wav = np.random.default_rng(0).normal(size=(2, 4003)).astype(np.float32)
    jfx = JAud.ConvFeatureExtractor(jcfg)
    params = jax.jit(jfx.init)(jax.random.PRNGKey(0), wav)["params"]
    want = f32(jax.jit(jfx.apply)({"params": params}, wav))

    launches = []
    real = KC.conv_stride2_fused
    monkeypatch.setattr(PAud, "conv_stride2_fused", lambda x, w: launches.append(x.shape) or real(x, w))
    pfx = PAud.ConvFeatureExtractor(pcfg)
    weights.load_flax_tree(pfx, to_numpy(params))
    conv = PAud.ConvFeatureExtractor(dataclasses.replace(pcfg, extractor_impl="conv"))
    conv.load_state_dict(pfx.state_dict())
    with torch.no_grad():
        got, got_conv = f32(pfx(torch.from_numpy(wav))), f32(conv(torch.from_numpy(wav)))
    assert got.shape == want.shape == got_conv.shape == (2, 99, dims["conv_channels"][-1])
    assert launches == []
    bound = 2e-5 if dtype == "float32" else bf16_bound(want)
    for other in (want, got_conv):
        err = np.abs(got - other).max()
        assert err <= bound, (err, bound)


def test_matmul_gate_follows_jax():
    """Only layers after the first with stride 2 and kernel 2 or 3 run as
    GEMMs (msa_tpu/models/audio.py:165); a config that mixes them with
    convolutions changes layout between the two and still gives JAX's
    output (f32, within 2e-5)."""
    dims = dict(conv_channels=(8,) * 5, conv_kernels=(10, 3, 4, 2, 3), conv_strides=(2, 2, 2, 3, 2), extractor_impl="matmul")
    fx = PAud.ConvFeatureExtractor(PAud.AudioModelConfig(**dims, encoder=PEncCfg.tiny()))
    assert [fx.as_matmul(i) for i in range(5)] == [False, True, False, False, True]
    assert not any(PAud.ConvFeatureExtractor(dataclasses.replace(fx.cfg, extractor_impl="conv")).as_matmul(i) for i in range(5))
    wav = np.random.default_rng(2).normal(size=(2, 1000)).astype(np.float32)
    jfx = JAud.ConvFeatureExtractor(JAud.AudioModelConfig(**dims, encoder=JEncCfg.tiny()))
    params = jax.jit(jfx.init)(jax.random.PRNGKey(0), wav)["params"]
    weights.load_flax_tree(fx, to_numpy(params))
    with torch.no_grad():
        got = fx(torch.from_numpy(wav)).numpy()
    want = np.asarray(jax.jit(jfx.apply)({"params": params}, wav))
    assert got.shape == want.shape == (2, 20, 8)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("widths", ["odd", "wide"])
def test_matmul_extractor_trains_like_jax(widths):
    """Gradients through ``extractor_impl="matmul"`` (f32): those of a
    fixed projection of the extractor's output on every conv kernel and
    the GroupNorm within 1e-5 of the largest of JAX's ``jax.grad``, and of
    the port's own "conv" extractor's."""
    dims = ODD if widths == "odd" else WIDE
    jfx = JAud.ConvFeatureExtractor(JAud.AudioModelConfig(**dims, extractor_impl="matmul", encoder=JEncCfg.tiny()))
    pcfg = PAud.AudioModelConfig(**dims, extractor_impl="matmul", encoder=PEncCfg.tiny())
    rng = np.random.default_rng(3)
    wav = rng.normal(size=(2, 4003)).astype(np.float32)
    proj = rng.normal(size=(2, 99, dims["conv_channels"][-1])).astype(np.float32)
    params = jax.jit(jfx.init)(jax.random.PRNGKey(0), wav)["params"]
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(jfx.apply({"params": p}, wav) * proj)))(params)
    want = {f"conv_{i}.weight": np.asarray(jgrads[f"conv_{i}"]["kernel"]).transpose(2, 1, 0) for i in range(4)}
    want.update({"gn.weight": np.asarray(jgrads["gn"]["scale"]), "gn.bias": np.asarray(jgrads["gn"]["bias"])})
    pfx = PAud.ConvFeatureExtractor(pcfg)
    weights.load_flax_tree(pfx, to_numpy(params))
    conv = PAud.ConvFeatureExtractor(dataclasses.replace(pcfg, extractor_impl="conv"))
    conv.load_state_dict(pfx.state_dict())
    for fx in (pfx, conv):
        (fx(torch.from_numpy(wav)) * torch.from_numpy(proj)).sum().backward()
        got = dict(fx.named_parameters())
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            err = np.abs(got[name].grad.numpy() - w).max()
            assert err <= 1e-5 * np.abs(w).max(), (name, err, np.abs(w).max())
