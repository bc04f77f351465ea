"""The JAX package's flax init, rebuilt in PyTorch (msa_tpu_torch.flax_init),
against ``init_params`` itself.

Contract: the integer stream (threefry bits, the SHA-1 fold of the module
path) is bit-equal; every float leaf lies within ULP_BOUND f32 ulp of
JAX's, with at least SHARE_BOUND of its elements bit-equal (the float steps
copy XLA's CPU erf_inv, log1p and log, and what is left is the order of a
few fused operations); zeros and ones are exact.
"""

import flax.core.scope as flax_scope
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
from msa_tpu.ops import quant as JQ
from msa_tpu_torch import flax_init as FI
from msa_tpu_torch import weights
from msa_tpu_torch.models import audio as PAud
from msa_tpu_torch.models import face as PFace
from msa_tpu_torch.models import fusion as PFus
from msa_tpu_torch.models import text as PText
from msa_tpu_torch.models.transformer import TransformerEncoder as PEncoder
from msa_tpu_torch.pipeline import graph as PG
from torch_parity import jax_encoder_cfg, port_encoder_cfg, to_numpy

ULP_BOUND, SHARE_BOUND = 4, 0.98


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance in f32 ulp (the count of floats between)."""

    def ordered(x):
        i = x.detach().float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("seed,shape", [(0, (7,)), (3, (33, 5)), (123456, (4, 3, 100))])
def test_threefry_bits_match_jax(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32)).astype(np.int64).reshape(-1)
    got = FI.random_bits(FI.prng_key(seed), 0, want.size, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert tuple(int(k) for k in np.asarray(jax.random.PRNGKey(seed))) == FI.prng_key(seed)


@pytest.mark.parametrize("parts", [("embeddings", "word_embeddings", 1), ("encoder", "layer_11", "attention", "qkv", 2), ("face_proj", 1)])
def test_the_path_fold_matches_flax(parts):
    root = jax.random.PRNGKey(5)
    want = np.asarray(flax_scope._fold_in_static(root, parts))
    assert FI.fold_in_names(FI.prng_key(5), *parts) == tuple(int(k) for k in want)
    assert FI.fold_in(FI.prng_key(5), 0xDEADBEEF) == tuple(int(k) for k in np.asarray(jax.random.fold_in(root, 0xDEADBEEF)))


def test_erf_inv_matches_xla():
    u = np.random.default_rng(0).uniform(-0.9545, 0.9545, 200_000).astype(np.float32)
    want = torch.from_numpy(np.asarray(jax.jit(jax.lax.erf_inv)(u)))
    d = ulp_distance(FI.erf_inv(torch.from_numpy(u)), want)
    assert int(d.max()) <= 2 and float((d == 0).double().mean()) >= 0.999


def _jax_text():
    return JText.init_params(JText.TextModel(JText.TextModelConfig.tiny()), 3)


def _jax_audio():
    return JAud.init_params(JAud.AudioEmotionModel(JAud.AudioModelConfig.tiny()), 2, samples=8000)


TINY = {
    # name: (port module factory, JAX init params, seed)
    "text": (lambda: PText.TextModel(PText.TextModelConfig.tiny()), _jax_text, 3),
    "audio": (lambda: PAud.AudioEmotionModel(PAud.AudioModelConfig.tiny()), _jax_audio, 2),
    "landmark": (
        lambda: PFace.FaceLandmarkNet(PFace.FaceModelConfig.tiny()),
        lambda: JFace.init_landmark_params(JFace.FaceLandmarkNet(JFace.FaceModelConfig.tiny()), 0),
        0,
    ),
    "face_cnn": (
        lambda: PFace.FaceEmotionCNN(PFace.FaceModelConfig.tiny()),
        lambda: JFace.init_emotion_params(JFace.FaceEmotionCNN(JFace.FaceModelConfig.tiny()), 1),
        1,
    ),
    "fusion": (lambda: PFus.FusionMLP(hidden_dim=64), lambda: JFus.init_params(JFus.FusionMLP(hidden_dim=64), 0), 0),
    # cnn_arch="deepface": the FER-2013 clone's conv_0…conv_4, fc_0, fc_1, emotion_head
    "face_cnn_deepface": (
        lambda: PFace.DeepFaceEmotionCNN(PFace.FaceModelConfig(cnn_arch="deepface")),
        lambda: JFace.init_emotion_params(JFace.DeepFaceEmotionCNN(JFace.FaceModelConfig(cnn_arch="deepface")), 1),
        1,
    ),
}


def _hold_leaves(port, twin, jax_params) -> int:
    """Every leaf of the rebuilt init in ``port`` against JAX's, carried into
    ``twin`` (a module of the same config) by the tested weight loader."""
    weights.load_flax_tree(twin, to_numpy(jax_params))
    const = {id(p) for leaf, p in FI.leaves(port) if leaf.init == "const"}
    pairs = list(zip(port.named_parameters(), twin.named_parameters()))
    assert [n for (n, _), _ in pairs] == [n for _, (n, _) in pairs]
    for (name, got), (_, want) in pairs:
        if id(got) in const:
            torch.testing.assert_close(got, want, rtol=0, atol=0, msg=f"{name}: constant leaf")
            continue
        d = ulp_distance(got, want)
        share = float((d == 0).double().mean())
        assert int(d.max()) <= ULP_BOUND, f"{name}: {int(d.max())} ulp"
        assert share >= SHARE_BOUND, f"{name}: {share:.4f} bit-equal"
    return len(pairs)


@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_leaves_match_init_params(name):
    make, jax_init, seed = TINY[name]
    assert _hold_leaves(FI.init_module_(make(), seed), make(), jax_init()) > 5


def test_int8_codes_of_an_initialised_layer_match_jax(rng):
    """The int8 recipe's derived codes and scales, from the rebuilt f32
    masters, against JAX's quantize_weight_axis on JAX's own init."""
    x = rng.normal(size=(1, 8, 128)).astype(np.float32)
    jp = JEncoder(jax_encoder_cfg("bfloat16", quantize="int8")).init(jax.random.PRNGKey(4), x, np.ones((1, 8), np.int32))["params"]
    enc = FI.init_module_(PEncoder(port_encoder_cfg("bfloat16", quantize="int8")), 4)
    quantize = jax.jit(JQ.quantize_weight_cols)
    for i in range(2):
        layer, jl = getattr(enc, f"layer_{i}"), jp[f"layer_{i}"]
        for got_q, got_s, kernel in (
            (layer.attention.w_qkv_q, layer.attention.s_qkv, jl["attention"]["qkv"]["kernel"]),
            (layer.attention.w_out_q, layer.attention.s_out, jl["attention"]["attn_out"]["kernel"]),
            (layer.w_in_q, layer.s_in, jl["fc_in"]["kernel"]),
            (layer.w_out_q, layer.s_out, jl["fc_out"]["kernel"]),
        ):
            jq, js = quantize(kernel)
            np.testing.assert_array_equal(got_q.numpy(), np.asarray(jq).T)
            np.testing.assert_array_equal(got_s.numpy(), np.asarray(js).reshape(-1))


def test_initialize_builds_from_the_seed_alone():
    """No torch.Generator anywhere: the random draw that stood in for the
    init is gone, and a seed gives the same models twice."""
    import inspect

    assert not hasattr(weights, "draw_random_")
    assert "generator" not in inspect.signature(PG.PipelineModels.initialize).parameters
    a, b = PG.PipelineModels.tiny(seed=5, device="cpu"), PG.PipelineModels.tiny(seed=5, device="cpu")
    for ma, mb in zip(a.modules(), b.modules()):
        for (n, pa), (_, pb) in zip(ma.named_parameters(), mb.named_parameters()):
            assert torch.equal(pa, pb), n


@pytest.mark.slow
@pytest.mark.parametrize("name", ["text", "audio"])
def test_full_size_trunks_match_init_params(name):
    """The full-size text (seed 3) and audio (seed 2) trunks of the serving
    recipe, as initialize() builds them."""
    from msa_tpu.models.transformer import EncoderConfig as JEnc

    jenc = JEnc(compute_dtype="bfloat16", attention_impl="pallas", ffn_impl="pallas", quantize="int8")
    penc = PG.PipelineModels.serving_encoder("int8")
    if name == "text":
        make = lambda: PText.TextModel(PText.TextModelConfig(encoder=penc, head_weights=None))  # noqa: E731
        want, seed = JText.init_params(JText.TextModel(JText.TextModelConfig(encoder=jenc)), 3), 3
    else:
        make = lambda: PAud.AudioEmotionModel(PAud.AudioModelConfig(encoder=penc, head_weights=None))  # noqa: E731
        want, seed = JAud.init_params(JAud.AudioEmotionModel(JAud.AudioModelConfig(encoder=jenc)), 2, samples=8000), 2
    assert _hold_leaves(FI.init_module_(make(), seed), make(), want) > 100
