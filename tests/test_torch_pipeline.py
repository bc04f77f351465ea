"""The slice as a whole: the port's SegmentPipeline.run_host against the
JAX SegmentPipeline.run_host on the same weights and inputs.

The JAX models come from PipelineModels.initialize with 128-wide encoders
(attention_impl="pallas", ffn_impl="pallas", so the Pallas kernels run, in
interpret mode), small face/audio/fusion configs, and three recipes: f32,
bf16 (quantize="none") and int8 (bf16 with W8A8 projections and FFN); the
port gets the very same parameters through msa_tpu_torch.weights. The batch
has a row without text (an empty transcript: all-zero token mask), a row
without face and a row without audio.

Bounds per _PACK_FIELDS group: ≤ 1e-3 in float32; in bfloat16 and int8
the bound of torch_parity.bf16_bound (5 bf16 steps of the group's largest
value): the int8 kernels' plain versions quantize bit for bit as JAX does
and their int32 sums are exact, so int8 rounds at the same points as bf16.
"""

import numpy as np
import pytest
import torch

from msa_tpu.models.audio import AudioModelConfig as JAudioCfg
from msa_tpu.models.face import FaceModelConfig as JFaceCfg
from msa_tpu.models.fusion import FusionMLP as JFusion
from msa_tpu.models.text import TextModelConfig as JTextCfg
from msa_tpu.pipeline import graph as JG
from msa_tpu_torch.models.audio import AudioModelConfig
from msa_tpu_torch.models.face import FaceModelConfig
from msa_tpu_torch.models.text import TextModelConfig
from msa_tpu_torch.pipeline import graph as PG
from torch_parity import AUDIO, FACE, TEXT, bf16_bound, jax_encoder_cfg, port_encoder_cfg, to_numpy

B, L, SAMPLES = 4, 32, 4000


def _inputs(jax_models):
    rng = np.random.default_rng(0)
    inp = JG.SegmentInputs.zeros(jax_models, B, samples=SAMPLES, tokens=L)
    inp.frames = rng.integers(0, 256, size=inp.frames.shape, dtype=np.uint8)
    inp.audio = (0.1 * rng.standard_normal((B, SAMPLES))).astype(np.float32)
    inp.token_ids = rng.integers(1, 128, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 20:] = 0
    mask[2, :] = 0  # empty transcript
    inp.token_mask = mask
    inp.text_avail = np.array([1, 1, 0, 1], bool)
    inp.face_avail = np.array([1, 0, 1, 1], bool)
    inp.audio_avail = np.array([1, 1, 1, 0], bool)
    inp.completeness = rng.random(B).astype(np.float32)
    inp.relevance = rng.random(B).astype(np.float32)
    inp.prev_landmarks = rng.uniform(0.2, 0.8, size=(478, 3)).astype(np.float32)
    inp.has_prev = np.asarray(True)
    return inp


RECIPES = {"float32": ("float32", "none"), "bfloat16": ("bfloat16", "none"), "int8": ("bfloat16", "int8")}


@pytest.fixture(scope="module", params=sorted(RECIPES))
def runs(request):
    dtype, quantize = RECIPES[request.param]
    jenc = jax_encoder_cfg(dtype, quantize=quantize)
    jm = JG.PipelineModels.initialize(
        0,
        face_cfg=JFaceCfg(**FACE),
        audio_cfg=JAudioCfg(positional="conv", encoder=jenc, **AUDIO),
        text_cfg=JTextCfg(encoder=jenc, **TEXT),
        fusion=JFusion(hidden_dim=64),
        quantize=quantize,
    )
    penc = port_encoder_cfg(dtype, quantize=quantize)
    pm = PG.PipelineModels.from_flax(
        to_numpy(jm.params_tree()),
        FaceModelConfig(**FACE),
        AudioModelConfig(encoder=penc, **AUDIO),
        TextModelConfig(encoder=penc, **TEXT),
        {"hidden_dim": 64},
        device="cpu",
    )
    inp = _inputs(jm)
    jout, jcarry = JG.SegmentPipeline(jm).run_host(inp)
    port_inp = PG.SegmentInputs(**{f.name: getattr(inp, f.name) for f in PG.dataclasses.fields(PG.SegmentInputs)})
    pout, pcarry = PG.SegmentPipeline(pm).run_host(port_inp)
    return dtype, (jout, jcarry), (pout, pcarry)


def test_hostpack_matches_jax_group_by_group(runs):
    dtype, (jout, _), (pout, _) = runs
    want = np.asarray(jout["hostpack"])
    got = pout["hostpack"].numpy()
    assert got.shape == want.shape == (B, PG.PACK_WIDTH) and PG.PACK_WIDTH == 1715
    assert [(n, s) for n, s in PG.PACK_SLICES.items()] == [(n, s) for n, s in JG._PACK_SLICES.items()]
    assert np.isfinite(got).all()
    for name, sl in PG.PACK_SLICES.items():
        err = np.abs(got[:, sl] - want[:, sl]).max()
        bound = 1e-3 if dtype == "float32" else bf16_bound(want[:, sl])
        assert err <= bound, f"{dtype} {name}: {err:.3e} > {bound:.3e}"


def test_missing_modalities_take_the_defaults(runs):
    _, (jout, _), (pout, _) = runs
    got = PG.unpack_hostpack(pout["hostpack"].numpy())
    np.testing.assert_array_equal(got["combo"][:, 0], [7, 3, 6, 5])
    np.testing.assert_allclose(got["text783"][2, :7], 1 / 7)  # no text: default vector
    np.testing.assert_allclose(got["text783"][2, 7:], 0)
    np.testing.assert_allclose(got["face27"][1, :7], 1 / 7)
    np.testing.assert_allclose(got["audio31"][3, :8], 1 / 8)
    np.testing.assert_allclose(got["s_face_quality"][1], 0)


def test_landmarks_detected_and_carry_match_jax(runs):
    _, (jout, (jl, jd)), (pout, (pl, pd)) = runs
    np.testing.assert_allclose(pout["landmarks"].numpy(), np.asarray(jout["landmarks"]), atol=1e-5)
    np.testing.assert_array_equal(pout["detected"].numpy(), np.asarray(jout["detected"]))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-5)
    assert bool(pd) == bool(jd)


def test_initialize_loads_the_shipped_checkpoints_on_cpu():
    enc = port_encoder_cfg("bfloat16")
    models = PG.PipelineModels.initialize(
        seed=1,
        audio_cfg=AudioModelConfig(encoder=enc, **{**AUDIO, "head_weights": None}),
        text_cfg=TextModelConfig(encoder=enc, **TEXT),
        quantize="none",
        device="cpu",
    )
    assert models.device.type == "cpu"
    assert sorted(models.loaded) == ["face_cnn", "fusion", "landmark"]  # heads configured as None
    assert models.fusion.text_proj.weight.shape == (1024, 783)  # the shipped exact-dims fusion
    inp = PG.SegmentInputs.zeros(models, 2, samples=SAMPLES, tokens=L)
    inp.token_mask[:] = 1
    out, (last_lm, _) = PG.SegmentPipeline(models).run_host(inp)
    assert out["hostpack"].shape == (2, 1715) and torch.isfinite(out["hostpack"]).all()
    assert last_lm.shape == (478, 3)


@pytest.mark.parametrize(
    "head_weights,error",
    [("checkpoints/text_heads.msgpack", ValueError), ("checkpoints/no_such_heads.msgpack", FileNotFoundError)],
)
def test_initialize_raises_on_a_shipped_checkpoint_it_cannot_load(head_weights, error):
    """A configured checkpoint that does not fit (768-wide heads on a
    128-wide trunk) or is missing raises instead of leaving random weights."""
    enc = port_encoder_cfg("bfloat16")
    with pytest.raises(error):
        PG.PipelineModels.initialize(
            face_cfg=FaceModelConfig(**FACE),
            audio_cfg=AudioModelConfig(encoder=enc, **AUDIO),
            text_cfg=TextModelConfig(encoder=enc, **{**TEXT, "head_weights": head_weights}),
            quantize="none",
            device="cpu",
        )


def test_initialize_builds_the_int8_recipe_by_default(monkeypatch):
    """No ``quantize`` and no MSA_QUANTIZE: JAX's production default, W8A8
    encoders at full width, with every shipped checkpoint loaded; the bf16
    recipe derives its weights from the same f32 masters."""
    monkeypatch.delenv("MSA_QUANTIZE", raising=False)
    models = PG.PipelineModels.initialize(device="cpu")
    assert sorted(models.loaded) == ["audio_head", "face_cnn", "fusion", "landmark", "text_heads"]
    for enc in (models.text.encoder, models.audio.encoder):
        assert enc.cfg.quantize == "int8" and enc.cfg.compute_dtype == "bfloat16"
        assert enc.cfg.attention_impl == enc.cfg.ffn_impl == "kernel"
    layer = models.text.encoder.layer_11
    assert layer.fc_in.weight.dtype == torch.float32 and layer.w_in_q.dtype == torch.int8
    assert layer.attention.w_qkv_q.shape == (3 * 768, 768) and layer.attention.s_qkv.shape == (3 * 768,)
    bf16 = models.with_encoders(quantize="none")
    blayer = bf16.text.encoder.layer_11
    assert blayer.fc_in.weight.data_ptr() == layer.fc_in.weight.data_ptr()  # the same masters
    assert torch.equal(blayer.w_in_c, layer.fc_in.weight.to(torch.bfloat16))
    back = bf16.with_encoders(quantize="int8").text.encoder.layer_11
    assert torch.equal(back.w_in_q, layer.w_in_q) and torch.equal(back.attention.s_out, layer.attention.s_out)


class _Built(Exception):
    pass


@pytest.mark.parametrize(
    "arg,env,want",
    [(None, None, "int8"), (None, "none", "none"), (None, "int8", "int8"), ("int8", "none", "int8"), ("none", None, "none")],
)
def test_quantize_resolves_like_jax(monkeypatch, arg, env, want):
    """The argument, then MSA_QUANTIZE, then "int8" (msa_tpu/pipeline/graph.py:114-117)."""
    if env is None:
        monkeypatch.delenv("MSA_QUANTIZE", raising=False)
    else:
        monkeypatch.setenv("MSA_QUANTIZE", env)
    seen = []

    def build(cls, face_cfg, audio_cfg, text_cfg, fusion_dims, device):
        seen.append((audio_cfg.encoder.quantize, text_cfg.encoder.quantize))
        raise _Built

    monkeypatch.setattr(PG.PipelineModels, "_build", classmethod(build))
    with pytest.raises(_Built):
        PG.PipelineModels.initialize(quantize=arg, device="cpu")
    assert seen == [(want, want)]


def test_unknown_quantize_mode_raises():
    with pytest.raises(ValueError):
        PG.PipelineModels.serving_encoder("int4")


def test_pad_segment_inputs_pads_with_unavailable_rows():
    inp = PG.SegmentInputs(
        frames=np.zeros((3, 8, 8, 3), np.uint8),
        audio=np.zeros((3, 100), np.float32),
        token_ids=np.zeros((3, 4), np.int32),
        token_mask=np.ones((3, 4), np.int32),
        face_avail=np.ones(3, bool),
        audio_avail=np.ones(3, bool),
        text_avail=np.ones(3, bool),
        completeness=np.zeros(3, np.float32),
        relevance=np.zeros(3, np.float32),
        prev_landmarks=np.zeros((478, 3), np.float32),
        has_prev=np.asarray(False),
    )
    padded, real = PG.pad_segment_inputs(inp, 4)
    assert real == 3 and padded.frames.shape[0] == 4
    assert not padded.face_avail[3] and not padded.text_avail[3]
    assert padded.prev_landmarks is inp.prev_landmarks


def test_with_encoders_shares_weights_and_switches_to_the_plain_path():
    enc = port_encoder_cfg("bfloat16")
    models = PG.PipelineModels.initialize(
        seed=2,
        face_cfg=FaceModelConfig(**FACE),
        audio_cfg=AudioModelConfig(encoder=enc, **AUDIO),
        text_cfg=TextModelConfig(encoder=enc, **TEXT),
        quantize="none",
        device="cpu",
    )
    plain = models.with_encoders(attention_impl="einsum", ffn_impl="dense")
    assert plain.text.encoder.cfg.attention_impl == "einsum" and plain.audio.encoder.cfg.ffn_impl == "dense"
    assert models.text.encoder.cfg.attention_impl == "kernel"
    assert plain.text.embeddings.word_embeddings.weight.data_ptr() == models.text.embeddings.word_embeddings.weight.data_ptr()
    assert plain.fusion is models.fusion
    inp = PG.SegmentInputs.zeros(models, 2, samples=SAMPLES, tokens=L)
    inp.token_mask[0] = 1
    a, _ = PG.SegmentPipeline(models).run_host(inp)
    b, _ = PG.SegmentPipeline(plain).run_host(inp)
    want = b["hostpack"].numpy()
    assert np.abs(a["hostpack"].numpy() - want).max() <= bf16_bound(want)
