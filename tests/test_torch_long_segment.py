"""The third slice as a whole, against the JAX package on the CPU.

- The long-segment path: ``segment_samples=12_000`` puts the audio
  encoder of tests/torch_parity.py's configs (kernel paths, d_model 128) at
  T = 598 > 512, so JAX and the port take the flash kernel (row 6) in every
  audio layer; the text stays on attention_block. JAX's trees are carried
  across by ``from_flax``; f32, bf16 and int8 recipes.
- ``PipelineModels.tiny()`` from the seed alone, no ``from_flax``: the
  rebuilt flax init (msa_tpu_torch.flax_init) is what makes the two
  hostpacks agree.
- JAX's checkpoint policy for the fusion MLP, and the streaming entry
  point at a segment length other than 5 s.

Bounds, as tests/test_torch_pipeline.py:96: ≤ 1e-3 per hostpack group in
float32, torch_parity.bf16_bound in bfloat16 and int8.
"""

import logging

import numpy as np
import pytest
import torch

from msa_tpu.core.config import PipelineConfig as JPipeCfg
from msa_tpu.core.config import SystemConfig as JSysCfg
from msa_tpu.models.audio import AudioModelConfig as JAudioCfg
from msa_tpu.models.face import FaceModelConfig as JFaceCfg
from msa_tpu.models.fusion import FusionMLP as JFusion
from msa_tpu.models.text import TextModelConfig as JTextCfg
from msa_tpu.pipeline import graph as JG
from msa_tpu_torch import flax_init
from msa_tpu_torch.core.config import PipelineConfig, SystemConfig
from msa_tpu_torch.models.audio import AudioModelConfig
from msa_tpu_torch.models.face import FaceModelConfig
from msa_tpu_torch.models.fusion import FusionMLP
from msa_tpu_torch.models.text import TextModelConfig
from msa_tpu_torch.ops.kernels import attention as A
from msa_tpu_torch.pipeline import graph as PG
from torch_parity import AUDIO, FACE, TEXT, bf16_bound, jax_encoder_cfg, port_encoder_cfg, to_numpy

LONG = 12_000  # audio T = (12000 − 10)/5 + 1 → (2399 − 8)/4 + 1 = 598
RECIPES = {"float32": ("float32", "none"), "bfloat16": ("bfloat16", "none"), "int8": ("bfloat16", "int8")}


def _inputs(jax_models, b, samples, tokens, vocab):
    rng = np.random.default_rng(1)
    inp = JG.SegmentInputs.zeros(jax_models, b, samples=samples, tokens=tokens)
    inp.frames = rng.integers(0, 256, size=inp.frames.shape, dtype=np.uint8)
    inp.audio = (0.1 * rng.standard_normal((b, samples))).astype(np.float32)
    inp.token_ids = rng.integers(1, vocab, size=(b, tokens)).astype(np.int32)
    inp.token_mask[0] = 1
    inp.token_mask[1, : tokens // 2] = 1
    if b > 2:
        inp.text_avail[2] = False  # an empty transcript
        inp.face_avail[1] = False
    inp.completeness = rng.random(b).astype(np.float32)
    inp.relevance = rng.random(b).astype(np.float32)
    return inp


def _port_inputs(inp):
    return PG.SegmentInputs(**{f.name: getattr(inp, f.name) for f in PG.dataclasses.fields(PG.SegmentInputs)})


def _hold_hostpack(got, want, dtype):
    assert got.shape == want.shape and np.isfinite(got).all()
    for name, sl in PG.PACK_SLICES.items():
        err = np.abs(got[:, sl] - want[:, sl]).max()
        bound = 1e-3 if dtype == "float32" else bf16_bound(want[:, sl])
        assert err <= bound, f"{dtype} {name}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_long_segments_match_jax(recipe, monkeypatch):
    dtype, quantize = RECIPES[recipe]
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
    inp = _inputs(jm, 2, LONG, 32, 128)
    want = np.asarray(JG.SegmentPipeline(jm, JSysCfg(pipeline=JPipeCfg(segment_samples=LONG))).run_host(inp)[0]["hostpack"])
    calls = []
    monkeypatch.setattr(
        "msa_tpu_torch.models.transformer.flash_attention",
        lambda qkv, m: calls.append(tuple(qkv.shape)) or A.flash_attention(qkv, m),
    )
    out, _ = PG.SegmentPipeline(pm, SystemConfig(pipeline=PipelineConfig(segment_samples=LONG))).run_host(_port_inputs(inp))
    assert calls == [(2, 598, 3, 4, 32)] * 2  # each audio layer, none of the text's
    _hold_hostpack(out["hostpack"].numpy(), want, dtype)


def test_tiny_from_the_seed_alone_matches_jax(tiny_models):
    """JAX's PipelineModels.tiny(seed=0) against the port's, each built from
    the seed alone: no weight crosses between them."""
    pm = PG.PipelineModels.tiny(seed=0, device="cpu")
    assert pm.loaded == {}  # the tiny configs name no checkpoint
    inp = _inputs(tiny_models, 3, 8000, 32, 128)
    want = np.asarray(JG.SegmentPipeline(tiny_models).run_host(inp)[0]["hostpack"])
    out, _ = PG.SegmentPipeline(pm).run_host(_port_inputs(inp))
    _hold_hostpack(out["hostpack"].numpy(), want, "float32")


def test_fusion_checkpoint_policy_follows_jax(caplog):
    """An explicit fusion config takes the init (seed 0, as JAX's
    init_params); a fusion_checkpoint that is missing warns and the
    shipped one loads instead."""
    tiny = dict(face_cfg=FaceModelConfig.tiny(), audio_cfg=AudioModelConfig.tiny(), text_cfg=TextModelConfig.tiny(), device="cpu")
    m = PG.PipelineModels.initialize(seed=7, fusion={"hidden_dim": 32}, **tiny)
    assert "fusion" not in m.loaded
    want = flax_init.init_module_(FusionMLP(hidden_dim=32), 7)
    for (n, a), (_, b) in zip(m.fusion.named_parameters(), want.named_parameters()):
        assert torch.equal(a, b), n
    with caplog.at_level(logging.WARNING, logger="msa_tpu_torch.pipeline.graph"):
        m = PG.PipelineModels.initialize(seed=7, fusion_checkpoint="checkpoints/no_such_fusion.msgpack", **tiny)
    assert "no_such_fusion" in caplog.text
    assert m.loaded["fusion"].endswith("checkpoints/fusion.msgpack")
    assert m.fusion.text_proj.weight.shape == (1024, 783)


def test_stream_window_at_another_segment_length():
    """run_stream unpacks the window at the configured segment_samples and
    equals run_host on the same window; a window of another length is
    refused."""
    models = PG.PipelineModels.tiny(seed=1, device="cpu")
    pipe = PG.SegmentPipeline(models, SystemConfig(pipeline=PipelineConfig(segment_samples=LONG)))
    rng = np.random.default_rng(2)
    inp = PG.SegmentInputs.zeros(models, 1, samples=LONG, tokens=16)
    window = dict(
        frames_u8=rng.integers(0, 256, size=inp.frames.shape[1:], dtype=np.uint8),
        audio_i16=(3000 * rng.standard_normal(LONG)).astype(np.int16),
        token_ids=rng.integers(1, 128, size=16).astype(np.int32),
        token_mask=np.ones(16, np.int32),
        face_avail=True,
        audio_avail=True,
        text_avail=True,
        completeness=0.5,
        relevance=0.25,
    )
    carry = (torch.zeros(478, 3), torch.tensor(False))
    got, _ = pipe.run_stream(PG.pack_stream_inputs(**window), *carry)
    inp.frames, inp.audio = window["frames_u8"][None], window["audio_i16"][None]
    inp.token_ids, inp.token_mask = window["token_ids"][None], window["token_mask"][None]
    inp.completeness[:], inp.relevance[:] = 0.5, 0.25
    want, _ = pipe.run_host(inp)
    assert torch.equal(got["hostpack"], want["hostpack"])
    with pytest.raises(ValueError):
        pipe.run_stream(PG.pack_stream_inputs(**{**window, "audio_i16": window["audio_i16"][:8000]}), *carry)
    padded, real = PG.pad_segment_inputs(inp, 4)
    assert real == 1 and padded.audio.shape == (4, LONG)
