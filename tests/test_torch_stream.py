"""The packed B=1 streaming entry point: ``pack_stream_inputs`` and
``SegmentPipeline.run_stream`` of the port against the JAX package's, in
the int8 serving recipe at the small configs of torch_parity (128-wide
encoders, the Pallas kernels in interpret mode on the JAX side).

Bounds: the packed buffer is byte-equal; the port's ``run_stream`` equals
its ``run_host`` on the same window bit for bit (one graph, the same
inputs); against JAX, each hostpack column group is held to
torch_parity.bf16_bound, as in tests/test_torch_pipeline.py, and the
landmark carry to 1e-5 (f32 face branch).
"""

import dataclasses

import numpy as np
import pytest
import torch

from msa_tpu.core.config import SystemConfig as JSystemConfig
from msa_tpu.models.audio import AudioModelConfig as JAudioCfg
from msa_tpu.models.face import FaceModelConfig as JFaceCfg
from msa_tpu.models.fusion import FusionMLP as JFusion
from msa_tpu.models.text import TextModelConfig as JTextCfg
from msa_tpu.pipeline import graph as JG
from msa_tpu_torch.core.config import PipelineConfig, SystemConfig
from msa_tpu_torch.models.audio import AudioModelConfig
from msa_tpu_torch.models.face import FaceModelConfig
from msa_tpu_torch.models.text import TextModelConfig
from msa_tpu_torch.pipeline import graph as PG
from torch_parity import AUDIO, FACE, TEXT, bf16_bound, jax_encoder_cfg, port_encoder_cfg, to_numpy

L, SAMPLES = 32, 4000


def _window(rng, text: bool = True):
    mask = np.zeros(L, np.int32)
    if text:
        mask[: int(rng.integers(5, L))] = 1
    return dict(
        frames_u8=rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8),
        audio_i16=(3000 * rng.standard_normal(SAMPLES)).astype(np.int16),
        token_ids=rng.integers(1, 128, size=L).astype(np.int32),
        token_mask=mask,
        face_avail=True,
        audio_avail=True,
        text_avail=text,
        completeness=float(rng.random()),
        relevance=float(rng.random()),
    )


@pytest.fixture(scope="module")
def pipelines():
    jenc = jax_encoder_cfg("bfloat16", quantize="int8")
    jm = JG.PipelineModels.initialize(
        0,
        face_cfg=JFaceCfg(**FACE),
        audio_cfg=JAudioCfg(positional="conv", encoder=jenc, **AUDIO),
        text_cfg=JTextCfg(encoder=jenc, **TEXT),
        fusion=JFusion(hidden_dim=64),
        quantize="int8",
    )
    penc = port_encoder_cfg("bfloat16", quantize="int8")
    pm = PG.PipelineModels.from_flax(
        to_numpy(jm.params_tree()),
        FaceModelConfig(**FACE),
        AudioModelConfig(encoder=penc, **AUDIO),
        TextModelConfig(encoder=penc, **TEXT),
        {"hidden_dim": 64},
        device="cpu",
    )
    jcfg = JSystemConfig()
    jcfg = dataclasses.replace(jcfg, pipeline=dataclasses.replace(jcfg.pipeline, segment_samples=SAMPLES))
    return JG.SegmentPipeline(jm, config=jcfg), PG.SegmentPipeline(pm, config=SystemConfig(pipeline=PipelineConfig(SAMPLES)))


@pytest.mark.parametrize("text", [True, False])
def test_pack_stream_inputs_is_byte_equal_to_jax(rng, text):
    w = _window(rng, text)
    got, want = PG.pack_stream_inputs(**w), JG.pack_stream_inputs(**w)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_run_stream_matches_jax_over_two_windows(pipelines):
    """Window 1 starts without a carry; window 2 takes window 1's. The
    second window has an empty transcript."""
    jpipe, ppipe = pipelines
    rng = np.random.default_rng(7)
    jcarry = (np.zeros((478, 3), np.float32), np.asarray(False))
    pcarry = (torch.zeros(478, 3), torch.tensor(False))
    for text in (True, False):
        packed = PG.pack_stream_inputs(**_window(rng, text))
        jout, jcarry = jpipe.run_stream(packed, *jcarry)
        pout, pcarry = ppipe.run_stream(packed, *pcarry)
        want, got = np.asarray(jout["hostpack"]), pout["hostpack"].numpy()
        assert got.shape == want.shape == (1, PG.PACK_WIDTH) and np.isfinite(got).all()
        for name, sl in PG.PACK_SLICES.items():
            err, bound = np.abs(got[:, sl] - want[:, sl]).max(), bf16_bound(want[:, sl])
            assert err <= bound, f"text={text} {name}: {err:.3e} > {bound:.3e}"
        np.testing.assert_allclose(pcarry[0].numpy(), np.asarray(jcarry[0]), atol=1e-5)
        assert bool(pcarry[1]) == bool(jcarry[1])


def test_run_stream_equals_run_host_on_the_same_window(pipelines):
    _, ppipe = pipelines
    w = _window(np.random.default_rng(3))
    carry = (torch.from_numpy(np.random.default_rng(4).uniform(0.2, 0.8, (478, 3)).astype(np.float32)), torch.tensor(True))
    inp = PG.SegmentInputs(
        frames=w["frames_u8"][None],
        audio=w["audio_i16"][None],
        token_ids=w["token_ids"][None],
        token_mask=w["token_mask"][None],
        face_avail=np.array([w["face_avail"]]),
        audio_avail=np.array([w["audio_avail"]]),
        text_avail=np.array([w["text_avail"]]),
        completeness=np.array([w["completeness"]], np.float32),
        relevance=np.array([w["relevance"]], np.float32),
        prev_landmarks=carry[0],
        has_prev=carry[1],
    )
    host, (hl, hd) = ppipe.run_host(inp)
    stream, (sl, sd) = ppipe.run_stream(PG.pack_stream_inputs(**w), *carry)
    assert torch.equal(stream["hostpack"], host["hostpack"])
    assert torch.equal(sl, hl) and bool(sd) == bool(hd)


def test_run_stream_rejects_a_buffer_that_does_not_fit(pipelines):
    _, ppipe = pipelines
    packed = PG.pack_stream_inputs(**_window(np.random.default_rng(0)))
    with pytest.raises(ValueError):
        ppipe.run_stream(packed[:-3], torch.zeros(478, 3), torch.tensor(False))
    with pytest.raises(TypeError):
        ppipe.run_stream(packed.view(np.int8), torch.zeros(478, 3), torch.tensor(False))
