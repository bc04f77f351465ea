"""JAX's f32 parity mode in the port: imported trunks served in f32
through the kernels' f32 variants.

- the serving precision resolves as JAX's (``msa_tpu/pipeline/graph.py:
  113-131``, held by tests/test_pipeline.py:170-190): imported trunks and
  no quantize asked for give f32 kernels with ``quantize="none"``; an
  explicit quantize (argument or MSA_QUANTIZE) keeps the bf16 recipe;
- a caller's trunk is the whole tree of its model: the shipped heads are
  not loaded over it, and a tree that lacks a parameter raises;
- the port's small parity-mode pipeline (imported BERT and wav2vec2 trunks,
  f32 kernel path, the kernels' plain versions on the CPU) against JAX's
  ``PipelineModels`` on the same trees, its Pallas kernels in interpret
  mode, within 1e-3 on every hostpack column;
- JAX's own in-graph check on the port (tests/test_pipeline.py:192): the
  f32 kernel path against the plain einsum/dense f32 path within 1e-3.
"""

import flax.serialization
import numpy as np
import pytest
import torch

from msa_tpu.models.audio import AudioModelConfig as JAudioCfg
from msa_tpu.models.face import FaceModelConfig as JFaceCfg
from msa_tpu.models.fusion import FusionMLP as JFusion
from msa_tpu.models.text import TextModelConfig as JTextCfg
from msa_tpu.pipeline import graph as JG
from msa_tpu_torch import weights
from msa_tpu_torch.models import audio as PAudio
from msa_tpu_torch.models import text as PText
from msa_tpu_torch.models.audio import AudioModelConfig
from msa_tpu_torch.models.face import FaceModelConfig
from msa_tpu_torch.models.text import TextModelConfig
from msa_tpu_torch.pipeline import graph as PG
from torch_parity import AUDIO, ENC, FACE, TEXT, jax_encoder_cfg, port_encoder_cfg, to_numpy

transformers = pytest.importorskip("transformers")

B, L, SAMPLES = 3, 32, 4000
STAND_IN = {"stand_in": np.zeros(1, np.float32)}


class _Built(Exception):
    pass


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: np.asarray(v)})
    return out


def _shift(tree):
    return {k: _shift(v) if isinstance(v, dict) else (v + 1.0).astype(np.float32) for k, v in tree.items()}


@pytest.mark.parametrize(
    "quantize,env,imported,want",
    [
        (None, None, True, ("none", "float32")),  # JAX's parity mode
        ("int8", None, True, ("int8", "bfloat16")),  # an explicit quantize wins
        ("none", None, True, ("none", "bfloat16")),
        (None, "none", True, ("none", "bfloat16")),  # MSA_QUANTIZE is explicit too
        (None, None, False, ("int8", "bfloat16")),  # the serving default
        ("none", None, False, ("none", "bfloat16")),
    ],
)
def test_precision_resolves_like_jax(monkeypatch, quantize, env, imported, want):
    if env is None:
        monkeypatch.delenv("MSA_QUANTIZE", raising=False)
    else:
        monkeypatch.setenv("MSA_QUANTIZE", env)
    resolved, parity = PG.resolve_precision(quantize, imported)
    assert (resolved, "float32" if parity else "bfloat16") == want
    seen = []

    def build(cls, face_cfg, audio_cfg, text_cfg, fusion_dims, device):
        seen.extend((audio_cfg.encoder, text_cfg.encoder))
        raise _Built

    monkeypatch.setattr(PG.PipelineModels, "_build", classmethod(build))
    trees = dict(text_params=STAND_IN, audio_params=STAND_IN) if imported else {}
    with pytest.raises(_Built):
        PG.PipelineModels.initialize(quantize=quantize, device="cpu", **trees)
    for enc in seen:
        assert (enc.quantize, enc.compute_dtype) == want
        assert enc.attention_impl == enc.ffn_impl == "kernel"


def _cfgs(penc, text_heads=None, audio_head=None):
    return dict(
        face_cfg=FaceModelConfig(**FACE),
        audio_cfg=AudioModelConfig(positional="conv", encoder=penc, **{**AUDIO, "head_weights": audio_head}),
        text_cfg=TextModelConfig(encoder=penc, **{**TEXT, "head_weights": text_heads}),
        fusion={"hidden_dim": 64},
        device="cpu",
    )


def test_imported_trunks_keep_their_heads(tmp_path, monkeypatch):
    """Head checkpoints that fit load over the init, but not over a trunk
    the caller passes; params_tree() is the inverse of from_flax."""
    monkeypatch.delenv("MSA_QUANTIZE", raising=False)
    penc = port_encoder_cfg("float32")
    base = PG.PipelineModels.initialize(0, **_cfgs(penc))
    tree = base.params_tree()
    rng = np.random.default_rng(1)
    heads = {k: tree["text"][k] for k in ("emotion_head", "sarcasm_head", "humor_head", "sentiment_head")}
    heads = {k: {n: (v + rng.normal(size=v.shape)).astype(np.float32) for n, v in h.items()} for k, h in heads.items()}
    audio_head = {k: _shift(tree["audio"][k]) for k in ("pool", "emotion_head")}
    text_file, audio_file = tmp_path / "text_heads.msgpack", tmp_path / "audio_head.msgpack"
    text_file.write_bytes(flax.serialization.msgpack_serialize(heads))
    audio_file.write_bytes(flax.serialization.msgpack_serialize(audio_head))
    cfgs = _cfgs(penc, str(text_file), str(audio_file))

    loaded = PG.PipelineModels.initialize(0, **cfgs)
    assert {"text_heads", "audio_head"} <= set(loaded.loaded)
    assert torch.equal(loaded.text.emotion_head.bias, torch.from_numpy(heads["emotion_head"]["bias"]))
    assert torch.equal(loaded.audio.emotion_head.bias, torch.from_numpy(audio_head["emotion_head"]["bias"]))

    imported = PG.PipelineModels.initialize(0, text_params=tree["text"], audio_params=tree["audio"], **cfgs)
    assert "text_heads" not in imported.loaded and "audio_head" not in imported.loaded
    for name in ("text", "audio"):  # every leaf the caller's, none from the head files
        got, want = _flat(imported.params_tree()[name]), _flat(tree[name])
        assert sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want), name

    round_trip = PG.PipelineModels.from_flax(tree, cfgs["face_cfg"], cfgs["audio_cfg"], cfgs["text_cfg"], {"hidden_dim": 64}, "cpu")
    for a, b in zip(base.modules(), round_trip.modules()):
        for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
            assert torch.equal(p, q), n

    trunk_only = {k: v for k, v in tree["text"].items() if not k.endswith("_head")}
    with pytest.raises(KeyError, match="lack"):
        PG.PipelineModels.initialize(0, text_params=trunk_only, **cfgs)


def _hf_trunks():
    torch.manual_seed(0)
    bert = transformers.BertModel(
        transformers.BertConfig(
            vocab_size=TEXT["vocab_size"], hidden_size=ENC["d_model"], num_hidden_layers=ENC["num_layers"],
            num_attention_heads=ENC["num_heads"], intermediate_size=ENC["d_ff"],
            max_position_embeddings=TEXT["max_positions"], hidden_act="gelu",
        )
    ).eval()
    w2v = transformers.Wav2Vec2Model(
        transformers.Wav2Vec2Config(
            conv_dim=AUDIO["conv_channels"], conv_kernel=AUDIO["conv_kernels"], conv_stride=AUDIO["conv_strides"],
            num_feat_extract_layers=len(AUDIO["conv_channels"]), hidden_size=ENC["d_model"],
            num_hidden_layers=ENC["num_layers"], num_attention_heads=ENC["num_heads"],
            intermediate_size=ENC["d_ff"], num_conv_pos_embeddings=AUDIO["pos_conv_kernel"],
            num_conv_pos_embedding_groups=AUDIO["pos_conv_groups"], feat_extract_norm="group",
            do_stable_layer_norm=False, hidden_act="gelu", feat_extract_activation="gelu",
        )
    ).eval()
    return bert.state_dict(), w2v.state_dict()


def _inputs(jax_models):
    rng = np.random.default_rng(0)
    inp = JG.SegmentInputs.zeros(jax_models, B, samples=SAMPLES, tokens=L)
    inp.frames = rng.integers(0, 256, size=inp.frames.shape, dtype=np.uint8)
    inp.audio = (0.1 * rng.standard_normal((B, SAMPLES))).astype(np.float32)
    inp.token_ids = rng.integers(1, TEXT["vocab_size"], size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 20:] = 0
    inp.token_mask = mask
    inp.face_avail = np.array([1, 0, 1], bool)
    inp.completeness = rng.random(B).astype(np.float32)
    inp.relevance = rng.random(B).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def parity():
    """JAX's and the port's small pipelines on the same imported trunks (heads,
    face nets and fusion from JAX's init), in the parity mode's f32 kernels."""
    bert_sd, w2v_sd = _hf_trunks()
    jenc = jax_encoder_cfg("float32")
    jcfgs = dict(
        face_cfg=JFaceCfg(**FACE),
        audio_cfg=JAudioCfg(positional="conv", encoder=jenc, **AUDIO),
        text_cfg=JTextCfg(encoder=jenc, **TEXT),
        fusion=JFusion(hidden_dim=64),
    )
    init = to_numpy(JG.PipelineModels.initialize(0, **jcfgs).params_tree())
    text = {**init["text"], **JG.text_lib.params_from_hf_bert(bert_sd, jcfgs["text_cfg"])}
    audio = {**init["audio"], **JG.audio_lib.params_from_hf_wav2vec2(w2v_sd, jcfgs["audio_cfg"])}
    jm = JG.PipelineModels.initialize(0, text_params=text, audio_params=audio, fusion_params=init["fusion"], **jcfgs)

    penc = port_encoder_cfg("float32")
    pcfgs = _cfgs(penc)
    ptext = {**init["text"], **PText.params_from_hf_bert(bert_sd, pcfgs["text_cfg"])}
    paudio = {**init["audio"], **PAudio.params_from_hf_wav2vec2(w2v_sd, pcfgs["audio_cfg"])}
    pm = PG.PipelineModels.initialize(0, text_params=ptext, audio_params=paudio, fusion_params=init["fusion"], **pcfgs)
    # the face nets from JAX's own init, so that only the encoders' paths differ
    weights.load_flax_tree(pm.landmark, init["landmark"])
    weights.load_flax_tree(pm.face_cnn, init["face_cnn"])
    inp = _inputs(jm)
    want = np.asarray(JG.SegmentPipeline(jm).run_host(inp)[0]["hostpack"])
    port_inp = PG.SegmentInputs(**{f.name: getattr(inp, f.name) for f in PG.dataclasses.fields(PG.SegmentInputs)})
    return pm, port_inp, want


def _hold(got, want, what):
    assert got.shape == want.shape == (B, PG.PACK_WIDTH) and np.isfinite(got).all()
    for name, sl in PG.PACK_SLICES.items():
        err = np.abs(got[:, sl] - want[:, sl]).max()
        assert err <= 1e-3, f"{what} {name}: {err:.3e}"


def test_parity_hostpack_matches_jax(parity):
    pm, inp, want = parity
    for enc in (pm.text.encoder, pm.audio.encoder):
        assert (enc.cfg.compute_dtype, enc.cfg.attention_impl, enc.cfg.ffn_impl) == ("float32", "kernel", "kernel")
    got = PG.SegmentPipeline(pm).run_host(inp)[0]["hostpack"].numpy()
    _hold(got, want, "port vs JAX")


def test_parity_kernel_path_matches_einsum_in_graph(parity):
    """tests/test_pipeline.py:192 on the port: the f32 kernel path against
    the plain einsum/dense f32 path, same params, same inputs."""
    pm, inp, _ = parity
    got = PG.SegmentPipeline(pm).run_host(inp)[0]["hostpack"].numpy()
    plain = pm.with_encoders(attention_impl="einsum", ffn_impl="dense")
    assert plain.text.encoder.cfg.compute_dtype == "float32"
    want = PG.SegmentPipeline(plain).run_host(inp)[0]["hostpack"].numpy()
    _hold(got, want, "kernel vs einsum")
