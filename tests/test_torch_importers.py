"""The port's pretrained-trunk importers against the JAX package's and
against the source models.

``params_from_hf_bert`` and ``params_from_hf_wav2vec2`` (copies in
``msa_tpu_torch/models/``) must give the very trees JAX's converters give,
leaf for leaf and bit for bit, from a randomly initialised
``transformers.BertModel`` / ``Wav2Vec2Model`` built here at a small
config (nothing is downloaded). The port's trunk on those weights must
then match the source model's hidden states within 1e-4, as JAX's
tests/test_text_model.py:85-100 and test_audio_face_models.py:89-145 hold
JAX's: on the plain f32 path and on the f32 kernel path that the parity
mode serves (the kernels' plain versions on the CPU).
"""

import jax
import numpy as np
import pytest
import torch

from msa_tpu.models import audio as JAudio
from msa_tpu.models import text as JText
from msa_tpu.models.transformer import EncoderConfig as JEncCfg
from msa_tpu_torch import flax_init, weights
from msa_tpu_torch.models import audio as PAudio
from msa_tpu_torch.models import text as PText
from msa_tpu_torch.models.transformer import EncoderConfig as PEncCfg
from torch_parity import same_tree

transformers = pytest.importorskip("transformers")

IMPLS = {"plain": dict(attention_impl="einsum", ffn_impl="dense"), "kernel": dict(attention_impl="kernel", ffn_impl="kernel")}
# d_model 128 so that the kernel path takes attention_block and ffn_fused
ENC = dict(num_layers=2, d_model=128, num_heads=4, d_ff=256)


def _bert():
    hf_cfg = transformers.BertConfig(
        vocab_size=128,
        hidden_size=ENC["d_model"],
        num_hidden_layers=ENC["num_layers"],
        num_attention_heads=ENC["num_heads"],
        intermediate_size=ENC["d_ff"],
        max_position_embeddings=64,
        type_vocab_size=2,
        hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
        hidden_act="gelu",
    )
    torch.manual_seed(0)
    return transformers.BertModel(hf_cfg).eval()


def _wav2vec2():
    hf_cfg = transformers.Wav2Vec2Config(
        conv_dim=(16, 16),
        conv_kernel=(10, 8),
        conv_stride=(5, 4),
        num_feat_extract_layers=2,
        hidden_size=ENC["d_model"],
        num_hidden_layers=ENC["num_layers"],
        num_attention_heads=ENC["num_heads"],
        intermediate_size=ENC["d_ff"],
        num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4,
        feat_extract_norm="group",
        do_stable_layer_norm=False,
        hidden_act="gelu",
        feat_extract_activation="gelu",
        hidden_dropout=0.0,
        attention_dropout=0.0,
        activation_dropout=0.0,
        feat_proj_dropout=0.0,
        layerdrop=0.0,
        apply_spec_augment=False,
    )
    torch.manual_seed(0)
    return transformers.Wav2Vec2Model(hf_cfg).eval()


AUDIO = dict(conv_channels=(16, 16), conv_kernels=(10, 8), conv_strides=(5, 4), pool_hidden=8, positional="conv",
             pos_conv_kernel=16, pos_conv_groups=4, head_weights=None)


def test_bert_tree_equals_jax_converters():
    sd = _bert().state_dict()
    jcfg = JText.TextModelConfig(vocab_size=128, max_positions=64, encoder=JEncCfg(**ENC))
    pcfg = PText.TextModelConfig(vocab_size=128, max_positions=64, head_weights=None, encoder=PEncCfg(**ENC))
    same_tree(PText.params_from_hf_bert(sd, pcfg), JText.params_from_hf_bert(sd, jcfg))
    # numpy leaves in, as JAX's converter also takes them
    as_np = {k: v.numpy() for k, v in sd.items()}
    same_tree(PText.params_from_hf_bert(as_np, pcfg), JText.params_from_hf_bert(sd, jcfg))


@pytest.mark.parametrize("pos_names", ["parametrizations", "weight_norm"])
def test_wav2vec2_tree_equals_jax_converters(pos_names):
    sd = dict(_wav2vec2().state_dict())
    pc = "encoder.pos_conv_embed.conv."
    if pos_names == "weight_norm":  # the names of older torch: weight_g / weight_v
        sd[pc + "weight_g"] = sd.pop(pc + "parametrizations.weight.original0")
        sd[pc + "weight_v"] = sd.pop(pc + "parametrizations.weight.original1")
    assert pc + ("weight_g" if pos_names == "weight_norm" else "parametrizations.weight.original0") in sd
    jcfg = JAudio.AudioModelConfig(encoder=JEncCfg(layer_norm_eps=1e-5, **ENC), **AUDIO)
    pcfg = PAudio.AudioModelConfig(encoder=PEncCfg(layer_norm_eps=1e-5, **ENC), **AUDIO)
    same_tree(PAudio.params_from_hf_wav2vec2(sd, pcfg), JAudio.params_from_hf_wav2vec2(sd, jcfg))


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_text_trunk_on_imported_bert_matches_hf(rng, impl):
    hf = _bert()
    cfg = PText.TextModelConfig(
        vocab_size=128, max_positions=64, head_weights=None, encoder=PEncCfg(**ENC, **IMPLS[impl])
    )
    model = flax_init.init_module_(PText.TextModel(cfg).eval(), 3)
    weights.load_flax_tree(model, PText.params_from_hf_bert(hf.state_dict(), cfg))
    ids = rng.integers(0, 128, size=(2, 40)).astype(np.int64)
    mask = np.ones((2, 40), np.int64)
    mask[1, 30:] = 0
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).last_hidden_state
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))["last_hidden_state"]
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_audio_trunk_on_imported_wav2vec2_matches_hf(rng, impl):
    hf = _wav2vec2()
    cfg = PAudio.AudioModelConfig(encoder=PEncCfg(layer_norm_eps=1e-5, **ENC, **IMPLS[impl]), **AUDIO)
    model = flax_init.init_module_(PAudio.AudioEmotionModel(cfg).eval(), 2)
    weights.load_flax_tree(model, PAudio.params_from_hf_wav2vec2(hf.state_dict(), cfg))
    wav = (0.1 * rng.normal(size=(2, 4000))).astype(np.float32)
    with torch.no_grad():
        want = hf(torch.from_numpy(wav)).last_hidden_state
        got = model(torch.from_numpy(wav))["hidden"]
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-4


def test_whisper_importer_matches_jax_and_hf():
    """``params_from_hf_whisper`` on a tiny ``transformers.WhisperModel``
    with random weights (tests/test_whisper.py:56-106's config): JAX's tree
    leaf for leaf, from torch tensors and from numpy arrays alike, and the
    port's teacher-forced logits on it within 2e-4 of HF's (its decoder
    states through the tied embedding) and of JAX's."""
    from msa_tpu.models import whisper as JW
    from msa_tpu_torch.models import whisper as PW

    cfg = PW.WhisperConfig.tiny()
    torch.manual_seed(0)
    hf = transformers.WhisperModel(
        transformers.WhisperConfig(
            vocab_size=cfg.vocab_size, num_mel_bins=cfg.n_mels, d_model=cfg.d_model,
            encoder_layers=cfg.encoder_layers, decoder_layers=cfg.decoder_layers,
            encoder_attention_heads=cfg.num_heads, decoder_attention_heads=cfg.num_heads,
            encoder_ffn_dim=cfg.d_ff, decoder_ffn_dim=cfg.d_ff,
            max_source_positions=cfg.max_source_positions, max_target_positions=cfg.max_target_positions,
            dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, activation_function="gelu",
            pad_token_id=0, bos_token_id=1, eos_token_id=cfg.eos_token_id,
            decoder_start_token_id=cfg.decoder_start_token_id,
        )
    ).eval()
    sd = hf.state_dict()
    tree = PW.params_from_hf_whisper(sd, cfg)
    same_tree(tree, JW.params_from_hf_whisper(sd, JW.WhisperConfig.tiny()))
    same_tree(PW.params_from_hf_whisper({k: v.numpy() for k, v in sd.items()}, cfg), tree)

    rng = np.random.default_rng(0)
    mel = rng.normal(size=(1, 2 * cfg.max_source_positions, cfg.n_mels)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, size=(1, 5))
    with torch.no_grad():
        hidden = hf(input_features=torch.from_numpy(mel.transpose(0, 2, 1)),
                    decoder_input_ids=torch.from_numpy(toks)).last_hidden_state
        want = (hidden @ hf.decoder.embed_tokens.weight.T).numpy()
        got = PW.whisper_from_flax(cfg, tree, "cpu")(torch.from_numpy(mel), torch.from_numpy(toks)).numpy()
    jax_logits = np.asarray(jax.jit(JW.WhisperModel(JW.WhisperConfig.tiny()).apply)({"params": tree}, mel, toks.astype(np.int32)))
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(got, jax_logits, atol=2e-4)
