"""The encoders' training step in f32 on the kernel path, against the JAX
package on the CPU: the backward (rows 3 and 4) and its differentiable
wrappers in f32, and one fine-tuning step of the parity mode's imported
trunks.

On the card the f32 step runs rows 5/6 forward and the f32 backward kernels
of ``csrc/attention_bwd_f32.cu`` (``chip_smoke.py`` phases 20 and 21); on
the CPU the wrappers run their plain versions, JAX its Pallas kernels in
interpret mode. Here, at tiny sizes (B ≤ 2, H ≤ 2 or 4, T ≤ 40 but for the
audio trunk's 198 frames, 2 layers):

- ``attention_bwd_plain`` in f32 against JAX's ``attention_bwd``, and the
  f32 gradients of ``attention_with_vjp`` and ``packed_qkv_attention``
  against ``jax.grad`` of JAX's, with a ragged mask and a row with no valid
  key;
- the card path's dispatch in f32: the one-pass C entry point at D ≤ 64,
  strided views of the packed dqkv, its launch count (a stand-in library,
  meta tensors);
- an HF-named BERT and wav2vec2 built locally (as
  tests/test_torch_importers.py does, nothing downloaded) → the importers →
  one f32 training step on the kernel path: the loss and every gradient
  against JAX's ``EncoderConfig(compute_dtype="float32",
  attention_impl="pallas", dropout=0.0)`` on the same params.

Tolerances are tests/test_torch_attention_bwd.py's for f32 (2e-4) and
tests/test_torch_training.py's (gradients within 2e-4 × max(1, the leaf's
largest |value|)).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tpu.models import audio as JAudio
from msa_tpu.models import text as JText
from msa_tpu.models.transformer import EncoderConfig as JEncCfg
from msa_tpu.ops.pallas.attention import _mha_attention_lse
from msa_tpu.ops.pallas.attention import attention_bwd as jax_attention_bwd
from msa_tpu.ops.pallas.attention import attention_with_vjp as jax_attention_with_vjp
from msa_tpu.ops.pallas.attention import packed_qkv_attention as jax_packed_qkv_attention
from msa_tpu_torch import training, weights
from msa_tpu_torch.models import audio as PAudio
from msa_tpu_torch.models import text as PText
from msa_tpu_torch.models.transformer import EncoderConfig as PEncCfg
from msa_tpu_torch.ops.kernels import attention as A
from msa_tpu_torch.ops.kernels import attention_bwd_plan as BP
from test_torch_importers import AUDIO, ENC, _bert, _wav2vec2
from test_torch_training import _hold_grads
from test_torch_wide_heads import card  # noqa: F401 (the stand-in kernel library, a fixture)
from torch_parity import f32, t, to_numpy

ATOL = 2e-4


def _mask(b, T):
    mask = np.ones((b, T), np.float32)
    mask[0, T * 3 // 4 :] = 0.0  # a ragged valid length
    if b > 1:
        mask[1, :] = 0.0  # no valid key: the gradient spreads over every padded key, as in JAX
    return mask


def _grads(fn, tensors, w):
    leaves = [x.clone().requires_grad_(True) for x in tensors]
    (fn(*leaves) * w).sum().backward()
    return [x.grad for x in leaves]


@pytest.mark.parametrize("d", [24, 32])
def test_attention_bwd_plain_f32_matches_pallas(rng, d):
    q, k, v, g = (jnp.asarray(rng.normal(size=(2, 2, 40, d)).astype(np.float32)) for _ in range(4))
    mask = jnp.asarray(_mask(2, 40))
    o, lse = _mha_attention_lse(q, k, v, mask, interpret=True)
    want = jax_attention_bwd(q, k, v, mask, lse, o, g, interpret=True)
    got = A.attention_bwd(t(q), t(k), t(v), t(mask), t(lse), t(o), t(g))
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        assert gt.dtype == torch.float32 and tuple(gt.shape) == (2, 2, 40, d)
        assert np.isfinite(f32(gt)).all()
        np.testing.assert_allclose(f32(gt), f32(wt), atol=ATOL, err_msg=name)


def test_attention_with_vjp_f32_grads_match_jax(rng):
    q, k, v = (jnp.asarray(rng.normal(size=(2, 2, 40, 32)).astype(np.float32)) for _ in range(3))
    mask = _mask(2, 40)
    w = rng.normal(size=(2, 2, 40, 32)).astype(np.float32)  # a non-uniform cotangent

    def loss(q, k, v):
        return jnp.sum(jax_attention_with_vjp(q, k, v, jnp.asarray(mask), True) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    got = _grads(lambda q, k, v: A.attention_with_vjp(q, k, v, t(mask)), [t(x) for x in (q, k, v)], torch.from_numpy(w))
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(f32(gt), f32(wt), atol=ATOL, err_msg=name)


def test_packed_qkv_attention_f32_grads_match_jax(rng):
    qkv = jnp.asarray(rng.normal(size=(2, 40, 3, 2, 24)).astype(np.float32))
    mask = _mask(2, 40)
    w = rng.normal(size=(2, 40, 48)).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(jax_packed_qkv_attention(x, jnp.asarray(mask), True) * w))(qkv)
    (got,) = _grads(lambda x: A.packed_qkv_attention(x, t(mask)), [t(qkv)], torch.from_numpy(w))
    assert tuple(got.shape) == (2, 40, 3, 2, 24)
    np.testing.assert_allclose(f32(got), f32(want), atol=ATOL)


@pytest.mark.parametrize("d", [64, 25])
def test_f32_backward_takes_the_f32_entries_on_the_card_path(card, d):
    """_PackedQKVAttention.backward's call on f32: the [B, H, T, D] views
    into the packed qkv and dqkv (their strides, D contiguous) go to the
    one-pass entry msa_attention_bwd_onepass_f32 (D = 25 zero-padded to 32
    first: D ≤ 64), with the ticket buffer and the planner's plan, counted
    in attention_bwd_onepass.launches; the D-tiled pair is not launched;
    row 2 in f32 goes to msa_fused_attention."""
    lib = card
    b, T, h = 2, 40, 2
    qkv, dqkv = (torch.empty(b, T, 3, h, d, device="meta") for _ in range(2))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    dq, dk, dv = (dqkv[:, :, i].transpose(1, 2) for i in range(3))
    g = torch.empty(b, T, h * d, device="meta")
    before = (A.attention_bwd_onepass.launches, A.attention_bwd_dq.launches_f32, A.attention_bwd_dkv.launches_f32,
              A.attention_bwd_dq.launches)
    A._attention_bwd_into(q, k, v, torch.empty(b, T, device="meta"), torch.empty(b, h, T, device="meta"),
                          torch.empty(b, T, h * d, device="meta").view(b, T, h, d).transpose(1, 2),
                          g.view(b, T, h, d).transpose(1, 2), dq, dk, dv)
    dp = -(-d // 8) * 8
    (name, args), = lib.calls
    assert name == "msa_attention_bwd_onepass_f32" and len(args) == 11 + 11 + 2  # pointers, ints, scale, stream
    assert args[11:15] == (b, T, h, dp)
    if d == dp:  # the packed layout's strides, read in place
        assert args[15:18] == (3 * T * h * d, d, 3 * h * d)
        assert args[18:21] == (T * h * d, d, h * d)
    assert args[21] == BP.plan(b, h, T, dp).code == BP.BwdPlan(64, 1).code
    assert args[-2] == float(np.float32(1.0 / np.sqrt(d)))
    assert (A.attention_bwd_onepass.launches, A.attention_bwd_dq.launches_f32, A.attention_bwd_dkv.launches_f32,
            A.attention_bwd_dq.launches) == (before[0] + 1, *before[1:])
    lib.calls.clear()
    n = A.mha_attention.launches_f32
    o, lse = A.mha_attention(q.contiguous(), k.contiguous(), v.contiguous(), torch.empty(b, T, device="meta"))
    (name, args), = lib.calls
    assert name == "msa_fused_attention" and args[9:11] == (dp, 0) and A.mha_attention.launches_f32 == n + 1
    assert tuple(o.shape) == (b, h, T, d) and o.dtype == torch.float32


# --- one f32 fine-tuning step of the imported trunks --------------------------------

F32_TRAIN = dict(compute_dtype="float32", dropout=0.0)


def _init_plain(model, cfg, *inputs):
    """JAX's params of ``model(cfg)``, initialised through its einsum path:
    the same tree as the kernel path's, without compiling its kernels."""
    plain = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, attention_impl="einsum", ffn_impl="dense"))
    return dict(model(plain).init(jax.random.PRNGKey(0), *inputs)["params"])


def _text_step(rng):
    hf = _bert()
    jcfg = JText.TextModelConfig(vocab_size=128, max_positions=64,
                                 encoder=JEncCfg(**ENC, **F32_TRAIN, attention_impl="pallas", ffn_impl="pallas"))
    pcfg = PText.TextModelConfig(vocab_size=128, max_positions=64, head_weights=None,
                                 encoder=PEncCfg(**ENC, **F32_TRAIN, attention_impl="kernel", ffn_impl="kernel"))
    ids = rng.integers(0, 128, size=(2, 40)).astype(np.int32)
    mask = np.ones((2, 40), np.int32)
    mask[1, 30:] = 0
    labels = {h: rng.integers(0, n, size=2) for h, n in zip(training.TEXT_HEADS, (7, 2, 2, 3))}
    jm = JText.TextModel(jcfg)
    heads = _init_plain(JText.TextModel, jcfg, ids, mask)  # the trunk is then replaced by the import
    params = {**heads, **JText.params_from_hf_bert(hf.state_dict(), jcfg)}

    def jloss(p):
        cls = jm.apply({"params": p}, ids, mask, deterministic=False)["context_embedding"]
        total = 0.0
        for head, y in labels.items():
            logp = jax.nn.log_softmax((cls @ p[head]["kernel"] + p[head]["bias"]).astype(jnp.float32))
            total = total - jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None], axis=1))
        return total

    pm = PText.TextModel(pcfg)
    weights.load_flax_tree(pm, to_numpy(params))
    batch = (torch.from_numpy(ids).long(), torch.from_numpy(mask), {h: torch.from_numpy(y) for h, y in labels.items()})
    return params, jloss, pm, lambda m: training.text_loss(m, *batch)


def _audio_step(rng):
    hf = _wav2vec2()
    jcfg = JAudio.AudioModelConfig(
        encoder=JEncCfg(layer_norm_eps=1e-5, **ENC, **F32_TRAIN, attention_impl="pallas", ffn_impl="pallas"), **AUDIO)
    pcfg = PAudio.AudioModelConfig(
        encoder=PEncCfg(layer_norm_eps=1e-5, **ENC, **F32_TRAIN, attention_impl="kernel", ffn_impl="kernel"), **AUDIO)
    wav = (0.1 * rng.normal(size=(2, 4000))).astype(np.float32)
    y = rng.integers(0, 4, size=2)
    jm = JAudio.AudioEmotionModel(jcfg)
    params = {**_init_plain(JAudio.AudioEmotionModel, jcfg, wav), **JAudio.params_from_hf_wav2vec2(hf.state_dict(), jcfg)}

    def jloss(p):
        logits = jm.apply({"params": p}, wav, deterministic=False)["logits"]
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None], axis=1))

    pm = PAudio.AudioEmotionModel(pcfg)
    weights.load_flax_tree(pm, to_numpy(params))
    return params, jloss, pm, lambda m: training.audio_loss(m, torch.from_numpy(wav), torch.from_numpy(y))


@pytest.mark.parametrize("kind", ["text", "audio"])
def test_imported_trunk_f32_step_matches_jax(rng, kind):
    params, jloss, pm, ploss = (_text_step if kind == "text" else _audio_step)(rng)
    assert pm.cfg.encoder.dtype == torch.float32 and pm.cfg.encoder.attention_impl == "kernel"
    want_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    loss = ploss(pm)
    loss.backward()
    want = float(np.float32(want_loss))
    assert abs(loss.item() - want) <= ATOL * max(1.0, abs(want)), (loss.item(), want)
    _hold_grads(pm, to_numpy(jgrads), "float32")
