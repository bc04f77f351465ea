"""The encoders' training step against the JAX package on the CPU.

The tiny text and audio models (``TextModelConfig.tiny()``,
``AudioModelConfig.tiny()``) and encoders with the kernel attention path,
``dropout=0.0`` and ``deterministic=False``, on JAX's params moved into the
port: the trainers' cross-entropy (``msa_tpu_torch.training``), its value
and every parameter's gradient against ``jax.value_and_grad`` (JAX runs its
Pallas forward and backward kernels in interpret mode, the port their plain
versions), then three ``torch.optim.AdamW`` steps against three
``optax.adamw`` steps. Port-only checks follow: remat, the audio convs' f32
masters, the dropout refusal and re-deriving the serving weights after a
step.

Tolerances: gradients within 2e-4 × max(1, the leaf's largest |value|) in
f32; in bf16 within torch_parity.bf16_bound of each module's gradients
(its kernel and bias, or scale and bias, together: a bias gradient that
sums terms of both signs is far smaller than its terms, and so than their
bf16 noise); the loss alike. Parameters after three AdamW steps within
1e-5 in f32, but for the elements whose gradient is zero up to rounding,
because softmax ignores a shift shared by all of a row's scores: the K third
of each QKV bias and the audio pool's score bias. Adam's step
g/(|g| + 1e-8) turns their rounding noise into steps of ±lr on both sides,
so there the test holds that the gradient is below 1e-6 and the two sides
within the 2·3·lr that three such steps allow.
"""

import dataclasses
from typing import Mapping

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msa_tpu.models import audio as JAud
from msa_tpu.models import text as JText
from msa_tpu.models.transformer import EncoderConfig as JEncCfg
from msa_tpu.models.transformer import TransformerEncoder as JEncoder
from msa_tpu_torch import training, weights
from msa_tpu_torch.models import audio as PAud
from msa_tpu_torch.models import text as PText
from msa_tpu_torch.models import transformer as PT
from torch_parity import ENC, bf16_bound, to_numpy

TRAIN = dict(attention_impl="kernel", ffn_impl="kernel", dropout=0.0)
JTRAIN = dict(attention_impl="pallas", ffn_impl="pallas", dropout=0.0)


def _bound(want: np.ndarray, dtype: str) -> float:
    if dtype == "float32":
        return 2e-4 * max(1.0, float(np.abs(want).max()))
    return bf16_bound(want)


def _leaves(module, tree, path=()):
    """(name, flax leaf name, flax value, port parameter) for every leaf."""
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(getattr(module, key), value, path + (key,))
        else:
            yield ".".join(path + (key,)), key, np.asarray(value), getattr(module, weights._RENAME.get(key, key))


def _hold_grads(model, jgrads, dtype):
    modules = {}
    for name, key, want, p in _leaves(model, jgrads):
        assert p.grad is not None, name
        got, want_t = p.grad.numpy(), weights._convert(key, want, p).numpy()
        assert np.isfinite(got).all(), name
        modules.setdefault(name.rsplit(".", 1)[0], []).append((name, got, want_t))
    for module, leaves in modules.items():
        group = np.concatenate([w.ravel() for _, _, w in leaves])
        for name, got, want_t in leaves:
            err = np.abs(got - want_t).max()
            bound = _bound(want_t, "float32") if dtype == "float32" else bf16_bound(group)
            assert err <= bound, (name, err, bound)


def _shift_invariant(name: str, p: torch.Tensor) -> torch.Tensor:
    """The elements of ``p`` whose gradient softmax's shift invariance makes
    zero: the K third of a QKV bias, the attentive pool's score bias."""
    mask = torch.zeros(p.shape, dtype=torch.bool)
    if name.endswith("attention.qkv.bias"):
        d = p.shape[0] // 3
        mask[d : 2 * d] = True
    elif name == "pool.attn_score.bias":
        mask[:] = True
    return mask


# --- the two models ---------------------------------------------------------------


def _rngs(dropout_seed):
    """JAX's ``rngs`` argument for a dropout seed (None: no dropout key)."""
    return {} if dropout_seed is None else {"rngs": {"dropout": jax.random.PRNGKey(dropout_seed)}}


def _text(dtype, seed=0, dropout=0.0, dropout_seed=None):
    """(JAX model, params, loss of params; port model with the params, loss
    of the port model): the text model, its four heads' cross-entropy; with
    ``dropout``, both draw their masks from ``dropout_seed``."""
    rng = np.random.default_rng(seed)
    jcfg = JText.TextModelConfig.tiny()
    jm = JText.TextModel(dataclasses.replace(jcfg, encoder=dataclasses.replace(
        jcfg.encoder, compute_dtype=dtype, **{**JTRAIN, "dropout": dropout})))
    pcfg = PText.TextModelConfig.tiny()
    pm = PText.TextModel(dataclasses.replace(pcfg, encoder=dataclasses.replace(
        pcfg.encoder, compute_dtype=dtype, **{**TRAIN, "dropout": dropout})))
    ids = rng.integers(1, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    mask = np.ones((2, 24), np.int32)
    mask[1, 15:] = 0
    labels = {h: rng.integers(0, n, size=2) for h, n in zip(training.TEXT_HEADS, (7, 2, 2, 3))}
    params = jm.init(jax.random.PRNGKey(seed), ids, mask)["params"]

    def jloss(p):
        cls = jm.apply({"params": p}, ids, mask, deterministic=False, **_rngs(dropout_seed))["context_embedding"]
        total = 0.0
        for head, y in labels.items():
            logp = jax.nn.log_softmax((cls @ p[head]["kernel"] + p[head]["bias"]).astype(jnp.float32))
            total = total - jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None], axis=1))
        return total

    weights.load_flax_tree(pm, to_numpy(params))
    batch = (torch.from_numpy(ids).long(), torch.from_numpy(mask), {h: torch.from_numpy(y) for h, y in labels.items()})
    return jm, params, jloss, pm, lambda m, seed=dropout_seed: training.text_loss(m, *batch, dropout_rng=seed)


def _audio(dtype, seed=0, dropout=0.0, dropout_seed=None):
    """As :func:`_text` for the audio model (T = 398 frames) and its
    emotion head's cross-entropy."""
    rng = np.random.default_rng(seed)
    jcfg = JAud.AudioModelConfig.tiny()
    jm = JAud.AudioEmotionModel(dataclasses.replace(jcfg, encoder=dataclasses.replace(
        jcfg.encoder, compute_dtype=dtype, **{**JTRAIN, "dropout": dropout})))
    pcfg = PAud.AudioModelConfig.tiny()
    pm = PAud.AudioEmotionModel(dataclasses.replace(pcfg, encoder=dataclasses.replace(
        pcfg.encoder, compute_dtype=dtype, **{**TRAIN, "dropout": dropout})))
    wav = (0.1 * rng.standard_normal((2, 8000))).astype(np.float32)
    y = rng.integers(0, 4, size=2)
    params = jm.init(jax.random.PRNGKey(seed), wav)["params"]

    def jloss(p):
        logits = jm.apply({"params": p}, wav, deterministic=False, **_rngs(dropout_seed))["logits"]
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None], axis=1))

    weights.load_flax_tree(pm, to_numpy(params))
    return jm, params, jloss, pm, lambda m, seed=dropout_seed: training.audio_loss(
        m, torch.from_numpy(wav), torch.from_numpy(y), dropout_rng=seed)


MODELS = {"text": _text, "audio": _audio}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_training_loss_and_grads_match_jax(kind, dtype):
    _, params, jloss, pm, ploss = MODELS[kind](dtype)
    want_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    loss = ploss(pm)
    loss.backward()
    want = np.float32(want_loss)
    assert abs(loss.item() - want) <= _bound(np.array([want]), dtype), (loss.item(), want)
    _hold_grads(pm, to_numpy(jgrads), dtype)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_three_adamw_steps_match_optax(kind):
    """optax.adamw(1e-3, weight_decay=1e-4) against training.adamw, three
    steps each on the same batch, f32."""
    _, params, jloss, pm, ploss = MODELS[kind]("float32")
    opt = optax.adamw(1e-3, weight_decay=1e-4)
    state = opt.init(params)
    opt_t = training.adamw(pm.parameters())
    first_grads = None
    value_and_grad = jax.jit(jax.value_and_grad(jloss))
    for _ in range(3):
        want_loss, grads = value_and_grad(params)
        first_grads = first_grads or to_numpy(grads)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        loss = training.train_step(pm, lambda m: ploss(m), opt_t)
        assert abs(float(loss) - float(want_loss)) <= 2e-4 * max(1.0, abs(float(want_loss)))
    grad_of = {name: (key, g) for name, key, g, _ in _leaves(pm, first_grads)}
    for name, key, want, p in _leaves(pm, to_numpy(params)):
        err = (p.detach() - weights._convert(key, want, p)).abs()
        zero = _shift_invariant(name, p)
        g = weights._convert(grad_of[name][0], grad_of[name][1], p).abs()
        assert (g[zero] <= 1e-6).all(), (name, g[zero].max())
        assert (err[~zero] <= 1e-5).all(), (name, err[~zero].max())
        assert (err[zero] <= 2 * 3 * 1e-3).all(), (name, err[zero].max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [50, 640])
def test_encoder_training_matches_jax_and_takes_no_serving_kernel(rng, dtype, T, monkeypatch):
    """torch_parity.ENC widths (d_model 128, which serving sends to
    attention_block and ffn_fused) in training mode: row 5 at T = 50, row 6
    at T = 640, both with the backward, and no serving kernel, as JAX's
    training dispatch (msa_tpu/models/transformer.py:86-90, :204-208)."""
    for name in ("attention_block", "attention_block_int8", "ffn_fused", "ffn_fused_int8"):
        monkeypatch.setattr(PT, name, lambda *a, _n=name: pytest.fail(f"training called {_n}"))
    b = 2 if T < 512 else 1
    jenc = JEncoder(JEncCfg(compute_dtype=dtype, quantize="int8", **JTRAIN, **ENC))
    penc = PT.TransformerEncoder(PT.EncoderConfig(compute_dtype=dtype, quantize="int8", **TRAIN, **ENC))
    x = rng.normal(size=(b, T, 128)).astype(np.float32)
    mask = np.ones((b, T), np.int32)
    mask[-1, T * 3 // 4 :] = 0
    w = rng.normal(size=128).astype(np.float32)  # a non-uniform cotangent
    params = jenc.init(jax.random.PRNGKey(0), x[:, :8], mask[:, :8])["params"]
    want_loss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jnp.mean(jenc.apply({"params": p}, x, mask, deterministic=False).astype(jnp.float32) @ w)
    ))(params)
    weights.load_flax_tree(penc, to_numpy(params))
    loss = (penc(torch.from_numpy(x), torch.from_numpy(mask), deterministic=False).float() @ torch.from_numpy(w)).mean()
    loss.backward()
    want = np.float32(want_loss)
    assert abs(loss.item() - want) <= _bound(np.array([want]), dtype), (loss.item(), want)
    _hold_grads(penc, to_numpy(jgrads), dtype)


def test_remat_leaves_loss_and_grads_equal(rng, monkeypatch):
    """remat=True recomputes each layer in the backward (the forward kernel
    runs twice per layer) and changes no value (tests/test_text_model.py:
    144-170)."""
    calls = []
    real = PT.packed_qkv_attention
    monkeypatch.setattr(PT, "packed_qkv_attention", lambda *a: calls.append(1) or real(*a))
    x = torch.from_numpy(rng.normal(size=(2, 12, 32)).astype(np.float32))
    mask = torch.ones(2, 12, dtype=torch.int32)
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(PT.EncoderConfig.tiny(), remat=remat, **TRAIN)
        enc = PT.TransformerEncoder(cfg)
        torch.manual_seed(0)
        for p in enc.parameters():
            torch.nn.init.normal_(p, std=0.2)
        calls.clear()
        loss = enc(x, mask, deterministic=False).square().sum()
        loss.backward()
        out[remat] = (loss.item(), [p.grad.clone() for p in enc.parameters()], len(calls))
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    assert (out[False][2], out[True][2]) == (2, 4)


def test_bf16_audio_model_keeps_f32_conv_masters():
    """The extractor's and pos_conv's weights are f32, as flax's params are;
    the convs cast them to bf16 in the forward."""
    cfg = PAud.AudioModelConfig(
        conv_channels=(8, 8), conv_kernels=(10, 8), conv_strides=(5, 4), pool_hidden=8, pos_conv_kernel=16,
        pos_conv_groups=4, head_weights=None, encoder=dataclasses.replace(PT.EncoderConfig.tiny(), compute_dtype="bfloat16"),
    )
    model = PAud.AudioEmotionModel(cfg)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert model.feature_extractor.conv_0.weight.dtype == model.pos_conv.conv.bias.dtype == torch.float32
    feats = model.feature_extractor(torch.zeros(1, 400))
    assert feats.dtype == torch.bfloat16


def test_training_with_dropout_raises():
    """Training with dropout > 0 and no dropout key raises, as flax's
    ``make_rng("dropout")`` does without ``rngs``; with a key it trains
    (the parity with JAX is held below); serving ignores dropout and needs
    no key, as JAX does."""
    cfg = PText.TextModelConfig.tiny()  # dropout 0.1, JAX's default
    model = PText.TextModel(cfg)
    ids, mask = torch.ones(1, 8, dtype=torch.long), torch.ones(1, 8)
    assert torch.isfinite(model(ids, mask)["emotion_probs"]).all()
    with pytest.raises(ValueError, match="dropout"):
        model(ids, mask, deterministic=False)
    with pytest.raises(ValueError, match="dropout"):
        model.encoder(torch.zeros(1, 8, 32), mask, deterministic=False)
    assert torch.isfinite(model(ids, mask, deterministic=False, dropout_rng=0)["emotion_probs"]).all()


@pytest.fixture(scope="module")
def dropout_models():
    """``kind`` → the tiny f32 model of that kind with dropout 0.1, its
    losses drawing from seed 7 (as :func:`_text`), each built once."""
    built = {}

    def get(kind):
        if kind not in built:
            built[kind] = MODELS[kind]("float32", dropout=0.1, dropout_seed=7)
        return built[kind]

    return get


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_training_with_dropout_matches_jax(kind, dropout_models):
    """The tiny f32 text and audio models with dropout 0.1 in training, on
    the kernel configs (which dropout sends to the einsum attention, as
    JAX's): the loss and every gradient within 1e-5 of JAX's
    ``value_and_grad`` under ``rngs={"dropout": PRNGKey(7)}``; the seed 8
    gives another loss."""
    _, params, jloss, pm, ploss = dropout_models(kind)
    want_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    pm.zero_grad(set_to_none=True)
    loss = ploss(pm)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5, (loss.item(), float(want_loss))
    for name, key, want, p in _leaves(pm, to_numpy(jgrads)):
        err = np.abs(p.grad.numpy() - weights._convert(key, want, p).numpy()).max()
        assert err <= 1e-5, (name, err)
    with torch.no_grad():
        assert ploss(pm, 8).item() != loss.item()


def _sites(kind):
    """(flax path of each dropout site's module) for the tiny models: the
    text embeddings', then per layer the attention probabilities', the
    attention output's and the FFN output's."""
    layers = [("encoder", f"layer_{i}") for i in range(PT.EncoderConfig.tiny().num_layers)]
    sites = [("embeddings", "Dropout_0")] if kind == "text" else []
    for layer in layers:
        sites += [layer + ("attention", "Dropout_0"), layer + ("Dropout_0",), layer + ("Dropout_1",)]
    return sites


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_dropout_masks_match_flax_at_every_site(kind, dropout_models):
    """Each site's mask for a fixed key is flax's bit for bit: JAX's
    intermediates of every ``nn.Dropout`` (zero where dropped; the text
    batch has no padded key here, so no kept value is 0) against
    ``dropout_mask`` under the port's ``DropoutRng`` of the same path, and
    the port's own output at each site zero exactly there."""
    jm, params, _, pm, _ = dropout_models(kind)
    rng = np.random.default_rng(1)
    if kind == "text":
        ids = rng.integers(1, 128, size=(2, 24)).astype(np.int32)
        args, pargs = (ids, np.ones((2, 24), np.int32)), (torch.from_numpy(ids).long(), torch.ones(2, 24))
    else:
        wav = (0.1 * rng.standard_normal((2, 8000))).astype(np.float32)
        args, pargs = (wav,), (torch.from_numpy(wav),)
    _, state = jm.apply({"params": params}, *args, deterministic=False, rngs={"dropout": jax.random.PRNGKey(3)},
                        capture_intermediates=lambda mdl, _: isinstance(mdl, flax.linen.Dropout), mutable=["intermediates"])
    got = {}
    real = PT.dropout
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PT, "dropout", lambda x, rate, det, rng_, i: got.setdefault(rng_.path + (f"Dropout_{i}",), real(x, rate, det, rng_, i)))
        if kind == "text":
            mp.setattr(PText, "dropout", PT.dropout)
        pm(*pargs, deterministic=False, dropout_rng=3)
    root = PT.DropoutRng.of(3)
    assert sorted(got) == sorted(_sites(kind))
    for path in _sites(kind):
        node = state["intermediates"]
        for name in path:
            node = node[name]
        dropped = np.asarray(node["__call__"][0]) == 0
        scope = root
        for name in path[:-1]:
            scope = scope.child(name)
        keep = PT.dropout_mask(scope.dropout_key(int(path[-1].split("_")[1])), dropped.shape, 0.1, "cpu").numpy()
        assert np.array_equal(keep, ~dropped), path
        assert np.array_equal(got[path].detach().numpy() == 0, dropped), path
        assert 0.05 < dropped.mean() < 0.15, (path, dropped.mean())


def test_dropout_keys_and_determinism():
    """Two keys give two masks, one key the same mask twice; deterministic
    ignores dropout and needs no key (the encoder's output equals that of
    a dropout-0 twin)."""
    x = torch.randn(2, 5, 32)
    a, b = (PT.dropout(x, 0.1, False, PT.DropoutRng.of(s).child("layer_0"), 0) for s in (1, 2))
    assert not torch.equal(a, b)
    assert torch.equal(a, PT.dropout(x, 0.1, False, PT.DropoutRng.of(1).child("layer_0"), 0))
    assert not torch.equal(a, PT.dropout(x, 0.1, False, PT.DropoutRng.of(1).child("layer_0"), 1))
    assert PT.dropout(x, 0.1, True, None, 0) is x and PT.dropout(x, 0.0, False, None, 0) is x
    enc = PT.TransformerEncoder(PT.EncoderConfig.tiny())
    twin = PT.TransformerEncoder(dataclasses.replace(PT.EncoderConfig.tiny(), dropout=0.0))
    twin.load_state_dict(enc.state_dict())
    with torch.no_grad():
        assert torch.equal(enc(x), twin(x, deterministic=False))


def test_serving_after_a_step_needs_derive_weights(rng):
    """After an optimizer step the serving copies are stale until
    weights.derive_weights_ runs; then the serving forward equals that of a
    model freshly built from the same masters (int8 recipe, kernel paths)."""
    cfg = PText.TextModelConfig(
        vocab_size=64, max_positions=32, head_weights=None,
        encoder=PT.EncoderConfig(compute_dtype="bfloat16", quantize="int8", **TRAIN, **ENC),
    )
    model = PText.TextModel(cfg)
    ids = torch.from_numpy(rng.integers(1, 64, size=(2, 16))).long()
    mask = torch.ones(2, 16)
    labels = {h: torch.zeros(2, dtype=torch.long) for h in training.TEXT_HEADS}
    training.train_step(model, training.text_loss, training.adamw(model.parameters(), lr=1e-2), ids, mask, labels)
    with torch.no_grad():
        stale = model(ids, mask)["last_hidden_state"]
        weights.derive_weights_(model)
        served = model(ids, mask)["last_hidden_state"]
        fresh = PText.TextModel(cfg)
        fresh.load_state_dict(model.state_dict())
        weights.derive_weights_(fresh)
        want = fresh(ids, mask)["last_hidden_state"]
    assert not torch.equal(stale, want)  # the derived copies did not follow the step
    assert torch.equal(served, want)
