"""Lexicon-supervised training for the four text heads (port of
``msa_tpu/training/train_text_heads.py``).

The heads (emotion 7 in the canonical order, sentiment 3 as [negative,
neutral, positive], sarcasm 2, humor 2) are fitted on synthetic
Portuguese sentences whose lexicon encodes the label
(:mod:`msa_tpu_torch.training.text_synth`), over the FROZEN trunk: the
[CLS] state of one forward per batch of 64 sentences at 64 tokens, under
``torch.no_grad()``, then :func:`~msa_tpu_torch.training.
train_audio_emotion.train_head` per head. With the serving trunk of
``PipelineModels.initialize()`` (int8 recipe) the forward takes rows 7
and 9 in every layer; a fresh ``TextModelConfig()`` trunk the plain
einsum/dense path, as JAX's.

CLI: ``python -m msa_tpu_torch.training.train_text_heads`` writes
``checkpoints/text_heads.msgpack`` with one {kernel, bias} tree per head.
"""

from __future__ import annotations

import logging
import zlib
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from msa_tpu_torch import flax_init, weights
from msa_tpu_torch.checkpoints import flax_msgpack
from msa_tpu_torch.precision import exact_fp32
from msa_tpu_torch.training import text_synth
from msa_tpu_torch.training.train_audio_emotion import train_head

logger = logging.getLogger(__name__)

TOKENS = 64  # one static shape for the cached trunk forward

TASKS: Tuple[Tuple[str, Any, int], ...] = (
    ("emotion_head", text_synth.emotion_sentences, 7),
    ("sentiment_head", text_synth.sentiment_sentences, 3),
    ("sarcasm_head", text_synth.sarcasm_sentences, 2),
    ("humor_head", text_synth.humor_sentences, 2),
)


def encode_batch(tokenizer, texts, tokens: int = TOKENS):
    ids = np.zeros((len(texts), tokens), np.int32)
    mask = np.zeros((len(texts), tokens), np.int32)
    for i, t in enumerate(texts):
        ids[i], mask[i] = tokenizer.encode(t, max_length=tokens)
    return ids, mask


@torch.no_grad()
def cls_features(model, params, tokenizer, texts, batch: int = 64, tokens: int = TOKENS) -> np.ndarray:
    """Frozen-trunk [CLS] features [N, d_model] (f32 numpy), one forward
    per batch of ``batch`` sentences on the model's device (the last padded
    to that shape, as JAX's). ``params`` (a flax tree) is loaded into
    ``model`` first; None keeps its weights."""
    if params is not None:
        weights.load_flax_tree(model, params)
    dev = weights.device_of(model)
    ids, mask = encode_batch(tokenizer, texts, tokens)
    out = []
    with exact_fp32():
        for lo in range(0, len(texts), batch):
            ci, cm = ids[lo : lo + batch], mask[lo : lo + batch]
            if len(ci) < batch:  # keep ONE shape
                pad = batch - len(ci)
                ci = np.pad(ci, [(0, pad), (0, 0)])
                cm = np.pad(cm, [(0, pad), (0, 0)])
            got = model(torch.from_numpy(ci).to(dev).long(), torch.from_numpy(cm).to(dev))["context_embedding"]
            out.append(got.float().cpu().numpy()[: len(texts) - lo])
    return np.concatenate(out, axis=0)


def evaluate_heads(
    model, params, tokenizer, heads: Mapping[str, Any], n: int = 256, seed: int = 1, adversarial: bool = False
) -> Dict[str, Dict[str, float]]:
    """Held-out metrics per task on fresh sentences from the RESERVED
    (word × template) cells. ``adversarial=True`` wraps every held-out
    sentence in out-of-vocabulary pseudo-word context
    (:func:`text_synth.with_oov_context`): the same labels and surface
    tokens, shifted positions and unseen-token noise."""
    from msa_tpu_torch.training.text_synth import with_oov_context

    metrics: Dict[str, Dict[str, float]] = {}
    for name, gen, _ in TASKS:
        rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 1000)
        texts, labels = gen(rng, n, holdout=True)
        if adversarial:
            texts = with_oov_context(rng, texts)
        feats = cls_features(model, params, tokenizer, texts)
        logits = feats @ heads[name]["kernel"] + heads[name]["bias"]
        pred = logits.argmax(axis=-1)
        acc = float((pred == labels).mean())
        recalls = [float((pred[labels == k] == k).mean()) for k in range(logits.shape[-1]) if (labels == k).any()]
        metrics[name] = {"accuracy": acc, "worst_class_recall": min(recalls)}
    return metrics


def train(
    model=None,
    params: Optional[Mapping[str, Any]] = None,
    tokenizer=None,
    n_train: int = 4096,
    steps: int = 3000,
    seed: int = 0,
    log_every: int = 0,
    device: "str | torch.device" = "cuda",
) -> Tuple[Dict[str, Any], Dict[str, Dict[str, float]]]:
    """The recipe: synthetic sentences (30% wrapped in OOV context) →
    frozen-trunk [CLS] cache → fit each linear head → held-out eval.
    ``model`` is the trunk (a TextModel on its device, e.g.
    ``PipelineModels.initialize().text``); None builds ``TextModelConfig()``
    on ``device`` from JAX's init of ``seed+3`` (the trunk the default
    pipeline builds). ``params``, where given, is loaded into the model.
    → ({head: {kernel, bias}}, metrics)."""
    from msa_tpu_torch.models.text import TextModel, TextModelConfig, WordPieceTokenizer
    from msa_tpu_torch.training.text_synth import with_oov_context

    cfg = TextModelConfig()
    if model is None:
        with torch.device(device):
            model = flax_init.init_module_(TextModel(cfg), seed + 3).eval()
    if params is not None:
        weights.load_flax_tree(model, params)
    if tokenizer is None:
        tokenizer = WordPieceTokenizer(vocab_size=cfg.vocab_size)
    dev = weights.device_of(model)

    heads: Dict[str, Any] = {}
    for name, gen, n_classes in TASKS:
        rng = np.random.default_rng(seed + 100 + zlib.crc32(name.encode()) % 1000)
        texts, labels = gen(rng, n_train)
        # OOV-noise augmentation: ~30% of the training sentences wrapped in
        # pseudo-word context, so keyword detection learns to ignore
        # unseen-token embeddings
        noisy = rng.random(len(texts)) < 0.3
        wrapped = with_oov_context(rng, [t for t, z in zip(texts, noisy) if z])
        it = iter(wrapped)
        texts = [next(it) if z else t for t, z in zip(texts, noisy)]
        feats = cls_features(model, None, tokenizer, texts)
        head0 = weights.flax_tree(getattr(model, name))
        assert head0["kernel"].shape[-1] == n_classes
        heads[name] = train_head(feats, labels, head0, steps=steps, seed=seed, log_every=log_every, device=dev)
        logger.info("trained %s on %d sentences", name, n_train)
    metrics = evaluate_heads(model, None, tokenizer, heads)
    return heads, metrics


def save_heads(heads: Mapping[str, Any], path: str) -> None:
    """JAX's file: ``flax.serialization.to_bytes(heads)``, the tree's own
    key order (the tasks' order, each head kernel then bias)."""
    flax_msgpack.dump(path, heads, sort_keys=False)


def load_heads(path: str) -> Dict[str, Any]:
    """→ {head_name: {kernel, bias}} numpy trees, as stored."""
    return flax_msgpack.load(path)


def main(argv=None):
    """JAX's CLI, plus ``--device``."""
    import argparse

    parser = argparse.ArgumentParser(description="Treina os classificadores de texto (léxico sintético)")
    parser.add_argument("--n-train", type=int, default=4096)
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--out", default="checkpoints/text_heads.msgpack")
    parser.add_argument("--device", default="cuda", help="torch device to run the trunk and the fit on")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    heads, metrics = train(n_train=args.n_train, steps=args.steps, log_every=500, device=args.device)
    for name, m in metrics.items():
        logger.info("%s: %s", name, m)
    save_heads(heads, args.out)
    logger.info("wrote %s", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
