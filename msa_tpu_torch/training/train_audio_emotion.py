"""Prosody-supervised training for the audio emotion head (port of
``msa_tpu/training/train_audio_emotion.py``).

The 4-class head (IEMOCAP4 order: neutral, angry, happy, sad) learns from
procedural voices whose PROSODY encodes the class, after the usual
arousal/valence acoustics:

- **neutral**: mid pitch, flat contour, moderate energy and rate
- **angry**: high energy, raised jittery pitch, fast sharp attacks, a
  bright spectrum (low tilt), amplitude roughness
- **happy**: high, strongly varying, rising pitch, high energy, fast
  smooth syllables
- **sad**: low, flat, falling pitch, low energy, slow syllables, a dark
  spectrum (high tilt)

The voice identity (:func:`msa_tpu_torch.models.speaker.random_voice`) is
drawn anew per clip, so the classifier must key on prosody. Training fits
the head (``mode="head"``) or the attentive pooling and the head
(``mode="pool"``, the shipped recipe) over the FROZEN trunk: one forward
of the trunk per clip under ``torch.no_grad()``, then the fit on the
cached features.

The data (:func:`make_dataset`) is numpy, byte-equal to JAX's from the
same generator. The trunk forward runs on the model's device: with the
serving trunk of ``PipelineModels.initialize()`` (int8 recipe) it takes
rows 7 and 9 (``attention_block_int8``, ``ffn_fused_int8``) in every
layer; a fresh ``AudioModelConfig()`` trunk takes the plain einsum/dense
path, as JAX's. The fits run f32 with TF32 off: :func:`train_head` on
numpy's ``rng.integers`` minibatches, :func:`train_pool_head` on JAX's
``jax.random.randint`` indices (:func:`msa_tpu_torch.flax_init.randint`),
both AdamW with weight decay 1e-4 on every leaf, as optax's.

CLI: ``python -m msa_tpu_torch.training.train_audio_emotion`` writes
``checkpoints/audio_emotion_head.msgpack`` (flax's bytes).
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from msa_tpu_torch import flax_init, weights
from msa_tpu_torch.checkpoints import flax_msgpack
from msa_tpu_torch.models.speaker import VoiceSpec, random_voice
from msa_tpu_torch.precision import exact_fp32

logger = logging.getLogger(__name__)

SR = 16_000


@dataclasses.dataclass(frozen=True)
class Prosody:
    f0_scale: float = 1.0  # pitch level multiplier on the voice's f0
    f0_var: float = 0.05  # slow pitch modulation depth
    f0_slope: float = 0.0  # rising (+) / falling (−) contour over the clip
    rate: float = 3.5  # syllables per second
    energy: float = 1.0  # output level multiplier
    tilt: float = 1.0  # spectral-tilt multiplier (<1 = brighter/tenser)
    attack: float = 1.0  # syllable envelope exponent (>1 = sharper bursts)
    roughness: float = 0.0  # low-frequency amplitude jitter depth


# IEMOCAP4 order: neutral, angry, happy, sad (core/emotions.py)
CLASS_PROSODY: Tuple[Prosody, ...] = (
    Prosody(),
    Prosody(f0_scale=1.25, f0_var=0.15, rate=4.8, energy=1.8, tilt=0.55, attack=2.4, roughness=0.3),
    Prosody(f0_scale=1.38, f0_var=0.28, f0_slope=0.25, rate=4.2, energy=1.35, tilt=0.85, attack=1.1),
    Prosody(f0_scale=0.78, f0_var=0.03, f0_slope=-0.15, rate=2.2, energy=0.5, tilt=1.45, attack=0.7),
)
CLASS_NAMES = ("neutral", "angry", "happy", "sad")


def _jitter(rng: np.random.Generator, p: Prosody) -> Prosody:
    g = lambda v, rel: float(v * rng.uniform(1 - rel, 1 + rel))  # noqa: E731
    return Prosody(
        f0_scale=g(p.f0_scale, 0.08),
        f0_var=g(p.f0_var, 0.3),
        f0_slope=float(p.f0_slope + rng.normal(0, 0.04)),
        rate=g(p.rate, 0.15),
        energy=g(p.energy, 0.15),
        tilt=g(p.tilt, 0.1),
        attack=g(p.attack, 0.15),
        roughness=float(max(0.0, p.roughness + rng.normal(0, 0.05))),
    )


def synth_prosody_voice(
    rng: np.random.Generator,
    spec: VoiceSpec,
    pros: Prosody,
    seconds: float,
    sample_rate: int = SR,
) -> np.ndarray:
    """Harmonic voice (formant envelope from ``spec``) with prosody from
    ``pros``: the emotional counterpart of
    :func:`msa_tpu_torch.models.speaker.synth_voice`."""
    n = int(seconds * sample_rate)
    t = np.arange(n) / sample_rate

    # pitch contour: level × (slow modulation + linear slope) × vibrato
    slow = np.sin(2 * np.pi * rng.uniform(0.4, 1.2) * t + rng.uniform(0, 2 * np.pi))
    contour = 1.0 + pros.f0_var * slow + pros.f0_slope * (t / seconds - 0.5)
    vibrato = 1.0 + 0.015 * np.sin(2 * np.pi * rng.uniform(4.5, 6.5) * t)
    f0 = np.clip(spec.f0 * pros.f0_scale * contour * vibrato, 40.0, 500.0)
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate

    base_f0 = spec.f0 * pros.f0_scale
    tilt = spec.tilt * pros.tilt
    sig = np.zeros(n)
    n_harm = min(40, max(3, int((sample_rate / 2 - 200) / base_f0)))
    for h in range(1, n_harm + 1):
        fh = base_f0 * h
        env = sum(1.0 / (1.0 + ((fh - fc) / spec.bandwidth) ** 2) for fc in spec.formants)
        amp = env / (h**tilt)
        sig += amp * np.sin(h * phase + rng.uniform(0, 2 * np.pi))

    # syllabic gating: half-rectified sine raised to the attack exponent
    syll = np.clip(np.sin(2 * np.pi * pros.rate * t + rng.uniform(0, 2 * np.pi)), 0.0, None)
    sig = sig * (0.25 + 0.75 * syll**pros.attack)

    if pros.roughness > 0:
        # low-pass amplitude jitter ≈ vocal roughness
        lp = np.cumsum(rng.standard_normal(n))
        lp = (lp - lp.mean()) / (np.abs(lp).max() + 1e-8)
        sig = sig * (1.0 + pros.roughness * lp)

    sig += spec.breathiness * rng.standard_normal(n) * np.max(np.abs(sig))
    peak = np.max(np.abs(sig)) + 1e-8
    # energy is part of the label signal: scale AFTER peak normalization
    return np.clip(0.18 * pros.energy * sig / peak, -1.0, 1.0).astype(np.float32)


def make_dataset(
    rng: np.random.Generator,
    n: int,
    seconds: float = 5.0,
    samples: int = 80_000,
    speech_fraction: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """n prosody-labelled clips, a fresh voice each. → (waves [n, samples]
    f32, labels [n] int64 in IEMOCAP4 order). ``speech_fraction`` of them
    are SPOKEN sentences (:mod:`msa_tpu_torch.training.speech_synth`) under
    the class prosody, the words drawn independently of the class."""
    from msa_tpu_torch.training.speech_synth import spoken_sentence, synth_spoken_clip
    from msa_tpu_torch.training.text_synth import EMOTION_WORDS

    all_words = [w for pool in EMOTION_WORDS for w in pool]
    waves = np.zeros((n, samples), np.float32)
    labels = rng.integers(0, 4, size=n).astype(np.int64)
    for i in range(n):
        pros = _jitter(rng, CLASS_PROSODY[int(labels[i])])
        voice = random_voice(rng)
        if rng.uniform() < speech_fraction:
            texts = [spoken_sentence(rng, all_words[int(rng.integers(0, len(all_words)))]) for _ in range(2)]
            # 0.6×: synth_utterance peak-normalizes to 0.3·energy against the
            # prosody voices' 0.18·energy; keeps the energy cue comparable
            w = 0.6 * synth_spoken_clip(rng, voice, texts, seconds, prosody=pros)
        else:
            w = synth_prosody_voice(rng, voice, pros, seconds)
        waves[i, : min(len(w), samples)] = w[:samples]
    return waves, labels


# --- training -----------------------------------------------------------------


def _sorted(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A tree with every dict's keys sorted, as JAX's tree maps leave it."""
    return {k: _sorted(v) if isinstance(v, Mapping) else v for k, v in sorted(tree.items())}


def _ce_acc(logits: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fits' loss and accuracy: the mean cross-entropy of the f32
    logits' log-softmax, and the share of argmax hits."""
    ce = -F.log_softmax(logits.float(), dim=-1).gather(1, y[:, None]).mean()
    return ce, (logits.detach().argmax(dim=-1) == y).float().mean()


@torch.no_grad()
def _batched_forward(model, params, waves: np.ndarray, key: str, batch: int = 32, device: bool = False):
    """The frozen trunk's ``key`` output over ``waves``, one forward per
    batch of ``batch`` clips (the last padded with zeros to that shape, as
    JAX's). ``device=True`` keeps the result on the model's device in bf16;
    otherwise it comes to the host as f32 numpy, ``"hidden"`` as f16.
    ``params`` (a flax tree) is loaded into ``model`` first; None keeps its
    weights."""
    if params is not None:
        weights.load_flax_tree(model, params)
    dev = weights.device_of(model)
    out = []
    with exact_fp32():
        for lo in range(0, len(waves), batch):
            chunk = waves[lo : lo + batch]
            if len(chunk) < batch:  # keep ONE shape
                chunk = np.pad(chunk, [(0, batch - len(chunk)), (0, 0)])
            got = model(torch.from_numpy(np.ascontiguousarray(chunk)).to(dev))[key][: len(waves) - lo]
            if device:
                out.append(got.to(torch.bfloat16))
                continue
            got = got.float().cpu().numpy()
            out.append(got.astype(np.float16) if key == "hidden" else got)
    return torch.cat(out, dim=0) if device else np.concatenate(out, axis=0)


def pooled_features(model, params, waves: np.ndarray, batch: int = 32) -> np.ndarray:
    """Frozen-trunk attentive-stats features [N, 2·d_model] (f32)."""
    return _batched_forward(model, params, waves, "pooled", batch)


def train_head(
    features: np.ndarray,
    labels: np.ndarray,
    head_params: Mapping[str, Any],
    steps: int = 2000,
    lr: float = 3e-3,
    batch: int = 128,
    seed: int = 0,
    log_every: int = 0,
    device: "str | torch.device" = "cuda",
) -> Dict[str, np.ndarray]:
    """Fit a linear head ``{kernel [d, C], bias [C]}`` on frozen features
    on ``device``: the features standardized, numpy's ``rng.integers``
    minibatches, AdamW (weight decay 1e-4), then the standardization folded
    back into the head (numpy, JAX's arithmetic), so the head takes the
    raw features."""
    from msa_tpu_torch.training.encoders import adamw

    rng = np.random.default_rng(seed)
    mu = features.mean(axis=0)
    sd = features.std(axis=0) + 1e-6
    feats = ((features - mu) / sd).astype(np.float32)
    x_all = torch.from_numpy(feats).to(device)
    y_all = torch.from_numpy(np.asarray(labels, np.int64)).to(device)
    kernel = nn.Parameter(torch.from_numpy(np.array(head_params["kernel"], np.float32)).to(device))
    bias = nn.Parameter(torch.from_numpy(np.array(head_params["bias"], np.float32)).to(device))
    optimizer = adamw([kernel, bias], lr=lr, weight_decay=1e-4)
    loss = acc = float("nan")
    for i in range(steps):
        idx = torch.from_numpy(rng.integers(0, len(feats), size=batch)).to(device)
        with exact_fp32():
            optimizer.zero_grad(set_to_none=True)
            loss, acc = _ce_acc(x_all[idx] @ kernel + bias, y_all[idx])
            loss.backward()
            optimizer.step()
        if log_every and (i + 1) % log_every == 0:
            logger.info("head step %d: ce=%.4f acc=%.3f", i + 1, float(loss.detach()), float(acc))
    # fold standardization: logits = ((x-mu)/sd)K + b = x(K/sd) + (b - (mu/sd)K)
    k_np, b_np = kernel.detach().cpu().numpy(), bias.detach().cpu().numpy()
    k = k_np / sd[:, None]
    b = b_np - (mu / sd) @ k_np
    return {"kernel": k.astype(np.float32), "bias": b.astype(np.float32)}


def train_pool_head(
    hidden,
    labels: np.ndarray,
    pool_module: nn.Module,
    init_params: Mapping[str, Any],
    steps: int = 3000,
    lr: float = 1e-3,
    batch: int = 64,
    seed: int = 0,
    log_every: int = 0,
) -> Dict[str, Any]:
    """Fit the attentive pooling and the head jointly on cached encoder
    states [N, T, d] (bf16 on the device, as :func:`_batched_forward` with
    ``device=True`` leaves them; a host array goes there in bf16). A copy of
    ``pool_module`` (an :class:`AttentiveStatsPool`) starts from
    ``init_params["pool"]`` and a Linear head from
    ``init_params["emotion_head"]``, on the pool's device; each step gathers
    ``randint(sub, (batch,), 0, N)`` rows, ``sub`` from JAX's key stream
    ``key, sub = split(key)`` from ``PRNGKey(seed)``. AdamW (weight decay
    1e-4), f32. → {"emotion_head", "pool"} f32 numpy trees."""
    from msa_tpu_torch.training.encoders import adamw

    pool = copy.deepcopy(pool_module)
    dev = weights.device_of(pool)
    weights.load_flax_tree(pool, init_params["pool"])
    head_tree = init_params["emotion_head"]
    with torch.device(dev):
        head = nn.Linear(*np.shape(head_tree["kernel"]))
    weights.load_flax_tree(head, head_tree)
    pool.train().requires_grad_(True)
    head.train().requires_grad_(True)
    optimizer = adamw([*pool.parameters(), *head.parameters()], lr=lr, weight_decay=1e-4)
    hidden_dev = hidden if isinstance(hidden, torch.Tensor) else torch.from_numpy(np.asarray(hidden, np.float32))
    hidden_dev = hidden_dev.to(device=dev, dtype=torch.bfloat16)
    labels_dev = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
    n = len(hidden_dev)

    key = flax_init.prng_key(seed)
    for i in range(steps):
        key, sub = flax_init.split(key)
        idx = flax_init.randint(sub, batch, 0, n).to(dev)
        with exact_fp32():
            optimizer.zero_grad(set_to_none=True)
            loss, acc = _ce_acc(head(pool(hidden_dev[idx].float())), labels_dev[idx])
            loss.backward()
            optimizer.step()
        if log_every and (i + 1) % log_every == 0:
            logger.info("pool+head step %d: ce=%.4f acc=%.3f", i + 1, float(loss.detach()), float(acc))
    return _sorted({"pool": weights.flax_tree(pool), "emotion_head": weights.flax_tree(head)})


@torch.no_grad()
def evaluate_head(model, params, head: Mapping[str, Any], waves, labels, batch: int = 32) -> Dict[str, float]:
    """Held-out metrics. ``head`` is a linear ``{kernel, bias}`` head on the
    frozen pooled features, or a ``{"pool", "emotion_head"}`` tree on the
    frozen encoder states."""
    if "pool" in head:
        from msa_tpu_torch.models.transformer import AttentiveStatsPool

        hidden = _batched_forward(model, params, waves, "hidden", batch, device=True)
        with torch.device(hidden.device):
            pool = AttentiveStatsPool(hidden.shape[-1], model.cfg.pool_hidden)
        weights.load_flax_tree(pool, head["pool"])
        with exact_fp32():
            pooled = pool(hidden.float()).cpu().numpy()
        logits = pooled @ head["emotion_head"]["kernel"] + head["emotion_head"]["bias"]
    else:
        feats = pooled_features(model, params, waves, batch)
        logits = feats @ head["kernel"] + head["bias"]
    pred = logits.argmax(axis=-1)
    acc = float((pred == labels).mean())
    recalls = {
        name: float((pred[labels == k] == k).mean()) for k, name in enumerate(CLASS_NAMES) if (labels == k).any()
    }
    return {
        "accuracy": acc,
        "worst_class_recall": min(recalls.values()),
        **{f"recall_{n}": v for n, v in recalls.items()},
    }


def train(
    model=None,
    params: Optional[Mapping[str, Any]] = None,
    n_train: int = 1024,
    n_eval: int = 256,
    steps: int = 3000,
    seed: int = 0,
    batch: int = 32,
    seconds: float = 5.0,
    samples: int = 80_000,
    log_every: int = 0,
    mode: str = "pool",
    speech_fraction: float = 0.0,
    device: "str | torch.device" = "cuda",
) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """The recipe: synthetic dataset → frozen-trunk forward → fit →
    held-out eval. ``model`` is the trunk (an AudioEmotionModel on its
    device, e.g. ``PipelineModels.initialize().audio``); None builds
    ``AudioModelConfig()`` on ``device`` from JAX's init of ``seed+2`` (the
    trunk the default pipeline builds). ``params``, where given, is loaded
    into the model. ``mode="pool"`` fits the attentive pooling and the head
    on the cached encoder states, ``mode="head"`` the linear head on the
    pooled features. → (the head's flax tree, metrics)."""
    from msa_tpu_torch.models.audio import AudioEmotionModel, AudioModelConfig
    from msa_tpu_torch.models.transformer import AttentiveStatsPool

    if model is None:
        with torch.device(device):
            model = flax_init.init_module_(AudioEmotionModel(AudioModelConfig()), seed + 2).eval()
    if params is not None:
        weights.load_flax_tree(model, params)
    dev = weights.device_of(model)

    rng = np.random.default_rng(seed + 100)
    waves, labels = make_dataset(rng, n_train, seconds, samples, speech_fraction)
    ew, el = make_dataset(np.random.default_rng(seed + 200), n_eval, seconds, samples, speech_fraction)

    if mode == "pool":
        hidden = _batched_forward(model, None, waves, "hidden", batch, device=True)
        with torch.device(dev):
            pool = AttentiveStatsPool(model.cfg.encoder.d_model, model.cfg.pool_hidden)
        init = {"pool": weights.flax_tree(model.pool), "emotion_head": weights.flax_tree(model.emotion_head)}
        head = train_pool_head(hidden, labels, pool, init, steps=steps, seed=seed, log_every=log_every)
    else:
        feats = pooled_features(model, None, waves, batch)
        head = train_head(feats, labels, weights.flax_tree(model.emotion_head), steps=steps, seed=seed,
                          log_every=log_every, device=dev)
    metrics = evaluate_head(model, None, head, ew, el, batch)
    return head, metrics


def save_head(head: Mapping[str, Any], path: str) -> None:
    """JAX's file: ``flax.serialization.to_bytes(head)``, the tree's own
    key order."""
    flax_msgpack.dump(path, head, sort_keys=False)


def load_head(path: str) -> Dict[str, Any]:
    """A trained head as stored: ``{"pool", "emotion_head": {kernel,
    bias}}`` (the pool recipe) or a bare ``{kernel, bias}``; numpy leaves."""
    return flax_msgpack.load(path)


def main(argv=None):
    """JAX's CLI, plus ``--device``."""
    import argparse

    parser = argparse.ArgumentParser(description="Treina o classificador de emoções de áudio (prosódia sintética)")
    parser.add_argument("--n-train", type=int, default=1024)
    parser.add_argument("--n-eval", type=int, default=256)
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--out", default="checkpoints/audio_emotion_head.msgpack")
    # mixed distribution: half SPOKEN sentences (what synth_av meetings
    # carry), half sustained prosody voices
    parser.add_argument("--speech-fraction", type=float, default=0.5)
    parser.add_argument("--device", default="cuda", help="torch device to run the trunk and the fit on")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    head, metrics = train(
        n_train=args.n_train,
        n_eval=args.n_eval,
        steps=args.steps,
        batch=args.batch,
        log_every=200,
        speech_fraction=args.speech_fraction,
        device=args.device,
    )
    logger.info("eval: %s", metrics)
    save_head(head, args.out)
    logger.info("wrote %s", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
