"""Synthetic-supervision training for :class:`FaceEmotionCNN` (port of
``msa_tpu/training/train_face_emotion.py``).

The CNN learns from procedural expression crops
(:mod:`msa_tpu_torch.training.face_synth`), rendered, cropped and
grayscaled through the serving graph's own ops, labelled in DeepFace's
class order. The loss is JAX's: the mean negative log of the true class's
probability, the probabilities clipped at 1e-8 from below; Adam. The step
runs on the model's device, f32 with TF32 off.

CLI: ``python -m msa_tpu_torch.training.train_face_emotion --steps 3000``
writes ``checkpoints/face_emotion_cnn.msgpack`` (flax's bytes).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from msa_tpu_torch import flax_init, weights
from msa_tpu_torch.checkpoints import flax_msgpack
from msa_tpu_torch.precision import exact_fp32
from msa_tpu_torch.training import face_synth

logger = logging.getLogger(__name__)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> Callable[..., Tuple]:
    """``step(crops, labels) → (loss, acc)``: one optimizer step of
    ``model`` in place."""
    dev = weights.device_of(model)

    def step(crops, labels):
        crops = torch.as_tensor(crops).to(dev)
        labels = torch.as_tensor(labels).to(dev).long()
        with exact_fp32():
            optimizer.zero_grad(set_to_none=True)
            probs = model(crops)
            logp = torch.log(torch.clamp(probs, min=1e-8))
            ce = -logp.gather(1, labels[:, None]).mean()
            acc = (probs.argmax(dim=-1) == labels).float().mean()
            ce.backward()
            optimizer.step()
        return ce.detach(), acc

    return step


def train(
    cfg=None,
    steps: int = 1500,
    batch: int = 64,
    lr: float = 1e-3,
    seed: int = 0,
    params: "Mapping[str, Any] | None" = None,
    log_every: int = 100,
    frame_size: int = 96,
    device: "str | torch.device" = "cuda",
) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """Train the emotion CNN on procedural expression crops on ``device``,
    from ``params`` (a flax tree) or JAX's init of ``seed``. → (the trained
    flax tree, metrics)."""
    from msa_tpu_torch.models.face import FaceEmotionCNN, FaceModelConfig
    from msa_tpu_torch.training.encoders import adam

    cfg = cfg or FaceModelConfig()
    with torch.device(device):
        model = FaceEmotionCNN(cfg)
    if params is None:
        flax_init.init_module_(model, seed)
    else:
        weights.load_flax_tree(model, params)
    model.train().requires_grad_(True)
    step = make_train_step(model, adam(model.parameters(), lr))

    rng = np.random.default_rng(seed)
    template = face_synth.make_template(cfg.landmark_count)
    loss = acc = float("nan")
    for i in range(steps):
        crops, labels = face_synth.render_crop_batch(
            rng, batch, frame_size=frame_size, crop_size=cfg.crop_size, template=template, device=device
        )
        loss, acc = step(crops, labels)
        if log_every and (i + 1) % log_every == 0:
            logger.info("step %d: ce=%.4f acc=%.3f", i + 1, float(loss), float(acc))
    model.eval().requires_grad_(False)
    metrics = evaluate(model, None, template, seed=seed + 1)
    metrics["final_loss"] = float(loss)
    return weights.flax_tree(model), metrics


@torch.no_grad()
def evaluate(model, params, template=None, n: int = 256, seed: int = 1) -> Dict[str, float]:
    """Held-out accuracy and worst-class recall on fresh procedural crops.
    ``params`` (a flax tree) is loaded into ``model`` first; None keeps its
    weights."""
    if params is not None:
        weights.load_flax_tree(model, params)
    dev = weights.device_of(model)
    rng = np.random.default_rng(seed)
    template = template if template is not None else face_synth.make_template(model.cfg.landmark_count)
    crops, labels = face_synth.render_crop_batch(rng, n, crop_size=model.cfg.crop_size, template=template, device=dev)
    with exact_fp32():
        probs = model(torch.from_numpy(crops).to(dev)).cpu().numpy()
    pred = probs.argmax(axis=-1)
    acc = float((pred == labels).mean())
    recalls = {}
    for k, name in enumerate(face_synth.CLASS_NAMES):
        m = labels == k
        if m.any():
            recalls[name] = float((pred[m] == k).mean())
    return {
        "accuracy": acc,
        "worst_class_recall": min(recalls.values()),
        **{f"recall_{k}": v for k, v in recalls.items()},
    }


def save_params(params: Mapping[str, Any], path: str) -> None:
    """JAX's file: ``flax.serialization.to_bytes(params)`` of the trained
    tree, whose keys come out of JAX's step sorted."""
    flax_msgpack.dump(path, params)


def main(argv=None):
    """JAX's CLI, plus ``--device``."""
    import argparse

    parser = argparse.ArgumentParser(description="Treina a CNN de emoções faciais")
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--out", default="checkpoints/face_emotion_cnn.msgpack")
    parser.add_argument("--device", default="cuda", help="torch device to train on")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    params, metrics = train(steps=args.steps, batch=args.batch, lr=args.lr, device=args.device)
    logger.info("eval: %s", metrics)
    save_params(params, args.out)
    logger.info("wrote %s", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
