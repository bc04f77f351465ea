"""Fusion-model trainer (port of ``msa_tpu/training/train_fusion.py``).

The reference trainer's hyperparameters: AdamW lr 1e-4 / weight decay 1e-5,
batch 32, at most 100 epochs, JAX's KL loss against the preprocessed
pseudo-label (:func:`msa_tpu_torch.models.fusion.compute_loss`), validation
each epoch, early stopping after 10 epochs without a better validation
loss, the best model in ``checkpoint_dir/best_model.msgpack`` and a
crash-resumable ``last_state.msgpack``.

As JAX's, bit for bit where it can be:

- the records load in the same order and shuffle with numpy's
  ``default_rng(seed + epoch)``;
- the dropout keys follow JAX's stream: ``PRNGKey(seed)``, then ``rng,
  step_rng = split(rng)`` each step (:func:`msa_tpu_torch.flax_init.split`),
  each step's masks flax's (a resumed run starts the stream again from
  ``PRNGKey(seed)``, as JAX's does);
- ``last_state.msgpack`` holds optax's AdamW state in its layout,
  ``{"0": {"count", "mu", "nu"}, "1": {}, "2": {}}`` keyed by the flax param
  tree, mapped to and from torch AdamW's ``step`` / ``exp_avg`` /
  ``exp_avg_sq``: a state either package writes resumes in the other;
- optax steps every leaf, so a parameter the batch leaves unused (the
  ``fusion2`` bridge under three modalities, the modality weights) takes a
  zero gradient and its weight decay, as in JAX.

The step runs in f32 with TF32 off (:func:`msa_tpu_torch.precision.exact_fp32`).
``device`` takes the place of JAX's ``mesh``: the port trains on one device.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from msa_tpu_torch import flax_init, weights
from msa_tpu_torch.checkpoints import flax_msgpack
from msa_tpu_torch.models import fusion as fusion_lib
from msa_tpu_torch.precision import exact_fp32
from msa_tpu_torch.training.encoders import adamw

logger = logging.getLogger(__name__)


class AMIDataset:
    """Loads preprocessed segment JSON: every ``*.json`` under
    ``data_dir/split`` holds a list of {face_vec, audio_vec, text_vec,
    target} records."""

    def __init__(self, data_dir: str, split: str = "train"):
        self.data_dir = data_dir
        self.split = split
        self.records: List[Dict] = []
        for f in sorted((Path(data_dir) / split).glob("*.json")):
            self.records.extend(json.loads(f.read_text()))

    def __len__(self) -> int:
        return len(self.records)

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        return tuple(np.asarray([r[k] for r in self.records], np.float32) for k in ("face_vec", "audio_vec", "text_vec", "target"))

    def batches(self, batch_size: int, shuffle: bool, seed: int = 0) -> Iterator[Tuple[np.ndarray, ...]]:
        """Full batches only (a last partial batch is dropped, as JAX's)."""
        face, audio, text, target = self.arrays()
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(self) - batch_size + 1, batch_size):
            sel = order[i : i + batch_size]
            yield face[sel], audio[sel], text[sel], target[sel]


@dataclass
class TrainState:
    """JAX's ``TrainState``: here ``params`` is the :class:`FusionMLP`
    (the module carries its params) and ``opt_state`` its optimizer."""

    params: Any
    opt_state: Any
    step: int = 0


def make_optimizer(model: nn.Module, learning_rate: float = 1e-4, weight_decay: float = 1e-5) -> torch.optim.AdamW:
    """optax's ``adamw(learning_rate, weight_decay=…)`` over ``model``'s
    parameters, the reference's settings by default."""
    return adamw(model.parameters(), lr=learning_rate, weight_decay=weight_decay)


def make_train_step(model: fusion_lib.FusionMLP, optimizer: torch.optim.Optimizer) -> Callable[..., torch.Tensor]:
    """``step(face, audio, text, target, rng) → loss``: one AdamW step of
    ``model`` in place on the KL loss, the dropout masks flax's for the key
    pair ``rng`` (JAX's ``step_rng``)."""

    def train_step(face, audio, text, target, rng) -> torch.Tensor:
        with exact_fp32():
            optimizer.zero_grad(set_to_none=True)
            loss, _ = fusion_lib.compute_loss(model, face, audio, text, target, dropout_rng=rng)
            loss.backward()
            for p in model.parameters():  # optax's zero gradient for an unused leaf
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            optimizer.step()
        return loss.detach()

    return train_step


def make_eval_step(model: fusion_lib.FusionMLP) -> Callable[..., torch.Tensor]:
    """``eval(face, audio, text, target) → loss`` with dropout off."""

    def eval_step(face, audio, text, target) -> torch.Tensor:
        with torch.no_grad(), exact_fp32():
            return fusion_lib.compute_loss(model, face, audio, text, target)[0]

    return eval_step


def _opt_state_tree(model: nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """torch AdamW's state as optax's ``adamw`` state dict (zeros before
    the first step)."""
    state = optimizer.state

    def moment(key):
        return lambda p: state[p][key] if p in state else torch.zeros_like(p)

    count = next((int(s["step"]) for s in state.values()), 0)
    return {
        "0": {"count": np.asarray(count, np.int32), "mu": weights.flax_tree(model, moment("exp_avg")),
              "nu": weights.flax_tree(model, moment("exp_avg_sq"))},
        "1": {},
        "2": {},
    }


def _load_opt_state(model: nn.Module, optimizer: torch.optim.Optimizer, tree: Mapping[str, Any]) -> None:
    adam = tree["0"]

    def port(moments, leaf, p):
        node = moments
        for name in leaf.path:
            node = node[name]
        return flax_init.to_port(leaf, torch.from_numpy(np.array(node, np.float32)), p).to(p.device).clone()

    step = float(np.asarray(adam["count"]))
    for leaf, p in flax_init.leaves(model):
        optimizer.state[p] = {"step": torch.tensor(step), "exp_avg": port(adam["mu"], leaf, p),
                              "exp_avg_sq": port(adam["nu"], leaf, p)}


def _save_train_state(path: str, epoch: int, model, optimizer, best_val: float, patience_left: int) -> None:
    """JAX's crash-resumable trainer state: ``{epoch, best_val,
    patience_left, params, opt_state}``."""
    flax_msgpack.dump(
        path,
        {
            "epoch": epoch,
            "best_val": float(best_val),
            "patience_left": int(patience_left),
            "params": weights.flax_tree(model),
            "opt_state": _opt_state_tree(model, optimizer),
        },
    )


def _load_train_state(path: str, model, optimizer) -> Tuple[int, float, int]:
    """Load a ``last_state.msgpack`` into ``model`` and ``optimizer``;
    → (epoch, best_val, patience_left)."""
    payload = flax_msgpack.load(path)
    weights.load_flax_tree(model, payload["params"])
    _load_opt_state(model, optimizer, payload["opt_state"])
    return int(payload["epoch"]), float(payload["best_val"]), int(payload["patience_left"])


def train(
    data_dir: str = "data/ami",
    checkpoint_dir: str = "checkpoints",
    batch_size: int = 32,
    learning_rate: float = 1e-4,
    weight_decay: float = 1e-5,
    num_epochs: int = 100,
    patience: int = 10,
    seed: int = 0,
    device: "str | torch.device" = "cuda",
    model: Optional[fusion_lib.FusionMLP] = None,
    params: Any = None,
    resume: bool = False,
) -> Tuple[fusion_lib.FusionMLP, Dict[str, List[float]]]:
    """JAX's training loop (``msa_tpu/training/train_fusion.py:155-240``) on
    ``device``: early stopping, best-val checkpointing and crash-resume
    (``resume=True`` continues from ``last_state.msgpack``). ``model`` gives
    the architecture (its fields; default ``FusionMLP()``); training starts
    from ``params`` (a flax tree, or a FusionMLP whose weights to copy) or
    else JAX's init of ``seed``. → (the trained FusionMLP on ``device``,
    ``{"train_loss": [...], "val_loss": [...]}``)."""
    with torch.device(device):
        net = fusion_lib.FusionMLP(**(model or fusion_lib.FusionMLP()).dims())
    if params is None:
        fusion_lib.init_params(net, seed)
    else:
        weights.load_flax_tree(net, weights.flax_tree(params) if isinstance(params, nn.Module) else params)
    net.train().requires_grad_(True)
    optimizer = make_optimizer(net, learning_rate, weight_decay)
    train_step = make_train_step(net, optimizer)
    eval_step = make_eval_step(net)

    train_ds = AMIDataset(data_dir, "train")
    val_ds = AMIDataset(data_dir, "val")
    if len(train_ds) == 0:
        raise ValueError(f"no training data under {data_dir}/train")

    rng = flax_init.prng_key(seed)
    best_val = float("inf")
    patience_left = patience
    start_epoch = 0
    history: Dict[str, List[float]] = {"train_loss": [], "val_loss": []}
    ckpt_path = os.path.join(checkpoint_dir, "best_model.msgpack")
    state_path = os.path.join(checkpoint_dir, "last_state.msgpack")
    if resume and os.path.exists(state_path):
        start_epoch, best_val, patience_left = _load_train_state(state_path, net, optimizer)
        logger.info("resumed training from epoch %d", start_epoch)

    def on_device(batch):
        return [torch.from_numpy(x).to(device) for x in batch]

    for epoch in range(start_epoch, num_epochs):
        losses = []
        for batch in train_ds.batches(batch_size, shuffle=True, seed=seed + epoch):
            rng, step_rng = flax_init.split(rng)
            losses.append(float(train_step(*on_device(batch), step_rng)))
        train_loss = float(np.mean(losses)) if losses else float("nan")

        val_losses = [float(eval_step(*on_device(batch))) for batch in val_ds.batches(batch_size, shuffle=False)]
        val_loss = float(np.mean(val_losses)) if val_losses else train_loss

        history["train_loss"].append(train_loss)
        history["val_loss"].append(val_loss)
        logger.info("epoch %d: train=%.4f val=%.4f", epoch + 1, train_loss, val_loss)

        if val_loss < best_val:
            best_val = val_loss
            patience_left = patience
            fusion_lib.save_checkpoint(ckpt_path, net)
        else:
            patience_left -= 1
            if patience_left <= 0:
                logger.info("early stopping at epoch %d", epoch + 1)
                break
        _save_train_state(state_path, epoch + 1, net, optimizer, best_val, patience_left)

    return net.eval().requires_grad_(False), history


def main(argv=None):
    """JAX's CLI (the reference trainer's flags), plus ``--device``."""
    import argparse

    parser = argparse.ArgumentParser(description="Treina o modelo de fusão")
    parser.add_argument("--data-dir", default="data/ami")
    parser.add_argument("--checkpoint-dir", default="checkpoints")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--learning-rate", type=float, default=1e-4)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--patience", type=int, default=10)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device to train on (JAX's mesh)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    _, history = train(
        data_dir=args.data_dir,
        checkpoint_dir=args.checkpoint_dir,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        num_epochs=args.epochs,
        patience=args.patience,
        resume=args.resume,
        device=args.device,
    )
    logger.info("final val loss: %.4f", history["val_loss"][-1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
