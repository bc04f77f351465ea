"""The encoders' training step: the text and audio models in training mode
(``deterministic=False``; with ``dropout > 0`` flax's masks from a seed,
``train_step(..., dropout_seed=s)``), the loss of the JAX package's
trainers, ``backward()`` through the attention kernels' backward (rows 3
and 4), and optax's AdamW.

    opt = adamw(model.parameters())
    loss = train_step(model, text_loss, opt, input_ids, attention_mask, labels)

In f32 (``compute_dtype="float32"``, the parity mode's imported trunks)
the same step runs rows 5/6 and the backward in f32 on the card.

The loss is the trainers' (``msa_tpu/training/train_audio_emotion.py:257-262``,
``:324-329``): the mean cross-entropy of ``log_softmax`` of the f32 head
logits. The text model sums it over its four heads on [CLS]; the audio
model takes its 4-class emotion head. Labels are int64 tensors of class
indices. After training, run :func:`msa_tpu_torch.weights.derive_weights_`
before serving: the serving paths read copies derived from the f32 masters.
"""

from __future__ import annotations

from typing import Callable, Iterable, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from msa_tpu_torch.precision import exact_fp32

TEXT_HEADS = ("emotion_head", "sarcasm_head", "humor_head", "sentiment_head")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """−mean(log_softmax(f32 logits)[label])."""
    return -F.log_softmax(logits.float(), dim=-1).gather(1, labels[:, None]).mean()


def text_loss(
    model: nn.Module, input_ids: torch.Tensor, attention_mask: torch.Tensor, labels: Mapping[str, torch.Tensor],
    dropout_rng: Optional[int] = None,
) -> torch.Tensor:
    """Σ over ``labels`` (head name → [B] classes) of each head's
    cross-entropy on the [CLS] state, in training mode, the dropout masks
    drawn from the seed ``dropout_rng``."""
    cls = model(input_ids, attention_mask, deterministic=False, dropout_rng=dropout_rng)["context_embedding"]
    return sum(cross_entropy(getattr(model, head)(cls), y) for head, y in labels.items())


def audio_loss(model: nn.Module, wav: torch.Tensor, labels: torch.Tensor, dropout_rng: Optional[int] = None) -> torch.Tensor:
    """The emotion head's cross-entropy, in training mode."""
    return cross_entropy(model(wav, deterministic=False, dropout_rng=dropout_rng)["logits"], labels)


def adamw(params: Iterable[torch.Tensor], lr: float = 1e-3, weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=…)`` with optax's defaults (b1 0.9, b2
    0.999, eps 1e-8 outside the square root, decoupled decay on every
    parameter), the trainers' settings by default."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def adam(params: Iterable[torch.Tensor], lr: float = 1e-3) -> torch.optim.Adam:
    """``optax.adam(lr)`` with optax's defaults (b1 0.9, b2 0.999, eps 1e-8
    outside the square root), the synthetic-supervision trainers'
    optimizer. The same update as optax's in another order of operations."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_step(
    model: nn.Module, loss_fn: Callable[..., torch.Tensor], optimizer: torch.optim.Optimizer, *batch,
    dropout_seed: Optional[int] = None,
):
    """One step: zero the gradients, ``loss_fn(model, *batch)``,
    ``backward()``, ``optimizer.step()``, with TF32 off
    (:func:`~msa_tpu_torch.precision.exact_fp32`: JAX's f32 is exact, and
    the f32 step of the parity mode's trunks keeps it). With
    ``dropout_seed`` the loss takes it as ``dropout_rng``: the step's
    masks are those of JAX's ``rngs={"dropout": PRNGKey(dropout_seed)}``.
    Returns the loss (detached)."""
    extra = {} if dropout_seed is None else {"dropout_rng": dropout_seed}
    with exact_fp32():
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, *batch, **extra)
        loss.backward()
        optimizer.step()
    return loss.detach()
