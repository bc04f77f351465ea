"""Adaptive multimodal fusion MLP (port of ``msa_tpu/models/fusion.py``):
exact reference dims (face 27, audio 31, text 783, hidden 1024, out 7,
dropout 0.3), per-modality LayerNorm → proj → processor, the 3-modality
head and the 2-modality ``fusion2`` bridge, and the learnable (reported,
not applied) modality weights.

Serving runs :meth:`FusionMLP.fuse_combo` with dropout off. Training runs
:meth:`FusionMLP.forward` (JAX's ``__call__``) with ``deterministic=False``
and a dropout key: JAX's one setup-defined ``nn.Dropout`` is named
``drop`` and called 6 times in a 2-modality forward and 8 times in a
3-modality one; flax counts the ``make_rng`` calls of that scope, so the
n-th call draws flax's mask with count n
(:meth:`~msa_tpu_torch.models.transformer.DropoutRng.dropout_key`).

The module is the params: :func:`init_params` fills it with JAX's flax
init, :func:`compute_loss` is JAX's KL loss, and :func:`save_checkpoint` /
:func:`load_checkpoint` write and read JAX's msgpack payload
``{"meta_json", "params"}``. Runs in f32; callers keep TF32 off around it
(:func:`msa_tpu_torch.precision.exact_fp32`), matching the reference's
Precision.HIGHEST."""

from __future__ import annotations

import itertools
import json
import logging
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from msa_tpu_torch import flax_init, weights
from msa_tpu_torch.checkpoints import flax_msgpack
from msa_tpu_torch.models.transformer import DropoutRng, LayerNorm, dropout
from msa_tpu_torch.ops.normalization import (
    AUDIO_TARGET_DIM,
    FACE_TARGET_DIM,
    LN_EPS,
    TEXT_TARGET_DIM,
)

logger = logging.getLogger(__name__)

_MODS = ("face", "audio", "text")
_DIMS = ("face_dim", "audio_dim", "text_dim", "hidden_dim", "output_dim", "dropout")

Drop = Callable[[torch.Tensor], torch.Tensor]


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class FusionMLP(nn.Module):
    def __init__(
        self,
        face_dim: int = FACE_TARGET_DIM,
        audio_dim: int = AUDIO_TARGET_DIM,
        text_dim: int = TEXT_TARGET_DIM,
        hidden_dim: int = 1024,
        output_dim: int = 7,
        dropout: float = 0.3,
    ):
        super().__init__()
        self.face_dim, self.audio_dim, self.text_dim = face_dim, audio_dim, text_dim
        self.hidden_dim, self.output_dim, self.dropout = hidden_dim, output_dim, dropout
        h, h2 = hidden_dim, hidden_dim // 2
        dims = {"face": face_dim, "audio": audio_dim, "text": text_dim}
        for m in _MODS:
            self.add_module(f"{m}_norm", LayerNorm(dims[m], LN_EPS, fast=False))
            self.add_module(f"{m}_proj", nn.Linear(dims[m], h))
            self.add_module(f"{m}_proc_ln1", LayerNorm(h, LN_EPS, fast=False))
            self.add_module(f"{m}_proc_fc", nn.Linear(h, h2))
            self.add_module(f"{m}_proc_ln2", LayerNorm(h2, LN_EPS, fast=False))
        self.fusion_fc1 = nn.Linear(3 * h2, h)
        self.fusion_ln1 = LayerNorm(h, LN_EPS, fast=False)
        self.fusion_fc2 = nn.Linear(h, h2)
        self.fusion_ln2 = LayerNorm(h2, LN_EPS, fast=False)
        self.fusion_out = nn.Linear(h2, output_dim)
        self.fusion2 = nn.Linear(2 * h2, h)
        self.audio_weight = nn.Parameter(torch.tensor(0.3))
        self.text_weight = nn.Parameter(torch.tensor(0.3))
        self.face_weight = nn.Parameter(torch.tensor(0.4))

    def dims(self) -> Dict[str, float]:
        """The constructor's arguments (JAX's module fields)."""
        return {k: getattr(self, k) for k in _DIMS}

    def _drop(self, deterministic: bool, dropout_rng) -> Drop:
        """flax's ``self.drop``: one scope whose n-th call draws with count n."""
        if deterministic or self.dropout == 0.0:
            return _identity
        rng, calls = DropoutRng.of(dropout_rng), itertools.count(1)
        return lambda x: dropout(x, self.dropout, False, rng, "drop", next(calls))

    def _branch(self, mod: str, x: torch.Tensor, drop: Drop = _identity) -> torch.Tensor:
        """LayerNorm → proj → [LN, ReLU, Drop, Linear, LN, ReLU, Drop] → [B, 512]."""
        g = lambda n: getattr(self, f"{mod}_{n}")  # noqa: E731
        x = g("proj")(g("norm")(x))
        x = drop(F.relu(g("proc_ln1")(x)))
        return drop(F.relu(g("proc_ln2")(g("proc_fc")(x))))

    def _head_tail(self, x: torch.Tensor, drop: Drop = _identity) -> torch.Tensor:
        x = drop(F.relu(self.fusion_ln1(x)))
        x = drop(F.relu(self.fusion_ln2(self.fusion_fc2(x))))
        return self.fusion_out(x)

    def forward(
        self,
        face: Optional[torch.Tensor] = None,
        audio: Optional[torch.Tensor] = None,
        text: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        dropout_rng=None,
    ) -> Dict[str, torch.Tensor]:
        """JAX's ``__call__`` (``msa_tpu/models/fusion.py:178-209``): the
        given vectors pass through; two modalities add ``fused`` through
        ``fusion2``, three through ``fusion_fc1`` (concat order face, audio,
        text). With ``deterministic=False`` and ``dropout > 0`` the masks are
        flax's from ``dropout_rng`` (a seed, a key pair or a
        :class:`~msa_tpu_torch.models.transformer.DropoutRng`); without one
        it raises ``ValueError``, as flax's ``make_rng`` does."""
        given = {m: x for m, x in zip(_MODS, (face, audio, text)) if x is not None}
        if not given:
            raise ValueError("no modality available for fusion")
        out = dict(given)
        if len(given) == 1:
            return out
        drop = self._drop(deterministic, dropout_rng)
        branches = [self._branch(m, x, drop) for m, x in given.items()]
        bridge = self.fusion_fc1 if len(given) == 3 else self.fusion2
        out["fused"] = self._head_tail(bridge(torch.cat(branches, dim=-1)), drop)
        return out

    def fuse_combo(self, face: torch.Tensor, audio: torch.Tensor, text: torch.Tensor, combo: torch.Tensor) -> torch.Tensor:
        """Per-row dispatch on ``combo = face·4 + audio·2 + text`` with no
        host sync: every branch runs for the whole batch and each row takes
        its own (the batched form of the JAX ``lax.switch``). Rows with
        fewer than two modalities take the first 7 columns of the one
        available vector (zeros for none). → [B, 7]."""
        f, a, t = (self._branch(m, x) for m, x in zip(_MODS, (face, audio, text)))
        k = self.output_dim
        branches = torch.stack(
            [
                torch.zeros_like(face[:, :k]),  # 0b000
                text[:, :k],  # 0b001
                audio[:, :k],  # 0b010
                self._head_tail(self.fusion2(torch.cat([a, t], dim=-1))),  # 0b011
                face[:, :k],  # 0b100
                self._head_tail(self.fusion2(torch.cat([f, t], dim=-1))),  # 0b101
                self._head_tail(self.fusion2(torch.cat([f, a], dim=-1))),  # 0b110
                self._head_tail(self.fusion_fc1(torch.cat([f, a, t], dim=-1))),  # 0b111
            ]
        )  # [8, B, 7]
        rows = torch.arange(face.shape[0], device=face.device)
        return branches[combo.long(), rows]

    def weights_dict(self) -> Dict[str, torch.Tensor]:
        """Softmaxed modality weights (audio, text, face)."""
        w = torch.softmax(torch.stack([self.audio_weight, self.text_weight, self.face_weight]), dim=0)
        return {"audio": w[0], "text": w[1], "face": w[2]}


FusionModel = FusionMLP  # the reference's name (msa_tpu/models/fusion.py:283)


def init_params(model: FusionMLP, seed: int = 0) -> FusionMLP:
    """Fill ``model`` with JAX's ``init_params(model, seed)``
    (``_init_host``: ``init(PRNGKey(seed))`` through ``init_all``, every
    branch's leaves), rebuilt by :mod:`msa_tpu_torch.flax_init`; returns it."""
    return flax_init.init_module_(model, seed)


def get_weights(model: FusionMLP) -> Dict[str, float]:
    """The softmaxed modality weights as host floats (JAX's
    ``msa_tpu/models/fusion.py:get_weights``; the reference reports them and
    does not apply them)."""
    with torch.no_grad():
        return {name: float(w) for name, w in model.weights_dict().items()}


def compute_loss(
    model: FusionMLP,
    face: torch.Tensor,
    audio: torch.Tensor,
    text: torch.Tensor,
    target: torch.Tensor,
    dropout_rng=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's KL loss (``msa_tpu/models/fusion.py:318-353``): the softmax of
    the fused logits against ``target``, torch ``kl_div(..., 'batchmean')``
    semantics with ``log(pred + 1e-8)`` and ``t·log t := 0`` where t = 0.
    Training mode (flax's dropout masks) where ``dropout_rng`` is given.
    → (loss, pred)."""
    deterministic = dropout_rng is None
    out = model(face, audio, text, deterministic=deterministic, dropout_rng=dropout_rng)
    pred = torch.softmax(out["fused"], dim=-1)
    log_pred = torch.log(pred + 1e-8)
    t = target
    tlogt = torch.where(t > 0, t * torch.log(torch.where(t > 0, t, torch.ones_like(t))), torch.zeros_like(t))
    kl = torch.sum(tlogt - t * log_pred, dim=-1)
    return kl.mean(), pred


def save_checkpoint(path: str, model: FusionMLP) -> None:
    """JAX's checkpoint (``msa_tpu/models/fusion.py:356-374``): one msgpack
    file of ``{"meta_json", "params"}``, the meta the reference's
    ``{weights, audio_dim, text_dim, face_dim, hidden_dim, output_dim,
    dropout}``, the params ``model``'s flax tree."""
    meta = {
        "weights": get_weights(model),
        "audio_dim": model.audio_dim,
        "text_dim": model.text_dim,
        "face_dim": model.face_dim,
        "hidden_dim": model.hidden_dim,
        "output_dim": model.output_dim,
        "dropout": model.dropout,
    }
    flax_msgpack.dump(path, {"meta_json": json.dumps(meta), "params": weights.flax_tree(model)})


def load_checkpoint(
    path: str, seed: int = 0, create_if_missing: bool = True, device: "str | torch.device" = "cuda"
) -> Tuple[FusionMLP, Dict[str, float]]:
    """A fusion checkpoint → ``(model on device, meta weights)``, the model
    rebuilt from the stored dims (JAX's ``load_checkpoint``; the module
    carries the params JAX returns beside it). Where the file is missing,
    a fresh ``FusionMLP()`` from JAX's init of ``seed`` is saved there and
    returned, as the reference's create-if-missing does; with
    ``create_if_missing=False`` it raises ``FileNotFoundError``."""
    p = Path(path)
    if not p.exists():
        if not create_if_missing:
            raise FileNotFoundError(path)
        logger.warning("checkpoint not found at %s — creating a new model", path)
        with torch.device(device):
            model = init_params(FusionMLP(), seed)
        save_checkpoint(path, model)
        return model, get_weights(model)
    payload = flax_msgpack.load(p)
    meta = json.loads(payload["meta_json"])
    with torch.device(device):
        model = FusionMLP(**{k: meta[k] for k in _DIMS})
    missing = weights.missing_leaves(model, payload["params"])
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} leaves of the model, e.g. {missing[:3]}")
    weights.load_flax_tree(model, payload["params"])
    return model, meta["weights"]
