"""Adaptive multimodal fusion MLP (port of ``msa_tpu/models/fusion.py``):
exact reference dims (face 27, audio 31, text 783, hidden 1024, out 7),
per-modality LayerNorm → proj → processor, the 3-modality head and the
2-modality ``fusion2`` bridge, and the learnable (reported, not applied)
modality weights. Inference only (dropout off). Runs in f32; the pipeline
keeps TF32 off around it, matching the reference's Precision.HIGHEST."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from msa_tpu_torch.models.transformer import LayerNorm
from msa_tpu_torch.ops.normalization import (
    AUDIO_TARGET_DIM,
    FACE_TARGET_DIM,
    LN_EPS,
    TEXT_TARGET_DIM,
)

_MODS = ("face", "audio", "text")


class FusionMLP(nn.Module):
    def __init__(
        self,
        face_dim: int = FACE_TARGET_DIM,
        audio_dim: int = AUDIO_TARGET_DIM,
        text_dim: int = TEXT_TARGET_DIM,
        hidden_dim: int = 1024,
        output_dim: int = 7,
    ):
        super().__init__()
        self.output_dim = output_dim
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

    def _branch(self, mod: str, x: torch.Tensor) -> torch.Tensor:
        """LayerNorm → proj → [LN, ReLU, Linear, LN, ReLU] → [B, 512]."""
        g = lambda n: getattr(self, f"{mod}_{n}")  # noqa: E731
        x = g("proj")(g("norm")(x))
        x = F.relu(g("proc_ln1")(x))
        return F.relu(g("proc_ln2")(g("proc_fc")(x)))

    def _head_tail(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.fusion_ln1(x))
        x = F.relu(self.fusion_ln2(self.fusion_fc2(x)))
        return self.fusion_out(x)

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


def get_weights(model: FusionMLP) -> Dict[str, float]:
    """The softmaxed modality weights as host floats (JAX's
    ``msa_tpu/models/fusion.py:get_weights``; the reference reports them and
    does not apply them)."""
    return {name: float(w) for name, w in model.weights_dict().items()}
