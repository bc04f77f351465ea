"""Face models (port of ``msa_tpu/models/face.py``): the landmark regressor
with its integral-heatmap head, the two 48×48 emotion CNNs (the native one
and the DeepFace FER-2013 clone that ``cnn_arch="deepface"`` selects, with
the importer of its Keras weights), grayscale and the fixed-size bilinear
crop. All f32. Convs run NCHW; the heads and every reshape follow the JAX
NHWC layout so flattened features line up with the flax weights."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class FaceModelConfig:
    landmark_count: int = 478
    frame_size: int = 192
    crop_size: int = 48
    backbone_channels: Tuple[int, ...] = (16, 32, 64, 128, 128)
    cnn_channels: Tuple[int, ...] = (32, 64, 128)
    min_detection_confidence: float = 0.5
    # "native": FaceEmotionCNN; "deepface": DeepFace's FER-2013 architecture,
    # whose Keras weights load through params_from_keras_fer
    cnn_arch: str = "native"
    emotion_weights: Optional[str] = "checkpoints/face_emotion_cnn.msgpack"
    landmark_weights: Optional[str] = "checkpoints/landmark_net.msgpack"

    @classmethod
    def tiny(cls) -> "FaceModelConfig":
        """Small nets for tests (``msa_tpu/models/face.py:59``); no
        checkpoints, which would not fit them."""
        return cls(backbone_channels=(4, 8), cnn_channels=(4, 8), frame_size=32, emotion_weights=None, landmark_weights=None)


def _same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding (the extra pixel goes after)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    kh, kw = conv.kernel_size
    sh, sw = conv.stride
    top, bottom = _same_pad(x.shape[2], kh, sh)
    left, right = _same_pad(x.shape[3], kw, sw)
    return conv(F.pad(x, (left, right, top, bottom)))


class FlaxGroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` defaults: eps 1e-6 and the fast variance
    E[x²]−E[x]² (clipped at 0), statistics in f32, on NCHW input."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        g = x.float().reshape(b, self.num_groups, -1)
        mean = g.mean(dim=-1, keepdim=True)
        var = torch.clamp((g * g).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        mean = mean.repeat_interleave(c // self.num_groups, dim=1).reshape(b, c, 1, 1)
        var = var.repeat_interleave(c // self.num_groups, dim=1).reshape(b, c, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight[:, None, None]
        return (x - mean) * mul + self.bias[:, None, None]


def rgb_to_gray(frame: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luminance, [..., 3] → [..., 1]."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=frame.dtype, device=frame.device)
    return (frame * w).sum(dim=-1, keepdim=True)


def bilinear_crop_resize(image: torch.Tensor, bbox: torch.Tensor, out_size: int) -> torch.Tensor:
    """Batched crop of ``bbox`` [B, 4] = [x, y, w, h] (pixels) from
    [B, H, W, C], resized to [B, out, out, C] bilinearly; boxes with w or
    h ≤ 1 take the whole frame."""
    b, h, w = image.shape[:3]
    x0, y0, bw, bh = bbox.unbind(dim=-1)
    ok = (bw > 1.0) & (bh > 1.0)
    x0 = torch.where(ok, x0, 0.0)
    y0 = torch.where(ok, y0, 0.0)
    bw = torch.where(ok, bw, float(w))
    bh = torch.where(ok, bh, float(h))
    grid = (torch.arange(out_size, dtype=torch.float32, device=image.device) + 0.5) / out_size
    ys = y0[:, None] + grid[None] * bh[:, None] - 0.5  # [B, out]
    xs = x0[:, None] + grid[None] * bw[:, None] - 0.5
    y_lo = torch.clamp(torch.floor(ys), 0, h - 1).long()
    x_lo = torch.clamp(torch.floor(xs), 0, w - 1).long()
    y_hi = torch.clamp(y_lo + 1, max=h - 1)
    x_hi = torch.clamp(x_lo + 1, max=w - 1)
    wy = torch.clamp(ys - y_lo.float(), 0.0, 1.0)[:, :, None, None]
    wx = torch.clamp(xs - x_lo.float(), 0.0, 1.0)[:, None, :, None]
    img = image.float()
    bi = torch.arange(b, device=image.device)[:, None, None]

    def at(yi, xi):
        return img[bi, yi[:, :, None], xi[:, None, :]]

    top = at(y_lo, x_lo) * (1 - wx) + at(y_lo, x_hi) * wx
    bot = at(y_hi, x_lo) * (1 - wx) + at(y_hi, x_hi) * wx
    return top * (1 - wy) + bot * wy


class Conv1x1(nn.Linear):
    """A 1×1 convolution applied as a Linear on NHWC features; its flax
    kernel is ``[1, 1, in, out]``."""


class FaceLandmarkNet(nn.Module):
    """[B, S, S, 3] f32 frames → landmarks [B, 478, 3] (x, y ∈ [0, 1]; small
    z) and a face-presence score [B]."""

    def __init__(self, cfg: FaceModelConfig):
        super().__init__()
        self.cfg = cfg
        cin = 3
        for i, ch in enumerate(cfg.backbone_channels):
            self.add_module(f"conv_{i}", nn.Conv2d(cin, ch, 3, stride=2))
            self.add_module(f"gn_{i}", FlaxGroupNorm(min(ch, 8), ch))
            cin = ch
        L = cfg.landmark_count
        self.heatmap_head = Conv1x1(cin, L)
        self.offset_head = Conv1x1(cin, 2 * L)
        self.z_head = Conv1x1(cin, L)
        self.presence_head = nn.Linear(2 * cin, 1)

    def forward(self, frame: torch.Tensor) -> Dict[str, torch.Tensor]:
        L = self.cfg.landmark_count
        x = frame.permute(0, 3, 1, 2)
        for i in range(len(self.cfg.backbone_channels)):
            x = conv_same(x, getattr(self, f"conv_{i}"))
            x = F.gelu(getattr(self, f"gn_{i}")(x))
        x = x.permute(0, 2, 3, 1)  # NHWC
        b, h, w, _ = x.shape
        hm = self.heatmap_head(x).reshape(b, h * w, L)
        off = torch.tanh(self.offset_head(x).reshape(b, h * w, L, 2))
        zf = self.z_head(x).reshape(b, h * w, L)

        probs = torch.softmax(hm, dim=1)  # spatial softmax per landmark
        cy = (torch.arange(h, dtype=torch.float32, device=x.device) + 0.5) / h
        cx = (torch.arange(w, dtype=torch.float32, device=x.device) + 0.5) / w
        centers = torch.stack(
            [cx[None, :].expand(h, w), cy[:, None].expand(h, w)], dim=-1
        ).reshape(h * w, 2)
        xy = torch.einsum("bpl,pc->blc", probs, centers)
        cell = torch.tensor([1.0 / w, 1.0 / h], dtype=torch.float32, device=x.device)
        xy = torch.clamp(xy + torch.einsum("bpl,bplc->blc", probs, off) * cell, 0.0, 1.0)
        z = 0.1 * torch.tanh(torch.einsum("bpl,bpl->bl", probs, zf))[..., None]

        pooled = torch.cat([x.mean(dim=(1, 2)), x.amax(dim=(1, 2))], dim=-1)
        presence = torch.sigmoid(self.presence_head(pooled)[..., 0])
        return {"landmarks": torch.cat([xy, z], dim=-1), "presence": presence}


class FaceEmotionCNN(nn.Module):
    """[B, 48, 48, 1] gray crops in [0, 1] → 7 emotion probs, DeepFace order."""

    def __init__(self, cfg: FaceModelConfig):
        super().__init__()
        self.cfg = cfg
        cin = 1
        for i, ch in enumerate(cfg.cnn_channels):
            self.add_module(f"conv_{i}", nn.Conv2d(cin, ch, 3))
            cin = ch
        side = cfg.crop_size // 2 ** len(cfg.cnn_channels)
        self.fc = nn.Linear(side * side * cin, 128)
        self.emotion_head = nn.Linear(128, 7)

    def forward(self, crop: torch.Tensor) -> torch.Tensor:
        x = crop.permute(0, 3, 1, 2)
        for i in range(len(self.cfg.cnn_channels)):
            x = F.gelu(conv_same(x, getattr(self, f"conv_{i}")))
            x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten, as flax
        x = F.gelu(self.fc(x))
        probs = torch.softmax(self.emotion_head(x), dim=-1)
        return probs / probs.sum(dim=-1, keepdim=True)


class DeepFaceEmotionCNN(nn.Module):
    """DeepFace's FER-2013 emotion CNN (``msa_tpu/models/face.py:203-239``),
    so its published Keras weights drop in: conv 64@5×5 → max-pool 5×5/2 →
    conv 64@3×3 ×2 → avg-pool 3×3/2 → conv 128@3×3 ×2 → avg-pool 3×3/2 →
    dense 1024 ×2 → dense 7, ReLU throughout, VALID everywhere, f32; the
    softmax renormalised as :class:`FaceEmotionCNN`'s. [B, 48, 48, 1] →
    [B, 7], DeepFace order. At 48×48 the last map is 1×1×128, so the
    flatten has one order in both layouts."""

    def __init__(self, cfg: FaceModelConfig):
        super().__init__()
        self.cfg = cfg
        for i, (cin, cout, k) in enumerate(((1, 64, 5), (64, 64, 3), (64, 64, 3), (64, 128, 3), (128, 128, 3))):
            self.add_module(f"conv_{i}", nn.Conv2d(cin, cout, k))
        self.fc_0 = nn.Linear(128, 1024)
        self.fc_1 = nn.Linear(1024, 1024)
        self.emotion_head = nn.Linear(1024, 7)

    def forward(self, crop: torch.Tensor) -> torch.Tensor:
        if crop.shape[1] != 48 or crop.shape[2] != 48:
            raise ValueError("deepface arch requires 48x48 crops")
        x = F.relu(self.conv_0(crop.permute(0, 3, 1, 2)))
        x = F.max_pool2d(x, 5, 2)
        x = F.relu(self.conv_2(F.relu(self.conv_1(x))))
        x = F.avg_pool2d(x, 3, 2)
        x = F.relu(self.conv_4(F.relu(self.conv_3(x))))
        x = F.avg_pool2d(x, 3, 2)
        assert x.shape[2:] == (1, 1), x.shape
        x = F.relu(self.fc_1(F.relu(self.fc_0(x.flatten(1)))))
        probs = torch.softmax(self.emotion_head(x), dim=-1)
        return probs / probs.sum(dim=-1, keepdim=True)


# Keras layer names (the h5 file's order) → the flax names. Keras kernels
# are flax's layouts, (kh, kw, in, out) and (in, out): a re-keying.
_KERAS_FER_LAYERS = (
    ("conv2d", "conv_0"),
    ("conv2d_1", "conv_1"),
    ("conv2d_2", "conv_2"),
    ("conv2d_3", "conv_3"),
    ("conv2d_4", "conv_4"),
    ("dense", "fc_0"),
    ("dense_1", "fc_1"),
    ("dense_2", "emotion_head"),
)


def params_from_keras_fer(state: Mapping[str, Any]) -> Dict[str, Any]:
    """A Keras FER state dict → :class:`DeepFaceEmotionCNN`'s flax tree
    (f32 numpy leaves), as ``msa_tpu/models/face.py:256`` converts it.
    ``state`` maps Keras layer names to ``{"kernel", "bias"}``, or holds
    flat ``"name/kernel"`` keys (an npz export of DeepFace's
    ``facial_expression_model_weights.h5``)."""
    flat: Dict[str, Dict[str, Any]] = {}
    for k, v in state.items():
        if isinstance(v, Mapping):
            flat[k] = dict(v)
        else:
            name, _, part = k.rpartition("/")
            flat.setdefault(name, {})[part] = v
    return {
        flax_name: {part: np.asarray(flat[keras_name][part], np.float32) for part in ("kernel", "bias")}
        for keras_name, flax_name in _KERAS_FER_LAYERS
    }


def make_emotion_cnn(cfg: FaceModelConfig) -> nn.Module:
    """The emotion CNN that ``cfg.cnn_arch`` names."""
    return DeepFaceEmotionCNN(cfg) if cfg.cnn_arch == "deepface" else FaceEmotionCNN(cfg)


def load_emotion_weights(model: nn.Module, path: str) -> Dict[str, Any]:
    """The emotion CNN's flax tree from ``path`` (``msa_tpu/models/face.py:
    292-366``): a ``.npz`` Keras FER export through
    :func:`params_from_keras_fer`, which needs ``cnn_arch="deepface"``;
    anything else a flax-msgpack params file. Every leaf of ``model`` must
    be there at its shape, or ``ValueError`` says where it is not."""
    from msa_tpu_torch import flax_init
    from msa_tpu_torch.checkpoints import flax_msgpack

    if str(path).endswith(".npz"):
        if not isinstance(model, DeepFaceEmotionCNN):
            raise ValueError("npz Keras FER exports require cnn_arch='deepface'")
        with np.load(path) as z:
            params = params_from_keras_fer(dict(z.items()))
    else:
        params = flax_msgpack.load(path)
    for leaf, _ in flax_init.leaves(model):
        node: Any = params
        for name in leaf.path:
            node = node.get(name) if isinstance(node, Mapping) else None
        got = None if node is None else tuple(np.shape(node))
        if got != leaf.shape:
            raise ValueError(
                f"emotion weights {path} don't fit the configured CNN at {'/'.join(leaf.path)}: {got} vs {leaf.shape}"
            )
    return params
