"""Parametric expression face renderer, the synthetic supervision of the
face branch's emotion half (port of ``msa_tpu/training/face_synth.py``).

The landmark template is deformed by per-class expression parameters (brow
raise/furrow and tilt, eye openness, mouth curvature/openness/width, raised
upper lip, nose wrinkle) and shaded from the same parameters through the
inverse affine, so pixels, landmark targets and labels agree exactly.
Classes are in DeepFace's order (angry, disgust, fear, happy, sad,
surprise, neutral), following FACS-style descriptions:

- angry: brows lowered, inner ends pulled down, narrowed eyes, pressed mouth
- disgust: nose wrinkle, raised upper lip, lowered brows, narrowed eyes
- fear: raised flat brows, widened eyes, slightly parted lips
- happy: mouth corners up, wide mouth, slightly narrowed eyes
- sad: mouth corners down, inner brow ends raised, droopy eyes
- surprise: brows high, eyes wide open, round open mouth
- neutral: the template

Everything is host numpy, byte-equal to JAX's from the same generator,
except :func:`render_crop_batch`'s grayscale, landmark box and bilinear
crop, which run the serving graph's own ops (``models/face.py``'s
``rgb_to_gray`` and ``bilinear_crop_resize``, ``ops/face_features.bbox``)
on ``device``, in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

import torch

from msa_tpu_torch.training.train_landmarks import _transform, make_template

# template part index ranges, fixed by make_template's construction order
OVAL = slice(0, 72)
BROW_L = slice(72, 88)
BROW_R = slice(88, 104)
EYE_L = slice(104, 128)  # outer 16 + inner 8
EYE_R = slice(128, 152)
NOSE = slice(152, 170)  # bridge 8 + nostril 10
MOUTH_OUT = slice(170, 194)
MOUTH_IN = slice(194, 210)

# neutral-face shape constants shared by the template and the shading
BROW_Y, BROW_RX, BROW_RY = 0.38, 0.09, 0.018
EYE_Y, EYE_RX, EYE_RY = 0.45, 0.055, 0.028
MOUTH_Y, MOUTH_RX, MOUTH_RY_OUT, MOUTH_RX_IN, MOUTH_RY_IN = (
    0.72,
    0.11,
    0.045,
    0.07,
    0.025,
)

# DeepFace dict order (face_analyzer.py:164-172)
CLASS_NAMES = ("angry", "disgust", "fear", "happy", "sad", "surprise", "neutral")


@dataclasses.dataclass
class Expression:
    brow_raise: float = 0.0  # + = brows up (template y down → subtract)
    brow_tilt: float = 0.0  # + = inner ends pulled DOWN (anger)
    eye_open: float = 1.0  # vertical eye aperture scale
    mouth_curve: float = 0.0  # + = corners DOWN (sad); − = corners up
    mouth_open: float = 1.0  # inner-mouth aperture scale
    mouth_width: float = 1.0
    lip_raise: float = 0.0  # + = whole mouth raised (disgust upper lip)
    nose_wrinkle: float = 0.0  # 0/1-ish: dark bridge creases


# per-class parameter means; sampling jitters around these
_CLASS_PARAMS = {
    "angry": Expression(
        brow_raise=-0.020,
        brow_tilt=0.022,
        eye_open=0.62,
        mouth_curve=0.012,
        mouth_open=0.35,
        mouth_width=0.92,
    ),
    "disgust": Expression(
        brow_raise=-0.012,
        brow_tilt=0.010,
        eye_open=0.62,
        mouth_curve=0.015,
        mouth_open=0.55,
        mouth_width=0.85,
        lip_raise=0.028,
        nose_wrinkle=1.0,
    ),
    "fear": Expression(
        brow_raise=0.030,
        brow_tilt=-0.006,
        eye_open=1.40,
        mouth_curve=0.006,
        mouth_open=1.45,
        mouth_width=0.80,
    ),
    "happy": Expression(
        eye_open=0.80,
        mouth_curve=-0.034,
        mouth_open=1.10,
        mouth_width=1.30,
    ),
    "sad": Expression(
        brow_raise=0.006,
        brow_tilt=-0.018,
        eye_open=0.74,
        mouth_curve=0.032,
        mouth_open=0.45,
        mouth_width=0.92,
    ),
    "surprise": Expression(
        brow_raise=0.038,
        eye_open=1.55,
        mouth_open=2.30,
        mouth_width=0.74,
    ),
    "neutral": Expression(),
}


def sample_expression(
    rng: np.random.Generator, class_idx: int, jitter_scale: float = 1.0
) -> Expression:
    """Jittered per-class expression parameters (≈20% relative + small
    absolute noise, so classes stay separable but not degenerate).
    ``jitter_scale`` widens every jitter sigma — the adversarial eval
    protocol samples OUTSIDE the training parameter envelope so the
    recorded metric can't saturate."""
    base = _CLASS_PARAMS[CLASS_NAMES[class_idx]]
    j = lambda v, a: v + rng.normal(0.0, a * jitter_scale)  # noqa: E731
    return Expression(
        brow_raise=j(base.brow_raise, 0.004),
        brow_tilt=j(base.brow_tilt, 0.003),
        eye_open=max(0.3, j(base.eye_open, 0.08)),
        mouth_curve=j(base.mouth_curve, 0.004),
        mouth_open=max(0.2, j(base.mouth_open, 0.12)),
        mouth_width=max(0.6, j(base.mouth_width, 0.06)),
        lip_raise=j(base.lip_raise, 0.003),
        nose_wrinkle=base.nose_wrinkle,
    )


def _mouth_geometry(e: Expression) -> Tuple[float, float, float, float, float]:
    my = MOUTH_Y - e.lip_raise
    rx = MOUTH_RX * e.mouth_width
    # outer lip band grows modestly with the aperture so an open mouth reads
    # as one region; the dark inner opening carries most of the signal
    ry_out = MOUTH_RY_OUT * (0.7 + 0.3 * e.mouth_open)
    rx_in = MOUTH_RX_IN * e.mouth_width
    ry_in = MOUTH_RY_IN * e.mouth_open
    return my, rx, ry_out, rx_in, ry_in


def deform_template(template: np.ndarray, e: Expression) -> np.ndarray:
    """Move template landmarks per the expression — the exact geometric
    counterpart of :func:`_shade` so crops and landmark targets agree."""
    t = template.copy()
    for sl, cx, sgn in ((BROW_L, 0.37, 1.0), (BROW_R, 0.63, -1.0)):
        t[sl, 1] -= e.brow_raise
        t[sl, 1] += e.brow_tilt * sgn * (t[sl, 0] - cx) / BROW_RX
    for sl in (EYE_L, EYE_R):
        t[sl, 1] = EYE_Y + (t[sl, 1] - EYE_Y) * e.eye_open
    my, rx, ry_out, rx_in, ry_in = _mouth_geometry(e)
    for sl, ry0, ry1 in (
        (MOUTH_OUT, MOUTH_RY_OUT, ry_out),
        (MOUTH_IN, MOUTH_RY_IN, ry_in),
    ):
        x = 0.5 + (t[sl, 0] - 0.5) * e.mouth_width
        y = my + (t[sl, 1] - MOUTH_Y) * (ry1 / ry0)
        y = y + e.mouth_curve * np.clip((x - 0.5) / rx, -1.2, 1.2) ** 2
        t[sl, 0], t[sl, 1] = x, y
    return t


def _shade(qx: np.ndarray, qy: np.ndarray, e: Expression, skin: float, bg: float):
    """Face shading evaluated in template space (callers pass the
    inverse-affine pixel grid)."""

    def ell(cx, cy, rx, ry):
        return ((qx - cx) / rx) ** 2 + ((qy - cy) / max(ry, 1e-4)) ** 2 <= 1.0

    img = np.full(qx.shape, bg)
    img[ell(0.5, 0.5, 0.30, 0.38)] = skin
    # brows: thin bands following raise + tilt
    for cx, sgn in ((0.37, 1.0), (0.63, -1.0)):
        by = BROW_Y - e.brow_raise + e.brow_tilt * sgn * (qx - cx) / BROW_RX
        img[((qx - cx) / BROW_RX) ** 2 + ((qy - by) / BROW_RY) ** 2 <= 1.0] = 0.30
    # eyes: aperture scales vertically
    for cx in (0.37, 0.63):
        img[ell(cx, EYE_Y, EYE_RX, EYE_RY * e.eye_open)] = 0.15
    img[ell(0.5, 0.60, 0.03, 0.06)] = skin * 0.8  # nose shadow
    if e.nose_wrinkle > 0.5:  # disgust: dark creases across the bridge
        for wy in (0.50, 0.54):
            img[(np.abs(qx - 0.5) < 0.055) & (np.abs(qy - wy) < 0.008)] = (
                skin * 0.45
            )
    my, rx, ry_out, rx_in, ry_in = _mouth_geometry(e)
    yq = qy - e.mouth_curve * np.clip((qx - 0.5) / rx, -1.2, 1.2) ** 2
    img[((qx - 0.5) / rx) ** 2 + ((yq - my) / ry_out) ** 2 <= 1.0] = 0.25
    img[((qx - 0.5) / rx_in) ** 2 + ((yq - my) / max(ry_in, 1e-4)) ** 2 <= 1.0] = 0.08
    return img


@dataclasses.dataclass
class ExpressionSample:
    frames: np.ndarray  # [B, S, S, 3] f32 in [0,1]
    landmarks: np.ndarray  # [B, L, 3] normalized coords
    labels: np.ndarray  # [B] int64, DeepFace class order
    present: np.ndarray  # [B] f32 (1.0 for every face here)


def render_expression_batch(
    rng: np.random.Generator,
    batch: int,
    size: int,
    template: Optional[np.ndarray] = None,
    landmark_count: int = 478,
    scale_range: Tuple[float, float] = (0.55, 0.95),
    p_negative: float = 0.0,
    jitter_scale: float = 1.0,
) -> ExpressionSample:
    """Expression-labeled procedural faces (full frames). ``p_negative`` adds
    face-less frames (label kept but present=0) for landmark-net reuse."""
    if template is None:
        template = make_template(landmark_count)
    L = template.shape[0]
    frames = np.empty((batch, size, size, 3), np.float32)
    lms = np.zeros((batch, L, 3), np.float32)
    labels = np.empty((batch,), np.int64)
    present = np.empty((batch,), np.float32)

    jj, ii = np.meshgrid(np.arange(size), np.arange(size))
    px = (jj + 0.5) / size
    py = (ii + 0.5) / size

    for b in range(batch):
        bg = rng.uniform(0.05, 0.45)
        noise = rng.normal(0.0, 0.03, (size, size))
        labels[b] = rng.integers(0, len(CLASS_NAMES))
        if rng.uniform() < p_negative:
            img = bg + noise
            if rng.uniform() < 0.5:
                cx, cy, r = rng.uniform(0.2, 0.8, 3)
                img += 0.3 * np.exp(
                    -(((px - cx) ** 2 + (py - cy) ** 2) / (0.02 * r + 1e-3))
                )
            frames[b] = np.clip(img, 0, 1)[..., None].repeat(3, -1)
            present[b] = 0.0
            continue

        e = sample_expression(rng, int(labels[b]), jitter_scale=jitter_scale)
        tmpl_e = deform_template(template, e)
        scale = rng.uniform(*scale_range)
        theta = rng.uniform(-0.4, 0.4)
        m = 0.45 * scale
        tx = rng.uniform(m, 1 - m)
        ty = rng.uniform(m, 1 - m)
        lms[b] = _transform(tmpl_e, scale, theta, tx, ty)
        present[b] = 1.0

        c, s = np.cos(-theta), np.sin(-theta)
        ux = (px - tx) / scale
        uy = (py - ty) / scale
        qx = c * ux - s * uy + 0.5
        qy = s * ux + c * uy + 0.5
        skin = rng.uniform(0.6, 0.85)
        img = np.clip(_shade(qx, qy, e, skin, bg) + noise, 0, 1)
        frames[b] = img[..., None].repeat(3, -1)
    return ExpressionSample(frames, lms, labels, present)


def render_crop_batch(
    rng: np.random.Generator,
    batch: int,
    frame_size: int = 96,
    crop_size: int = 48,
    template: Optional[np.ndarray] = None,
    jitter_scale: float = 1.0,
    device: "str | torch.device" = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Training crops for the emotion CNN, made as the serving graph makes
    them: render a frame, take the landmark box of the ground-truth
    landmarks, crop it bilinearly, grayscale. The three ops run on
    ``device``. Returns (crops [B, crop, crop, 1] f32, labels [B])."""
    from msa_tpu_torch.models.face import bilinear_crop_resize, rgb_to_gray
    from msa_tpu_torch.ops import face_features as FF

    s = render_expression_batch(
        rng, batch, frame_size, template=template, p_negative=0.0,
        jitter_scale=jitter_scale,
    )
    with torch.no_grad():
        gray = rgb_to_gray(torch.from_numpy(s.frames).to(device))
        boxes = FF.bbox(torch.from_numpy(s.landmarks).to(device), frame_size, frame_size)
        crops = bilinear_crop_resize(gray, boxes, crop_size)
    return crops.cpu().numpy().astype(np.float32), s.labels


def adversarial_crop_batch(
    rng: np.random.Generator,
    batch: int,
    frame_size: int = 96,
    crop_size: int = 48,
    template: Optional[np.ndarray] = None,
    jitter_scale: float = 2.0,
    occlude_frac: Tuple[float, float] = (0.06, 0.18),
    device: "str | torch.device" = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """OUT-OF-FAMILY eval crops for the emotion CNN (the in-family held-out
    accuracy saturates at 1.0, so it cannot catch a partial regression). Three perturbations the training
    distribution never contains:

    - expression parameters sampled at ``jitter_scale``× the training
      jitter sigma (attenuated/exaggerated expressions near class borders)
    - a random occluding rectangle covering ``occlude_frac`` of the crop
      area at a random gray level (hand/hair/sensor-dropout analog)
    - lighting shifts: per-crop gamma in [0.5, 1.9] plus a lateral
      illumination gradient up to ±35%

    Labels remain the generating class, so accuracy measures robustness of
    the decision, not reconstruction of clean pixels."""
    crops, labels = render_crop_batch(
        rng, batch, frame_size, crop_size, template, jitter_scale=jitter_scale, device=device
    )
    n = crops.shape[1]
    for b in range(batch):
        # occlusion rectangle
        frac = rng.uniform(*occlude_frac)
        w = max(2, int(n * np.sqrt(frac * rng.uniform(0.5, 2.0))))
        h = max(2, min(n, int(n * n * frac / w)))
        y0 = int(rng.integers(0, n - h + 1))
        x0 = int(rng.integers(0, n - w + 1))
        crops[b, y0 : y0 + h, x0 : x0 + w] = rng.uniform(0.0, 1.0)
        # lighting: gamma + lateral gradient
        gamma = rng.uniform(0.5, 1.9)
        grad = 1.0 + rng.uniform(-0.35, 0.35) * (
            np.linspace(-1, 1, n)[None, :, None]
            if rng.uniform() < 0.5
            else np.linspace(-1, 1, n)[:, None, None]
        )
        crops[b] = np.clip(np.clip(crops[b], 0, 1) ** gamma * grad, 0.0, 1.0)
    return crops, labels
