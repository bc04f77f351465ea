"""Synthetic-supervision training for FaceLandmarkNet (port of
``msa_tpu/training/train_landmarks.py``).

- :func:`make_template`: the deterministic 478-point face template laid
  out like a face mesh (oval, brows, eyes, nose, mouth, cheek fill);
- :func:`render_batch`: procedural faces drawn from an affine-transformed
  template (scale, rotation, translation, noise) and face-less negatives,
  shaded in template space through the inverse affine so pixels and
  landmark targets agree exactly;
- :func:`make_train_step`: masked L2 on the landmark positions (z weighted
  0.25) plus 0.5 × the presence BCE (probabilities clipped at 1e-6), Adam.

The renderers are numpy, byte-equal to JAX's from the same generator. The
step runs on the model's device, f32 with TF32 off; the model carries its
params (JAX's ``params`` / ``opt_state`` arguments), and :func:`train`
returns them as a flax tree. CLI: ``python -m
msa_tpu_torch.training.train_landmarks --steps 2000`` writes
``checkpoints/landmark_net.msgpack`` (flax's bytes).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from msa_tpu_torch import flax_init, weights
from msa_tpu_torch.precision import exact_fp32

logger = logging.getLogger(__name__)


# --- template -----------------------------------------------------------------


def make_template(count: int = 478) -> np.ndarray:
    """Deterministic [count, 3] face template in normalized coords
    (x, y ∈ [0, 1] around center 0.5; z small, nose forward)."""
    pts = []

    def ring(cx, cy, rx, ry, n, z=0.0, a0=0.0, a1=2 * np.pi):
        t = np.linspace(a0, a1, n, endpoint=False)
        for a in t:
            pts.append((cx + rx * np.cos(a), cy + ry * np.sin(a), z))

    # face oval
    ring(0.5, 0.5, 0.30, 0.38, 72, z=-0.02)
    # brows (arcs above the eyes)
    ring(0.37, 0.38, 0.09, 0.03, 16, z=0.01, a0=np.pi, a1=2 * np.pi)
    ring(0.63, 0.38, 0.09, 0.03, 16, z=0.01, a0=np.pi, a1=2 * np.pi)
    # eyes (two rings each)
    for cx in (0.37, 0.63):
        ring(cx, 0.45, 0.055, 0.028, 16, z=0.0)
        ring(cx, 0.45, 0.028, 0.014, 8, z=0.0)
    # nose: bridge line + nostril arc
    for y in np.linspace(0.45, 0.62, 8):
        pts.append((0.5, y, 0.05))
    ring(0.5, 0.64, 0.045, 0.02, 10, z=0.03)
    # mouth (outer + inner)
    ring(0.5, 0.72, 0.11, 0.045, 24, z=0.01)
    ring(0.5, 0.72, 0.07, 0.025, 16, z=0.01)
    # cheek / forehead fill: concentric interior rings
    k = 0
    while len(pts) < count:
        rr = 0.08 + 0.03 * (k % 8)
        ring(0.5, 0.5, rr, rr * 1.2, 12, z=-0.005 * (k % 4))
        k += 1
    return np.asarray(pts[:count], np.float32)


# --- renderer -----------------------------------------------------------------


@dataclasses.dataclass
class FaceSample:
    frames: np.ndarray  # [B, S, S, 3] f32 in [0,1]
    landmarks: np.ndarray  # [B, L, 3]
    present: np.ndarray  # [B] f32 {0,1}


def _transform(tmpl: np.ndarray, scale, theta, tx, ty) -> np.ndarray:
    """Affine map of the template: rotate+scale around (0.5, 0.5), translate."""
    c, s = np.cos(theta), np.sin(theta)
    xy = tmpl[:, :2] - 0.5
    x = scale * (c * xy[:, 0] - s * xy[:, 1]) + tx
    y = scale * (s * xy[:, 0] + c * xy[:, 1]) + ty
    z = tmpl[:, 2] * scale
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def render_batch(
    rng: np.random.Generator,
    batch: int,
    size: int,
    template: np.ndarray,
    p_negative: float = 0.15,
) -> FaceSample:
    """Procedural faces: shading is evaluated in TEMPLATE space via the
    inverse affine, so pixels and landmark targets are exactly consistent."""
    L = template.shape[0]
    frames = np.empty((batch, size, size, 3), np.float32)
    lms = np.empty((batch, L, 3), np.float32)
    present = np.empty((batch,), np.float32)

    jj, ii = np.meshgrid(np.arange(size), np.arange(size))
    px = (jj + 0.5) / size  # x right
    py = (ii + 0.5) / size  # y down

    for b in range(batch):
        bg = rng.uniform(0.05, 0.45)
        noise = rng.normal(0.0, 0.03, (size, size))
        if rng.uniform() < p_negative:
            img = bg + noise
            # distractor blob so "presence" can't key on any non-uniformity
            if rng.uniform() < 0.5:
                cx, cy, r = rng.uniform(0.2, 0.8, 3)
                img += 0.3 * np.exp(-(((px - cx) ** 2 + (py - cy) ** 2) / (0.02 * r + 1e-3)))
            frames[b] = np.clip(img, 0, 1)[..., None].repeat(3, -1)
            lms[b] = 0.0
            present[b] = 0.0
            continue

        scale = rng.uniform(0.55, 0.95)
        theta = rng.uniform(-0.4, 0.4)
        m = 0.45 * scale  # keep the oval inside the frame
        tx = rng.uniform(m, 1 - m)
        ty = rng.uniform(m, 1 - m)
        lms[b] = _transform(template, scale, theta, tx, ty)
        present[b] = 1.0

        # inverse affine of the pixel grid into template space
        c, s = np.cos(-theta), np.sin(-theta)
        ux = (px - tx) / scale
        uy = (py - ty) / scale
        qx = c * ux - s * uy + 0.5
        qy = s * ux + c * uy + 0.5

        def ell(cx, cy, rx, ry):
            return ((qx - cx) / rx) ** 2 + ((qy - cy) / ry) ** 2 <= 1.0

        skin = rng.uniform(0.6, 0.85)
        img = np.full((size, size), bg)
        img[ell(0.5, 0.5, 0.30, 0.38)] = skin
        img[ell(0.37, 0.38, 0.09, 0.018)] = 0.30  # brows
        img[ell(0.63, 0.38, 0.09, 0.018)] = 0.30
        img[ell(0.37, 0.45, 0.055, 0.028)] = 0.15  # eyes
        img[ell(0.63, 0.45, 0.055, 0.028)] = 0.15
        img[ell(0.5, 0.60, 0.03, 0.06)] = skin * 0.8  # nose shadow
        img[ell(0.5, 0.72, 0.11, 0.045)] = 0.25  # mouth
        img = np.clip(img + noise, 0, 1)
        frames[b] = img[..., None].repeat(3, -1)
    return FaceSample(frames, lms, present)


# --- training ---------------------------------------------------------------


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> Callable[..., Tuple]:
    """``step(frames, targets, present) → (loss, (lm_loss, bce))``: one
    optimizer step of ``model`` in place (arrays or tensors; moved to the
    model's device)."""
    dev = weights.device_of(model)
    xyz = torch.tensor([1.0, 1.0, 0.25], device=dev)

    def step(frames, targets, present):
        frames, targets, present = (torch.as_tensor(a).to(dev) for a in (frames, targets, present))
        with exact_fp32():
            optimizer.zero_grad(set_to_none=True)
            out = model(frames)
            mask = present[:, None, None]
            # masked L2 on positions, xy over z as in integral regression
            err = (out["landmarks"] - targets) ** 2 * xyz
            lm_loss = (err * mask).sum() / (torch.clamp(mask.sum(), min=1.0) * 3)
            p = torch.clamp(out["presence"], 1e-6, 1 - 1e-6)
            bce = -(present * torch.log(p) + (1 - present) * torch.log(1 - p)).mean()
            loss = lm_loss + 0.5 * bce
            loss.backward()
            optimizer.step()
        return loss.detach(), (lm_loss.detach(), bce.detach())

    return step


def train(
    cfg=None,
    steps: int = 600,
    batch: int = 32,
    lr: float = 3e-3,
    seed: int = 0,
    params: "Mapping[str, Any] | None" = None,
    log_every: int = 100,
    expressions: bool = False,
    device: "str | torch.device" = "cuda",
) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """Train FaceLandmarkNet on procedural faces on ``device``, from
    ``params`` (a flax tree) or JAX's init of ``seed``.
    ``expressions=True`` renders every other batch with
    :func:`msa_tpu_torch.training.face_synth.render_expression_batch`, so
    the targets track brow, eye and mouth movement too. → (the trained
    flax tree, metrics)."""
    from msa_tpu_torch.models.face import FaceLandmarkNet, FaceModelConfig
    from msa_tpu_torch.training.encoders import adam

    cfg = cfg or FaceModelConfig()
    with torch.device(device):
        model = FaceLandmarkNet(cfg)
    if params is None:
        flax_init.init_module_(model, seed)
    else:
        weights.load_flax_tree(model, params)
    model.train().requires_grad_(True)
    step = make_train_step(model, adam(model.parameters(), lr))

    rng = np.random.default_rng(seed)
    template = make_template(cfg.landmark_count)
    loss = float("nan")
    for i in range(steps):
        if expressions and i % 2 == 1:
            from msa_tpu_torch.training import face_synth

            es = face_synth.render_expression_batch(rng, batch, cfg.frame_size, template=template, p_negative=0.25)
            s = FaceSample(es.frames, es.landmarks, es.present)
        else:
            s = render_batch(rng, batch, cfg.frame_size, template, p_negative=0.25)
        loss, (lm, bce) = step(s.frames, s.landmarks, s.present)
        if log_every and (i + 1) % log_every == 0:
            logger.info("step %d: loss=%.5f lm=%.5f bce=%.5f", i + 1, float(loss), float(lm), float(bce))
    model.eval().requires_grad_(False)
    metrics = evaluate(model, None, template, seed=seed + 1)
    metrics["final_loss"] = float(loss)
    return weights.flax_tree(model), metrics


@torch.no_grad()
def evaluate(model, params, template, n: int = 64, seed: int = 1) -> Dict[str, float]:
    """Held-out landmark error (mean euclidean xy distance, normalized
    coords) against the mean-predictor baseline, and the presence
    separation. ``params`` (a flax tree) is loaded into ``model`` first;
    None keeps its weights."""
    if params is not None:
        weights.load_flax_tree(model, params)
    rng = np.random.default_rng(seed)
    s = render_batch(rng, n, model.cfg.frame_size, template, p_negative=0.25)
    with exact_fp32():
        out = model(torch.from_numpy(s.frames).to(weights.device_of(model)))
    out = {k: v.cpu().numpy() for k, v in out.items()}
    pos = s.present > 0.5
    pred = out["landmarks"][pos][..., :2]
    tgt = s.landmarks[pos][..., :2]
    err = float(np.mean(np.linalg.norm(pred - tgt, axis=-1)))
    mean_pred = tgt.mean(axis=0, keepdims=True)
    baseline = float(np.mean(np.linalg.norm(mean_pred - tgt, axis=-1)))
    return {
        "landmark_err": err,
        "mean_predictor_err": baseline,
        "presence_pos": float(out["presence"][pos].mean()),
        "presence_neg": float(out["presence"][~pos].mean()) if (~pos).any() else 0.0,
    }


def main(argv=None):
    """JAX's CLI, plus ``--device``."""
    import argparse

    from msa_tpu_torch.checkpoints import flax_msgpack

    parser = argparse.ArgumentParser(description="Treina o detector de landmarks")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument("--expressions", action="store_true")
    parser.add_argument("--out", default="checkpoints/landmark_net.msgpack")
    parser.add_argument("--device", default="cuda", help="torch device to train on")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    params, metrics = train(
        steps=args.steps, batch=args.batch, lr=args.lr, expressions=args.expressions, device=args.device
    )
    logger.info("eval: %s", metrics)
    flax_msgpack.dump(args.out, params)
    logger.info("wrote %s", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
