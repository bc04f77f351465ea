"""The batched segment graph (port of ``msa_tpu/pipeline/graph.py``: models,
inputs, the three modality branches, fusion, and the ``[B, 1715]``
hostpack of ``_forward_host``).

    frames[B,S,S,3] ─ landmark net ─ geometry ─ crop ─ emotion CNN ┐
    audio[B,80000] ── DSP stack ──── audio encoder ────────────────┤→ 27/31/783
    tokens[B,L] ───── BERT trunk ─── 4 heads + CLS + coherence ────┘     │
                                                          fusion MLP ← combo

PyTorch runs eagerly, so the JAX ``jit`` has no counterpart here; each
branch is batched tensor code where JAX ``vmap``-ed a per-segment function.
The encoders run the serving recipe, as in JAX: bf16 activations with W8A8
projections and FFN through the hand-written ``attention_block_int8`` and
``ffn_fused_int8`` CUDA kernels by default (``quantize="int8"``), or bf16
matmuls through ``attention_block`` and ``ffn_fused`` under
``quantize="none"`` / ``MSA_QUANTIZE=none``. The feature math and the fusion
MLP stay f32 with TF32 off.

Two entry points run the graph: :meth:`SegmentPipeline.run_host` on a
batch of :class:`SegmentInputs`, and :meth:`SegmentPipeline.run_stream` on
one streaming window packed by :func:`pack_stream_inputs` into a single
uint8 buffer.

Movement state: landmarks are shifted by one segment along the batch, with
an explicit carry for the first row, so B=1 streaming and B=n offline share
the graph.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from msa_tpu_torch import flax_init, weights
from msa_tpu_torch.checkpoints import flax_msgpack
from msa_tpu_torch.core import emotions
from msa_tpu_torch.core.config import SystemConfig
from msa_tpu_torch.models.audio import AudioEmotionModel, AudioModelConfig
from msa_tpu_torch.models.face import (
    FaceEmotionCNN,
    FaceLandmarkNet,
    FaceModelConfig,
    bilinear_crop_resize,
    rgb_to_gray,
)
from msa_tpu_torch.models.fusion import FusionMLP
from msa_tpu_torch.models.text import TextModel, TextModelConfig
from msa_tpu_torch.models.transformer import EncoderConfig
from msa_tpu_torch.ops import audio_features as AF
from msa_tpu_torch.ops import face_features as FF
from msa_tpu_torch.ops.normalization import normalize_audio, normalize_face, normalize_text

QUANTIZE_MODES = ("none", "int8")

# The shipped checkpoints are data files of the JAX package; they are read
# by path (config defaults are "checkpoints/<name>", relative to msa_tpu/).
_ASSET_ROOT = Path(__file__).resolve().parents[2] / "msa_tpu"


def resolve_asset(rel: str) -> Path:
    for cand in (Path(rel), _ASSET_ROOT / rel):
        if cand.exists():
            return cand
    raise FileNotFoundError(f"shipped asset {rel} not found (looked in . and {_ASSET_ROOT})")


logger = logging.getLogger(__name__)

_FUSION_DIMS = ("face_dim", "audio_dim", "text_dim", "hidden_dim", "output_dim")
# what a missing, unreadable or misfit checkpoint raises: the file
# (OSError), the msgpack/JSON reader and the loader's shape check
# (ValueError), a missing leaf or key (KeyError), a tree of the wrong kind
# (TypeError)
_LOAD_ERRORS = (OSError, KeyError, ValueError, TypeError)


def _read_fusion(rel: str):
    """The dims and param tree of a fusion checkpoint, checked by loading
    it into a CPU module of those dims. Raises on a missing, unreadable or
    misfit file."""
    path = resolve_asset(rel)
    payload = flax_msgpack.load(path)
    meta = json.loads(payload["meta_json"])
    dims = {k: meta[k] for k in _FUSION_DIMS}
    with torch.device("cpu"):
        weights.load_flax_tree(FusionMLP(**dims), payload["params"])
    return path, dims, payload["params"]


def _init_then_load(models: "PipelineModels", name: str, module: torch.nn.Module, seed: int, rel, shape_tree=None):
    """JAX's init of ``module`` from ``seed`` (:mod:`msa_tpu_torch.flax_init`),
    then the configured checkpoint ``rel`` on top. A checkpoint that is
    missing or does not fit logs a warning and leaves the init, as
    ``msa_tpu/pipeline/graph.py:161-271`` does; ``models.loaded`` records
    only what loaded."""
    flax_init.init_module_(module, seed)
    if rel is None:  # configured without a checkpoint
        return
    try:
        path = resolve_asset(rel)
        tree = flax_msgpack.load(path)
        weights.load_flax_tree(module, shape_tree(tree) if shape_tree else tree)
    except _LOAD_ERRORS as e:
        logger.warning("%s checkpoint %s does not fit this config (%s); keeping the init from seed %d", name, rel, e, seed)
        flax_init.init_module_(module, seed)  # a failed load may have written some leaves
        return
    models.loaded[name] = str(path)


@dataclasses.dataclass
class PipelineModels:
    """All modules of the pipeline, on one device, in eval mode."""

    landmark: FaceLandmarkNet
    face_cnn: FaceEmotionCNN
    audio: AudioEmotionModel
    text: TextModel
    fusion: FusionMLP
    device: torch.device
    # shipped checkpoints that were loaded: component → path
    loaded: Dict[str, str] = dataclasses.field(default_factory=dict)

    @staticmethod
    def serving_encoder(quantize: str = "int8") -> EncoderConfig:
        """The production encoder recipe: bf16 through the fused kernels,
        W8A8 under ``quantize="int8"``."""
        if quantize not in QUANTIZE_MODES:
            raise ValueError(f"quantize={quantize!r}: expected one of {QUANTIZE_MODES}")
        return EncoderConfig(
            compute_dtype="bfloat16", attention_impl="kernel", ffn_impl="kernel", quantize=quantize
        )

    @classmethod
    def _build(cls, face_cfg, audio_cfg, text_cfg, fusion_dims, device) -> "PipelineModels":
        device = torch.device(device)
        with torch.device(device):
            models = cls(
                landmark=FaceLandmarkNet(face_cfg),
                face_cnn=FaceEmotionCNN(face_cfg),
                audio=AudioEmotionModel(audio_cfg),
                text=TextModel(text_cfg),
                fusion=FusionMLP(**fusion_dims),
                device=device,
            )
        for m in models.modules():
            m.eval().requires_grad_(False)
        return models

    def modules(self):
        return (self.landmark, self.face_cnn, self.audio, self.text, self.fusion)

    def with_encoders(self, **changes) -> "PipelineModels":
        """A copy whose text and audio encoders run
        ``dataclasses.replace(encoder_cfg, **changes)`` — e.g. the plain
        ``attention_impl="einsum", ffn_impl="dense"`` path, or another
        ``quantize``. It shares every parameter with this one (the encoders'
        f32 masters included) and derives its encoders' int8 or
        compute-dtype weights from those masters; if ``compute_dtype``
        changes, it holds a copy of the parameters cast to the new dtype."""

        def swap(model):
            cfg = dataclasses.replace(model.cfg, encoder=dataclasses.replace(model.cfg.encoder, **changes))
            share = cfg.encoder.compute_dtype == model.cfg.encoder.compute_dtype
            with torch.device("meta" if share else self.device):
                new = type(model)(cfg)
            new.load_state_dict(model.state_dict(), assign=share)
            weights.derive_weights_(new)
            return new.eval().requires_grad_(False)

        return dataclasses.replace(self, audio=swap(self.audio), text=swap(self.text))

    @classmethod
    def initialize(
        cls,
        seed: int = 0,
        face_cfg: Optional[FaceModelConfig] = None,
        audio_cfg: Optional[AudioModelConfig] = None,
        text_cfg: Optional[TextModelConfig] = None,
        fusion: Optional[Mapping[str, int]] = None,
        fusion_checkpoint: Optional[str] = None,
        quantize: Optional[str] = None,
        device: "str | torch.device" = "cuda",
    ) -> "PipelineModels":
        """The JAX package's ``PipelineModels.initialize``
        (``msa_tpu/pipeline/graph.py:75-285``), on ``device``.

        Every module starts from JAX's flax init, rebuilt without JAX
        (:mod:`msa_tpu_torch.flax_init`), with JAX's seeds: the fusion MLP
        and the landmark net ``seed``, the face CNN ``seed+1``, the audio
        trunk ``seed+2`` and the text trunk ``seed+3``. The shipped
        checkpoints load on top: the landmark net, the face CNN, the audio
        pool and head and the text heads (trained over those very trunks).
        A configured checkpoint that is missing or does not fit logs a
        warning and leaves the init; one configured as ``None`` is not
        looked for. ``models.loaded`` names every checkpoint that loaded.

        The fusion MLP: ``fusion`` (its dims, as ``FusionMLP``'s keyword
        arguments) builds one from the init alone; otherwise
        ``fusion_checkpoint`` is tried, then the shipped
        ``checkpoints/fusion.msgpack``, then the default dims from the init.

        ``quantize`` resolves as in JAX (``msa_tpu/pipeline/graph.py:114-117``):
        the argument, then ``MSA_QUANTIZE``, then ``"int8"`` (W8A8 through
        the int8 kernels); ``"none"`` is the bf16 recipe. The JAX package's
        f32 parity mode for imported trunks is not ported (the kernels take
        bf16 only)."""
        quantize = quantize or os.environ.get("MSA_QUANTIZE") or "int8"
        enc = cls.serving_encoder(quantize)
        face_cfg = face_cfg or FaceModelConfig()
        audio_cfg = audio_cfg or AudioModelConfig(encoder=enc)
        text_cfg = text_cfg or TextModelConfig(encoder=enc)

        fusion_ckpt = None
        if fusion is None:
            for rel in (fusion_checkpoint, "checkpoints/fusion.msgpack"):
                if not rel:
                    continue
                try:
                    fusion_ckpt = _read_fusion(rel)
                    break
                except _LOAD_ERRORS as e:
                    logger.warning("fusion checkpoint %s failed to load (%s); trying next", rel, e)
        fusion_dims = fusion_ckpt[1] if fusion_ckpt else dict(fusion or {})
        models = cls._build(face_cfg, audio_cfg, text_cfg, fusion_dims, device)
        if fusion_ckpt:
            weights.load_flax_tree(models.fusion, fusion_ckpt[2])
            models.loaded["fusion"] = str(fusion_ckpt[0])
        else:
            flax_init.init_module_(models.fusion, seed)

        def audio_head(tree):
            return tree if "pool" in tree else {"emotion_head": tree}  # bare linear head format

        _init_then_load(models, "landmark", models.landmark, seed, face_cfg.landmark_weights)
        _init_then_load(models, "face_cnn", models.face_cnn, seed + 1, face_cfg.emotion_weights)
        _init_then_load(models, "audio_head", models.audio, seed + 2, audio_cfg.head_weights, audio_head)
        _init_then_load(models, "text_heads", models.text, seed + 3, text_cfg.head_weights)
        return models

    @classmethod
    def tiny(cls, seed: int = 0, device: "str | torch.device" = "cuda") -> "PipelineModels":
        """Test-scale models, the same graph (``msa_tpu/pipeline/graph.py:287``):
        the tiny face, audio and text configs and a 64-wide fusion MLP, all
        from the init alone. Their encoders are the plain f32 path, so no
        kernel runs."""
        return cls.initialize(
            seed,
            face_cfg=FaceModelConfig.tiny(),
            audio_cfg=AudioModelConfig.tiny(),
            text_cfg=TextModelConfig.tiny(),
            fusion={"hidden_dim": 64},
            device=device,
        )

    @classmethod
    def from_flax(
        cls,
        params: Mapping[str, Any],
        face_cfg: FaceModelConfig,
        audio_cfg: AudioModelConfig,
        text_cfg: TextModelConfig,
        fusion_dims: Optional[Mapping[str, int]] = None,
        device: "str | torch.device" = "cuda",
    ) -> "PipelineModels":
        """Models carrying a JAX ``PipelineModels.params_tree()`` (numpy
        leaves): the JAX trunks themselves, moved across in memory."""
        models = cls._build(face_cfg, audio_cfg, text_cfg, dict(fusion_dims or {}), device)
        for name, module in (
            ("landmark", models.landmark),
            ("face_cnn", models.face_cnn),
            ("audio", models.audio),
            ("text", models.text),
            ("fusion", models.fusion),
        ):
            weights.load_flax_tree(module, params[name])
        return models


@dataclasses.dataclass
class SegmentInputs:
    """One batch of segments (numpy arrays or tensors)."""

    frames: Any  # [B, S, S, 3] uint8 RGB (or f32 in [0, 1])
    audio: Any  # [B, T] f32 waveform (or int16 PCM)
    token_ids: Any  # [B, L] int
    token_mask: Any  # [B, L] int
    face_avail: Any  # [B] bool
    audio_avail: Any  # [B] bool
    text_avail: Any  # [B] bool (empty transcript → False)
    completeness: Any  # [B] f32 host text heuristic
    relevance: Any  # [B] f32 host text heuristic
    prev_landmarks: Any  # [478, 3] carry for the first row
    has_prev: Any  # [] bool carry

    @staticmethod
    def zeros(models: PipelineModels, batch: int, samples: int = 80_000, tokens: int = 512) -> "SegmentInputs":
        s = models.landmark.cfg.frame_size
        lc = models.landmark.cfg.landmark_count
        return SegmentInputs(
            frames=np.zeros((batch, s, s, 3), np.uint8),
            audio=np.zeros((batch, samples), np.float32),
            token_ids=np.zeros((batch, tokens), np.int32),
            token_mask=np.zeros((batch, tokens), np.int32),
            face_avail=np.ones((batch,), bool),
            audio_avail=np.ones((batch,), bool),
            text_avail=np.ones((batch,), bool),
            completeness=np.zeros((batch,), np.float32),
            relevance=np.zeros((batch,), np.float32),
            prev_landmarks=np.zeros((lc, 3), np.float32),
            has_prev=np.asarray(False),
        )

    def to(self, device: torch.device) -> "SegmentInputs":
        """Every field as a tensor on ``device`` (numpy arrays are copied)."""

        def tensor(v):
            return v.to(device) if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v), device=device)

        return SegmentInputs(**{f.name: tensor(getattr(self, f.name)) for f in dataclasses.fields(self)})


_BATCH_FIELDS = (
    "frames",
    "audio",
    "token_ids",
    "token_mask",
    "face_avail",
    "audio_avail",
    "text_avail",
    "completeness",
    "relevance",
)


def pad_segment_inputs(inp: SegmentInputs, multiple: int, to: int = 0) -> Tuple[SegmentInputs, int]:
    """Pad the batch axis to a multiple of ``multiple`` (or to ``to``).
    Padded rows have every modality unavailable. → (padded, real_count)."""
    real = inp.frames.shape[0]
    padded = ((max(real, to) + multiple - 1) // multiple) * multiple
    if padded == real:
        return inp, real
    kwargs = {}
    for f in _BATCH_FIELDS:
        x = np.asarray(getattr(inp, f))
        kwargs[f] = x if x.shape[0] == padded else np.pad(x, [(0, padded - real)] + [(0, 0)] * (x.ndim - 1))
    return dataclasses.replace(inp, **kwargs), real


# --- hostpack ---------------------------------------------------------------
# Every column a host consumer reads, in one [B, 1715] f32 row per segment;
# the column order is the JAX package's, exactly.
_PACK_FIELDS = (
    ("fused", 7),
    ("face27", 27),  # nan_to_num'd
    ("audio31", 31),
    ("text783", 783),
    ("face_probs_raw", 7),  # canonical-order true probabilities
    ("audio_probs_raw", 7),
    ("text_probs_raw", 7),
    ("combo", 1),  # modality bitmask as f32
    ("s_face27", 27),  # pre-nan branch outputs
    ("s_face_quality", 4),
    ("s_audio31", 31),
    ("s_text783", 783),
)
PACK_WIDTH = sum(d for _, d in _PACK_FIELDS)
PACK_SLICES: Dict[str, slice] = {}
_off = 0
for _name, _d in _PACK_FIELDS:
    PACK_SLICES[_name] = slice(_off, _off + _d)
    _off += _d


def unpack_hostpack(pack) -> Dict[str, Any]:
    """[B, 1715] → named column views."""
    return {name: pack[:, sl] for name, sl in PACK_SLICES.items()}


def pack_stream_inputs(
    frames_u8: np.ndarray,
    audio_i16: np.ndarray,
    token_ids: np.ndarray,
    token_mask: np.ndarray,
    face_avail: bool,
    audio_avail: bool,
    text_avail: bool,
    completeness: float,
    relevance: float,
) -> np.ndarray:
    """One uint8 host buffer for a B=1 streaming window, the inverse of
    :meth:`SegmentPipeline.run_stream`'s unpacking (the JAX package's byte
    layout, ``msa_tpu/pipeline/graph.py:392-420``): frames u8 [S, S, 3] |
    audio i16 [samples] | ids i32 [L] | mask i32 [L] | f32 scalars
    (face_avail, audio_avail, text_avail, completeness, relevance)."""
    scalars = np.asarray([face_avail, audio_avail, text_avail, completeness, relevance], np.float32)
    return np.concatenate(
        [
            np.ascontiguousarray(frames_u8, np.uint8).reshape(-1),
            np.ascontiguousarray(audio_i16, np.int16).view(np.uint8).reshape(-1),
            np.ascontiguousarray(token_ids, np.int32).view(np.uint8).reshape(-1),
            np.ascontiguousarray(token_mask, np.int32).view(np.uint8).reshape(-1),
            scalars.view(np.uint8),
        ]
    )


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for the f32 convolutions, matmuls and feature math (cuDNN
    convolutions default to TF32, which keeps ~3 digits)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _blend(x: torch.Tensor, default: torch.Tensor, avail: torch.Tensor) -> torch.Tensor:
    return x * avail + default[None] * (1 - avail)


class SegmentPipeline:
    """Owns the models and runs the graph on their device."""

    def __init__(
        self,
        models: PipelineModels,
        config: Optional[SystemConfig] = None,
        original_frame_hw: Tuple[int, int] = (480, 640),
    ):
        self.models = models
        self.config = config or SystemConfig()
        self.original_frame_hw = original_frame_hw

    # --- modality branches -------------------------------------------------

    def _face_branch(self, frames, face_avail, prev_landmarks, has_prev):
        m = self.models
        s = m.landmark.cfg.frame_size
        oh, ow = self.original_frame_hw
        if frames.dtype == torch.uint8:
            frames = frames.float() / 255.0
        lout = m.landmark(frames)
        landmarks, presence = lout["landmarks"], lout["presence"]
        detected = (presence >= m.landmark.cfg.min_detection_confidence) & face_avail

        # previous-frame landmarks: explicit carry + shift along the batch
        prev = torch.cat([prev_landmarks[None].float(), landmarks[:-1]], dim=0)
        prev_ok = torch.cat([has_prev.reshape(1), detected[:-1]], dim=0)
        geometry, position, quality = FF.face_feature_stack(landmarks, prev, detected, prev_ok, oh, ow)

        crop_bbox = FF.bbox(landmarks, s, s) * detected[:, None].float()
        crops = bilinear_crop_resize(rgb_to_gray(frames), crop_bbox, m.face_cnn.cfg.crop_size)
        emo_deepface = m.face_cnn(crops)

        normed = normalize_face(torch.cat([emo_deepface, geometry], dim=-1))  # [B, 27]
        face27 = torch.cat([normed[:, :23], position], dim=-1)
        default27 = torch.cat([torch.full((7,), 1.0 / 7.0), torch.zeros(20)]).to(frames.device)
        avail = face_avail[:, None].float()
        face27 = _blend(face27, default27, avail)
        quality = quality * avail
        probs_raw = emotions.reorder(emo_deepface, emotions.DEEPFACE_TO_CANONICAL)
        probs_raw = probs_raw * avail + (1.0 / 7.0) * (1 - avail)
        return {
            "face27": face27,
            "emotion_probs_raw": probs_raw,
            "face_quality": quality,
            "landmarks": landmarks,
            "detected": detected,
        }

    def _audio_branch(self, audio, audio_avail):
        m = self.models
        cfg = self.config.audio
        if audio.dtype == torch.int16:
            audio = audio.float() / 32768.0
        audio_out = m.audio(audio)
        dsp, quality = AF.audio_feature_stack(audio, cfg.sample_rate, cfg.pitch_mode)
        normed = normalize_audio(torch.cat([audio_out["emotion_probs"], dsp], dim=-1))  # [B, 31]
        audio31 = torch.cat([normed[:, :27], quality], dim=-1)
        default31 = torch.cat([torch.full((8,), 1.0 / 8.0), torch.zeros(23)]).to(audio.device)
        avail = audio_avail[:, None].float()
        probs_raw = emotions.iemocap4_to_canonical7(audio_out["probs4"])
        return {
            "audio31": _blend(audio31, default31, avail),
            "emotion_probs_raw": probs_raw * avail + (1.0 / 7.0) * (1 - avail),
        }

    def _text_branch(self, token_ids, token_mask, text_avail, completeness, relevance):
        tout = self.models.text(token_ids.long(), token_mask)
        coherence = tout["coherence"]
        quality = torch.stack(
            [0.4 * coherence + 0.3 * completeness + 0.3 * relevance, coherence, completeness, relevance],
            dim=-1,
        )
        raw = torch.cat(
            [
                tout["emotion_probs"],
                tout["sarcasm_score"],
                tout["humor_score"],
                tout["polarity"],
                tout["intensity"],
                tout["context_embedding"],
            ],
            dim=-1,
        )  # [B, 779]
        text783 = torch.cat([normalize_text(raw)[:, :779], quality], dim=-1)
        default783 = torch.cat([torch.full((7,), 1.0 / 7.0), torch.zeros(776)]).to(raw.device)
        avail = text_avail[:, None].float()
        return {
            "text783": _blend(text783, default783, avail),
            "emotion_probs_raw": tout["emotion_probs"] * avail + (1.0 / 7.0) * (1 - avail),
        }

    # --- full graph ---------------------------------------------------------

    def _forward(self, inp: SegmentInputs):
        face = self._face_branch(inp.frames, inp.face_avail.bool(), inp.prev_landmarks, inp.has_prev.bool())
        audio = self._audio_branch(inp.audio, inp.audio_avail.bool())
        text = self._text_branch(
            inp.token_ids, inp.token_mask, inp.text_avail.bool(), inp.completeness.float(), inp.relevance.float()
        )
        f27 = torch.nan_to_num(face["face27"])
        a31 = torch.nan_to_num(audio["audio31"])
        t783 = torch.nan_to_num(text["text783"])
        combo = inp.face_avail.long() * 4 + inp.audio_avail.long() * 2 + inp.text_avail.long()
        fused = self.models.fusion.fuse_combo(f27, a31, t783, combo)
        hostpack = torch.cat(
            [
                fused,
                f27,
                a31,
                t783,
                face["emotion_probs_raw"],
                audio["emotion_probs_raw"],
                text["emotion_probs_raw"],
                combo[:, None].float(),
                face["face27"],
                face["face_quality"].float(),
                audio["audio31"],
                text["text783"],
            ],
            dim=-1,
        )
        new_carry = (face["landmarks"][-1], face["detected"][-1])
        out = {
            "face": face,
            "audio": audio,
            "text": text,
            "face27": f27,
            "audio31": a31,
            "text783": t783,
            "combo": combo,
            "fused": fused,
            "hostpack": hostpack,
        }
        return out, new_carry

    def run(self, inputs: SegmentInputs):
        """The whole graph. → (outputs, (last_landmarks, last_detected))."""
        with torch.inference_mode(), exact_fp32():
            return self._forward(inputs.to(self.models.device))

    def run_host(self, inputs: SegmentInputs):
        """The serving graph: only what a host consumer reads — ``hostpack``
        and the landmark/detected rows — plus the carry."""
        out, carry = self.run(inputs)
        slim = {
            "hostpack": out["hostpack"],
            "landmarks": out["face"]["landmarks"],
            "detected": out["face"]["detected"],
        }
        return slim, carry

    def run_stream(self, packed, prev_landmarks, has_prev):
        """One packed streaming window (see :func:`pack_stream_inputs`) through
        the :meth:`run_host` graph at B=1. The buffer is copied to the
        device once and its regions are bit-cast back there; the token
        bucket is inferred from its length. ``prev_landmarks`` [478, 3] and
        ``has_prev`` are the carry (the previous window's, or zeros and
        False), and may stay on the device between windows."""
        s = self.models.landmark.cfg.frame_size
        n_frames = s * s * 3
        samples = self.config.pipeline.segment_samples
        n_audio = 2 * samples
        buf = torch.as_tensor(packed).to(self.models.device)
        if buf.dtype != torch.uint8 or buf.dim() != 1:
            raise TypeError(f"packed window: expected a 1-D uint8 buffer, got {buf.dtype} {tuple(buf.shape)}")
        n_tokens = (buf.shape[0] - n_frames - n_audio - 20) // 8
        if n_tokens <= 0 or n_frames + n_audio + 8 * n_tokens + 20 != buf.shape[0]:
            raise ValueError(f"packed window of {buf.shape[0]} bytes does not fit {s}² frames and {samples} samples")

        def region(start: int, stop: int, dtype: torch.dtype) -> torch.Tensor:
            r = buf[start:stop]
            if start % dtype.itemsize:  # view(dtype) needs an aligned offset
                r = r.clone()
            return r.view(dtype)

        off = n_frames + n_audio
        sc = region(off + 8 * n_tokens, buf.shape[0], torch.float32)
        inp = SegmentInputs(
            frames=buf[:n_frames].reshape(1, s, s, 3),
            audio=region(n_frames, off, torch.int16).reshape(1, samples),
            token_ids=region(off, off + 4 * n_tokens, torch.int32).reshape(1, n_tokens),
            token_mask=region(off + 4 * n_tokens, off + 8 * n_tokens, torch.int32).reshape(1, n_tokens),
            face_avail=sc[0:1] > 0.5,
            audio_avail=sc[1:2] > 0.5,
            text_avail=sc[2:3] > 0.5,
            completeness=sc[3:4],
            relevance=sc[4:5],
            prev_landmarks=prev_landmarks,
            has_prev=has_prev,
        )
        return self.run_host(inp)
