"""Whole-pipeline checkpointing (port of ``msa_tpu/pipeline/checkpoint.py``).

One msgpack file of ``{"meta_json": ..., "params": {...}}``, as JAX writes
it (:func:`msa_tpu_torch.checkpoints.flax_msgpack.dump`): the meta holds the
face, audio and text configs (``dataclasses.asdict``), the fusion MLP's
fields and the tokenizer's vocabulary size; the params are
:meth:`PipelineModels.params_tree`. A file either package writes loads in
the other. The meta is JAX's schema: the encoders' kernel paths are named
``"pallas"`` in the file (the port's ``"kernel"``) and their fields come in
JAX's order.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path

import torch

from msa_tpu_torch.checkpoints import flax_msgpack
from msa_tpu_torch.models.audio import AudioModelConfig
from msa_tpu_torch.models.face import FaceModelConfig
from msa_tpu_torch.models.text import TextModelConfig
from msa_tpu_torch.models.transformer import EncoderConfig
from msa_tpu_torch.pipeline.graph import PipelineModels, _load_whole

logger = logging.getLogger(__name__)

# JAX's EncoderConfig fields in its order (msa_tpu/models/transformer.py)
_ENCODER_FIELDS = (
    "num_layers", "d_model", "num_heads", "d_ff", "dropout", "layer_norm_eps",
    "compute_dtype", "attention_impl", "ffn_impl", "remat", "quantize",
)
_IMPL_NAMES = {"kernel": "pallas"}  # the port's name → JAX's, for both impl fields


def _encoder_meta(enc: EncoderConfig) -> dict:
    d = dataclasses.asdict(enc)
    for k in ("attention_impl", "ffn_impl"):
        d[k] = _IMPL_NAMES.get(d[k], d[k])
    return {k: d[k] for k in _ENCODER_FIELDS}


def _encoder_cfg(d: dict) -> EncoderConfig:
    back = {v: k for k, v in _IMPL_NAMES.items()}
    return EncoderConfig(**{k: back.get(v, v) if k in ("attention_impl", "ffn_impl") else v for k, v in d.items()})


def _with_encoder(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["encoder"] = _encoder_meta(cfg.encoder)
    return d


def save_pipeline(path: str, models: PipelineModels) -> None:
    """Write ``models`` (every parameter and the configs that rebuild it)
    to ``path``, creating its directory."""
    meta = {
        "face": dataclasses.asdict(models.landmark.cfg),
        "audio": _with_encoder(models.audio.cfg),
        "text": _with_encoder(models.text.cfg),
        "fusion": models.fusion.dims(),
        "tokenizer_vocab_size": models.tokenizer.vocab_size,
    }
    flax_msgpack.dump(path, {"meta_json": json.dumps(meta), "params": models.params_tree()})
    logger.info("saved pipeline checkpoint to %s", path)


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def load_pipeline(
    path: str, seed: int = 0, create_if_missing: bool = True, device: "str | torch.device" = "cuda"
) -> PipelineModels:
    """Rebuild :class:`PipelineModels` on ``device`` from a checkpoint;
    every leaf of the file is loaded (a missing one raises ``KeyError``),
    and each encoder layer's int8 or compute-dtype copies are derived from
    the loaded masters. Where the file is missing, ``initialize(seed)`` is
    saved there and returned, as JAX's create-if-missing does."""
    p = Path(path)
    if not p.exists():
        if not create_if_missing:
            raise FileNotFoundError(path)
        logger.warning("pipeline checkpoint not found at %s — creating", path)
        models = PipelineModels.initialize(seed=seed, device=device)
        save_pipeline(path, models)
        return models

    payload = flax_msgpack.load(p)
    meta = json.loads(payload["meta_json"])
    face_cfg = FaceModelConfig(**_tuples(meta["face"]))
    audio_meta, text_meta = dict(meta["audio"]), dict(meta["text"])
    audio_enc, text_enc = _encoder_cfg(audio_meta.pop("encoder")), _encoder_cfg(text_meta.pop("encoder"))
    audio_cfg = AudioModelConfig(**_tuples(audio_meta), encoder=audio_enc)
    text_cfg = TextModelConfig(**text_meta, encoder=text_enc)
    models = PipelineModels._build(face_cfg, audio_cfg, text_cfg, meta["fusion"], device)
    for name, module in zip(("landmark", "face_cnn", "audio", "text", "fusion"), models.modules()):
        _load_whole(name, module, payload["params"][name])
    models.loaded["pipeline"] = str(p)
    return models
