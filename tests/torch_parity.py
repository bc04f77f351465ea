"""Shared helpers for the ``tests/test_torch_*.py`` parity tests: the same
numpy inputs and the same parameters go through a ``msa_tpu`` (JAX)
function and its ``msa_tpu_torch`` counterpart on the CPU.

The small configs keep ``d_model`` at 128 so that the JAX encoders reach
their Pallas kernels (taken only when ``d_model % 128 == 0``; they run in
interpret mode on the CPU), unlike ``EncoderConfig.tiny()``.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import torch


def share_cpu_threads() -> None:
    """Under pytest-xdist, give this worker's torch its share of the CPU's
    cores (at least one thread): each worker's torch otherwise takes every
    core, and the workers then oversubscribe the CPU several times over. In
    one process torch keeps its default. Called once, at this module's
    import, which each ``tests/test_torch_*.py`` makes before its first
    torch op."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


share_cpu_threads()


ENC = dict(num_layers=2, d_model=128, num_heads=4, d_ff=256)
FACE = dict(
    backbone_channels=(4, 8),
    cnn_channels=(4, 8),
    frame_size=32,
    emotion_weights=None,
    landmark_weights=None,
)
AUDIO = dict(
    conv_channels=(32, 32),
    conv_kernels=(10, 8),
    conv_strides=(5, 4),
    pool_hidden=16,
    pos_conv_kernel=16,  # even kernel: exercises the one-frame trim
    pos_conv_groups=4,
    head_weights=None,
)
TEXT = dict(vocab_size=128, max_positions=64, head_weights=None)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_numpy(tree):
    """A JAX param tree with numpy leaves (what ``weights.py`` takes)."""
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_encoder_cfg(dtype: str, kernels: bool = True, quantize: str = "none"):
    from msa_tpu.models.transformer import EncoderConfig

    impl = dict(attention_impl="pallas", ffn_impl="pallas") if kernels else {}
    return EncoderConfig(compute_dtype=dtype, quantize=quantize, **impl, **ENC)


def port_encoder_cfg(dtype: str, kernels: bool = True, quantize: str = "none"):
    from msa_tpu_torch.models.transformer import EncoderConfig

    impl = dict(attention_impl="kernel", ffn_impl="kernel") if kernels else {}
    return EncoderConfig(compute_dtype=dtype, quantize=quantize, **impl, **ENC)


def t(x, dtype=None) -> torch.Tensor:
    """numpy/JAX array → CPU tensor (bf16 via f32, which is exact)."""
    a = np.asarray(jax.numpy.asarray(x).astype(np.float32)) if dtype is torch.bfloat16 else np.asarray(x)
    out = torch.from_numpy(np.array(a))
    return out.to(dtype) if dtype is not None else out


def f32(x) -> np.ndarray:
    """JAX array or tensor → float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jax.numpy.asarray(x).astype(np.float32))


def bf16_bound(ref: np.ndarray) -> float:
    """The bf16 bound these tests state: 5 bf16 steps (2^-8 each) of the
    largest magnitude in the compared group, plus 1e-3 for groups near 0.
    Both sides round to bf16 at the same points; what is left is f32
    summation order flipping the last bit of a rounded value, which later
    layers carry forward."""
    return 5 * 2.0**-8 * float(np.abs(ref).max()) + 1e-3


def flat_tree(tree, prefix=""):
    """A nested dict of arrays → {"a/b/leaf": numpy array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def same_tree(got, want):
    """Two param trees with the same paths, dtypes and shapes, bit for bit."""
    got, want = flat_tree(got), flat_tree(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


def jax_tiny_models(port_models):
    """JAX's ``PipelineModels`` at JAX's tiny configs carrying the port's
    tiny models' params (numpy leaves): JAX's own classes and graph without
    JAX's init, which compiles op by op for half a minute on the CPU."""
    from msa_tpu.models import audio as JA
    from msa_tpu.models import face as JFace
    from msa_tpu.models import fusion as JF
    from msa_tpu.models import text as JT
    from msa_tpu.pipeline import graph as JG

    tree = port_models.params_tree()
    face_cfg, audio_cfg, text_cfg = JFace.FaceModelConfig.tiny(), JA.AudioModelConfig.tiny(), JT.TextModelConfig.tiny()
    return JG.PipelineModels(
        landmark=JFace.FaceLandmarkNet(face_cfg), landmark_params=tree["landmark"],
        face_cnn=JFace.make_emotion_cnn(face_cfg), face_cnn_params=tree["face_cnn"],
        audio=JA.AudioEmotionModel(audio_cfg), audio_params=tree["audio"],
        text=JT.TextModel(text_cfg), text_params=tree["text"],
        fusion=JF.FusionMLP(**port_models.fusion.dims()), fusion_params=tree["fusion"],
        tokenizer=JT.WordPieceTokenizer(vocab_size=text_cfg.vocab_size),
    )
