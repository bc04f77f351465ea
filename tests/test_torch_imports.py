"""Import hygiene of the port: ``msa_tpu_torch`` and ``chip_smoke.py`` run
where there is no JAX, so they import nothing of jax, flax, msgpack, optax
or the JAX package."""

import ast
import pathlib

import pytest

import torch_parity  # noqa: F401  (its import shares the CPU among xdist workers)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "msa_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = {"jax", "jaxlib", "flax", "msgpack", "optax", "msa_tpu"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_side_imports(path):
    bad = sorted(m for m in _imports(path) if m.split(".")[0] in BANNED)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_port_is_there():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for want in (
        "chip_smoke.py",
        "msa_tpu_torch/host/audio_io.py",
        "msa_tpu_torch/host/bpe.py",
        "msa_tpu_torch/host/diarization.py",
        "msa_tpu_torch/host/transcription.py",
        "msa_tpu_torch/models/speaker.py",
        "msa_tpu_torch/models/whisper.py",
        "msa_tpu_torch/ops/kernels/attention.py",
        "msa_tpu_torch/ops/kernels/conv.py",
        "msa_tpu_torch/ops/kernels/ffn.py",
        "msa_tpu_torch/ops/kernels/quant.py",
        "msa_tpu_torch/ops/quant.py",
        "msa_tpu_torch/pipeline/graph.py",
        "msa_tpu_torch/processors/offline.py",
        "msa_tpu_torch/host/video.py",
        "msa_tpu_torch/runtime/native_lib.py",
        "msa_tpu_torch/utils/profiling.py",
        "msa_tpu_torch/core/schema.py",
        "msa_tpu_torch/processors/streaming.py",
        "msa_tpu_torch/visualizers/overlay.py",
        "msa_tpu_torch/utils/logging_config.py",
        "msa_tpu_torch/utils/misc.py",
        "msa_tpu_torch/main.py",
        "msa_tpu_torch/checkpoints/flax_msgpack.py",
        "msa_tpu_torch/pipeline/checkpoint.py",
        "msa_tpu_torch/training/encoders.py",
        "msa_tpu_torch/training/train_fusion.py",
        "msa_tpu_torch/training/preprocess_ami.py",
        "msa_tpu_torch/evaluation/evaluator.py",
        "msa_tpu_torch/evaluation/metrics.py",
        "msa_tpu_torch/training/face_synth.py",
        "msa_tpu_torch/training/text_synth.py",
        "msa_tpu_torch/training/speech_synth.py",
        "msa_tpu_torch/training/synth_av.py",
        "msa_tpu_torch/training/train_landmarks.py",
        "msa_tpu_torch/training/train_face_emotion.py",
        "msa_tpu_torch/training/train_audio_emotion.py",
        "msa_tpu_torch/training/train_text_heads.py",
        "msa_tpu_torch/training/train_speaker.py",
    ):
        assert want in names


# JAX's package namespaces and what each re-exports; parallel/ follows when
# its modules are ported
NAMESPACES = ("", "core", "evaluation", "host", "models", "ops", "pipeline", "processors", "training", "utils", "visualizers")


def _exported(init: pathlib.Path):
    """The names an ``__init__.py`` imports from its submodules."""
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            yield from (a.asname or a.name for a in node.names)


@pytest.mark.parametrize("ns", NAMESPACES, ids=lambda n: n or "msa_tpu_torch")
def test_namespaces_export_jax_names(ns):
    """Each name that JAX's ``msa_tpu/<ns>/__init__.py`` exports is in the
    port's namespace, and importing it builds no kernel."""
    import importlib

    from msa_tpu_torch.ops.kernels import build

    want = sorted(_exported(ROOT / "msa_tpu" / ns / "__init__.py"))
    assert want
    port = importlib.import_module(f"msa_tpu_torch.{ns}" if ns else "msa_tpu_torch")
    assert [n for n in want if not hasattr(port, n)] == []
    assert build.library.cache_info().currsize == 0
