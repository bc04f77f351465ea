"""The port's configuration tree against ``msa_tpu/core/config.py``: the
same dataclasses, fields and defaults, and the same environment overrides,
field by field. The one intended difference: ``ModelConfig.device`` names
the card ("cuda") where JAX's names the TPU."""

import dataclasses

import pytest

from msa_tpu.core import config as J
from msa_tpu_torch.core import config as P

import torch_parity  # noqa: F401  (its import shares the CPU among xdist workers)

ENV = ("HF_TOKEN", "MODEL_DEVICE", "FACE_MODEL", "AUDIO_MODEL", "MSA_MODEL_SCALE", "MSA_PRECOMPILE")


def _tree(cfg):
    out = dataclasses.asdict(cfg)
    out["model"].pop("device")
    return out


def test_same_fields_and_defaults():
    j, p = J.SystemConfig(), P.SystemConfig()
    assert [f.name for f in dataclasses.fields(P.SystemConfig)] == [f.name for f in dataclasses.fields(J.SystemConfig)]
    for name in (f.name for f in dataclasses.fields(J.SystemConfig)):
        js, ps = getattr(j, name), getattr(p, name)
        if dataclasses.is_dataclass(js):
            assert type(ps).__name__ == type(js).__name__
            assert [f.name for f in dataclasses.fields(ps)] == [f.name for f in dataclasses.fields(js)], name
    assert _tree(p) == _tree(j)
    assert (j.model.device, p.model.device) == ("tpu", "cuda")
    assert p.pipeline.should_precompile() == j.pipeline.should_precompile()


@pytest.mark.parametrize(
    "env",
    [
        {},
        {"HF_TOKEN": "tok", "FACE_MODEL": "f", "AUDIO_MODEL": "a"},
        {"MODEL_DEVICE": "cpu"},
        {"MSA_MODEL_SCALE": "tiny"},
        {"MSA_PRECOMPILE": "1"},
        {"MSA_PRECOMPILE": "0", "MSA_MODEL_SCALE": "full"},
        {"MSA_PRECOMPILE": "false"},
    ],
    ids=lambda e: ",".join(e) or "none",
)
def test_from_env_overrides(monkeypatch, env):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    j = J.SystemConfig.from_env(seed=3)
    p = P.SystemConfig.from_env(seed=3)
    assert _tree(p) == _tree(j)
    if "MODEL_DEVICE" in env:
        assert p.model.device == j.model.device == env["MODEL_DEVICE"]
    assert p.pipeline.should_precompile() == j.pipeline.should_precompile()


def test_ensure_directories(tmp_path):
    dirs = {k: str(tmp_path / k) for k in ("data_dir", "checkpoints_dir", "output_dir", "temp_dir")}
    P.SystemConfig(dirs=P.DirectoryConfig(**dirs)).ensure_directories()
    assert all((tmp_path / k).is_dir() for k in dirs)
