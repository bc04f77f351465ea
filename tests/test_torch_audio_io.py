"""The port's host audio ingest against ``msa_tpu/host/audio_io.py``:
WAV reading and writing, resampling, the fixed window and the int16 byte
buffer, equal output for equal input."""

import wave

import numpy as np
import pytest

from msa_tpu.host import audio_io as J
from msa_tpu_torch.host import audio_io as P

import torch_parity  # noqa: F401  (its import shares the CPU among xdist workers)


def _write(path, frames: np.ndarray, width: int, channels: int, rate: int = 22_050):
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(channels)
        wf.setsampwidth(width)
        wf.setframerate(rate)
        wf.writeframes(frames.tobytes())


@pytest.mark.parametrize(
    "dtype,width,channels", [(np.int16, 2, 1), (np.int16, 2, 2), (np.int32, 4, 1), (np.uint8, 1, 2)]
)
def test_load_wav_matches_jax(tmp_path, dtype, width, channels):
    info = np.iinfo(dtype)
    frames = np.random.default_rng(width).integers(info.min, info.max, size=(300, channels), dtype=dtype)
    _write(tmp_path / "x.wav", frames, width, channels)
    (xj, srj), (xp, srp) = J.load_wav(tmp_path / "x.wav"), P.load_wav(tmp_path / "x.wav")
    assert srp == srj == 22_050 and xp.dtype == xj.dtype
    np.testing.assert_array_equal(xp, xj)


def test_save_wav_matches_jax(tmp_path):
    x = np.random.default_rng(0).uniform(-1.2, 1.2, size=1000).astype(np.float32)
    J.save_wav(str(tmp_path / "j" / "x.wav"), x, 16_000)
    P.save_wav(str(tmp_path / "p" / "x.wav"), x, 16_000)
    assert (tmp_path / "p" / "x.wav").read_bytes() == (tmp_path / "j" / "x.wav").read_bytes()


@pytest.mark.parametrize("sr_in", [16_000, 22_050, 44_100, 8_000])
def test_resample_and_window_match_jax(sr_in):
    x = np.random.default_rng(1).normal(size=sr_in // 3).astype(np.float32)
    got, want = P.resample(x, sr_in, 16_000), J.resample(x, sr_in, 16_000)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for n in (100, len(got), len(got) + 77):
        np.testing.assert_array_equal(P.fixed_window(got, n), J.fixed_window(got, n))


def test_pcm16_bytes_match_jax():
    pcm = np.array([-32768, -1, 0, 1, 12345, 32767], np.int16)
    np.testing.assert_array_equal(P.pcm16_bytes_to_float(pcm.tobytes()), J.pcm16_bytes_to_float(pcm.tobytes()))
