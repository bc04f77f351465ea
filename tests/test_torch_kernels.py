"""Parity of the port's kernel modules with the JAX Pallas kernels.

On the CPU a wrapper runs its kernel's plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode (as tests/test_pallas_*.py do).
Weights cross in PyTorch's Linear layout ([out, in]).

Tolerances: float32 ≤ 5e-5, what tests/test_pallas_attention.py:109
allows the kernel against its einsum path. bfloat16 uses
tests/test_pallas_attention.py:137's bound (atol 0.15, rtol 0.1); both
sides round at the same points, so the median error is also asserted to
be 0 (only f32 summation order can flip a last bit).
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tpu.ops.pallas.attention import attention_block as jax_attention_block
from msa_tpu.ops.pallas.ffn import ffn_fused as jax_ffn_fused
from msa_tpu_torch.ops.kernels import attention as A
from msa_tpu_torch.ops.kernels import ffn as F
from torch_parity import TORCH_DTYPES, f32, t

CASES = [(dt, T) for dt in ("float32", "bfloat16") for T in (50, 128)]


def _check(got, want, dtype):
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=5e-5)
    else:
        np.testing.assert_allclose(got, want, atol=0.15, rtol=0.1)
        assert np.median(np.abs(got - want)) == 0.0


@pytest.mark.parametrize("dtype,T", CASES)
def test_attention_block_matches_pallas(rng, dtype, T):
    b, dm, h = 3, 128, 4
    tdt = TORCH_DTYPES[dtype]
    x = rng.normal(size=(b, T, dm)).astype(np.float32)
    w_qkv = (rng.normal(size=(dm, 3 * dm)) / np.sqrt(dm)).astype(np.float32)
    b_qkv = (0.1 * rng.normal(size=3 * dm)).astype(np.float32)
    w_out = (rng.normal(size=(dm, dm)) / np.sqrt(dm)).astype(np.float32)
    b_out = (0.1 * rng.normal(size=dm)).astype(np.float32)
    mask = np.ones((b, T), np.float32)
    mask[0, 30:] = 0.0
    mask[1, :] = 0.0  # no valid key at all: must stay finite (−1e9, not −inf)

    xj = jnp.asarray(x).astype(dtype)
    want = f32(jax_attention_block(xj, w_qkv, b_qkv, w_out, b_out, mask, h, True))
    got = A.attention_block(
        t(xj, tdt),
        t(w_qkv.T, tdt),
        t(b_qkv),
        t(w_out.T, tdt),
        t(b_out),
        t(mask),
        h,
    )
    assert got.dtype == tdt and tuple(got.shape) == (b, T, dm)
    _check(f32(got), want, dtype)


@pytest.mark.parametrize("dtype,T", CASES)
def test_ffn_fused_matches_pallas(rng, dtype, T):
    n, d, f = 2 * T, 128, 256
    tdt = TORCH_DTYPES[dtype]
    x = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32)).astype(dtype)
    w1 = jnp.asarray((rng.normal(size=(d, f)) / np.sqrt(d)).astype(np.float32)).astype(dtype)
    b1 = jnp.asarray((0.1 * rng.normal(size=f)).astype(np.float32)).astype(dtype)
    w2 = jnp.asarray((rng.normal(size=(f, d)) / np.sqrt(f)).astype(np.float32)).astype(dtype)
    b2 = jnp.asarray((0.1 * rng.normal(size=d)).astype(np.float32)).astype(dtype)
    want = f32(jax_ffn_fused(x, w1, b1, w2, b2, interpret=True))
    got = F.ffn_fused(t(x, tdt), t(w1, tdt).T, t(b1, tdt), t(w2, tdt).T, t(b2, tdt))
    assert got.dtype == tdt and tuple(got.shape) == (n, d)
    _check(f32(got), want, dtype)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing(rng):
    x = torch.from_numpy(rng.normal(size=(1, 40, 128)).astype(np.float32))
    w_qkv, w_out = torch.eye(128).repeat(3, 1), torch.eye(128)
    a0, f0 = A.attention_block.launches, F.ffn_fused.launches
    out = A.attention_block(x, w_qkv, torch.zeros(384), w_out, torch.zeros(128), torch.ones(1, 40), 4)
    ref = A.attention_block_plain(x, w_qkv, torch.zeros(384), w_out, torch.zeros(128), torch.ones(1, 40), 4)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    F.ffn_fused(x[0], torch.eye(128), torch.zeros(128), torch.eye(128), torch.zeros(128))
    assert (A.attention_block.launches, F.ffn_fused.launches) == (a0, f0)


def test_attention_block_rejects_t_beyond_single_pass():
    x = torch.zeros(1, 513, 128)
    with pytest.raises(NotImplementedError):
        A.attention_block(x, torch.zeros(384, 128), torch.zeros(384), torch.zeros(128, 128), torch.zeros(128), torch.ones(1, 513), 4)


def test_polynomial_gelu_tracks_exact_gelu():
    """The A&S erf (max abs error 1.5e-7) keeps GELU within 2e-7·|x| of
    torch's exact erf GELU."""
    x = torch.linspace(-8, 8, 4001, dtype=torch.float64)
    np.testing.assert_array_less(
        (F.gelu_as(x) - torch.nn.functional.gelu(x)).abs().numpy(), (2e-7 * x.abs() + 1e-12).numpy()
    )


def test_kernel_sources_and_build_command(tmp_path, monkeypatch):
    """One nvcc call over every csrc/*.cu, for sm_90a, into a C-ABI .so
    (no PyTorch headers, no cpp_extension, no fast math); the library name
    hashes every source, the included .cuh headers too."""
    from msa_tpu_torch.ops.kernels import build

    names = {p.name for p in build._sources()}
    assert names == {"attention.cu", "attention_flash.cu", "attention_packed.cu", "ffn.cu", "quant.cu"}
    assert {p.name for p in build.CSRC.glob("*.cuh")} == {"gemm.cuh", "gemm_s8.cuh"}
    assert build.ARCH_FLAGS == ("-gencode", "arch=compute_90a,code=sm_90a")
    assert "-shared" in build.NVCC_FLAGS and not any("fast_math" in f for f in build.NVCC_FLAGS)
    for p in build.CSRC.glob("*.cu*"):
        src = p.read_text()
        assert "torch/extension.h" not in src and "cublas" not in src.lower()
    assert set(build._SIGNATURES) == {
        "msa_ffn_fused",
        "msa_attention_block",
        "msa_quantize_rows",
        "msa_ffn_fused_int8",
        "msa_attention_block_int8",
        "msa_packed_qkv_attention",
        "msa_flash_attention",
    }
    for name in build._SIGNATURES:  # every bound entry point is defined in a source
        assert any(f'extern "C" int {name}(' in p.read_text() for p in build._sources()), name

    # the one command: every .cu, and a name that moves with any .cu or .cuh
    calls = []
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.subprocess, "run", lambda cmd, **kw: calls.append(cmd) or _Done())
    monkeypatch.setattr(build.os, "replace", lambda src, dst: None)
    lib, _ = build.build()
    assert len(calls) == 1 and calls[0][0] == "nvcc"
    assert sorted(a for a in calls[0] if a.endswith(".cu")) == sorted(str(p) for p in build._sources())
    digest = build._digest()
    assert lib.name == f"libmsa_kernels_{digest}.so"
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    assert build._digest() == digest
    (copy / "gemm_s8.cuh").write_text((copy / "gemm_s8.cuh").read_text() + "//\n")
    assert build._digest() != digest


class _Done:
    returncode, stdout, stderr = 0, "", ""
