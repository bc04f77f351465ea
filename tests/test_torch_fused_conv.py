"""Rows 1 and 11 of the kernel table against the JAX package on the CPU.

On the CPU the wrappers run their kernels' plain versions; JAX runs its
Pallas kernels in interpret mode, as its own tests do.

- Row 1, ``fused_attention`` / ``fused_attention_lse`` against
  ``fused_attention(interpret=True)`` and ``_fused_attention_lse`` at
  tests/test_pallas_attention.py:9-20's cases (a half-masked row), f32 at
  its atol 2e-5, o and lse; one bf16 case at row 2's bound (atol 0.15, rtol
  0.1, median error 0: both sides round at the same points, see
  tests/test_torch_flash.py). ``reference_attention`` against JAX's.
- Row 11, ``conv_stride2_fused`` against ``conv_stride2_fused(interpret=
  True)`` at tests/test_pallas_conv.py:22-55's cases: f32 at 2e-4 (atol
  and rtol), bf16 within 2e-2 of the largest output.
- Row 11's bf16 kernel runs only on the card (``csrc/conv_stride2.cu``,
  ``chip_smoke.py`` phase 14); on ``meta`` tensors with a stand-in kernel
  library, the wrapper passes ``msa_conv_stride2`` its argument list (the
  shapes, k, the GELU flag and the persistent grid, one CTA an SM) and
  counts one launch.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tpu.ops.pallas.attention import _fused_attention_lse as jax_fused_lse
from msa_tpu.ops.pallas.attention import fused_attention as jax_fused
from msa_tpu.ops.pallas.attention import reference_attention as jax_reference
from msa_tpu.ops.pallas.conv import conv_stride2_fused as jax_conv
from msa_tpu_torch.ops.kernels import attention as A
from msa_tpu_torch.ops.kernels import conv as C
from torch_parity import f32, t


def _qkvm(rng, t_len, d):
    b, h = 2, 2
    q, k, v = (rng.normal(size=(b, h, t_len, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, t_len), np.float32)
    mask[1, t_len // 2 :] = 0.0
    return q, k, v, mask


@pytest.mark.parametrize("t_len,d", [(128, 128), (64, 32), (250, 64)])
def test_fused_attention_matches_pallas_f32(rng, t_len, d):
    q, k, v, mask = _qkvm(rng, t_len, d)
    want_o, want_lse = jax_fused_lse(q, k, v, mask, interpret=True)
    got_o, got_lse = A.fused_attention_lse(*(t(x) for x in (q, k, v, mask)))
    assert got_o.dtype == torch.float32 and tuple(got_o.shape) == q.shape
    np.testing.assert_allclose(f32(got_o), f32(want_o), atol=2e-5)
    np.testing.assert_allclose(f32(got_lse), f32(want_lse), atol=2e-5)
    np.testing.assert_allclose(f32(A.fused_attention(*(t(x) for x in (q, k, v, mask)))), f32(jax_fused(q, k, v, mask, interpret=True)), atol=2e-5)
    np.testing.assert_allclose(f32(A.reference_attention(*(t(x) for x in (q, k, v, mask)))), f32(jax_reference(q, k, v, mask)), atol=2e-5)


def test_fused_attention_matches_pallas_bf16(rng):
    """T=250 pads to 256; row 0 has no valid key, row 1 none past 125."""
    q, k, v, mask = (jnp.asarray(x).astype(jnp.bfloat16) if x.ndim == 4 else x for x in _qkvm(rng, 250, 64))
    mask[0, :] = 0.0  # a row with no valid key: V averaged over all 256 padded keys
    want_o, want_lse = jax_fused_lse(q, k, v, mask, interpret=True)
    got_o, got_lse = A.fused_attention_lse(*(t(x, torch.bfloat16) for x in (q, k, v)), t(mask))
    assert got_o.dtype == torch.bfloat16
    got, want = f32(got_o), f32(want_o)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=0.15, rtol=0.1)
    assert np.median(np.abs(got - want)) == 0.0
    np.testing.assert_allclose(f32(got_lse), f32(want_lse), atol=1e-3)


@pytest.mark.parametrize("gelu", [True, False])
@pytest.mark.parametrize("length", [1023, 1999, 2048])
@pytest.mark.parametrize("k", [2, 3])
def test_conv_stride2_matches_pallas(k, length, gelu):
    rng = np.random.default_rng(k * 10_000 + length)
    x = rng.standard_normal((2, length, 128), dtype=np.float32)
    w = 0.05 * rng.standard_normal((k, 128, 128), dtype=np.float32)
    want = f32(jax_conv(jnp.asarray(x), jnp.asarray(w), apply_gelu=gelu, block_l=256, interpret=True))
    got = C.conv_stride2_fused(t(x), t(w), apply_gelu=gelu)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, (length - k) // 2 + 1, 128)
    np.testing.assert_allclose(f32(got), want, atol=2e-4, rtol=2e-4)


def test_conv_stride2_matches_pallas_bf16():
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((1, 999, 128), dtype=np.float32), jnp.bfloat16)
    w = 0.05 * rng.standard_normal((3, 128, 128), dtype=np.float32)
    want = f32(jax_conv(x, jnp.asarray(w), block_l=128, interpret=True))
    got = C.conv_stride2_fused(t(x, torch.bfloat16), t(w))
    assert got.dtype == torch.bfloat16
    rel = np.abs(f32(got) - want).max() / (np.abs(want).max() + 1e-9)
    assert rel < 2e-2, rel


@pytest.mark.parametrize(
    "x_shape,w_shape",
    [((1, 64, 128), (4, 128, 128)), ((1, 64, 128), (3, 64, 128)), ((1, 64, 96), (2, 96, 128)), ((1, 2, 128), (3, 128, 128))],
)
def test_conv_stride2_refuses_what_jax_asserts(x_shape, w_shape):
    """k ∈ {2, 3}, cin == C, C and C' multiples of 128 (conv.py:98-99), and
    at least one output row."""
    with pytest.raises(ValueError):
        C.conv_stride2_fused(torch.zeros(x_shape), torch.zeros(w_shape))


class _Library:
    """Stands in for the kernel library: records each entry point's name and
    arguments, returns 0 (no CUDA error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("msa_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("b,length,k,cout,gelu", [(64, 15999, 3, 512, True), (2, 999, 2, 384, False)])
def test_conv_stride2_argument_list_on_the_card_path(monkeypatch, b, length, k, cout, gelu):
    """bf16 on the card: one call of msa_conv_stride2 with x, wt [C', k·C],
    out, B, L, C, C', k, the GELU flag, the persistent grid (one CTA an SM;
    the kernel takes fewer where there are fewer tiles) and the stream; one
    launch counted."""
    lib = _Library()
    monkeypatch.setattr(C.build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device=None: SimpleNamespace(multi_processor_count=132))
    x = torch.empty(b, length, 512, dtype=torch.bfloat16, device="meta")
    w = torch.empty(k, 512, cout, device="meta")
    before = C.conv_stride2_fused.launches
    out = C.conv_stride2_fused(x, w, apply_gelu=gelu)
    out_len = (length - k) // 2 + 1
    assert tuple(out.shape) == (b, out_len, cout) and out.dtype == torch.bfloat16
    (name, args), = lib.calls
    assert name == "msa_conv_stride2" and len(args) == len(C.build._SIGNATURES[name])
    assert args[3:] == (b, length, 512, cout, k, int(gelu), 132, 7)
    assert C.conv_stride2_fused.launches == before + 1
