"""Rows 5 and 6 of the kernel table, and the encoder dispatch that reaches
them, against the JAX package on the CPU.

On the CPU the wrappers run their kernels' plain versions; JAX runs its
Pallas kernels in interpret mode. ``packed_qkv_attention_lse`` (row 5) is held
against ``_packed_qkv_attention_lse``, ``flash_attention_lse`` (row 6) against
``_flash_attention_lse`` on the [B, H, T, D] transposes of the same
projection; both ``o`` and ``lse``.

Tolerances: float32 2e-5 (row 5) and 3e-5 (row 6), the JAX tests' own
(tests/test_pallas_attention.py:57, :215); bfloat16 atol 0.15, rtol 0.1
(tests/test_pallas_attention.py:137), with the median error 0 since both
sides round at the same points. The lse is f32 on both sides from the same
bf16 scores: 1e-3 in the bf16 cases. The encoders: 1e-3 in f32 and
torch_parity.bf16_bound in bf16 and int8, as tests/test_torch_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tpu.models.transformer import EncoderConfig as JEncCfg
from msa_tpu.models.transformer import TransformerEncoder as JEncoder
from msa_tpu.ops.pallas.attention import _flash_attention_lse, _packed_qkv_attention_lse
from msa_tpu_torch import weights
from msa_tpu_torch.models.transformer import EncoderConfig as PEncCfg
from msa_tpu_torch.models.transformer import TransformerEncoder as PEncoder
from msa_tpu_torch.ops.kernels import attention as A
from torch_parity import ENC, TORCH_DTYPES, bf16_bound, f32, t, to_numpy

F32_ATOL = {"packed": 2e-5, "flash": 3e-5}


def _qkv_and_mask(rng, b, T, h, d, dtype):
    qkv = jnp.asarray(rng.normal(size=(b, T, 3, h, d)).astype(np.float32)).astype(dtype)
    mask = np.ones((b, T), np.float32)
    mask[0, T // 3 :] = 0.0  # ragged valid length
    mask[1, :] = 0.0  # no valid key at all: finite, V averaged over every padded row
    return qkv, mask


def _check(got, want, dtype, kind):
    got, want = f32(got), f32(want)
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL[kind])
    else:
        np.testing.assert_allclose(got, want, atol=0.15, rtol=0.1)
        assert np.median(np.abs(got - want)) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,h,d", [(40, 4, 24), (50, 4, 32), (200, 2, 64)])
def test_packed_qkv_attention_matches_pallas(rng, dtype, T, h, d):
    qkv, mask = _qkv_and_mask(rng, 2, T, h, d, dtype)
    want_o, want_lse = _packed_qkv_attention_lse(qkv, jnp.asarray(mask), interpret=True)
    got_o, got_lse = A.packed_qkv_attention_lse(t(qkv, TORCH_DTYPES[dtype]), t(mask))
    assert got_o.dtype == TORCH_DTYPES[dtype] and tuple(got_o.shape) == (2, T, h * d)
    _check(got_o, want_o, dtype, "packed")
    np.testing.assert_allclose(f32(got_lse), f32(want_lse), atol=F32_ATOL["packed"] if dtype == "float32" else 1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [24, 32, 64])
def test_flash_attention_matches_pallas(rng, dtype, d):
    T, h = 598, 2  # ragged: padded to 640, five 128-key blocks
    qkv, mask = _qkv_and_mask(rng, 2, T, h, d, dtype)
    q, k, v = (qkv[:, :, i].transpose(0, 2, 1, 3) for i in range(3))
    want_o, want_lse = _flash_attention_lse(q, k, v, jnp.asarray(mask), interpret=True)
    got_o, got_lse = A.flash_attention_lse(t(qkv, TORCH_DTYPES[dtype]), t(mask))
    assert tuple(got_o.shape) == (2, T, h * d) and tuple(got_lse.shape) == (2, h, T)
    _check(got_o.reshape(2, T, h, d).permute(0, 2, 1, 3), want_o, dtype, "flash")
    np.testing.assert_allclose(f32(got_lse), f32(want_lse), atol=F32_ATOL["flash"] if dtype == "float32" else 1e-3)


RECIPES = {"float32": ("float32", "none"), "bfloat16": ("bfloat16", "none"), "int8": ("bfloat16", "int8")}


def _encoders(widths, recipe):
    dtype, quantize = RECIPES[recipe]
    common = dict(compute_dtype=dtype, quantize=quantize, **widths)
    return (
        JEncoder(JEncCfg(attention_impl="pallas", ffn_impl="pallas", **common)),
        PEncoder(PEncCfg(attention_impl="kernel", ffn_impl="kernel", **common)),
        dtype,
    )


def _hold(jenc, penc, dtype, x, mask, seed=0):
    params = jenc.init(jax.random.PRNGKey(seed), x[:, :8], mask[:, :8])["params"]
    want = f32(jenc.apply({"params": params}, x, mask))
    weights.load_flax_tree(penc, to_numpy(params))
    got = f32(penc(torch.from_numpy(x), torch.from_numpy(mask)))
    assert np.isfinite(got).all()
    bound = 1e-3 if dtype == "float32" else bf16_bound(want)
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(), bound)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_custom_width_encoder_takes_row5_like_jax(rng, recipe, monkeypatch):
    """d_model 96 (4 heads of 24): JAX leaves attention_block for the dense
    QKV → packed_qkv_attention → dense Wo, and its FFN for nn.Dense."""
    jenc, penc, dtype = _encoders(dict(num_layers=2, d_model=96, num_heads=4, d_ff=256), recipe)
    calls = []
    monkeypatch.setattr(
        "msa_tpu_torch.models.transformer.packed_qkv_attention_lse",
        lambda qkv, m: calls.append(qkv.shape) or A.packed_qkv_attention_lse(qkv, m),
    )
    x = rng.normal(size=(2, 40, 96)).astype(np.float32)
    mask = np.ones((2, 40), np.int32)
    mask[1, 25:] = 0
    _hold(jenc, penc, dtype, x, mask)
    assert calls == [(2, 40, 3, 4, 24)] * 2


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_long_encoder_takes_row6_like_jax(rng, recipe, monkeypatch):
    """torch_parity.ENC widths (d_model 128) at T = 598 > 512: JAX leaves
    attention_block for the dense QKV → flash attention → dense Wo; its FFN
    kernel still runs (int8 in the int8 recipe)."""
    jenc, penc, dtype = _encoders(ENC, recipe)
    calls = []
    monkeypatch.setattr(
        "msa_tpu_torch.models.transformer.flash_attention_lse",
        lambda qkv, m: calls.append(qkv.shape) or A.flash_attention_lse(qkv, m),
    )
    x = rng.normal(size=(2, 598, 128)).astype(np.float32)
    mask = np.ones((2, 598), np.int32)
    mask[1, 400:] = 0
    _hold(jenc, penc, dtype, x, mask)
    assert calls == [(2, 598, 3, 4, 32)] * 2
