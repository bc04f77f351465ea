"""W8A8 under f32 compute (``EncoderConfig(compute_dtype="float32",
quantize="int8")``) in the port against the JAX package on the CPU.

JAX's int8 kernels take the operands' dtype: ``attention_block(int8=True)``
runs its score and P·V dots in f32 on f32 x and quantizes the f32
attention output, and ``ffn_fused_int8`` quantizes ``x.astype(f32)`` and
writes f32. The port's plain versions follow x's dtype in the same way; on
the card the wrappers launch ``msa_attention_block_int8_f32`` and
``msa_ffn_fused_int8_f32`` (``chip_smoke.py`` phase 23).

- the plain versions on f32 inputs from a numpy seed against the Pallas
  kernels in interpret mode, with ``tests/test_torch_int8.py``'s bound in
  its f32 form: at most 4 bf16 steps (2^-8) of the largest output, and at
  most 5% of the rows off, where a row is off by more than 2^-20 of the
  largest output (a last-bit difference in the f32 attention output can
  move a row's int8 codes). In bf16 the rows that are not off are equal;
  in f32 every output keeps the dequantizing epilogue's last bits
  (``acc·xs·s + b``, which XLA may contract into an FMA), about 2^-24 of
  its value, so the median error is held to 2^-20 of the largest output,
  not to 0;
- a 2-layer f32 int8 encoder (d_model 128, 2 heads) against JAX's
  ``TransformerEncoder`` on the same params, at ``torch_parity.bf16_bound``
  as the bf16-x int8 encoder is held;
- the card path's dispatch on a stand-in library with meta tensors: f32 x
  goes to the f32 entries with f32 scratch and output, counted in
  ``launches_f32``; bf16 x keeps the bf16 entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tpu.models.transformer import EncoderConfig as JEncCfg
from msa_tpu.models.transformer import TransformerEncoder as JEncoder
from msa_tpu.ops.pallas.attention import attention_block as jax_attention_block
from msa_tpu.ops.pallas.ffn import ffn_fused_int8 as jax_ffn_fused_int8
from msa_tpu_torch import weights
from msa_tpu_torch.models.transformer import EncoderConfig as PEncCfg
from msa_tpu_torch.models.transformer import TransformerEncoder as PEncoder
from msa_tpu_torch.ops import quant as PQ
from msa_tpu_torch.ops.kernels import attention as A
from msa_tpu_torch.ops.kernels import ffn as F
from msa_tpu_torch.ops.kernels import quant as KQ
from msa_tpu_torch.ops.kernels import gemm_s8 as GS
from test_torch_int8 import _attention_weights
from test_torch_wide_heads import card  # noqa: F401 (the stand-in kernel library, a fixture)
from torch_parity import bf16_bound, f32, to_numpy


def _int8_close(got, want):
    assert np.isfinite(got).all()
    err, top = np.abs(got - want), np.abs(want).max()
    assert err.max() <= 4 * 2.0**-8 * top, err.max()
    rows = (err > 2.0**-20 * top).reshape(-1, err.shape[-1]).any(-1)
    assert np.median(err) <= 2.0**-20 * top and rows.mean() <= 0.05, (np.median(err), rows.mean())


@pytest.mark.parametrize("T", [50, 128])
def test_attention_block_int8_on_f32_x_matches_pallas(rng, T):
    b, dm, h = 3, 128, 4
    x = rng.normal(size=(b, T, dm)).astype(np.float32)
    w_qkv, b_qkv, w_out, b_out = _attention_weights(rng, dm)
    mask = np.ones((b, T), np.float32)
    mask[0, 30:] = 0.0
    mask[1, :] = 0.0  # no valid key at all: must stay finite (−1e9, not −inf)
    want = jax_attention_block(jnp.asarray(x), w_qkv, b_qkv, w_out, b_out, mask, h, True, int8=True)
    assert want.dtype == jnp.float32
    wqkv_q, s_qkv = PQ.quantize_weight_axis(torch.from_numpy(w_qkv.T.copy()), axis=1)
    wout_q, s_out = PQ.quantize_weight_axis(torch.from_numpy(w_out.T.copy()), axis=1)
    args = (torch.from_numpy(x), wqkv_q, s_qkv[:, 0], torch.from_numpy(b_qkv), wout_q, s_out[:, 0], torch.from_numpy(b_out))
    n0 = (A.attention_block_int8.launches, A.attention_block_int8.launches_f32)
    got = A.attention_block_int8(*args, torch.from_numpy(mask), h)
    assert (A.attention_block_int8.launches, A.attention_block_int8.launches_f32) == n0  # CPU: no launch
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, T, dm)
    _int8_close(f32(got), f32(want))


@pytest.mark.parametrize("n", [100, 256])
def test_ffn_fused_int8_on_f32_x_matches_pallas(rng, n):
    d, f = 128, 256
    x = rng.normal(size=(n, d)).astype(np.float32)
    w1 = (rng.normal(size=(d, f)) / np.sqrt(d)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=f)).astype(np.float32)
    w2 = (rng.normal(size=(f, d)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=d)).astype(np.float32)
    want = jax_ffn_fused_int8(jnp.asarray(x), w1, b1, w2, b2, interpret=True)
    assert want.dtype == jnp.float32
    w1q, s1 = PQ.quantize_weight_axis(torch.from_numpy(w1.T.copy()), axis=1)
    w2q, s2 = PQ.quantize_weight_axis(torch.from_numpy(w2.T.copy()), axis=1)
    got = F.ffn_fused_int8(torch.from_numpy(x), w1q, s1[:, 0], torch.from_numpy(b1), w2q, s2[:, 0], torch.from_numpy(b2))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, d)
    _int8_close(f32(got), f32(want))


def test_f32_int8_encoder_matches_jax(rng):
    common = dict(num_layers=2, d_model=128, num_heads=2, d_ff=256, compute_dtype="float32", quantize="int8")
    jenc = JEncoder(JEncCfg(attention_impl="pallas", ffn_impl="pallas", **common))
    penc = PEncoder(PEncCfg(attention_impl="kernel", ffn_impl="kernel", **common))
    x = rng.normal(size=(2, 100, 128)).astype(np.float32)
    mask = np.ones((2, 100), np.int32)
    mask[1, 60:] = 0
    params = jenc.init(jax.random.PRNGKey(0), x[:, :8], mask[:, :8])["params"]
    want = f32(jenc.apply({"params": params}, x, mask))
    weights.load_flax_tree(penc, to_numpy(params))
    att = penc.layer_0.attention
    assert att.w_qkv_q.dtype == torch.int8 and penc.layer_0.w_in_q.dtype == torch.int8
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for name, real in (("attention_block_int8", A.attention_block_int8), ("ffn_fused_int8", F.ffn_fused_int8)):
            mp.setattr(f"msa_tpu_torch.models.transformer.{name}",
                       lambda *a, name=name, real=real: calls.append((name, a[0].dtype)) or real(*a))
        got = penc(torch.from_numpy(x), torch.from_numpy(mask))
    assert calls == [("attention_block_int8", torch.float32), ("ffn_fused_int8", torch.float32)] * 2
    assert got.dtype == torch.float32
    got = f32(got)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= bf16_bound(want), np.abs(got - want).max()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_wrappers_take_the_entry_of_x_dtype_on_the_card_path(card, dtype):
    """The card path picks the entry by x's dtype: f32 x → the f32 entries
    (the attention block with the f32 core's lse scratch), outputs and
    scratch in x's dtype, counted in ``launches_f32``; bf16 x → the bf16
    entries, counted in ``launches``; two row quantizations each."""
    b, t, dm, h, dff = 2, 100, 128, 2, 256
    i8 = torch.int8
    is_f32 = dtype == torch.float32
    counter = "launches_f32" if is_f32 else "launches"
    before = (getattr(A.attention_block_int8, counter), getattr(F.ffn_fused_int8, counter), KQ.quantize_rows.launches)
    out = A.attention_block_int8(_meta(b, t, dm, dtype=dtype), _meta(3 * dm, dm, dtype=i8), _meta(3 * dm), _meta(3 * dm),
                                 _meta(dm, dm, dtype=i8), _meta(dm), _meta(dm), _meta(b, t), h)
    assert out.dtype == dtype and tuple(out.shape) == (b, t, dm)
    out = F.ffn_fused_int8(_meta(b * t, dm, dtype=dtype), _meta(dff, dm, dtype=i8), _meta(dff), _meta(dff),
                           _meta(dm, dff, dtype=i8), _meta(dm), _meta(dm))
    assert out.dtype == dtype and tuple(out.shape) == (b * t, dm)
    sfx = "_f32" if is_f32 else ""
    assert [name for name, _ in card.calls] == ["msa_attention_block_int8" + sfx, "msa_ffn_fused_int8" + sfx]
    (_, att), (_, ffn) = card.calls
    # pointers, then B, T, DM, H, DP, the two plans, (f32: the wide f32 core's plan, tickets and
    # workspace, zeros at DP ≤ 128), scale, stream
    wide = 3 if is_f32 else 0
    assert len(att) == (18 if is_f32 else 17) + 9 + wide
    assert att[-9 - wide : -4 - wide] == (b, 128, dm, h, dm // h) and att[-2] == float(np.float32(1.0 / np.sqrt(dm // h)))
    assert att[-4 - wide : -2 - wide] == (GS.plan(b * 128, 3 * dm, dm).code, GS.plan(b * 128, dm, dm).code)
    assert att[-2 - wide : -2] == (0, 0, 0)[:wide]
    assert ffn[-6:-1] == (b * t, dm, dff, GS.plan(b * t, dff, dm).code, GS.plan(b * t, dm, dff).code)
    assert (getattr(A.attention_block_int8, counter), getattr(F.ffn_fused_int8, counter), KQ.quantize_rows.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 4)
