"""Parity of the port's int8 (W8A8) serving pieces with the JAX package:
the quantization helpers, the plain versions of the two int8 kernels
(``attention_block_int8``, ``ffn_fused_int8``) against the Pallas kernels
in interpret mode, the row-quantize wrapper, and an int8 encoder.

The JAX functions run as the JAX package runs them, under ``jax.jit``
(the Pallas wrappers are jitted; so are the quant helpers here): XLA turns
``amax / 127.0`` into a multiplication by float32 1/127 there, which the
port reproduces (see msa_tpu_torch/ops/quant.py).

Tolerances:
- quantization codes and scales, and the int8 weights each layer derives
  from its f32 masters: bit-equal;
- int8 kernels: both sides quantize alike and their int32 sums are exact,
  so what is left is f32 summation order in the bf16 attention core (and
  the GELU's exp). A last-bit flip in a row's attention output can move
  that row's int8 codes, and with them every output of the row by about a
  bf16 step. The bound: 4 bf16 steps (2^-8) of the largest output
  magnitude, the median error 0, and at most 5% of the rows off (the
  worst case here reads 9 of 384 rows, 2.3%).
  The JAX package's own int8 tests against f32 allow far more
  (tests/test_pallas_ffn.py:104-105: median relative error ≤ 3%);
- the int8 encoder (2 layers, LayerNorms between): torch_parity.bf16_bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tpu.models.transformer import TransformerEncoder as JEncoder
from msa_tpu.ops import quant as JQ
from msa_tpu.ops.pallas.attention import attention_block as jax_attention_block
from msa_tpu.ops.pallas.ffn import ffn_fused_int8 as jax_ffn_fused_int8
from msa_tpu_torch import weights
from msa_tpu_torch.models.transformer import TransformerEncoder as PEncoder
from msa_tpu_torch.ops import quant as PQ
from msa_tpu_torch.ops.kernels import attention as A
from msa_tpu_torch.ops.kernels import ffn as F
from msa_tpu_torch.ops.kernels import quant as KQ
from torch_parity import bf16_bound, f32, jax_encoder_cfg, port_encoder_cfg, to_numpy

JIT_QUANT = {
    "rows": (jax.jit(JQ.quantize_rows), PQ.quantize_rows),
    "cols": (jax.jit(JQ.quantize_weight_cols), PQ.quantize_weight_cols),
    "axis1": (jax.jit(lambda w: JQ.quantize_weight_axis(w, 1)), lambda w: PQ.quantize_weight_axis(w, 1)),
    "axis0": (jax.jit(lambda w: JQ.quantize_weight_axis(w, 0)), lambda w: PQ.quantize_weight_axis(w, 0)),
}


def _quant_cases():
    rng = np.random.default_rng(3)
    random = (rng.standard_normal((64, 96)) * rng.uniform(1e-3, 10, size=(64, 1))).astype(np.float32)
    random[5] = 0.0  # a zero row: the 1e-8 floor, codes 0
    random[:, 7] = 0.0  # a zero column
    # codes on .5 ties (amax 127 · 1/127 rounds to 1 - 2^-24, so build the
    # ties from the scale the quantizer will take)
    s = np.float32(np.float32(127.0) * np.float32(1.0 / 127.0))
    ties = (np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5], np.float32) * s).astype(np.float32)
    ties = np.stack([ties, -ties, ties[::-1].copy()])
    ends = np.array([[1.0, -1.0, 0.999, -0.999, 0.25, 1e-3, -1e-3, 0.0]], np.float32) * 3.0  # codes ±127
    return {"random": random, "ties": ties, "ends": ends}


@pytest.mark.parametrize("fn", sorted(JIT_QUANT))
@pytest.mark.parametrize("case", ["random", "ties", "ends"])
def test_quant_helpers_bit_equal_to_jax(fn, case):
    x = _quant_cases()[case]
    jax_fn, port_fn = JIT_QUANT[fn]
    jq, js = jax_fn(jnp.asarray(x))
    pq, ps = port_fn(torch.from_numpy(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert np.isfinite(ps.numpy()).all() and np.abs(pq.numpy()).max() <= 127


def test_quant_rows_reaches_127_and_ties_round_to_even():
    x = _quant_cases()
    q, _ = PQ.quantize_rows(torch.from_numpy(x["ends"]))
    assert q[0, 0] == 127 and q[0, 1] == -127
    q, s = PQ.quantize_rows(torch.from_numpy(x["ties"][:1]))
    np.testing.assert_array_equal(q[0].numpy(), [127, 0, 2, 2, 0, -2, -2, 126])
    z, zs = PQ.quantize_rows(torch.zeros(2, 16, dtype=torch.bfloat16))
    assert not z.any() and float(zs[0, 0]) == float(np.float32(np.float32(1e-8) * np.float32(1 / 127)))


def test_quantize_rows_wrapper_takes_the_plain_version_on_cpu(rng):
    x = torch.from_numpy(rng.normal(size=(10, 64)).astype(np.float32)).bfloat16()
    n0 = KQ.quantize_rows.launches
    q, s = KQ.quantize_rows(x)
    pq, ps = PQ.quantize_rows(x)
    assert torch.equal(q, pq) and torch.equal(s, ps) and KQ.quantize_rows.launches == n0


def _int8_close(got, want):
    assert np.isfinite(got).all()
    err = np.abs(got - want)
    assert err.max() <= 4 * 2.0**-8 * np.abs(want).max(), err.max()
    rows = (err > 0).reshape(-1, err.shape[-1]).any(-1)
    assert np.median(err) == 0.0 and rows.mean() <= 0.05, rows.mean()


def _attention_weights(rng, dm):
    w_qkv = (rng.normal(size=(dm, 3 * dm)) / np.sqrt(dm)).astype(np.float32)
    b_qkv = (0.1 * rng.normal(size=3 * dm)).astype(np.float32)
    w_out = (rng.normal(size=(dm, dm)) / np.sqrt(dm)).astype(np.float32)
    b_out = (0.1 * rng.normal(size=dm)).astype(np.float32)
    return w_qkv, b_qkv, w_out, b_out


@pytest.mark.parametrize("T", [50, 128])
def test_attention_block_int8_matches_pallas(rng, T):
    b, dm, h = 3, 128, 4
    x = jnp.asarray(rng.normal(size=(b, T, dm)).astype(np.float32)).astype(jnp.bfloat16)
    w_qkv, b_qkv, w_out, b_out = _attention_weights(rng, dm)
    mask = np.ones((b, T), np.float32)
    mask[0, 30:] = 0.0
    mask[1, :] = 0.0  # no valid key at all: must stay finite (−1e9, not −inf)
    want = f32(jax_attention_block(x, w_qkv, b_qkv, w_out, b_out, mask, h, True, int8=True))

    # the port's int8 weights and scales, from the f32 masters in Linear
    # layout, equal JAX's: per head over the contraction axis for QKV
    # ([H, dm, dh] → one scale per output column), per column for Wo
    wqkv_q, s_qkv = PQ.quantize_weight_axis(torch.from_numpy(w_qkv.T.copy()), axis=1)
    wout_q, s_out = PQ.quantize_weight_axis(torch.from_numpy(w_out.T.copy()), axis=1)
    w4 = jnp.asarray(w_qkv).reshape(dm, 3, h, dm // h)
    for i in range(3):
        jq, js = jax.jit(lambda w: JQ.quantize_weight_axis(w, 1))(w4[:, i].transpose(1, 0, 2))  # [H, dm, dh]
        rows = slice(i * dm, (i + 1) * dm)
        np.testing.assert_array_equal(wqkv_q[rows].numpy(), np.asarray(jq).transpose(0, 2, 1).reshape(dm, dm))
        np.testing.assert_array_equal(s_qkv[rows, 0].numpy(), np.asarray(js).reshape(dm))
    jq, js = jax.jit(JQ.quantize_weight_cols)(w_out)
    np.testing.assert_array_equal(wout_q.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(s_out[:, 0].numpy(), np.asarray(js))

    xt = torch.from_numpy(np.array(f32(x))).bfloat16()
    args = (xt, wqkv_q, s_qkv[:, 0], torch.from_numpy(b_qkv), wout_q, s_out[:, 0], torch.from_numpy(b_out))
    n0 = A.attention_block_int8.launches
    got = A.attention_block_int8(*args, torch.from_numpy(mask), h)
    assert A.attention_block_int8.launches == n0  # CPU: the plain version, no launch
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, T, dm)
    _int8_close(f32(got), want)


@pytest.mark.parametrize("n", [100, 256])
def test_ffn_fused_int8_matches_pallas(rng, n):
    d, f = 128, 256
    x = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32)).astype(jnp.bfloat16)
    w1 = (rng.normal(size=(d, f)) / np.sqrt(d)).astype(np.float32)
    b1 = (0.1 * rng.normal(size=f)).astype(np.float32)
    w2 = (rng.normal(size=(f, d)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=d)).astype(np.float32)
    want = f32(jax_ffn_fused_int8(x, w1, b1, w2, b2, interpret=True))
    w1q, s1 = PQ.quantize_weight_axis(torch.from_numpy(w1.T.copy()), axis=1)
    w2q, s2 = PQ.quantize_weight_axis(torch.from_numpy(w2.T.copy()), axis=1)
    for port_q, port_s, w in ((w1q, s1, w1), (w2q, s2, w2)):
        jq, js = jax.jit(JQ.quantize_weight_cols)(w)
        np.testing.assert_array_equal(port_q.numpy(), np.asarray(jq).T)
        np.testing.assert_array_equal(port_s[:, 0].numpy(), np.asarray(js))
    n0 = F.ffn_fused_int8.launches
    got = F.ffn_fused_int8(
        torch.from_numpy(np.array(f32(x))).bfloat16(), w1q, s1[:, 0], torch.from_numpy(b1), w2q, s2[:, 0], torch.from_numpy(b2)
    )
    assert F.ffn_fused_int8.launches == n0
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n, d)
    _int8_close(f32(got), want)


def test_int8_encoder_matches_jax(rng):
    x = rng.normal(size=(2, 50, 128)).astype(np.float32)
    mask = np.ones((2, 50), np.int32)
    mask[1, 30:] = 0
    jenc = JEncoder(jax_encoder_cfg("bfloat16", quantize="int8"))
    params = jenc.init(jax.random.PRNGKey(0), x, mask)["params"]
    want = f32(jenc.apply({"params": params}, x, mask))
    penc = PEncoder(port_encoder_cfg("bfloat16", quantize="int8"))
    weights.load_flax_tree(penc, to_numpy(params))
    layer = penc.layer_0
    assert layer.fc_in.weight.dtype == torch.float32 and layer.w_in_q.dtype == torch.int8
    jq, js = jax.jit(JQ.quantize_weight_cols)(params["layer_0"]["fc_in"]["kernel"])
    np.testing.assert_array_equal(layer.w_in_q.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(layer.s_in.numpy(), np.asarray(js))
    got = f32(penc(torch.from_numpy(x), torch.from_numpy(mask)))
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= bf16_bound(want), np.abs(got - want).max()


def test_int8_weights_follow_the_masters():
    """A new random draw re-derives the int8 weights; the bf16 recipe
    derives its copies from the same f32 masters."""
    enc = PEncoder(port_encoder_cfg("bfloat16", quantize="int8"))
    weights.draw_random_(enc, torch.Generator().manual_seed(1))
    att = enc.layer_1.attention
    q, s = PQ.quantize_weight_axis(att.qkv.weight, axis=1)
    assert torch.equal(att.w_qkv_q, q) and torch.equal(att.s_qkv, s[:, 0])
    bf = PEncoder(port_encoder_cfg("bfloat16"))
    bf.load_state_dict(enc.state_dict())
    weights.derive_weights_(bf)
    assert torch.equal(bf.layer_1.attention.w_qkv_c, att.qkv.weight.to(torch.bfloat16))
    assert torch.equal(bf.layer_1.b_out_c, enc.layer_1.fc_out.bias.to(torch.bfloat16))
