"""Head dims the kernels' tiles do not match, on the CPU.

Rows 7 and 8 (``attention_block[_int8]``) serve any head dim D on weights
padded once per head to the core's DP ∈ {32, 64, 128} (or, above 128, the
next multiple of 128: ``pad_block_weights``); rows 2–6 zero-pad a D that is not a multiple of
8 on the card, with the scale of the unpadded D. These tests hold the
padding identities the card's wrappers rely on (the plain versions on
padded operands against the same on unpadded ones: f32 within 1e-6, int8
bit for bit), the encoders at head dims 32, 48 and 128 against JAX's
``attention_block`` in interpret mode, rows 2–6 at D ∈ {24, 25, 32, 128}
against JAX's kernels, and JAX's public names with JAX's contracts
(``packed_qkv_attention`` → o, differentiable; ``flash_attention`` on
q, k, v [B, H, T, D] → o).

Tolerances are those of tests/test_torch_kernels.py, test_torch_int8.py,
test_torch_flash.py and test_torch_attention_bwd.py for the same kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tpu.models.transformer import EncoderConfig as JEncCfg
from msa_tpu.models.transformer import TransformerEncoder as JEncoder
from msa_tpu.ops.pallas.attention import _flash_attention_lse, _mha_attention_lse, _packed_qkv_attention_lse
from msa_tpu.ops.pallas.attention import flash_attention as jax_flash_attention
from msa_tpu.ops.pallas.attention import packed_qkv_attention as jax_packed_qkv_attention
from msa_tpu_torch import weights
from msa_tpu_torch.models.transformer import EncoderConfig as PEncCfg
from msa_tpu_torch.models.transformer import TransformerEncoder as PEncoder
from msa_tpu_torch.ops import quant as Q
from msa_tpu_torch.ops.kernels import attention as A
from torch_parity import TORCH_DTYPES, bf16_bound, f32, t, to_numpy

PAD_D = [24, 32, 48, 96, 128]  # DP 32, 32, 64, 128, 128
H = 4


def _block_weights(rng, d):
    dm = H * d
    w_qkv = torch.from_numpy((rng.normal(size=(3 * dm, dm)) / np.sqrt(dm)).astype(np.float32))
    b_qkv = torch.from_numpy((0.1 * rng.normal(size=3 * dm)).astype(np.float32))
    w_out = torch.from_numpy((rng.normal(size=(dm, dm)) / np.sqrt(dm)).astype(np.float32))
    b_out = torch.from_numpy((0.1 * rng.normal(size=dm)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 50, dm)).astype(np.float32))
    mask = torch.ones(2, 50)
    mask[0, 30:] = 0.0
    mask[1] = 0.0  # no valid key
    return x, w_qkv, b_qkv, w_out, b_out, mask


def test_block_head_dim_and_the_limit():
    """32, 64 or 128 up to 128; above, the next multiple of 128 (the
    D-tiled kernel's column tile, as JAX pads D): no limit."""
    assert [A.block_head_dim(d) for d in (1, 24, 32, 33, 64, 65, 100, 128)] == [32, 32, 32, 64, 64, 128, 128, 128]
    assert [A.block_head_dim(d) for d in (129, 192, 256, 257, 512)] == [256, 256, 256, 384, 512]
    with pytest.raises(ValueError):
        A.block_head_dim(0)


@pytest.mark.parametrize("d", PAD_D)
def test_pad_block_weights_layout(rng, d):
    _, w_qkv, b_qkv, w_out, _, _ = _block_weights(rng, d)
    s_qkv = torch.rand(3 * H * d) + 0.5
    pw, pb, po, ps = A.pad_block_weights(w_qkv, b_qkv, w_out, H, s_qkv)
    dp = A.block_head_dim(d)
    if dp == d:  # nothing to pad: the same tensors
        assert pw is w_qkv and pb is b_qkv and po is w_out and ps is s_qkv
        return
    assert pw.shape == (3 * H * dp, H * d) and po.shape == (H * d, H * dp) and pb.shape == ps.shape == (3 * H * dp,)
    w4, b3, s3 = pw.view(3, H, dp, -1), pb.view(3, H, dp), ps.view(3, H, dp)
    assert torch.equal(w4[:, :, :d], w_qkv.view(3, H, d, -1)) and not w4[:, :, d:].any()
    assert torch.equal(b3[:, :, :d], b_qkv.view(3, H, d)) and not b3[:, :, d:].any()
    assert torch.equal(s3[:, :, :d], s_qkv.view(3, H, d)) and bool((s3[:, :, d:] == 1.0).all())
    o3 = po.view(H * d, H, dp)
    assert torch.equal(o3[:, :, :d], w_out.view(H * d, H, d)) and not o3[:, :, d:].any()


@pytest.mark.parametrize("d", PAD_D)
def test_padded_weights_leave_the_f32_block_unchanged(rng, d):
    x, w_qkv, b_qkv, w_out, b_out, mask = _block_weights(rng, d)
    want = A.attention_block_plain(x, w_qkv, b_qkv, w_out, b_out, mask, H)
    pw, pb, po, _ = A.pad_block_weights(w_qkv, b_qkv, w_out, H)
    got = A.attention_block(x, pw, pb, po, b_out, mask, H, head_dim=d)
    assert got.shape == want.shape == x.shape
    assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("d", PAD_D)
def test_padded_int8_weights_are_bit_equal(rng, d):
    """Quantize the unpadded f32 masters, then pad the codes (zeros) and the
    scales (1.0): the W8A8 block's output is the same, bit for bit (the
    attention output's row amax does not see the zero columns)."""
    x, w_qkv, b_qkv, w_out, b_out, mask = _block_weights(rng, d)
    x = x.bfloat16()
    wq, sq = Q.quantize_weight_axis(w_qkv, axis=1)
    wo, so = Q.quantize_weight_axis(w_out, axis=1)
    sq, so = sq[:, 0].contiguous(), so[:, 0].contiguous()
    want = A.attention_block_int8_plain(x, wq, sq, b_qkv, wo, so, b_out, mask, H)
    pwq, pb, pwo, psq = A.pad_block_weights(wq, b_qkv, wo, H, sq)
    got = A.attention_block_int8(x, pwq, psq, pb, pwo, so, b_out, mask, H, head_dim=d)
    assert pwq.dtype == pwo.dtype == torch.int8
    assert torch.equal(got, want)


RECIPES = {
    "float32": ("float32", "none"),
    "bfloat16": ("bfloat16", "none"),
    "int8": ("bfloat16", "int8"),
    "int8_f32": ("float32", "int8"),  # W8A8 under f32 compute
}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
@pytest.mark.parametrize("dm,heads", [(128, 4), (384, 8), (768, 6)])  # D = 32, 48 (padded to 64), 128
def test_encoder_at_any_head_dim_matches_jax_attention_block(rng, recipe, dm, heads):
    """A 2-layer encoder whose layers take attention_block[_int8] (d_model
    % 128 == 0, T ≤ 512) at head dims the old kernel refused, against JAX's
    encoder with its Pallas kernels in interpret mode."""
    dtype, quantize = RECIPES[recipe]
    common = dict(num_layers=2, d_model=dm, num_heads=heads, d_ff=256, compute_dtype=dtype, quantize=quantize)
    jenc = JEncoder(JEncCfg(attention_impl="pallas", ffn_impl="pallas", **common))
    penc = PEncoder(PEncCfg(attention_impl="kernel", ffn_impl="kernel", **common))
    x = rng.normal(size=(2, 40, dm)).astype(np.float32)
    mask = np.ones((2, 40), np.int32)
    mask[1, 25:] = 0
    params = jenc.init(jax.random.PRNGKey(0), x[:, :8], mask[:, :8])["params"]
    want = f32(jenc.apply({"params": params}, x, mask))
    weights.load_flax_tree(penc, to_numpy(params))
    att = penc.layer_0.attention
    dp = A.block_head_dim(dm // heads)
    w_blk = att.w_qkv_q if quantize == "int8" else att.w_qkv_blk
    assert w_blk.shape == (3 * heads * dp, dm)
    calls = []
    real = A.attention_block_int8 if quantize == "int8" else A.attention_block
    name = "attention_block_int8" if quantize == "int8" else "attention_block"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(f"msa_tpu_torch.models.transformer.{name}", lambda *a: calls.append(a[-1]) or real(*a))
        got = f32(penc(torch.from_numpy(x), torch.from_numpy(mask)))
    assert calls == [dm // heads] * 2  # both layers, with the unpadded head dim
    assert np.isfinite(got).all()
    bound = 1e-3 if recipe == "float32" else bf16_bound(want)  # int8 at either dtype: bf16's bound
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(), bound)


def _qkv(rng, T, h, d, dtype):
    qkv = jnp.asarray(rng.normal(size=(2, T, 3, h, d)).astype(np.float32)).astype(dtype)
    mask = np.ones((2, T), np.float32)
    mask[0, T // 3 :] = 0.0
    mask[1, :] = 0.0  # no valid key
    return qkv, mask


def _heads(o, h, d, dp):
    """[B, T, H·DP] → the first D columns of each head, [B, T, H·D]."""
    return o.reshape(*o.shape[:2], h, dp)[..., :d].reshape(*o.shape[:2], h * d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [24, 25, 31])
def test_rows_5_and_6_plain_on_padded_d(rng, dtype, d):
    """What the card's wrappers do for D % 8 ≠ 0 (zero-pad D, keep the
    unpadded scale, slice o back) leaves o and the lse unchanged."""
    tdt = TORCH_DTYPES[dtype]
    for T, plain in ((100, A.packed_qkv_attention_lse_plain), (600, A.flash_attention_lse_plain)):
        qkv, mask = _qkv(rng, T, 3, d, dtype)
        qkv, mask = t(qkv, tdt), t(mask)
        (padded,) = A._pad_head_dim(qkv)
        dp = padded.shape[-1]
        assert dp % 8 == 0 and dp - d < 8
        want_o, want_lse = plain(qkv, mask)
        got_o, got_lse = plain(padded, mask, A._scale(d))
        tol = 1e-6 if dtype == "float32" else 0.0
        assert (f32(_heads(got_o, 3, d, dp)) - f32(want_o)).__abs__().max() <= tol * max(1.0, float(np.abs(f32(want_o)).max()))
        assert np.abs(f32(got_lse) - f32(want_lse)).max() <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_3_and_4_plain_on_padded_d(rng, dtype):
    tdt, d = TORCH_DTYPES[dtype], 25
    q, k, v, g = (torch.from_numpy(rng.normal(size=(2, 3, 130, d)).astype(np.float32)).to(tdt) for _ in range(4))
    mask = torch.ones(2, 130)
    mask[0, 90:] = 0.0
    o, lse = A.mha_attention_plain(q, k, v, mask)
    want = A.attention_bwd_plain(q, k, v, mask, lse, o, g)
    got = A.attention_bwd_plain(*A._pad_head_dim(q, k, v), mask, lse, *A._pad_head_dim(o, g), A._scale(d))
    for w, gt in zip(want, got):
        err = (f32(gt[..., :d]) - f32(w)).__abs__().max()
        assert err <= (1e-5 if dtype == "float32" else 5 * 2.0**-8 * float(np.abs(f32(w)).max())), err
        assert not f32(gt[..., d:]).any()  # the padded columns' gradients, dropped by the wrapper, are 0


F32_ATOL = {"packed": 2e-5, "flash": 3e-5}


def _close(got, want, dtype, kind):
    got, want = f32(got), f32(want)
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL[kind])
    else:
        np.testing.assert_allclose(got, want, atol=0.15, rtol=0.1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [24, 25, 32, 128])
def test_rows_2_5_6_at_any_d_match_pallas(rng, dtype, d):
    tdt = TORCH_DTYPES[dtype]
    qkv, mask = _qkv(rng, 100, 2, d, dtype)
    want_o, want_lse = _packed_qkv_attention_lse(qkv, jnp.asarray(mask), interpret=True)
    got_o, got_lse = A.packed_qkv_attention_lse(t(qkv, tdt), t(mask))
    _close(got_o, want_o, dtype, "packed")
    np.testing.assert_allclose(f32(got_lse), f32(want_lse), atol=2e-5 if dtype == "float32" else 1e-3)
    q, k, v = (qkv[:, :, i].transpose(0, 2, 1, 3) for i in range(3))
    want_o, want_lse = _mha_attention_lse(q, k, v, jnp.asarray(mask), interpret=True)
    got_o, got_lse = A.mha_attention(*(t(x, tdt) for x in (q, k, v)), t(mask))
    _close(got_o, want_o, dtype, "packed")
    qkv, mask = _qkv(rng, 600, 2, d, dtype)
    q, k, v = (qkv[:, :, i].transpose(0, 2, 1, 3) for i in range(3))
    want_o, want_lse = _flash_attention_lse(q, k, v, jnp.asarray(mask), interpret=True)
    got_o, got_lse = A.flash_attention_lse(t(qkv, tdt), t(mask))
    _close(got_o.reshape(2, 600, 2, d).permute(0, 2, 1, 3), want_o, dtype, "flash")
    np.testing.assert_allclose(f32(got_lse), f32(want_lse), atol=3e-5 if dtype == "float32" else 1e-3)


@pytest.mark.parametrize("d", [25, 128])
def test_packed_qkv_attention_has_jaxs_contract(rng, d):
    """JAX's ``packed_qkv_attention(qkv, key_mask)``: o alone, and
    differentiable (tests/test_pallas_attention.py calls it so)."""
    qkv, mask = _qkv(rng, 60, 2, d, "float32")
    mask[1, :10] = 1.0  # a valid key in each row: the einsum-free gradient stays O(1)
    w = rng.normal(size=(2, 60, 2 * d)).astype(np.float32)
    want = jax_packed_qkv_attention(qkv, jnp.asarray(mask), True)
    want_g = jax.grad(lambda x: jnp.sum(jax_packed_qkv_attention(x, jnp.asarray(mask), True) * w))(qkv)
    leaf = t(qkv).requires_grad_(True)
    got = A.packed_qkv_attention(leaf, t(mask))
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == (2, 60, 2 * d)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(f32(leaf.grad), f32(want_g), atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_has_jaxs_contract(rng, dtype):
    """JAX's ``flash_attention(q, k, v, key_mask)`` on [B, H, T, D] → o."""
    jdt, tdt = jnp.dtype(dtype), TORCH_DTYPES[dtype]
    q, k, v = (jnp.asarray(rng.normal(size=(2, 2, 300, 32)).astype(np.float32)).astype(jdt) for _ in range(3))
    mask = np.ones((2, 300), np.float32)
    mask[1, 200:] = 0.0
    want = jax_flash_attention(q, k, v, jnp.asarray(mask), interpret=True)
    got = A.flash_attention(t(q, tdt), t(k, tdt), t(v, tdt), t(mask))
    assert isinstance(got, torch.Tensor) and got.dtype == tdt and tuple(got.shape) == (2, 2, 300, 32)
    _close(got, want, dtype, "flash")

