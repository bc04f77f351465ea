"""Head dims above 128 on the CPU: the plain versions against JAX, and the
card path's routing.

JAX's wrappers serve any head dim D (they pad D to 64 or 128), and so do
the port's: above 128 every bf16 attention row runs the tensor-core
kernels of ``csrc/attention_wide_mma.cu`` (rows 1, 2, 5, 6, 7 and 8) and
``csrc/attention_bwd_wide.cu`` (rows 3 and 4), at any D (above D = 512 the
tiles held over all of D are streamed), every f32 one the
D-tiled kernels of ``csrc/attention_wide.cu`` and
``csrc/attention_bwd_f32.cu``, and rows 7 and 8 take weights padded once
per head to the next multiple of 128 (``block_head_dim``,
``pad_block_weights``). Here:

- the plain versions of rows 5, 8 and 3 + 4 at D = 160 and 256, of rows
  1, 2, 6 and 7 at D = 192 (row 6 at T = 130: two 128-key blocks), and of
  rows 1 and 3 + 4 at D = 640 (one head), against JAX's Pallas kernels in
  interpret mode, at T ≤ 40;
- the padding of row 8's weights at D = 160 (DP 256);
- the card path at D up to 1024: each wrapper, given tensors on the
  ``meta`` device and a stand-in for the kernel library that records its
  calls, raises nothing and calls its C entry point with the (8-padded)
  head dim and the scale of the unpadded D, and counts a bf16 launch above
  D = 128 in the tensor-core kernels' counters (``wide_mma``,
  ``wide_bwd_dq``, ``wide_bwd_dkv``), above D = 512 too; in f32 the
  forward above 128 passes the wide kernel's plan (``wide_f32``) and the
  backward is the one pass at every D (``wide_onepass_f32`` above 64). The
  kernels themselves run only on the card (``chip_smoke.py`` phase 22).

Tolerances are those of tests/test_torch_kernels.py (row 8: f32 5e-5),
test_torch_head_dims.py (rows 1, 2 and 5: f32 2e-5, row 6 3e-5; bf16 atol
0.15, rtol 0.1; the lse 1e-3 in bf16), test_torch_int8.py (row 7: within 4
bf16 steps of the largest output, the median error 0, at most 5% of the
rows off) and test_torch_attention_bwd.py (rows 3 and 4 in f32: 2e-4).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tpu.ops.pallas.attention import _flash_attention_lse, _fused_attention_lse, _mha_attention_lse
from msa_tpu.ops.pallas.attention import _packed_qkv_attention_lse
from msa_tpu.ops.pallas.attention import attention_block as jax_attention_block
from msa_tpu.ops.pallas.attention import attention_bwd as jax_attention_bwd
from msa_tpu_torch.ops import quant as Q
from msa_tpu_torch.ops.kernels import attention as A
from torch_parity import TORCH_DTYPES, f32, t

WIDE = [160, 256]
HEADS = {160: 4, 256: 2}  # d_model 640 and 512: multiples of 128, as attention_block takes


def _mask(b, T):
    mask = np.ones((b, T), np.float32)
    mask[0, T * 3 // 4 :] = 0.0  # a ragged valid length
    mask[1, :] = 0.0  # no valid key
    return mask


def test_block_head_dim_above_128():
    assert A.block_head_dim(192) == 256
    assert [A.block_head_dim(d) for d in (129, 160, 255, 256, 300, 512)] == [256, 256, 256, 256, 384, 512]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", WIDE)
def test_row5_plain_matches_pallas_at_wide_heads(rng, dtype, d):
    qkv = jnp.asarray(rng.normal(size=(2, 40, 3, 2, d)).astype(np.float32)).astype(dtype)
    mask = _mask(2, 40)
    want_o, want_lse = _packed_qkv_attention_lse(qkv, jnp.asarray(mask), interpret=True)
    got_o, got_lse = A.packed_qkv_attention_lse(t(qkv, TORCH_DTYPES[dtype]), t(mask))
    assert tuple(got_o.shape) == (2, 40, 2 * d)
    if dtype == "float32":
        np.testing.assert_allclose(f32(got_o), f32(want_o), atol=2e-5)
        np.testing.assert_allclose(f32(got_lse), f32(want_lse), atol=2e-5)
    else:
        np.testing.assert_allclose(f32(got_o), f32(want_o), atol=0.15, rtol=0.1)
        np.testing.assert_allclose(f32(got_lse), f32(want_lse), atol=1e-3)


def _block(rng, d):
    h = HEADS[d]
    dm = h * d
    x = rng.normal(size=(2, 40, dm)).astype(np.float32)
    w_qkv = (rng.normal(size=(dm, 3 * dm)) / np.sqrt(dm)).astype(np.float32)  # flax's [in, out]
    b_qkv = (0.1 * rng.normal(size=3 * dm)).astype(np.float32)
    w_out = (rng.normal(size=(dm, dm)) / np.sqrt(dm)).astype(np.float32)
    b_out = (0.1 * rng.normal(size=dm)).astype(np.float32)
    return h, x, w_qkv, b_qkv, w_out, b_out


@pytest.mark.parametrize("d", WIDE)
def test_row8_plain_matches_pallas_at_wide_heads(rng, d):
    """attention_block on weights padded to DP = 256 (the card's layout),
    with the unpadded D's scale, against JAX's kernel on the unpadded ones."""
    h, x, w_qkv, b_qkv, w_out, b_out = _block(rng, d)
    mask = _mask(2, 40)
    want = f32(jax_attention_block(jnp.asarray(x), w_qkv, b_qkv, w_out, b_out, mask, h, True))
    pw, pb, po, _ = A.pad_block_weights(t(w_qkv.T), t(b_qkv), t(w_out.T), h)
    assert pw.shape[0] == 3 * h * 256
    got = f32(A.attention_block(t(x), pw, pb, po, t(b_out), t(mask), h, head_dim=d))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("d", WIDE)
def test_rows_3_and_4_plain_match_pallas_at_wide_heads(rng, d):
    q, k, v, g = (jnp.asarray(rng.normal(size=(2, 2, 40, d)).astype(np.float32)) for _ in range(4))
    mask = jnp.asarray(_mask(2, 40))
    o, lse = _mha_attention_lse(q, k, v, mask, interpret=True)
    want = jax_attention_bwd(q, k, v, mask, lse, o, g, interpret=True)
    got = A.attention_bwd(t(q), t(k), t(v), t(mask), t(lse), t(o), t(g))
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        assert tuple(gt.shape) == (2, 2, 40, d)
        np.testing.assert_allclose(f32(gt), f32(wt), atol=2e-4, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("row", ["1", "3 + 4"])
def test_rows_1_and_3_4_plain_match_pallas_at_head_dim_640(rng, row, dtype):
    """Row 1 (fused_attention) and rows 3 + 4 (attention_bwd) at D = 640,
    one head, T = 40: above the old D ≤ 512 limit of the bf16 kernels,
    their plain versions on the CPU against JAX's."""
    d, h, T = 640, 1, 40
    q, k, v, g = (jnp.asarray(rng.normal(size=(2, h, T, d)).astype(np.float32)).astype(dtype) for _ in range(4))
    mask = _mask(2, T)
    tq, tk, tv, tg = (t(x, TORCH_DTYPES[dtype]) for x in (q, k, v, g))
    if row == "1":
        want_o, want_lse = _fused_attention_lse(q, k, v, jnp.asarray(mask), interpret=True)
        got_o, got_lse = A.fused_attention_lse(tq, tk, tv, t(mask))
        assert tuple(got_o.shape) == (2, h, T, d) and got_o.dtype == TORCH_DTYPES[dtype]
        if dtype == "float32":
            np.testing.assert_allclose(f32(got_o), f32(want_o), atol=2e-5)
            np.testing.assert_allclose(f32(got_lse), f32(want_lse), atol=2e-5)
        else:
            np.testing.assert_allclose(f32(got_o), f32(want_o), atol=0.15, rtol=0.1)
            np.testing.assert_allclose(f32(got_lse), f32(want_lse), atol=1e-3)
        return
    o, lse = _mha_attention_lse(q, k, v, jnp.asarray(mask), interpret=True)
    want = jax_attention_bwd(q, k, v, jnp.asarray(mask), lse, o, g, interpret=True)
    to = t(o, TORCH_DTYPES[dtype])
    got = A.attention_bwd(tq, tk, tv, t(mask), t(lse), to, tg)
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        assert tuple(gt.shape) == (2, h, T, d) and gt.dtype == TORCH_DTYPES[dtype]
        if dtype == "float32":
            np.testing.assert_allclose(f32(gt), f32(wt), atol=2e-4, err_msg=name)
        else:  # both round dS and Pᵀ to bf16 before the products: the row-2 bound
            np.testing.assert_allclose(f32(gt), f32(wt), atol=0.15, rtol=0.1, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("row", ["1", "2", "6"])
def test_rows_1_2_6_plain_match_pallas_at_head_dim_192(rng, row, dtype):
    """Rows 1 (fused_attention), 2 (mha_attention) and 6
    (flash_attention_lse, at T = 130: two 128-key blocks of the online
    order) at D = 192, the kernels' plain versions on the CPU against
    JAX's."""
    d, h, T = 192, 2, 130 if row == "6" else 40
    q, k, v = (jnp.asarray(rng.normal(size=(2, h, T, d)).astype(np.float32)).astype(dtype) for _ in range(3))
    mask = _mask(2, T)
    tq, tk, tv = (t(x, TORCH_DTYPES[dtype]) for x in (q, k, v))
    if row == "6":
        want_o, want_lse = _flash_attention_lse(q, k, v, jnp.asarray(mask), interpret=True)
        got_o, got_lse = A.flash_attention_lse(A._to_packed(tq, tk, tv), t(mask))
        got_o = got_o.reshape(2, T, h, d).permute(0, 2, 1, 3)
    elif row == "1":
        want_o, want_lse = _fused_attention_lse(q, k, v, jnp.asarray(mask), interpret=True)
        got_o, got_lse = A.fused_attention_lse(tq, tk, tv, t(mask))
    else:
        want_o, want_lse = _mha_attention_lse(q, k, v, jnp.asarray(mask), interpret=True)
        got_o, got_lse = A.mha_attention(tq, tk, tv, t(mask))
    assert tuple(got_o.shape) == (2, h, T, d) and got_o.dtype == TORCH_DTYPES[dtype]
    if dtype == "float32":
        atol = 3e-5 if row == "6" else 2e-5
        np.testing.assert_allclose(f32(got_o), f32(want_o), atol=atol)
        np.testing.assert_allclose(f32(got_lse), f32(want_lse), atol=atol)
    else:
        np.testing.assert_allclose(f32(got_o), f32(want_o), atol=0.15, rtol=0.1)
        np.testing.assert_allclose(f32(got_lse), f32(want_lse), atol=1e-3)


def test_row7_plain_matches_pallas_at_head_dim_192(rng):
    """attention_block_int8 on bf16 x at D = 192 (d_model 768, 4 heads),
    its int8 weights padded to DP = 256 (the card's layout), against JAX's
    ``attention_block(int8=True)`` on the unpadded f32 masters."""
    d, h = 192, 4
    dm = h * d
    x = rng.normal(size=(2, 40, dm)).astype(np.float32)
    w_qkv = (rng.normal(size=(dm, 3 * dm)) / np.sqrt(dm)).astype(np.float32)  # flax's [in, out]
    b_qkv = (0.1 * rng.normal(size=3 * dm)).astype(np.float32)
    w_out = (rng.normal(size=(dm, dm)) / np.sqrt(dm)).astype(np.float32)
    b_out = (0.1 * rng.normal(size=dm)).astype(np.float32)
    mask = _mask(2, 40)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = f32(jax_attention_block(xj, w_qkv, b_qkv, w_out, b_out, mask, h, True, int8=True))
    wq, sq = Q.quantize_weight_axis(t(w_qkv.T), axis=1)
    wo, so = Q.quantize_weight_axis(t(w_out.T), axis=1)
    sq, so = sq[:, 0].contiguous(), so[:, 0].contiguous()
    pwq, pbq, pwo, psq = A.pad_block_weights(wq, t(b_qkv), wo, h, sq)
    assert pwq.shape == (3 * h * 256, dm)
    got = f32(A.attention_block_int8(t(f32(xj), torch.bfloat16), pwq, psq, pbq, pwo, so, t(b_out), t(mask), h, head_dim=d))
    assert np.isfinite(got).all()
    err = np.abs(got - want)
    assert err.max() <= 4 * 2.0**-8 * np.abs(want).max(), err.max()
    rows = (err > 0).reshape(-1, err.shape[-1]).any(-1)
    assert np.median(err) == 0.0 and rows.mean() <= 0.05, rows.mean()


def test_pad_block_weights_at_160(rng):
    """D = 160 pads to DP = 256: each head's rows of w_qkv and b_qkv (and
    the int8 scales, with 1.0) get 96 zero rows, w_out 96 zero columns; the
    f32 block is unchanged and the W8A8 block bit for bit."""
    d, h = 160, 4
    dm = h * d
    w_qkv = torch.from_numpy((rng.normal(size=(3 * dm, dm)) / np.sqrt(dm)).astype(np.float32))
    b_qkv = torch.from_numpy((0.1 * rng.normal(size=3 * dm)).astype(np.float32))
    w_out = torch.from_numpy((rng.normal(size=(dm, dm)) / np.sqrt(dm)).astype(np.float32))
    b_out = torch.from_numpy((0.1 * rng.normal(size=dm)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 30, dm)).astype(np.float32))
    mask = torch.from_numpy(_mask(2, 30))
    pw, pb, po, _ = A.pad_block_weights(w_qkv, b_qkv, w_out, h)
    assert pw.shape == (3 * h * 256, dm) and po.shape == (dm, h * 256)
    w4 = pw.view(3, h, 256, dm)
    assert torch.equal(w4[:, :, :d], w_qkv.view(3, h, d, dm)) and not w4[:, :, d:].any()
    assert not pb.view(3, h, 256)[:, :, d:].any() and not po.view(dm, h, 256)[:, :, d:].any()
    want = A.attention_block_plain(x, w_qkv, b_qkv, w_out, b_out, mask, h)
    got = A.attention_block(x, pw, pb, po, b_out, mask, h, head_dim=d)
    assert (got - want).abs().max().item() <= 1e-6
    wq, sq = Q.quantize_weight_axis(w_qkv, axis=1)
    wo, so = Q.quantize_weight_axis(w_out, axis=1)
    sq, so = sq[:, 0].contiguous(), so[:, 0].contiguous()
    pwq, pbq, pwo, psq = A.pad_block_weights(wq, b_qkv, wo, h, sq)
    assert pwq.dtype == torch.int8 and bool((psq.view(3, h, 256)[:, :, d:] == 1.0).all())
    xb = x.bfloat16()
    want8 = A.attention_block_int8_plain(xb, wq, sq, b_qkv, wo, so, b_out, mask, h)
    assert torch.equal(A.attention_block_int8(xb, pwq, psq, pbq, pwo, so, b_out, mask, h, head_dim=d), want8)


# --- the card path's routing, on meta tensors ---------------------------------------


class _Library:
    """Stands in for the kernel library: records each entry point's name and
    arguments, returns 0 (no CUDA error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("msa_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def card(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(A.build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=0))
    return lib


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _attend_calls(d, dtype):
    """(wrapper, call, [(entry, index of D in its args)], its counter)"""
    dp = -(-d // 8) * 8
    sfx = "launches" if dtype == torch.bfloat16 else "launches_f32"
    q, k, v = (_meta(1, 2, 40, d, dtype=dtype) for _ in range(3))
    mask = _meta(1, 40)
    bf = dtype == torch.bfloat16
    return dp, [
        (A.packed_qkv_attention_lse, lambda: A.packed_qkv_attention_lse(_meta(1, 40, 3, 2, d, dtype=dtype), mask),
         [("msa_packed_qkv_attention" if bf else "msa_packed_attention_f32", 7)], sfx),
        (A.flash_attention_lse, lambda: A.flash_attention_lse(_meta(1, 600, 3, 2, d, dtype=dtype), _meta(1, 600)),
         [("msa_flash_attention" if bf else "msa_packed_attention_f32", 7)], sfx),
        (A.mha_attention, lambda: A.mha_attention(q, k, v, mask), [("msa_mha_attention" if bf else "msa_fused_attention", 9)], sfx),
        (A.fused_attention_lse, lambda: A.fused_attention_lse(q, k, v, mask), [("msa_fused_attention", 9)], "launches"),
        (A.attention_bwd_dq if bf else A.attention_bwd_onepass,
         lambda: A.attention_bwd(q, k, v, mask, _meta(1, 2, 40), _meta(1, 2, 40, d, dtype=dtype), _meta(1, 2, 40, d, dtype=dtype)),
         [("msa_attention_bwd_dq", 11), ("msa_attention_bwd_dkv", 12)] if bf else [("msa_attention_bwd_onepass_f32", 14)],
         sfx if bf else "launches"),
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [96, 128, 136, 160, 201, 256, 512, 768, 1024])
def test_attention_wrappers_take_wide_heads_on_the_card_path(card, dtype, d):
    """No error at any D: each wrapper calls its entry point with D padded
    to a multiple of 8 and the unpadded D's scale; the f32 backward is the
    one pass at every D (rows 3 and 4 in one launch)."""
    dp, cases = _attend_calls(d, TORCH_DTYPES[dtype])
    for fn, call, entries, counter in cases:
        before, card.calls[:] = getattr(fn, counter), []
        call()
        assert [name for name, _ in card.calls] == [name for name, _ in entries], fn.__name__
        for (name, args), (_, at) in zip(card.calls, entries):
            assert args[at] == dp, (name, args[at])
            assert args[-2] == float(np.float32(1.0 / np.sqrt(d))), name
        assert getattr(fn, counter) == before + 1, fn.__name__


@pytest.mark.parametrize("recipe", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("d", [160, 192, 256, 512])
def test_attention_block_takes_wide_heads_on_the_card_path(card, recipe, d):
    """Rows 7, 8 and 8 in f32 at D above 128: weights padded to DP (a
    multiple of 128), the entry called with DP and the unpadded D's scale."""
    h, dp = 2, A.block_head_dim(d)
    dm = -(-h * d // 128) * 128
    dtype = torch.float32 if recipe == "float32" else torch.bfloat16
    x, mask = _meta(1, 40, dm, dtype=dtype), _meta(1, 40)
    b_qkv, b_out = _meta(3 * h * dp), _meta(dm)
    if recipe == "int8":
        w_qkv, w_out = _meta(3 * h * dp, dm, dtype=torch.int8), _meta(dm, h * dp, dtype=torch.int8)
        out = A.attention_block_int8(x, w_qkv, _meta(3 * h * dp), b_qkv, w_out, _meta(dm), b_out, mask, h, d)
        entry, at = "msa_attention_block_int8", 21
    else:
        w_qkv, w_out = _meta(3 * h * dp, dm, dtype=dtype), _meta(dm, h * dp, dtype=dtype)
        out = A.attention_block(x, w_qkv, b_qkv, w_out, b_out, mask, h, d)
        entry, at = ("msa_attention_block_f32", 16) if recipe == "float32" else ("msa_attention_block", 15)
    assert tuple(out.shape) == (1, 40, dm)
    (name, args), = card.calls
    assert name == entry and args[at] == dp and args[-2] == float(np.float32(1.0 / np.sqrt(d)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 136, 192, 512])
def test_wide_kernel_counters_on_the_card_path(card, dtype, d):
    """Each wrapper counts a bf16 launch above D = 128 in the tensor-core
    kernels' counters (the forward in ``wide_mma``, rows 3 and 4 in
    ``wide_bwd_dq`` and ``wide_bwd_dkv``), an f32 forward above 128 in
    ``wide_f32`` and an f32 backward above 64 in ``wide_onepass_f32``, and
    nothing else; rows 7 and 8 count their core there too."""
    tdt = TORCH_DTYPES[dtype]
    wide = dtype == "bfloat16" and d > 128
    wide_f32, wide_bwd_f32 = dtype == "float32" and d > 128, dtype == "float32" and d > 64
    counters = (A.wide_mma, A.wide_bwd_dq, A.wide_bwd_dkv, A.wide_f32, A.wide_onepass_f32)
    _, cases = _attend_calls(d, tdt)
    for fn, call, entries, _ in cases:
        before = [c.launches for c in counters]
        call()
        after = [c.launches for c in counters]
        bwd = fn in (A.attention_bwd_dq, A.attention_bwd_onepass)
        want = [0, wide, wide, 0, wide_bwd_f32] if bwd else [wide, 0, 0, wide_f32, 0]
        assert [a - b_ for a, b_ in zip(after, before)] == want, fn.__name__
    h, dp = 2, A.block_head_dim(d)
    dm = -(-h * d // 128) * 128
    x, mask = _meta(1, 40, dm, dtype=tdt), _meta(1, 40)
    before = A.wide_mma.launches, A.wide_f32.launches
    A.attention_block(x, _meta(3 * h * dp, dm, dtype=tdt), _meta(3 * h * dp), _meta(dm, h * dp, dtype=tdt), _meta(dm), mask, h, d)
    A.attention_block_int8(x, _meta(3 * h * dp, dm, dtype=torch.int8), _meta(3 * h * dp), _meta(3 * h * dp),
                           _meta(dm, h * dp, dtype=torch.int8), _meta(dm), _meta(dm), mask, h, d)
    assert (A.wide_mma.launches, A.wide_f32.launches) == (before[0] + 2 * wide, before[1] + 2 * wide_f32)


def _reaches_wide_kernels(card, what, d):
    """Above D = 512, where the kernels stream the tiles they held over all
    of D, a bf16 head raises nothing: each entry point is called once with
    D, and the tensor-core kernels count the launch (rows 7/8's block at
    head dim d + 56, padded to DP = 640 or 1152)."""
    bf16 = torch.bfloat16
    q, k, v = (_meta(1, 2, 40, d, dtype=bf16) for _ in range(3))
    mask = _meta(1, 40)
    dh = d + 56
    dp, dm = A.block_head_dim(dh), -(-2 * dh // 128) * 128
    # (call, [(entry, index of D in its args)], launches of wide_mma, wide_bwd_dq, wide_bwd_dkv)
    calls = {
        "packed": (lambda: A.packed_qkv_attention_lse(_meta(1, 40, 3, 2, d, dtype=bf16), mask),
                   [("msa_packed_qkv_attention", 7)], [1, 0, 0]),
        "flash": (lambda: A.flash_attention_lse(_meta(1, 600, 3, 2, d, dtype=bf16), _meta(1, 600)),
                  [("msa_flash_attention", 7)], [1, 0, 0]),
        "mha": (lambda: A.mha_attention(q, k, v, mask), [("msa_mha_attention", 9)], [1, 0, 0]),
        "fused": (lambda: A.fused_attention_lse(q, k, v, mask), [("msa_fused_attention", 9)], [1, 0, 0]),
        "bwd": (lambda: A.attention_bwd(q, k, v, mask, _meta(1, 2, 40), _meta(1, 2, 40, d, dtype=bf16),
                                        _meta(1, 2, 40, d, dtype=bf16)),
                [("msa_attention_bwd_dq", 11), ("msa_attention_bwd_dkv", 12)], [0, 1, 1]),
        "block": (lambda: A.attention_block(_meta(1, 40, dm, dtype=bf16), _meta(3 * 2 * dp, dm, dtype=bf16),
                                            _meta(3 * 2 * dp), _meta(dm, 2 * dp, dtype=bf16), _meta(dm), mask, 2, dh),
                  [("msa_attention_block", 15)], [1, 0, 0]),
    }
    call, entries, wide = calls[what]
    before = [c.launches for c in (A.wide_mma, A.wide_bwd_dq, A.wide_bwd_dkv)]
    call()
    after = [c.launches for c in (A.wide_mma, A.wide_bwd_dq, A.wide_bwd_dkv)]
    assert [name for name, _ in card.calls] == [name for name, _ in entries]
    for (name, args), (_, at) in zip(card.calls, entries):
        assert args[at] == (dp if what == "block" else d), (name, args[at])
    assert [a - b_ for a, b_ in zip(after, before)] == wide


@pytest.mark.parametrize("what", ["packed", "flash", "mha", "fused", "bwd", "block"])
def test_bf16_at_520_reaches_the_wide_kernels_on_the_card_path(card, what):
    """bf16 at D = 520 (the block at head dim 576) is no longer refused:
    it reaches the tensor-core kernels (:func:`_reaches_wide_kernels`)."""
    _reaches_wide_kernels(card, what, 520)


@pytest.mark.parametrize("what", ["packed", "flash", "mha", "fused", "bwd", "block"])
def test_bf16_at_1024_reaches_the_wide_kernels_on_the_card_path(card, what):
    """The same at D = 1024 (the block at head dim 1080, DP 1152), where
    the backward's owned tiles no longer fit resident."""
    _reaches_wide_kernels(card, what, 1024)


@pytest.mark.parametrize("d", [128, 192, 256, 640])
def test_f32_forward_passes_the_wide_plan_on_the_card_path(card, d):
    """Every f32 forward entry gets the wide kernel's plan, tickets and
    workspace just before the scale: the planner's code above D = 128 (the
    buffers null without a split, live with one), zeros at or below it."""
    from msa_tpu_torch.ops.kernels import attention_wide_plan as WP

    q, k, v = (_meta(2, 2, 100, d) for _ in range(3))
    mask = _meta(2, 100)
    h, dp = 2, A.block_head_dim(d)
    dm = -(-h * d // 128) * 128
    x = _meta(2, 100, dm)
    calls = [
        (lambda: A.mha_attention(q, k, v, mask), 2, 100, d),
        (lambda: A.fused_attention_lse(q, k, v, mask), 2, 100, d),
        (lambda: A.packed_qkv_attention_lse(_meta(2, 100, 3, 2, d), mask), 2, 100, d),
        (lambda: A.flash_attention_lse(_meta(2, 600, 3, 2, d), _meta(2, 600)), 2, 600, d),
        (lambda: A.attention_block(x, _meta(3 * h * dp, dm), _meta(3 * h * dp), _meta(dm, h * dp), _meta(dm), mask, h, d),
         2, 128, dp),
        (lambda: A.attention_block_int8(x, _meta(3 * h * dp, dm, dtype=torch.int8), _meta(3 * h * dp), _meta(3 * h * dp),
                                        _meta(dm, h * dp, dtype=torch.int8), _meta(dm), _meta(dm), mask, h, d), 2, 128, dp),
    ]
    for call, b, t_, dk in calls:
        card.calls.clear()
        call()
        (name, args), = card.calls
        code, tickets, ws = args[-5:-2]
        if dk <= 128:
            assert (code, tickets, ws) == (0, 0, 0), name
            continue
        p = WP.plan(b, h, t_, dk)
        assert code == p.code, (name, code, p)
        assert (tickets, ws) == (0, 0) if p.splits == 1 else True, name
