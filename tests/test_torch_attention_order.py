"""The order of operations of the flash (row 6) and packed-QKV (rows 5 and
2) CUDA kernels, modelled in plain torch and held against the plain
versions the kernels are checked against on the card.

The kernels (``msa_tpu_torch/csrc/attention_mma.cuh``) keep each warp's 16
query rows in ``mma.sync.m16n8k16`` tiles: a score is summed over 16-column
slices of D in order, P·V over 16-key slices in order, and a row's max or
sum is taken by each of the 4 lanes of a quad over its own columns (8n + 2j
and 8n + 2j + 1 for lane j) and then combined across the quad (xor 1, then
xor 2). On top of that:

- rows 5 and 2 run two passes over 64-key tiles: pass 1 keeps the row max m
  and the denominator l online (l rescaled by exp(m_old − m_new) when the
  max moves), pass 2 recomputes the scores and accumulates bf16(exp(s − m)
  / l) · V, where the plain version takes the exact Σ exp(s − m);
- row 6 sums each 128-key block's P·V in an accumulator of its own and adds
  it as acc·α + pv, as the plain version does;
- the attention core of rows 7 and 8 (``attention_block[_int8]``) runs
  rows 5 and 2's two passes in its own order: pass 2 accumulates the
  unnormalised bf16(exp(s − m)) · V, and o / l comes after P·V, rounded
  once; held against the plain core (``_attend``) alone, and with the model
  in its place inside both blocks' plain versions at head dims 32, 64 and
  128, as the smoke holds rows 7 and 8.

Rows 5 and 2 divide by l as q = p·r with r = RN(1/l), then one FMA step on
the exact remainder (``div_rn`` in attention_packed.cu); a test below holds
that sequence to the correctly rounded quotient, so the models divide.

The models below follow that order in f32 on the CPU, so these tests show
without a card that the kernels' order stays inside the bounds the smoke
holds them to: ``KERNEL_RTOL`` of the largest output (+ 1e-3) on o and
``LSE_ATOL`` on the lse (chip_smoke.py). Inputs are bf16 from a numpy seed,
with a ragged valid length and a batch row with no valid key.
"""

import importlib.util
import math
import pathlib
from fractions import Fraction

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from msa_tpu_torch.ops.kernels import attention as A

import torch_parity  # noqa: F401  (its import shares the CPU among xdist workers)

_SPEC = importlib.util.spec_from_file_location("chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
_SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(_SMOKE)
KERNEL_RTOL, LSE_ATOL = _SMOKE.KERNEL_RTOL, _SMOKE.LSE_ATOL


def _inputs(seed, b, t, h, d):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(b, t, 3, h, d)).astype(np.float32)).to(torch.bfloat16)
    mask = np.ones((b, t), np.float32)
    mask[0, t * 2 // 3 :] = 0.0  # a ragged valid length
    mask[1] = 0.0  # a row with no valid key
    return qkv, torch.from_numpy(mask)


def _operands(qkv, key_mask):
    """→ q, k, v [B, H, T_pad, DP] f32 (T padded to a multiple of 128, D
    to the kernel's DP with zeros), the mask bias [B, T_pad], T_pad."""
    b, t, _, h, d = qkv.shape
    dp = 32 if d <= 32 else 64 if d <= 64 else 128
    t_pad = -(-t // 128) * 128
    qkv = F.pad(qkv.float(), (0, dp - d, 0, 0, 0, 0, 0, t_pad - t))
    bias = torch.where(F.pad(key_mask, (0, t_pad - t)) > 0, 0.0, -1e9)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    return q, k, v, bias, t_pad


def _scores(q, k, bias, k0, nk, scale):
    """s = (Q·Kᵀ)·scale + bias over keys [k0, k0 + nk), Q·Kᵀ summed over
    16-column slices of D in order, as the mma steps do."""
    kb = k[:, :, k0 : k0 + nk]
    dots = torch.zeros(q.shape[:3] + (nk,))
    for c in range(0, q.shape[-1], 16):
        dots = dots + q[..., c : c + 16] @ kb[..., c : c + 16].transpose(-1, -2)
    return dots * scale + bias[:, None, None, k0 : k0 + nk]


def _pv(p, v, k0, nk):
    """P·V over keys [k0, k0 + nk), summed over 16-key slices in order."""
    out = torch.zeros(p.shape[:3] + (v.shape[-1],))
    for c in range(0, nk, 16):
        out = out + p[..., c : c + 16] @ v[:, :, k0 + c : k0 + c + 16]
    return out


def _quad(x, op):
    """A row reduction as a quad of lanes takes it: lane j reduces columns
    8n + 2j and 8n + 2j + 1 in order, then xor 1, then xor 2."""
    nk = x.shape[-1]
    cols = x.reshape(x.shape[:-1] + (nk // 8, 4, 2)).transpose(-3, -2).reshape(x.shape[:-1] + (4, nk // 4))
    lanes = cols[..., 0]
    for i in range(1, nk // 4):
        lanes = op(lanes, cols[..., i])
    pair = op(lanes[..., 0::2], lanes[..., 1::2])  # xor 1: (0, 1), (2, 3)
    return op(pair[..., 0], pair[..., 1])[..., None]  # xor 2


def _finish(o, lse, t, h, d, dt):
    b, _, t_pad, _ = o.shape
    o = o[..., :d].to(dt).permute(0, 2, 1, 3).reshape(b, t_pad, h * d)
    return o[:, :t], lse[..., 0][:, :, :t]


def packed_order_model(qkv, key_mask, tile=64):
    """Rows 5 and 2 as the kernel orders them: pass 1 online (m, l) over
    64-key tiles, pass 2 bf16(exp(s − m) / l) · V."""
    b, t, _, h, d = qkv.shape
    q, k, v, bias, t_pad = _operands(qkv, key_mask)
    scale = A._scale(d)
    m = torch.full((b, h, t_pad, 1), -1e30)
    l = torch.zeros_like(m)
    for k0 in range(0, t_pad, tile):
        s = _scores(q, k, bias, k0, tile, scale)
        m_new = torch.maximum(m, _quad(s, torch.maximum))
        l = l * torch.exp(m - m_new) + _quad(torch.exp(s - m_new), torch.add)
        m = m_new
    o = torch.zeros_like(q)
    for k0 in range(0, t_pad, tile):
        p = (torch.exp(_scores(q, k, bias, k0, tile, scale) - m) / l).to(qkv.dtype).float()
        o = o + _pv(p, v, k0, tile)
    return _finish(o, m + torch.log(l), t, h, d, qkv.dtype)


def flash_order_model(qkv, key_mask, block=A.FLASH_BLOCK_K):
    """Row 6 as the kernel orders it: per 128-key block m_cur, α, p, l = α·l
    + Σp, and acc = acc·α + pv with the block's pv summed on its own."""
    b, t, _, h, d = qkv.shape
    q, k, v, bias, t_pad = _operands(qkv, key_mask)
    scale = A._scale(d)
    m = torch.full((b, h, t_pad, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for k0 in range(0, t_pad, block):
        s = _scores(q, k, bias, k0, block, scale)
        m_cur = torch.maximum(m, _quad(s, torch.maximum))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur)
        l = alpha * l + _quad(p, torch.add)
        acc = acc * alpha + _pv(p.to(qkv.dtype).float(), v, k0, block)
        m = m_cur
    l = torch.clamp_min(l, 1e-30)
    return _finish(acc / l, m + torch.log(l), t, h, d, qkv.dtype)


def block_core_order_model(qkv, key_mask, num_heads, dt, scale, tile=64):
    """The core of rows 7 and 8 as the kernel orders it, on ``_attend``'s
    arguments (qkv [B, T, 3·H·DP], T a multiple of 128): pass 1 online
    (m, l) over 64-key tiles, pass 2 bf16(exp(s − m)) · V, then o / l."""
    b, t, w3 = qkv.shape
    q, k, v, bias, _ = _operands(qkv.view(b, t, 3, num_heads, w3 // (3 * num_heads)), key_mask)
    m = torch.full((b, num_heads, t, 1), -1e30)
    l = torch.zeros_like(m)
    for k0 in range(0, t, tile):
        s = _scores(q, k, bias, k0, tile, scale)
        m_new = torch.maximum(m, _quad(s, torch.maximum))
        l = l * torch.exp(m - m_new) + _quad(torch.exp(s - m_new), torch.add)
        m = m_new
    o = torch.zeros_like(q)
    for k0 in range(0, t, tile):
        o = o + _pv(torch.exp(_scores(q, k, bias, k0, tile, scale) - m).to(torch.bfloat16).float(), v, k0, tile)
    return (o / l).to(dt).permute(0, 2, 1, 3).reshape(b, t, -1)


def _check(got, want):
    (o, lse), (po, plse) = got, want
    assert o.shape == po.shape and lse.shape == plse.shape
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    err = (o.float() - po.float()).abs().max().item()
    bound = KERNEL_RTOL * po.float().abs().max().item() + 1e-3
    assert err <= bound, f"o: max abs err {err:.4e} > {bound:.4e}"
    lse_err = (lse - plse).abs().max().item()
    assert lse_err <= LSE_ATOL, f"lse: max abs err {lse_err:.3e} > {LSE_ATOL}"


@pytest.mark.parametrize("t, h, d", [(40, 4, 24), (100, 3, 32), (200, 2, 64), (512, 2, 64)])
def test_packed_order_within_the_smoke_bounds(t, h, d):
    qkv, mask = _inputs(t + d, 2, t, h, d)
    _check(packed_order_model(qkv, mask), A.packed_qkv_attention_lse_plain(qkv, mask))


@pytest.mark.parametrize("t, h, d", [(100, 3, 24), (300, 2, 32), (749, 2, 64)])
def test_flash_order_within_the_smoke_bounds(t, h, d):
    qkv, mask = _inputs(t + d, 2, t, h, d)
    _check(flash_order_model(qkv, mask), A.flash_attention_lse_plain(qkv, mask))


@pytest.mark.parametrize("t", [128, 256, 512])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_block_core_order_within_the_smoke_bounds(t, d):
    """The core alone against the plain core, with the unpadded D's scale."""
    h = 2
    qkv, mask = _inputs(t + d, 2, t, h, d)
    qkv = qkv.float().reshape(2, t, 3 * h * d)
    got = block_core_order_model(qkv, mask, h, torch.bfloat16, A._scale(d))
    want = A._attend(qkv, mask, h, torch.bfloat16, A._scale(d))
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    bound = KERNEL_RTOL * want.float().abs().max().item() + 1e-3
    assert err <= bound, f"max abs err {err:.4e} > {bound:.4e}"


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dm, heads", [(128, 4), (128, 2), (256, 2)])  # D = 32, 64, 128
def test_rows_7_and_8_with_the_core_order_within_the_smoke_bounds(monkeypatch, int8, dm, heads):
    """attention_block and attention_block_int8 (bf16 x) with the core's
    order model in place of the plain core, against their plain versions at
    the bound phase 3 of the smoke holds the kernels to, at T = 200 (padded
    to 256) with a ragged row and a row with no valid key."""
    from msa_tpu_torch.ops import quant as Q

    rng = np.random.default_rng(dm + heads)
    t = 200

    def normal(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))

    x = normal(2, t, dm).to(torch.bfloat16)
    w_qkv, w_out = normal(3 * dm, dm, scale=dm**-0.5), normal(dm, dm, scale=dm**-0.5)
    b_qkv, b_out = normal(3 * dm, scale=0.02), normal(dm, scale=0.02)
    mask = torch.ones(2, t)
    mask[0, 150:] = 0.0
    mask[1] = 0.0
    if int8:
        (wq, sq), (wo, so) = (Q.quantize_weight_axis(w, axis=1) for w in (w_qkv, w_out))
        args, plain = (x, wq, sq[:, 0], b_qkv, wo, so[:, 0], b_out, mask, heads), A.attention_block_int8_plain
    else:
        args, plain = (x, w_qkv.to(torch.bfloat16), b_qkv, w_out.to(torch.bfloat16), b_out, mask, heads), A.attention_block_plain
    want = plain(*args)
    monkeypatch.setattr(A, "_attend", block_core_order_model)
    got = plain(*args)
    err = (got.float() - want.float()).abs().max().item()
    bound = KERNEL_RTOL * want.float().abs().max().item() + 1e-3
    assert torch.isfinite(got.float()).all() and err <= bound, f"max abs err {err:.4e} > {bound:.4e}"


def test_row2_takes_row5_order():
    """Row 2 is row 5's core on [B, H, T, D] operands: the same model holds
    against ``mha_attention_plain``."""
    qkv, mask = _inputs(7, 2, 100, 3, 32)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    o, lse = packed_order_model(qkv, mask)
    po, plse = A.mha_attention_plain(q, k, v, mask)
    _check((A._heads_first(o, 3), lse), (po, plse))


def test_quad_reduction_covers_every_column():
    """The quad model reduces each row over exactly its columns."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 3, 5, 64)).astype(np.float32))
    torch.testing.assert_close(_quad(x, torch.maximum), x.amax(-1, keepdim=True), rtol=0, atol=0)
    torch.testing.assert_close(_quad(x, torch.add), x.sum(-1, keepdim=True), rtol=1e-6, atol=1e-5)


def _rn32(x: Fraction) -> Fraction:
    """x rounded to the nearest float32 (ties to even), exactly; normal range."""
    if x == 0:
        return Fraction(0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = math.frexp(float(x))[1] - 1  # 2^e ≤ x < 2^(e+1), corrected below where float(x) rounded up
    if Fraction(2) ** e > x:
        e -= 1
    ulp = Fraction(2) ** (e - 23)
    n, rem = divmod(x, ulp)
    if rem > ulp / 2 or (rem == ulp / 2 and n % 2):
        n += 1
    return sign * n * ulp


def test_reciprocal_division_rounds_as_ieee():
    """The kernel's p / l: q = RN(p·r) with r = RN(1/l), then RN(q + RN(p −
    q·l)·r) with both steps fused (FMA), equals RN(p / l) (Markstein) for p
    in (1e-30, 1] and l in [1, 512] — the values exp(s − m) and the
    denominator take."""
    rng = np.random.default_rng(0)
    ps = np.concatenate([[1.0, 0.5, 2.0**-100], 10.0 ** rng.uniform(-30, 0, 2000)]).astype(np.float32)
    ls = np.concatenate([[1.0, 3.0, 128.0, 512.0], rng.uniform(1, 512, 2000)]).astype(np.float32)
    for p, l in zip(ps, np.resize(ls, ps.shape)):
        p, l = Fraction(float(p)), Fraction(float(l))
        r = _rn32(1 / l)
        q = _rn32(p * r)
        q = _rn32(q + _rn32(p - q * l) * r)
        assert q == _rn32(p / l), (float(p), float(l))
