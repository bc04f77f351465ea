"""The orders of operations of the row-1 (``fused_attention``) and row-4
(``attention_bwd`` dK/dV) CUDA kernels, modelled in plain torch on the CPU
and held against the plain versions the kernels are checked against on the
card, at the smoke's bounds (``chip_smoke.py``).

- Row 3 (``bwd_dq_kernel``, ``csrc/attention_bwd.cu``): one block per 64
  queries; per step of 64 keys (32 at DP = 128) S = Q·Kᵀ and dP = dO·Vᵀ
  summed over 16-column slices of D in order, P = exp(S·scale + bias − L)
  and dS = P·(dP − Δ) in f32, bf16(dS)·K added to dQ a 16-key slice at a
  time, the steps in order, and dQ·scale at the end. Keys past T (to the
  next multiple of 64) come as k = v = 0 under the −1e9 bias.
- Row 4 (``bwd_dkv_kernel``, ``csrc/attention_bwd.cu``): one block per 64
  keys; per query chunk of 32 rows Sᵀ = K·Qᵀ and dPᵀ =
  V·dOᵀ summed over 16-column slices of D in order, P = exp(Sᵀ·scale +
  bias − L) and dS = P·(dP − Δ) in f32, bf16(Pᵀ)·dO and bf16(dSᵀ)·Q summed
  over 16-query slices, the chunks in order, and dK·scale at the end. Query
  rows past T come as q = dO = 0 and L = Δ = 0.
- Row 1 in f32 (``fused_f32_kernel``, ``csrc/attention_fused.cu``): one
  pass over 64-key chunks with FlashAttention-2's online rescale; each dot
  an FMA chain over d in order; a row's sum taken by each of its 8 lanes
  over keys kg + 8j and combined across the lanes (xor 1, 2, 4); o = α·o +
  P·V over the chunk's keys in order; o / l and lse = m + log l at the end.
- Row 1 in bf16 runs rows 5 and 2's core (``attend_heads_first``) at any T:
  ``packed_order_model`` from ``test_torch_attention_order.py``, beyond 512.
- D not a multiple of 8: the wrapper zero-pads D on the card
  (``_pad_head_dim``) and keeps the unpadded D's scale.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from msa_tpu.ops.pallas.attention import _fused_attention_lse as jax_fused_lse
from msa_tpu_torch.ops.kernels import attention as A
from test_torch_attention_order import _check, _inputs, packed_order_model

import torch_parity  # noqa: F401  (its import shares the CPU among xdist workers)

_SPEC = importlib.util.spec_from_file_location("chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
_SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(_SMOKE)
KERNEL_RTOL, LSE_ATOL, ROW1_F32_ATOL = _SMOKE.KERNEL_RTOL, _SMOKE.LSE_ATOL, _SMOKE.ROW1_F32_ATOL


def _heads(seed, b, h, t, d, n, dtype):
    """n tensors [B, H, T, D] from a numpy seed, and a key mask with a
    ragged row and a row with no valid key."""
    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(rng.normal(size=(b, h, t, d)).astype(np.float32)).to(dtype) for _ in range(n)]
    mask = np.ones((b, t), np.float32)
    mask[0, t * 2 // 3 :] = 0.0
    mask[1] = 0.0
    return xs, torch.from_numpy(mask)


def _dp(d):
    return 32 if d <= 32 else 64 if d <= 64 else 128


def _slices16(a, b_):
    """a @ b_ summed over 16-wide slices of the inner dimension in order, as
    the mma.sync steps take it."""
    out = torch.zeros(a.shape[:-1] + (b_.shape[-1],))
    for c in range(0, a.shape[-1], 16):
        out = out + a[..., c : c + 16] @ b_[..., c : c + 16, :]
    return out


# --- row 3 ---------------------------------------------------------------------------


def dq_order_model(q, k, v, key_mask, lse, o, g):
    """Row 3 as the kernel orders it, on attention_bwd_plain's arguments →
    dq in the operands' dtype."""
    b, h, t, d = q.shape
    dp, scale = _dp(d), A._scale(d)
    nk = 32 if dp == 128 else 64  # keys a step takes
    tp = -(-t // 64) * 64

    def pad(x):
        return F.pad(x.float(), (0, dp - d, 0, tp - t))

    qf, gf, kf, vf = pad(q), pad(g), pad(k), pad(v)  # rows and keys past T: zeros
    lq = F.pad(lse.float(), (0, tp - t))[..., None]  # L = 0 past T
    delta = F.pad(A._delta(o, g), (0, tp - t))[..., None]  # Δ = 0 past T
    bias = torch.where(F.pad(key_mask, (0, tp - t)) > 0, 0.0, -1e9)[:, None, None, :]  # per key column
    dq = torch.zeros(b, h, tp, dp)
    for k0 in range(0, tp, nk):
        ks, vs = kf[:, :, k0 : k0 + nk], vf[:, :, k0 : k0 + nk]
        p = torch.exp(_slices16(qf, ks.transpose(-1, -2)) * scale + bias[..., k0 : k0 + nk] - lq)
        ds = (p * (_slices16(gf, vs.transpose(-1, -2)) - delta)).to(torch.bfloat16).float()
        for c in range(0, nk, 16):  # each mma step adds a 16-key slice to the accumulator
            dq = dq + ds[..., c : c + 16] @ ks[:, :, c : c + 16]
    return (dq * scale)[:, :, :t, :d].to(q.dtype)


@pytest.mark.parametrize("t, h, d", [(40, 4, 24), (100, 3, 32), (300, 2, 64), (512, 2, 64), (130, 2, 128), (200, 2, 96)])
def test_dq_order_within_the_smoke_bounds(t, h, d):
    """T = 40, 100, 300, 130 and 200 end mid-step; D = 24 and 96 are
    zero-padded to the kernel's DP (32, 128)."""
    (q, k, v, g), mask = _heads(t + d + 1, 2, h, t, d, 4, torch.bfloat16)
    o, lse = _forward(q, k, v, mask)
    pdq, _, _ = A.attention_bwd_plain(q, k, v, mask, lse, o, g)
    _check_rows("dq", dq_order_model(q, k, v, mask, lse, o, g), pdq)


def test_dq_padded_keys_add_exact_zeros():
    """Keys past T arrive as k = v = 0 under the −1e9 bias: their dS·K
    products are exact zeros, so 64 such keys leave dQ as it was, even for
    the row with no valid key (L ≈ −1e9 + log T_pad, where P on a padded
    key is about 1/T_pad, not 0)."""
    (q, k, v, g), mask = _heads(5, 2, 2, 64, 32, 4, torch.bfloat16)
    o, lse = _forward(q, k, v, mask)
    dq = dq_order_model(q, k, v, mask, lse, o, g)
    assert lse.min() < -1e8  # the row with no valid key
    q2, k2, v2, o2, g2 = (F.pad(x, (0, 0, 0, 64)) for x in (q, k, v, o, g))
    dq2 = dq_order_model(q2, k2, v2, F.pad(mask, (0, 64)), F.pad(lse, (0, 64)), o2, g2)
    torch.testing.assert_close(dq2[:, :, :64], dq, rtol=0, atol=0)


# --- row 4 ---------------------------------------------------------------------------


def dkv_order_model(q, k, v, key_mask, lse, o, g):
    """Row 4 as the kernel orders it, on attention_bwd_plain's arguments →
    (dk, dv) in the operands' dtypes."""
    b, h, t, d = q.shape
    dp, scale = _dp(d), A._scale(d)
    nc = 32  # query rows per chunk
    tk, tq = -(-t // 64) * 64, -(-t // nc) * nc

    def pad(x, rows):
        return F.pad(x.float(), (0, dp - d, 0, rows - t))

    qf, gf = pad(q, tq), pad(g, tq)  # query rows past T: zeros
    kf, vf = pad(k, tk), pad(v, tk)
    lq = F.pad(lse.float(), (0, tq - t))  # L = 0 past T
    delta = F.pad(A._delta(o, g), (0, tq - t))  # Δ = 0 past T
    bias = torch.where(F.pad(key_mask, (0, tk - t)) > 0, 0.0, -1e9)[:, None, :, None]  # per key row
    dk, dv = torch.zeros(b, h, tk, dp), torch.zeros(b, h, tk, dp)
    for c0 in range(0, tq, nc):
        qs, gs = qf[:, :, c0 : c0 + nc], gf[:, :, c0 : c0 + nc]
        st = _slices16(kf, qs.transpose(-1, -2))  # Sᵀ [B, H, keys, queries]
        p = torch.exp(st * scale + bias - lq[:, :, None, c0 : c0 + nc])
        dv = dv + _slices16(p.to(torch.bfloat16).float(), gs)
        dpt = _slices16(vf, gs.transpose(-1, -2))
        ds = p * (dpt - delta[:, :, None, c0 : c0 + nc])
        dk = dk + _slices16(ds.to(torch.bfloat16).float(), qs)
    return (dk * scale)[:, :, :t, :d].to(k.dtype), dv[:, :, :t, :d].to(v.dtype)


def _forward(q, k, v, key_mask):
    """The forward's o [B, H, T, D] and lse (row 5's plain version)."""
    o, lse = A.packed_qkv_attention_lse_plain(A._to_packed(q, k, v), key_mask)
    return A._heads_first(o, q.shape[1]), lse


def _check_rows(name, got, want):
    """The smoke's bound per batch row (phase 10): the row with no valid key
    carries a gradient ~100× the valid row's."""
    for i in range(got.shape[0]):
        err = (got[i].float() - want[i].float()).abs().max().item()
        bound = KERNEL_RTOL * want[i].float().abs().max().item() + 1e-3
        assert torch.isfinite(got[i].float()).all()
        assert err <= bound, f"{name} row {i}: max abs err {err:.4e} > {bound:.4e}"


@pytest.mark.parametrize("t, h, d", [(40, 4, 24), (100, 3, 32), (300, 2, 64), (130, 2, 128)])
def test_dkv_order_within_the_smoke_bounds(t, h, d):
    """T = 40, 100, 300 and 130 are not multiples of 64 (nor of the
    32-query chunk but 300 and 130, which end mid-chunk)."""
    (q, k, v, g), mask = _heads(t + d, 2, h, t, d, 4, torch.bfloat16)
    o, lse = _forward(q, k, v, mask)
    _, pdk, pdv = A.attention_bwd_plain(q, k, v, mask, lse, o, g)
    dk, dv = dkv_order_model(q, k, v, mask, lse, o, g)
    _check_rows("dk", dk, pdk)
    _check_rows("dv", dv, pdv)


def test_dkv_padded_query_rows_add_exact_zeros():
    """Query rows past T arrive as q = dO = 0 and L = Δ = 0: P = exp(bias)
    is 1 or 0 and every product with them is an exact zero, so a chunk of
    only such rows leaves dK and dV as they were — even for a key whose
    real rows' L is near −1e9 (a stale L would overflow exp)."""
    (q, k, v, g), mask = _heads(3, 2, 2, 64, 32, 4, torch.bfloat16)
    o, lse = _forward(q, k, v, mask)
    dk, dv = dkv_order_model(q, k, v, mask, lse, o, g)
    assert torch.isfinite(lse).all() and lse.min() < -1e8  # the row with no valid key
    # 64 zero rows past T: keys under the −1e9 bias, queries with L = Δ = 0
    q2, k2, v2, o2, g2 = (F.pad(x, (0, 0, 0, 64)) for x in (q, k, v, o, g))
    dk2, dv2 = dkv_order_model(q2, k2, v2, F.pad(mask, (0, 64)), F.pad(lse, (0, 64)), o2, g2)
    torch.testing.assert_close(dk2[:, :, :64], dk, rtol=0, atol=0)
    torch.testing.assert_close(dv2[:, :, :64], dv, rtol=0, atol=0)


# --- row 1, f32 ----------------------------------------------------------------------


def _lane_sum(p):
    """Σ over a chunk's 64 keys as the kernel takes it: lane kg sums keys
    kg + 8j over j in order, then xor 1, xor 2, xor 4 across the 8 lanes."""
    lanes = p[..., 0:8].clone()
    for j in range(1, 8):
        lanes = lanes + p[..., 8 * j : 8 * j + 8]
    for s in (1, 2, 4):
        idx = torch.arange(8) ^ s
        lanes = lanes + lanes[..., idx]
    return lanes[..., :1]


def fused_f32_order_model(q, k, v, key_mask, chunk=64):
    """Row 1 in f32 as the one-pass kernel orders it → (o, lse)."""
    b, h, t, d = q.shape
    scale = A._scale(d)
    t_pad = -(-t // 128) * 128
    kf, vf = (F.pad(x, (0, 0, 0, t_pad - t)) for x in (k, v))
    bias = torch.where(F.pad(key_mask, (0, t_pad - t)) > 0, 0.0, -1e9)[:, None, None, :]
    m = torch.full((b, h, t, 1), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros_like(q)
    for k0 in range(0, t_pad, chunk):
        kc, vc = kf[:, :, k0 : k0 + chunk], vf[:, :, k0 : k0 + chunk]
        dots = torch.zeros(b, h, t, chunk)
        for i in range(d):  # the FMA chain over d in order
            dots = dots + q[..., i : i + 1] * kc[..., i][:, :, None, :]
        s = dots * scale + bias[..., k0 : k0 + chunk]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + _lane_sum(p)
        o = o * alpha
        for j in range(chunk):  # P·V over the chunk's keys in order
            o = o + p[..., j : j + 1] * vc[:, :, j : j + 1, :]
        m = m_new
    return o / l, (m + torch.log(l))[..., 0]


def _check_f32(got, want, what):
    (o, lse), (wo, wlse) = got, want
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    err = (o - wo).abs().max().item()
    assert err <= ROW1_F32_ATOL, f"{what} o: max abs err {err:.3e} > {ROW1_F32_ATOL}"
    lse_err = (lse - wlse).abs().max().item()
    assert lse_err <= LSE_ATOL, f"{what} lse: max abs err {lse_err:.3e} > {LSE_ATOL}"


@pytest.mark.parametrize("t, h, d", [(250, 2, 64), (100, 3, 32), (130, 2, 128)])
def test_fused_f32_one_pass_order_within_the_smoke_bounds(t, h, d):
    (q, k, v), mask = _heads(t * d, 2, h, t, d, 3, torch.float32)
    got = fused_f32_order_model(q, k, v, mask)
    _check_f32(got, A.fused_attention_plain(q, k, v, mask), "plain")
    if (t, d) in ((250, 64), (100, 32)):  # JAX's own test shapes
        jo, jl = jax_fused_lse(*(x.numpy() for x in (q, k, v, mask)), interpret=True)
        _check_f32(got, (torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jl))), "JAX")


# --- row 1, bf16: rows 5 and 2's core beyond T = 512 ------------------------------------


def test_fused_bf16_takes_the_packed_core_past_512():
    qkv, mask = _inputs(749, 2, 749, 2, 64)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    o, lse = packed_order_model(qkv, mask)
    _check((A._heads_first(o, 2), lse), A.fused_attention_plain(q, k, v, mask))


# --- D not a multiple of 8 -----------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_padding_is_exact(dtype):
    """The plain version on the zero-padded operands (D = 20 → 24), at the
    unpadded D's scale and sliced back, equals it unpadded; the packed
    core's order holds at D = 20 too."""
    (q, k, v), mask = _heads(20, 2, 3, 100, 20, 3, dtype)
    qp, kp, vp = A._pad_head_dim(q, k, v)
    assert qp.shape[-1] == 24 and torch.equal(qp[..., :20], q) and not qp[..., 20:].any()
    o, lse = A.packed_qkv_attention_lse_plain(A._to_packed(qp, kp, vp), mask, A._scale(20))
    want_o, want_lse = A.fused_attention_plain(q, k, v, mask)
    tol = dict(rtol=0, atol=1e-6) if dtype is torch.float32 else dict(rtol=0, atol=2.0**-8)
    torch.testing.assert_close(A._heads_first(o, 3)[..., :20].float(), want_o.float(), **tol)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-6)
    q16 = q[..., :16]
    assert A._pad_head_dim(q16)[0] is q16  # a multiple of 8 is left as it is
    if dtype is torch.bfloat16:
        qkv = A._to_packed(q, k, v)
        _check(packed_order_model(qkv, mask), A.packed_qkv_attention_lse_plain(qkv, mask))
