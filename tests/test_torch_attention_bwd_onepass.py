"""The one-pass f32 attention backward (rows 3 and 4 on f32 operands at
D ≤ 64, ``onepass_f32_kernel`` in ``csrc/attention_bwd_f32.cu``): its order
of operations modelled in plain torch on the CPU, and its planner.

The kernel runs only on the card (``chip_smoke.py`` phase 20); here, at
tiny sizes, its plain-torch model is held against JAX's ``attention_bwd``
(Pallas in interpret mode, numpy inputs from a seed) and against
``attention_bwd_plain`` within the smoke's ``F32_BWD_RTOL`` of the largest
|value| per batch row (the row with no valid key has its own scale):

- a block owns ``bk`` keys (64 or 128) of one (b, h) and walks its split of
  the query steps of 64; per step Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ once, P =
  exp(Sᵀ·scale + bias − L), dS = P·(dP − Δ); dV += Pᵀ·dO, dK += dSᵀ·Q;
- the step's dQ share of a key tile is dS·K over its keys, and the shares
  go into dq in key-tile order: the first stored, the others added, the
  last multiplied by scale;
- a split's dK and dV are added in split order, dK multiplied by scale by
  the last;
- keys past T come as k = v = 0 under the −1e9 bias, query rows past T as
  q = dO = 0 with L = Δ = 0, and D is zero-padded to a multiple of 8 with
  the scale of the unpadded D (``_attention_bwd_into``).

The planner (``ops/kernels/attention_bwd_plan.py``): every served shape's
blocks cover every (key, query) pair of every (b, h) once, by the kernel's
own index arithmetic; its grid leaves no last wave under a fifth full
where it takes more than one; it refuses what the kernel cannot take.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from msa_tpu.ops.pallas.attention import attention_bwd as jax_attention_bwd
from msa_tpu_torch.ops.kernels import attention as A
from msa_tpu_torch.ops.kernels import attention_bwd_plan as BP

import torch_parity  # noqa: F401  (its import shares the CPU among xdist workers)

_SPEC = importlib.util.spec_from_file_location("chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
_SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(_SMOKE)
F32_BWD_RTOL = _SMOKE.F32_BWD_RTOL

# the f32 training steps' shapes (B, H, T, D) and the custom widths'
SERVED = [(8, 12, 512, 64), (8, 12, 250, 64), (2, 12, 749, 64), (2, 4, 40, 24), (2, 4, 40, 32)]


def onepass_order_model(q, k, v, key_mask, lse, o, g, plan=None):
    """The one pass as the kernel orders it, on attention_bwd_plain's
    arguments → (dq, dk, dv) in f32 [B, H, T, D]."""
    b, h, t, d = q.shape
    scale = A._scale(d)
    q, k, v, o, g = A._pad_head_dim(q, k, v, o, g)
    dp = q.shape[-1]
    plan = plan or BP.plan(b, h, t, dp)
    BP.validate(plan, b, h, t, dp)
    bk, nkt, nq = plan.bk, plan.key_tiles(t), BP.query_steps(t)
    tk, tq = nkt * bk, nq * BP.QUERY_STEP
    qf, gf = (F.pad(x.float(), (0, 0, 0, tq - t)) for x in (q, g))  # query rows past T: zeros
    kf, vf = (F.pad(x.float(), (0, 0, 0, tk - t)) for x in (k, v))  # keys past T: zeros
    lq = F.pad(lse.float(), (0, tq - t))  # L = 0 past T
    delta = F.pad(A._delta(o, g), (0, tq - t))  # Δ = 0 past T
    kb = torch.where(F.pad(key_mask, (0, tk - t)) > 0, 0.0, -1e9)[:, None, :, None]  # per key row
    dq = torch.zeros(b, h, tq, dp)
    dk = dv = None
    for sp in range(plan.splits):
        j0, j1 = sp * nq // plan.splits, (sp + 1) * nq // plan.splits
        acc_k, acc_v = torch.zeros(b, h, tk, dp), torch.zeros(b, h, tk, dp)
        for j in range(j0, j1):
            qs = slice(j * BP.QUERY_STEP, (j + 1) * BP.QUERY_STEP)
            st = kf @ qf[:, :, qs].transpose(-1, -2)  # Sᵀ [B, H, keys, queries], once
            p = torch.exp(st * scale + kb - lq[:, :, None, qs])
            ds = p * (vf @ gf[:, :, qs].transpose(-1, -2) - delta[:, :, None, qs])
            acc_v = acc_v + p @ gf[:, :, qs]
            acc_k = acc_k + ds @ qf[:, :, qs]
            for kt in range(nkt):  # the key tiles' shares in order
                keys = slice(kt * bk, (kt + 1) * bk)
                share = ds[:, :, keys].transpose(-1, -2) @ kf[:, :, keys]
                dq[:, :, qs] = share if kt == 0 else dq[:, :, qs] + share
                if kt == nkt - 1:
                    dq[:, :, qs] = dq[:, :, qs] * scale
        dk, dv = (acc_k, acc_v) if sp == 0 else (dk + acc_k, dv + acc_v)
    dk = dk * scale
    return dq[:, :, :t, :d], dk[:, :, :t, :d], dv[:, :, :t, :d]


def _inputs(seed, b, h, t, d):
    """q, k, v, dO from a numpy seed; a key mask with a ragged row and a row
    with no valid key; the forward's o and lse (row 2's plain version, f32),
    all as torch tensors."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, h, t, d)).astype(np.float32)) for _ in range(4))
    mask = torch.ones(b, t)
    mask[0, t * 2 // 3 :] = 0.0
    mask[1] = 0.0
    o, lse = A.mha_attention_plain(q, k, v, mask)
    return q, k, v, g, mask, o, lse


def _check_rows(name, got, want):
    for i in range(got.shape[0]):
        err = (got[i] - want[i]).abs().max().item()
        bound = F32_BWD_RTOL * want[i].abs().max().item()
        assert torch.isfinite(got[i]).all()
        assert err <= bound, f"{name} row {i}: max abs err {err:.4e} > {bound:.4e}"


@pytest.mark.parametrize(
    "t, d, plan, against_jax",
    [(40, 24, None, False), (40, 25, None, True), (100, 32, None, True), (100, 64, BP.BwdPlan(128, 2), False),
     (130, 64, BP.BwdPlan(128, 3), True), (130, 25, BP.BwdPlan(64, 2), False)],
)
def test_onepass_order_against_jax_and_plain(t, d, plan, against_jax):
    """T = 40, 100 and 130 end mid-tile; D = 24 and 25 are padded to 24 and
    32 (the kernel's 32 columns add exact zeros past them); the plans take
    both key tiles, splits of the query loop and a split of a single step.
    Three cases also against JAX's kernels in interpret mode."""
    q, k, v, g, mask, o, lse = _inputs(t * 100 + d, 2, 2, t, d)
    got = onepass_order_model(q, k, v, mask, lse, o, g, plan)
    wants = {"plain": A.attention_bwd_plain(q, k, v, mask, lse, o, g)}
    if against_jax:
        wants["JAX"] = [torch.from_numpy(np.array(x)) for x in
                        jax_attention_bwd(*(x.numpy() for x in (q, k, v, mask, lse, o, g)), interpret=True)]
    for ref, want in wants.items():
        for name, mine, w in zip(("dq", "dk", "dv"), got, want):
            assert tuple(mine.shape) == (2, 2, t, d)
            _check_rows(f"{name} vs {ref}", mine, w)


@pytest.mark.parametrize("plan", [BP.BwdPlan(64, 1), BP.BwdPlan(128, 1), BP.BwdPlan(128, 2)])
def test_onepass_padded_rows_and_keys_add_exact_zeros(plan):
    """64 rows past T (q = dO = 0, L = Δ = 0, masked keys with k = v = 0)
    leave dq, dk and dv of the real rows as they were, bit for bit: an
    extra key tile adds zero shares to dq, an extra query step zero
    products to dk and dv, even for the row with no valid key, whose P on
    the padded keys is about 1/T_pad, not 0."""
    q, k, v, g, mask, o, lse = _inputs(7, 2, 2, 128, 32)
    assert lse.min() < -1e8  # the row with no valid key
    got = onepass_order_model(q, k, v, mask, lse, o, g, plan)
    padded = [F.pad(x, (0, 0, 0, 64)) for x in (q, k, v)]
    got2 = onepass_order_model(*padded, F.pad(mask, (0, 64)), F.pad(lse, (0, 64)), F.pad(o, (0, 0, 0, 64)),
                               F.pad(g, (0, 0, 0, 64)), plan)
    for a, b_ in zip(got, got2):
        torch.testing.assert_close(b_[:, :, :128], a, rtol=0, atol=0)


# --- the planner ------------------------------------------------------------------------


@pytest.mark.parametrize("b, h, t, d", SERVED)
def test_plan_covers_every_key_and_query_once(b, h, t, d):
    p = BP.plan(b, h, t, d)
    BP.validate(p, b, h, t, d)
    seen = np.zeros((b, h, t, t), np.int8)  # [.., key, query]
    for bi, hi, keys, queries in BP.work_items(p, b, h, t):
        seen[bi, hi, keys.start : keys.stop, queries.start : queries.stop] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("b, h, t, d", SERVED)
def test_plan_fills_the_card(b, h, t, d):
    """Where the grid takes more than one wave of 132 blocks, the last is
    at least a fifth full (B=2 T=749 without a split: 144 blocks, a second
    wave of 12); at B=8 T=512 and T=250 it is 91% full."""
    p = BP.plan(b, h, t, d)
    blocks = p.blocks(b, h, t)
    if blocks > BP.SMS:
        assert BP.wave_fill(p, b, h, t) >= 0.2, (p, blocks)
    assert BP.wave_fill(BP.BwdPlan(128, 1), 2, 12, 749) < 0.1  # what the split repairs
    expected = {(8, 12, 512): BP.BwdPlan(128, 1), (8, 12, 250): BP.BwdPlan(128, 2), (2, 12, 749): BP.BwdPlan(128, 3)}
    if (b, h, t) in expected:
        assert p == expected[(b, h, t)] and BP.wave_fill(p, b, h, t) >= 0.27
    assert p.ticket_elems(b, h, t) == 2 + b * h * (-(-t // 64) + -(-t // p.bk))


def test_plan_refuses_what_the_kernel_cannot_take():
    for shape in ((2, 4, 40, 68), (2, 4, 40, 20), (2, 4, 0, 32), (0, 4, 40, 32), (2, 4, 40, 4)):
        with pytest.raises(ValueError):
            BP.plan(*shape)
    for p in (BP.BwdPlan(32, 1), BP.BwdPlan(64, 0), BP.BwdPlan(128, 2), BP.BwdPlan(256, 1)):
        with pytest.raises(ValueError):
            BP.validate(p, 2, 4, 64, 32)  # T = 64: one query step, so no split
    assert BP.BwdPlan(128, 3).code == 128 | 3 << 10
