"""The f32 attention kernels above head dim 64 / 128 (``wide_f32_kernel`` in
``csrc/attention_wide.cu``, ``wide_onepass_f32_kernel`` in
``csrc/attention_bwd_f32.cu``): their orders of operations modelled in
plain torch on the CPU, and their planners.

The kernels run only on the card (``chip_smoke.py`` phase 22); here, at
tiny sizes, their plain-torch models are held against JAX's Pallas kernels
in interpret mode (numpy inputs from a seed, one head, T ≤ 130, a ragged
row and a row with no valid key), at the tolerances of
``test_torch_wide_heads.py`` (f32 rows 1, 2, 5: 2e-5; row 6: 3e-5; rows 3
+ 4: 2e-4):

- the forward: a block owns ``bq`` query rows and a column tile of 256
  columns of o and walks its split of the 128-key blocks in row 6's online
  order, forming S once per key block (``⌈D/256⌉`` times above D = 256);
  the splits are combined in split order, as the online softmax would;
- the backward: a block owns ``bk`` keys (64 at D ≤ 128, 32 above) and a
  column tile, walks its split of the query steps of 32, forms Sᵀ and dPᵀ
  once per step (again per column tile above D = 256), sums dQ into dq in
  key-tile order and its dK, dV in split order.

The models count their S (and dP) formations, which shows the work: 4·T²·D
forward and 10·T²·D backward at D ≤ 256. The planners: every (query, key,
column) of every (b, h) is covered once, by the kernels' own index
arithmetic; the full-width grids fill the card; they refuse what the
kernels cannot take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from msa_tpu.ops.pallas.attention import _flash_attention_lse, _fused_attention_lse, _mha_attention_lse
from msa_tpu.ops.pallas.attention import _packed_qkv_attention_lse
from msa_tpu.ops.pallas.attention import attention_bwd as jax_attention_bwd
from msa_tpu_torch.ops.kernels import attention as A
from msa_tpu_torch.ops.kernels import attention_bwd_plan as BP
from msa_tpu_torch.ops.kernels import attention_wide_plan as WP
from torch_parity import f32

# the full-width shapes (B, T, H, D) of the forward and the backward
FULL_FWD = [(2, 512, 4, 192), (2, 512, 3, 256), (8, 512, 4, 192), (2, 749, 4, 192)]
FULL_BWD = [(8, 512, 4, 192), (8, 512, 3, 256), (8, 512, 6, 128)]


def wide_fwd_order_model(q, k, v, key_mask, plan=None):
    """The forward as ``wide_f32_kernel`` orders it, on q, k, v [B, H, T, D]
    f32 → (o, lse, the number of S formations per (query tile, key
    block))."""
    b, h, t, d = q.shape
    plan = plan or WP.plan(b, h, t, d)
    WP.validate(plan, b, h, t, d)
    scale = A._scale(d)
    nkb, nct = WP.key_blocks(t), WP.col_tiles(d)
    tk = nkb * WP.KEY_BLOCK
    kf, vf = (F.pad(x.float(), (0, 0, 0, tk - t)) for x in (k, v))  # keys past T: zeros under −1e9
    bias = torch.where(F.pad(key_mask, (0, tk - t)) > 0, 0.0, -1e9)[:, None, None, :]
    o = torch.zeros(b, h, t, d)
    lse = torch.zeros(b, h, t)
    formed = 0
    for q0 in range(0, t, plan.bq):
        qt = q[:, :, q0 : q0 + plan.bq].float()
        for ct in range(nct):
            cols = slice(ct * WP.COL_TILE, (ct + 1) * WP.COL_TILE)
            parts = []
            for sp in range(plan.splits):  # each split's online softmax over its key blocks
                m = torch.full(qt.shape[:3], -1e30)
                l = torch.zeros(qt.shape[:3])
                acc = torch.zeros(*qt.shape[:3], vf[..., cols].shape[-1])
                for kb in range(sp * nkb // plan.splits, (sp + 1) * nkb // plan.splits):
                    keys = slice(kb * WP.KEY_BLOCK, (kb + 1) * WP.KEY_BLOCK)
                    s = (qt @ kf[:, :, keys].transpose(-1, -2)) * scale + bias[..., keys]  # S over the full D, once
                    formed += 1
                    m_cur = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp(m - m_cur)
                    p = torch.exp(s - m_cur[..., None])
                    l = alpha * l + p.sum(-1)
                    acc = acc * alpha[..., None] + p @ vf[:, :, keys, cols]
                    m = m_cur
                parts.append((m, l, acc))
            m, l, acc = parts[0]
            for ms, ls, accs in parts[1:]:  # the splits in split order
                mn = torch.maximum(m, ms)
                a, bb = torch.exp(m - mn), torch.exp(ms - mn)
                l = a * l + bb * ls
                acc = a[..., None] * acc + bb[..., None] * accs
                m = mn
            lc = torch.clamp(l, min=1e-30)
            o[:, :, q0 : q0 + plan.bq, cols] = acc / lc[..., None]
            if ct == 0:
                lse[:, :, q0 : q0 + plan.bq] = m + torch.log(lc)
    return o, lse, formed / (-(-t // plan.bq) * nkb)


def wide_bwd_order_model(q, k, v, key_mask, lse, o, g, plan=None):
    """The backward above D = 64 as ``wide_onepass_f32_kernel`` orders it,
    on attention_bwd_plain's arguments → (dq, dk, dv, the number of S and
    dP formations per (key tile, query step))."""
    b, h, t, d = q.shape
    scale = A._scale(d)
    plan = plan or BP.plan(b, h, t, d)
    BP.validate(plan, b, h, t, d)
    bk, nkt, nq, step, nct = plan.bk, plan.key_tiles(t), BP.query_steps(t, d), BP.query_step(d), BP.col_tiles(d)
    width = d if nct == 1 else BP.COL_TILE
    tk, tq = nkt * bk, nq * step
    qf, gf = (F.pad(x.float(), (0, 0, 0, tq - t)) for x in (q, g))  # query rows past T: zeros
    kf, vf = (F.pad(x.float(), (0, 0, 0, tk - t)) for x in (k, v))  # keys past T: zeros
    lq = F.pad(lse.float(), (0, tq - t))  # L = 0 past T
    delta = F.pad(A._delta(o, g), (0, tq - t))  # Δ = 0 past T
    kb = torch.where(F.pad(key_mask, (0, tk - t)) > 0, 0.0, -1e9)[:, None, :, None]
    dq, dk, dv = (torch.zeros(b, h, n, d) for n in (tq, tk, tk))
    formed = 0
    for ct in range(nct):
        cols = slice(ct * width, min((ct + 1) * width, d))
        for kt in range(nkt):
            keys = slice(kt * bk, (kt + 1) * bk)
            acc_k = acc_v = None
            for sp in range(plan.splits):
                j0, j1 = sp * nq // plan.splits, (sp + 1) * nq // plan.splits
                sk, sv = (torch.zeros(b, h, bk, cols.stop - cols.start) for _ in range(2))
                for j in range(j0, j1):
                    qs = slice(j * step, (j + 1) * step)
                    st = kf[:, :, keys] @ qf[:, :, qs].transpose(-1, -2)  # Sᵀ over the full D, once
                    dpt = vf[:, :, keys] @ gf[:, :, qs].transpose(-1, -2)  # dPᵀ, once
                    formed += 1
                    p = torch.exp(st * scale + kb[:, :, keys] - lq[:, :, None, qs])
                    ds = p * (dpt - delta[:, :, None, qs])
                    sv = sv + p @ gf[:, :, qs, cols]
                    sk = sk + ds @ qf[:, :, qs, cols]
                    share = ds.transpose(-1, -2) @ kf[:, :, keys, cols]  # this key tile's share, in key-tile order
                    dq[:, :, qs, cols] = share if kt == 0 else dq[:, :, qs, cols] + share
                    if kt == nkt - 1:
                        dq[:, :, qs, cols] = dq[:, :, qs, cols] * scale
                acc_k, acc_v = (sk, sv) if sp == 0 else (acc_k + sk, acc_v + sv)  # the splits in order
            dk[:, :, keys, cols] = acc_k * scale
            dv[:, :, keys, cols] = acc_v
    return dq[:, :, :t], dk[:, :, :t], dv[:, :, :t], formed / (nkt * nq)


def _inputs(seed, b, h, t, d):
    """q, k, v, dO [B, H, T, D] f32 from a numpy seed and a key mask with a
    ragged row and a row with no valid key, as numpy arrays."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(b, h, t, d)).astype(np.float32) for _ in range(4))
    mask = np.ones((b, t), np.float32)
    mask[0, t * 2 // 3 :] = 0.0
    mask[1] = 0.0
    return q, k, v, g, mask


# --- the forward -----------------------------------------------------------------------


@pytest.mark.parametrize(
    "d, t, plan",
    [(136, 100, None), (192, 130, WP.WidePlan(64, 2)), (256, 130, WP.WidePlan(32, 1)), (640, 130, WP.WidePlan(16, 2))],
)
def test_wide_forward_order_against_jax(d, t, plan):
    """Rows 1, 2 and 5 (T = 100 and 130: one and two key blocks, ragged
    query tiles) and row 6 against JAX in interpret mode, one head; the
    plans take each query tile, a split of the key loop and, at D = 640,
    three column tiles. S is formed once per (query tile, key block) at D ≤
    256, three times above."""
    q, k, v, g, mask = _inputs(d + t, 2, 1, t, d)
    got_o, got_lse, formed = wide_fwd_order_model(*(torch.from_numpy(x) for x in (q, k, v, mask)), plan)
    assert formed == (1 if d <= 256 else WP.col_tiles(d))
    jm = jnp.asarray(mask)
    wants = {
        "row 1": (_fused_attention_lse(q, k, v, jm, interpret=True), 2e-5),
        "row 2": (_mha_attention_lse(q, k, v, jm, interpret=True), 2e-5),
        "row 6": (_flash_attention_lse(q, k, v, jm, interpret=True), 3e-5),
    }
    qkv = np.stack((q, k, v), axis=1).transpose(0, 3, 1, 2, 4)  # [B, T, 3, H, D]
    o5, lse5 = _packed_qkv_attention_lse(jnp.asarray(qkv), jm, interpret=True)
    wants["row 5"] = ((np.asarray(o5).reshape(2, t, 1, d).transpose(0, 2, 1, 3), lse5), 2e-5)
    for row, ((want_o, want_lse), atol) in wants.items():
        np.testing.assert_allclose(f32(got_o), f32(want_o), atol=atol, err_msg=row)
        np.testing.assert_allclose(f32(got_lse), f32(want_lse), atol=atol, err_msg=row)


def test_wide_forward_splits_and_tiles_agree():
    """Every query tile and split at T = 300 (three key blocks) and a D of
    two column tiles gives the plain version's o and lse within the row-6
    bound: the split combine is the online softmax's step."""
    q, k, v, g, mask = (torch.from_numpy(x) for x in _inputs(3, 2, 2, 300, 264))
    want_o, want_lse = A.flash_attention_lse_plain(A._to_packed(q, k, v), mask)
    want_o = want_o.reshape(2, 300, 2, 264).permute(0, 2, 1, 3)
    for p in (WP.WidePlan(bq, s) for bq in WP.QUERY_TILES for s in (1, 2, 3)):
        o, lse, formed = wide_fwd_order_model(q, k, v, mask, p)
        assert formed == 2
        torch.testing.assert_close(o, want_o, atol=3e-5, rtol=0)
        torch.testing.assert_close(lse, want_lse, atol=3e-5, rtol=0)


# --- the backward ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "d, t, plan",
    [(136, 100, None), (192, 130, BP.BwdPlan(32, 2)), (256, 130, BP.BwdPlan(32, 3)), (640, 64, None),
     (96, 130, BP.BwdPlan(64, 2)), (128, 100, None)],
)
def test_wide_backward_order_against_jax(d, t, plan):
    """Rows 3 + 4 against JAX's ``attention_bwd`` in interpret mode, one
    head: key tiles of 64 (D = 96, 128) and 32, splits of the query loop,
    three column tiles at D = 640. Sᵀ and dPᵀ are formed once per (key
    tile, query step) at D ≤ 256, three times above."""
    q, k, v, g, mask = _inputs(d * 7 + t, 2, 1, t, d)
    jm = jnp.asarray(mask)
    o, lse = _mha_attention_lse(q, k, v, jm, interpret=True)
    want = jax_attention_bwd(q, k, v, jm, lse, o, g, interpret=True)
    tq, tk, tv, tg, tm = (torch.from_numpy(x) for x in (q, k, v, g, mask))
    *got, formed = wide_bwd_order_model(tq, tk, tv, tm, torch.from_numpy(np.array(lse)), torch.from_numpy(np.array(o)),
                                        tg, plan)
    assert formed == BP.col_tiles(d) and BP.col_tiles(d) == (1 if d <= 256 else -(-d // 256))
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        assert tuple(gt.shape) == (2, 1, t, d)
        np.testing.assert_allclose(f32(gt), f32(wt), atol=2e-4, err_msg=name)


@pytest.mark.parametrize("plan", [BP.BwdPlan(32, 1), BP.BwdPlan(32, 3)])
def test_wide_backward_padded_rows_and_keys_add_exact_zeros(plan):
    """32 rows past T (q = dO = 0, L = Δ = 0, masked keys with k = v = 0)
    leave dq, dk and dv of the real rows as they were, bit for bit."""
    q, k, v, g, mask = (torch.from_numpy(x) for x in _inputs(11, 2, 2, 96, 160))
    o, lse = A.mha_attention_plain(q, k, v, mask)
    got = wide_bwd_order_model(q, k, v, mask, lse, o, g, plan)[:3]
    padded = [F.pad(x, (0, 0, 0, 32)) for x in (q, k, v)]
    got2 = wide_bwd_order_model(*padded, F.pad(mask, (0, 32)), F.pad(lse, (0, 32)), F.pad(o, (0, 0, 0, 32)),
                                F.pad(g, (0, 0, 0, 32)), plan)[:3]
    for a, b_ in zip(got, got2):
        torch.testing.assert_close(b_[:, :, :96], a, rtol=0, atol=0)


# --- the planners -------------------------------------------------------------------------


@pytest.mark.parametrize("b, t, h, d", FULL_FWD + [(2, 100, 2, 192), (2, 600, 2, 256), (1, 64, 1, 2048), (2, 300, 2, 520)])
def test_wide_forward_plan_covers_every_query_key_and_column_once(b, t, h, d):
    for p in {WP.plan(b, h, t, d), WP.WidePlan(16, WP.key_blocks(t)), WP.WidePlan(32, 1)}:
        WP.validate(p, b, h, t, d)
        seen = np.zeros((b, h, t, t, WP.col_tiles(d)), np.int8)  # [.., query, key, column tile]
        for bi, hi, queries, keys, cols in WP.work_items(p, b, h, t, d):
            assert cols.start % WP.COL_TILE == 0 and len(cols) <= WP.COL_TILE
            seen[bi, hi, queries.start : queries.stop, keys.start : keys.stop, cols.start // WP.COL_TILE] += 1
        assert (seen == 1).all(), p


def test_wide_forward_plan_fills_the_card():
    """The full-width grids: one wave holds 73–97% of the SMs at B=2, two
    waves 97% at B=8; the small shapes take 16-row tiles (28 blocks of one
    key block, against 8 of 64 rows)."""
    want = {(2, 512, 4, 192): WP.WidePlan(64, 2), (2, 512, 3, 256): WP.WidePlan(64, 2),
            (8, 512, 4, 192): WP.WidePlan(64, 1), (2, 749, 4, 192): WP.WidePlan(64, 1),
            (2, 100, 2, 192): WP.WidePlan(16, 1), (2, 600, 2, 192): WP.WidePlan(64, 3)}
    for (b, t, h, d), p in want.items():
        assert WP.plan(b, h, t, d) == p, (b, t, h, d)
        if p.blocks(b, h, t, d) >= 96:
            assert WP.wave_fill(p, b, h, t, d) >= 0.72
    assert WP.WidePlan(64, 2).code == 64 | 2 << 10
    p = WP.WidePlan(64, 2)
    assert p.ticket_elems(2, 4, 512, 192) == 64 and p.ws_elems(2, 4, 512, 192) == 128 * (64 * 256 + 128)
    assert WP.WidePlan(64, 1).ticket_elems(2, 4, 512, 192) == WP.WidePlan(64, 1).ws_elems(2, 4, 512, 192) == 0


def test_wide_forward_plan_refuses_what_the_kernel_cannot_take():
    for shape in ((2, 4, 40, 128), (2, 4, 40, 132), (2, 4, 0, 192), (0, 4, 40, 192)):
        with pytest.raises(ValueError):
            WP.plan(*shape)
    for p in (WP.WidePlan(128, 1), WP.WidePlan(8, 1), WP.WidePlan(64, 0), WP.WidePlan(64, 2)):
        with pytest.raises(ValueError):
            WP.validate(p, 2, 4, 100, 192)  # T = 100: one key block, so no split


@pytest.mark.parametrize("b, t, h, d", FULL_BWD + [(2, 100, 2, 192), (2, 130, 1, 640), (1, 64, 1, 2048), (2, 40, 2, 72)])
def test_wide_backward_plan_covers_every_key_query_and_column_once(b, t, h, d):
    for p in {BP.plan(b, h, t, d), BP.BwdPlan(BP.key_tiles_for(d)[0], BP.query_steps(t, d))}:
        BP.validate(p, b, h, t, d)
        nct = BP.col_tiles(d)
        seen = np.zeros((b, h, t, t, nct), np.int8)  # [.., key, query, column tile]
        for bi, hi, keys, queries, cols in BP.tiles(p, b, h, t, d):
            seen[bi, hi, keys.start : keys.stop, queries.start : queries.stop, cols.start // BP.COL_TILE] += 1
            assert cols.stop == min(cols.start + (d if nct == 1 else BP.COL_TILE), d)
        assert (seen == 1).all(), p


def test_wide_backward_plan_fills_the_card():
    """The full-width backward grids: 384–512 blocks, 2.9–3.9 waves of 132,
    the last wave at least 85% full, no split; the small shapes split the
    query loop to fill more SMs."""
    for b, t, h, d in FULL_BWD:
        p = BP.plan(b, h, t, d)
        assert p == BP.BwdPlan(64 if d <= 128 else 32, 1), (d, p)
        assert p.blocks(b, h, t, d) >= 384 and BP.wave_fill(p, b, h, t, d) >= 0.85
        assert p.ticket_elems(b, h, t, d) == 2 + b * h * (-(-t // 32) + -(-t // p.bk))
    assert BP.plan(2, 2, 100, 192) == BP.BwdPlan(32, 4)
    assert BP.BwdPlan(32, 1).ticket_elems(1, 1, 64, 640) == 2 + 3 * (2 + 2)  # three column tiles


def test_wide_backward_plan_refuses_what_the_kernel_cannot_take():
    for p, d in ((BP.BwdPlan(64, 1), 192), (BP.BwdPlan(32, 1), 128), (BP.BwdPlan(128, 1), 96), (BP.BwdPlan(32, 0), 256),
                 (BP.BwdPlan(32, 3), 256)):
        with pytest.raises(ValueError):
            BP.validate(p, 2, 4, 64, d)  # T = 64: two query steps of 32 above D = 64
    with pytest.raises(ValueError):
        BP.plan(2, 4, 40, 68)
    assert BP.key_tiles_for(64) == (128, 64) and BP.key_tiles_for(72) == (64,) and BP.key_tiles_for(136) == (32,)
