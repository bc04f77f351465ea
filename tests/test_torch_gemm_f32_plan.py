"""The f32 GEMM's planner, its stream-K runs and folded split-K sum, and its
plain version, on the CPU.

``msa_tpu_torch/csrc/gemm_f32.cuh`` (rows 10, 8 and 11 in f32 on the card)
runs each GEMM on the tile and stream-K grid that
``ops/kernels/gemm_plan.py:plan_f32`` picks; the CUDA kernel runs only on
the card (``chip_smoke.py`` phase 17 holds it against ``gemm_f32_plain``
and 200 further calls bit for bit), so these tests hold what surrounds it:

- every plan's runs, by the kernel's own index arithmetic
  (``stream_runs``, and the owner and slot formulas of the kernel's
  ``finish``, mirrored here), cover M × N × K exactly once at the parity
  forward's eight encoder GEMMs, the 15 s audio FFN, row 11's conv and
  ragged M (500, 1498, 40); no two partial runs share a workspace slot;
  the planner's choices are pinned;
- the shapes and plans the kernel refuses raise;
- a model of the folded split-K sum (each run's f32 partial, added in k
  order by whichever CTA of the tile arrives last) gives the same bits
  under shuffled arrival orders, where adding in arrival order does not,
  so the test can fail;
- ``gemm_f32_plain`` is the product ``ffn_plain`` and
  ``attention_block_plain`` take on f32 operands, bit for bit, and matches
  JAX's f32 ``ffn_fused`` (interpret mode) within 1e-5 of the largest
  output;
- on ``meta`` tensors with a stand-in kernel library, rows 10 and 8 in f32
  pass the planner's codes to their entries and count two GEMM launches,
  and row 11 on f32 and the GEMM alone reach ``msa_gemm_f32``.
"""

from __future__ import annotations

from collections import defaultdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tpu.ops.pallas.ffn import ffn_fused as jax_ffn_fused
from msa_tpu_torch.ops.kernels import attention as A
from msa_tpu_torch.ops.kernels import conv as KC
from msa_tpu_torch.ops.kernels import ffn as F
from msa_tpu_torch.ops.kernels import gemm_f32 as GF
from msa_tpu_torch.ops.kernels import gemm_plan as GP
from test_torch_wide_heads import card  # noqa: F401 (the stand-in kernel library, a fixture)

import torch_parity  # noqa: F401  (its import shares the CPU among xdist workers)

F32 = torch.float32
STEP = GP.F32_K_STEP
# the parity forward's GEMMs at B=2 (M, N, K): text at bucket 512, audio at
# 5 s (QKV and Wo on T_pad 256, the FFN on T = 250), the 15 s audio FFN
GEMMS = {
    "text_qkv": (1024, 2304, 768), "text_wo": (1024, 768, 768), "text_fc_in": (1024, 3072, 768),
    "text_fc_out": (1024, 768, 3072), "audio_qkv": (512, 2304, 768), "audio_wo": (512, 768, 768),
    "audio_fc_in": (500, 3072, 768), "audio_fc_out": (500, 768, 3072),
    "long_fc_in": (1498, 3072, 768), "long_fc_out": (1498, 768, 3072),
}
# the planner's (bm, bn, ctas) at those GEMMs: 64 × 128 tiles on two CTAs an
# SM (264), or 128 × 64 where 64 × 128 tiles number under 96 (N = 768 at M ≤
# 512), in whole waves of 132 CTAs whose runs keep 8 k-steps or more (Wo at
# M = 512: one wave)
PLANS = {
    "text_qkv": (64, 128, 264), "text_wo": (64, 128, 264), "text_fc_in": (64, 128, 264),
    "text_fc_out": (64, 128, 264), "audio_qkv": (64, 128, 264), "audio_wo": (128, 64, 132),
    "audio_fc_in": (64, 128, 264), "audio_fc_out": (128, 64, 264),
    "long_fc_in": (64, 128, 264), "long_fc_out": (64, 128, 264),
}
CONV = (999, 512, 1536, 8)  # row 11 on f32 at B=8 L=1999 k=3 C=512: (out_len, C', k·C, B)


def _owner(x, total, grid):
    """The kernel's f32_owner: the CTA whose run holds k-step x."""
    return ((x + 1) * grid - 1) // total


def _slot(c, t, total, grid, ipt):
    """The kernel's slot_of: CTA c's first tile takes slot 2c, its last 2c + 1."""
    return 2 * c + (0 if t == (c * total // grid) // ipt else 1)


def _tile_runs(m, n, k, p, batch=1):
    """Each tile's runs in k order: [(cta, rows, cols, k range)]."""
    runs = defaultdict(list)
    n_tiles, m_tiles = n // p.bn, -(-m // p.bm)
    for g, z, rows, cols, ks in GP.stream_runs(m, n, k, p, batch):
        t = (z * m_tiles + rows.start // p.bm) * n_tiles + cols.start // p.bn
        runs[t].append((g, rows, cols, ks))
    return runs


def _check_runs(m, n, k, p, batch=1):
    """Every cell once; each tile's runs contiguous in k, owned as the
    kernel's arithmetic says; partial runs on distinct slots."""
    count = np.zeros((batch, -(-m // 16), n // 16, -(-k // 4)), np.int64)
    ipt, total, grid = -(-k // STEP), p.steps(m, n, k, batch), p.grid(m, n, batch)
    slots = set()
    tiles = _tile_runs(m, n, k, p, batch)
    assert len(tiles) == p.tiles(m, n, batch)
    for t, runs in tiles.items():
        z = t // (-(-m // p.bm) * (n // p.bn))
        assert [r[3].start for r in runs] == sorted(r[3].start for r in runs)
        assert runs[0][3].start == 0 and runs[-1][3].stop == k
        assert all(a[3].stop == b[3].start for a, b in zip(runs, runs[1:]))
        gs = [r[0] for r in runs]
        assert gs == list(range(gs[0], gs[0] + len(gs)))  # consecutive CTAs
        assert gs[0] == _owner(t * ipt, total, grid) and gs[-1] == _owner((t + 1) * ipt - 1, total, grid)
        for g, rows, cols, ks in runs:
            assert len(rows) and len(cols) and len(ks) and ks.start % STEP == 0
            count[z, rows.start // 16 : -(-rows.stop // 16), cols.start // 16 : cols.stop // 16,
                  ks.start // 4 : ks.stop // 4] += 1
            if len(runs) > 1:
                s = _slot(g, t, total, grid, ipt)
                assert 0 <= s < 2 * grid and s not in slots
                slots.add(s)
    assert (count == 1).all()
    assert p.partial_elems(m, n, batch) >= (max(slots) + 1) * p.bm * p.bn if slots else True


@pytest.mark.parametrize("gemm", list(GEMMS))
def test_plan_covers_the_gemm_once(gemm):
    m, n, k = GEMMS[gemm]
    p = GP.plan_f32(m, n, k)
    GP.validate(p, m, n, k, F32)
    assert GP.plan(m, n, k, F32) == p and (p.bm, p.bn, p.ctas) == PLANS[gemm]
    _check_runs(m, n, k, p)
    assert GP.StreamPlan(p.code & 0x3FF, p.code >> 10 & 0x3FF, p.code >> 20) == p  # the C entry's decoding
    # no grid of 144 or 192 tiles on 132 SMs: every CTA has the same k-steps, to one
    per_cta = defaultdict(int)
    for g, _, _, _, ks in GP.stream_runs(m, n, k, p):
        per_cta[g] += -(-len(ks) // STEP)
    assert len(per_cta) == p.grid(m, n) and max(per_cta.values()) - min(per_cta.values()) <= 1
    assert min(per_cta.values()) >= GP.F32_MIN_RUN


def test_plan_takes_one_cta_a_tile_where_runs_would_be_short():
    """A GEMM too small for a wave of 132 runs of 8 k-steps takes one CTA a
    tile (the head-dim encoders' M = 80, K = 128; M = 1); the conv's [K, N]
    path 128 × 128 on one CTA an SM."""
    assert GP.plan_f32(80, 384, 128) == GP.StreamPlan(128, 64, 0)
    assert GP.plan_f32(1, 128, 4) == GP.StreamPlan(128, 64, 0)
    assert GP.plan_f32(80, 3072, 768) == GP.StreamPlan(128, 64, 132)
    m, n, k, b = CONV
    assert GP.plan_f32(m, n, k, batch=b, w_nk=False) == GP.StreamPlan(128, 128, 132)


@pytest.mark.parametrize("m", [500, 1498, 40, 1, 129])
@pytest.mark.parametrize("n, k", [(768, 3072), (384, 128), (256, 1028)])
def test_plan_covers_ragged_shapes_once(m, n, k):
    """Rows past a tile and K past a k-step (K = 1028: one 4-value chunk
    over 32 steps): one run a cell, on every tile the kernel is built for,
    at one CTA a tile and at the stream-K grids."""
    for bm, bn in GP.F32_TILES:
        for ctas in (0, 3, 132, 264):
            p = GP.StreamPlan(bm, bn, ctas)
            if ctas > p.steps(m, n, k):
                continue
            GP.validate(p, m, n, k, F32)
            _check_runs(m, n, k, p)
    _check_runs(m, n, k, GP.plan_f32(m, n, k))


@pytest.mark.parametrize("batch", [8, 2])
def test_conv_plan_covers_each_batch_row_once(batch):
    """Row 11 on f32: w [K, N] takes 128 × 128 tiles, the batch rows on
    the same grid."""
    m, n, k, _ = CONV
    p = GP.plan_f32(m, n, k, batch=batch, w_nk=False)
    GP.validate(p, m, n, k, F32, batch, w_nk=False)
    assert (p.bm, p.bn) in GP.F32_KN_TILES
    _check_runs(m, n, k, p, batch)
    for ctas in (0, 132, 264):
        _check_runs(m, n, k, GP.StreamPlan(128, 128, ctas), batch)


def test_plan_refuses_what_the_kernel_does_not_take():
    for bad in ((64, 192, 768), (64, 768, 6), (0, 768, 768), (64, 768, 0)):
        with pytest.raises(ValueError):
            GP.plan_f32(*bad)
    with pytest.raises(ValueError):
        GP.plan_f32(64, 768, 768, batch=0)
    for p, shape, kw in (
        (GP.StreamPlan(64, 64, 0), (64, 768, 768), {}),  # no such tile
        (GP.StreamPlan(128, 128, 0), (64, 768, 768), {}),  # w [N, K] takes 64 × 128 and 128 × 64
        (GP.StreamPlan(64, 128, 0), (64, 768, 768), {"w_nk": False}),  # w [K, N] takes 128 × 128 only
        (GP.StreamPlan(64, 128, -1), (64, 768, 768), {}),
        (GP.StreamPlan(64, 128, 7), (64, 128, 192), {}),  # more CTAs than k-steps (6)
        (GP.StreamPlan(64, 128, 2048), (4096, 3072, 768), {}),  # past the code's 11 bits
        (GP.StreamPlan(128, 64, 0), (64, 192, 768), {}),  # N % 128
        (GP.Plan(64, 128, 1), (64, 768, 768), {}),  # a split-K plan of the wgmma GEMMs
    ):
        with pytest.raises(ValueError):
            GP.validate(p, *shape, F32, **kw)
    GP.validate(GP.StreamPlan(64, 128, 6), 64, 128, 192, F32)  # one k-step a CTA


def _runs_sum(a, w, m, n, k, p):
    """Each tile's runs as f32 partials, and the model of the kernel's sum:
    [(tile rows, tile cols, partials in k order)]."""
    out = []
    for runs in _tile_runs(m, n, k, p).values():
        rows, cols = runs[0][1], runs[0][2]
        r, c = slice(rows.start, rows.stop), slice(cols.start, cols.stop)
        parts = [a[r, ks.start : ks.stop] @ w[c, ks.start : ks.stop].t() for _, _, _, ks in runs]
        out.append((r, c, parts))
    return out


def _last_cta_sum(parts, arrival):
    """The tile's last CTA to arrive (the last of ``arrival``) reads every
    run's partial and adds them in k order."""
    assert sorted(arrival) == list(range(len(parts)))
    acc = parts[0].clone()
    for s in range(1, len(parts)):
        acc = acc + parts[s]
    return acc


@pytest.mark.parametrize("m, n, k, ctas", [(512, 768, 768, 132), (500, 768, 3072, 264), (1024, 768, 768, 264)])
def test_split_k_sum_in_k_order_is_deterministic(m, n, k, ctas):
    """Tiles cut between 2–6 CTAs: the same bits under shuffled arrival
    orders; adding the partials in arrival order instead moves the last bit
    where a tile has three runs or more, so the order matters and the test
    can fail."""
    p = GP.StreamPlan(64, 128, ctas)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32))
    exact = (a.double() @ w.double().t()).float()
    moved, three = False, False
    for rows, cols, parts in _runs_sum(a, w, m, n, k, p):
        orders = [list(range(len(parts)))] + [list(rng.permutation(len(parts))) for _ in range(3)]
        sums = [_last_cta_sum(parts, order) for order in orders]
        assert all(torch.equal(s, sums[0]) for s in sums)
        assert (sums[0] - exact[rows, cols]).abs().max().item() < 1e-4
        three |= len(parts) > 2
        for order in orders[1:]:
            acc = parts[order[0]].clone()
            for s in order[1:]:
                acc = acc + parts[s]
            moved |= not torch.equal(acc, sums[0])
    assert three and moved


def _weights(rng, out_f, in_f):
    return torch.from_numpy((rng.standard_normal((out_f, in_f)) / np.sqrt(in_f)).astype(np.float32))


def test_gemm_f32_plain_is_the_ffn_plain_products():
    """ffn_plain on f32 = fc_out(gelu(fc_in(x))), each a gemm_f32_plain,
    bit for bit; on the CPU the wrapper is its plain version, whatever the
    plan."""
    rng = np.random.default_rng(1)
    d, f = 128, 256
    x = torch.from_numpy(rng.standard_normal((70, d)).astype(np.float32))
    w1, w2 = _weights(rng, f, d), _weights(rng, d, f)
    b1, b2 = (torch.from_numpy(0.1 * rng.standard_normal(s).astype(np.float32)) for s in (f, d))
    h = GF.gemm_f32(x, w1, b1, gelu=True)
    assert h.dtype == F32 and torch.equal(h, GF.gemm_f32_plain(x, w1, b1, gelu=True))
    assert torch.equal(GF.gemm_f32(h, w2, b2, GP.StreamPlan(64, 128, 5)), F.ffn_plain(x, w1, b1, w2, b2))


def test_gemm_f32_plain_is_the_attention_block_plain_products():
    """attention_block_plain on f32 = Wo(attend(QKV(x))), both projections
    gemm_f32_plain, bit for bit (T = 128: no padding)."""
    rng = np.random.default_rng(2)
    b, t, dm, h = 2, 128, 128, 2
    x = torch.from_numpy(rng.standard_normal((b, t, dm)).astype(np.float32))
    w_qkv, w_out = _weights(rng, 3 * dm, dm), _weights(rng, dm, dm)
    b_qkv, b_out = (torch.from_numpy(0.1 * rng.standard_normal(s).astype(np.float32)) for s in (3 * dm, dm))
    mask = torch.ones(b, t)
    mask[1, 90:] = 0.0
    qkv = GF.gemm_f32_plain(x.reshape(b * t, dm), w_qkv, b_qkv)
    attn = A._attend(qkv.view(b, t, 3 * dm), mask, h, F32, A._block_scale(w_qkv, h, None))
    out = GF.gemm_f32_plain(attn.reshape(b * t, dm), w_out, b_out).view(b, t, dm)
    assert torch.equal(out, A.attention_block_plain(x, w_qkv, b_qkv, w_out, b_out, mask, h))


def test_gemm_f32_plain_matches_jax_ffn_fused_f32():
    """Two gemm_f32_plain (fc_in with the GELU, fc_out) against JAX's f32
    ffn_fused in interpret mode, within 1e-5 of the largest output (the
    smoke's F32_GEMM_RTOL: both exact f32, the sums in another order)."""
    rng = np.random.default_rng(3)
    n, d, f = 100, 128, 256
    x = rng.standard_normal((n, d)).astype(np.float32)
    w1, w2 = (rng.standard_normal(s).astype(np.float32) / np.sqrt(s[1]) for s in ((f, d), (d, f)))
    b1, b2 = (0.1 * rng.standard_normal(s).astype(np.float32) for s in (f, d))
    t = torch.from_numpy
    got = GF.gemm_f32_plain(GF.gemm_f32_plain(t(x), t(w1), t(b1), gelu=True), t(w2), t(b2)).numpy()
    want = np.asarray(jax_ffn_fused(jnp.asarray(x), jnp.asarray(w1.T), jnp.asarray(b1), jnp.asarray(w2.T),
                                    jnp.asarray(b2), interpret=True))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_conv_plain_is_the_gemm_f32_plain_product():
    """Row 11's plain version on f32 is gemm_f32_plain over the taps (rows
    2C apart, w [k·C, C'] as W [N, K] transposed), with the GELU."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 41, 128)).astype(np.float32))
    w = torch.from_numpy(0.05 * rng.standard_normal((3, 128, 256)).astype(np.float32))
    out_len = (41 - 3) // 2 + 1
    taps = x.as_strided((2, out_len, 3 * 128), (41 * 128, 2 * 128, 1)).reshape(2 * out_len, 3 * 128)
    got = GF.gemm_f32_plain(taps, w.reshape(3 * 128, 256).t(), gelu=True).view(2, out_len, 256)
    assert torch.equal(got, KC.conv_stride2_reference(x, w))


# --- the card path on meta tensors ----------------------------------------------


def _meta(*shape, dtype=F32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_rows_8_and_10_pass_the_planners_codes_on_the_card_path(card):
    dm, dff, heads = 768, 3072, 12
    before, before_f = GF.gemm_f32.launches, (F.ffn_fused.launches_f32, A.attention_block.launches_f32)
    F.ffn_fused(_meta(500, dm), _meta(dff, dm), _meta(dff), _meta(dm, dff), _meta(dm))
    A.attention_block(_meta(2, 512, dm), _meta(3 * dm, dm), _meta(3 * dm), _meta(dm, dm), _meta(dm),
                      _meta(2, 512), heads)
    (ffn_name, ffn), (att_name, att) = card.calls
    assert (ffn_name, att_name) == ("msa_ffn_fused_f32", "msa_attention_block_f32")
    # the block: 12 pointers, 7 ints, the wide f32 core's plan, tickets and workspace (zeros at DP 64), scale, stream
    assert len(ffn) == 9 + 5 + 1 and len(att) == 12 + 7 + 3 + 2
    assert ffn[-6:-1] == (500, dm, dff, GP.plan_f32(500, dff, dm).code, GP.plan_f32(500, dm, dff).code)
    assert att[12:17] == (2, 512, dm, heads, 64)
    assert att[-7:-5] == (GP.plan_f32(1024, 3 * dm, dm).code, GP.plan_f32(1024, dm, dm).code) and att[-5:-2] == (0, 0, 0)
    assert GF.gemm_f32.launches == before + 4
    assert (F.ffn_fused.launches_f32, A.attention_block.launches_f32) == (before_f[0] + 1, before_f[1] + 1)


def test_gemm_f32_alone_and_row_11_on_the_card_path(card):
    """The entry gets the plan's code, w's layout, the row stride and the
    batch strides; a plan the kernel is not built for raises before any
    launch."""
    before = GF.gemm_f32.launches
    out = GF.gemm_f32(_meta(64, 768), _meta(3072, 768), _meta(3072), gelu=True)
    assert tuple(out.shape) == (64, 3072) and out.dtype == F32
    (name, args), = card.calls
    assert name == "msa_gemm_f32" and args[6:16] == (64, 3072, 768, 768, 1, 1, 0, 0, GP.plan_f32(64, 3072, 768).code, 1)
    GF.gemm_f32(_meta(64, 768), _meta(768, 768), None, GP.StreamPlan(64, 128, 0))
    assert card.calls[-1][1][2] is None and card.calls[-1][1][14] == GP.StreamPlan(64, 128, 0).code
    with pytest.raises(ValueError):
        GF.gemm_f32(_meta(64, 768), _meta(768, 768), _meta(768), GP.StreamPlan(64, 64, 0))
    with pytest.raises(ValueError):
        GF.gemm_f32(_meta(64, 768), _meta(768, 768), _meta(768), GP.StreamPlan(64, 128, 10_000))
    b, length, c, cout = 8, 1999, 512, 512
    conv_before = KC.conv_stride2_fused.launches
    out = KC.conv_stride2_fused(_meta(b, length, c), _meta(3, c, cout))
    assert tuple(out.shape) == (b, 999, cout)
    name, args = card.calls[-1]
    p = GP.plan_f32(999, cout, 3 * c, batch=b, w_nk=False)
    assert name == "msa_gemm_f32" and args[2] is None
    assert args[6:16] == (999, cout, 3 * c, 2 * c, 0, b, length * c, 999 * cout, p.code, 1)
    assert GF.gemm_f32.launches == before + 3 and KC.conv_stride2_fused.launches == conv_before + 1
    assert len(card.calls) == 3
