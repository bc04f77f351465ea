"""The bf16 GEMM's planner, its deterministic split-K sum and its plain
version, on the CPU.

``msa_tpu_torch/csrc/gemm_bf16.cuh`` (rows 8 and 10 on the card) runs each
GEMM on the tile and K split that ``ops/kernels/gemm_plan.py:plan`` picks
for bf16; the CUDA kernel runs only on the card (``chip_smoke.py`` phase 3
holds it against an f32 product of the same bf16 operands, two calls bit
for bit), so these tests hold what surrounds it:

- every plan's grid, by the kernel's own index arithmetic
  (``cta_ranges``), covers M × N × K exactly once, and the planner's
  choices at the encoders' GEMMs are pinned (the rule read off
  ``profile_slice.py --gemm-bf16`` on an H100 80GB HBM3 at 700 W);
- the shapes and plans the kernel refuses raise;
- a model of the kernel's split-K sum (each split's f32 partial, added
  in split order by whichever CTA of the tile arrives last) gives the same
  bits under shuffled arrival orders, where adding in arrival order does
  not, so the test can fail;
- ``gemm_bf16_plain`` is the product ``ffn_plain`` and
  ``attention_block_plain`` round at, bit for bit;
- on ``meta`` tensors with a stand-in kernel library, rows 8 and 10 pass
  the planner's codes to their entries and count two GEMM launches.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from msa_tpu_torch.ops.kernels import attention as A
from msa_tpu_torch.ops.kernels import ffn as F
from msa_tpu_torch.ops.kernels import gemm_bf16 as GB
from msa_tpu_torch.ops.kernels import gemm_plan as GP

import torch_parity  # noqa: F401  (its import shares the CPU among xdist workers)

BF16 = torch.bfloat16
K_VALUES = GP.K_TILE // 2  # bf16 values a k-tile holds
# (N, K) of the encoders' four GEMMs at d_model 768, d_ff 3072, and of a
# D = 192 block (DP 256, 4 heads: QKV N = 3072, Wo K = 1024)
GEMMS = {"qkv": (2304, 768), "wo": (768, 768), "fc_in": (3072, 768), "fc_out": (768, 3072),
         "qkv_d192": (3072, 768), "wo_d192": (768, 1024)}
ROWS = (1024, 500, 256, 128, 64)  # B·T_pad of the main path: text 512 and audio 5 s at B=2, the stream at B=1

# the planner's (bm, bn, splits) at the main path's GEMMs, M = 1024, 500,
# 256, 128, 64: the largest tile (128 × 192, 64 × 192, 128 × 128, 64 × 128)
# whose grid alone holds BF16_FILL CTAs, else 64 × 64; only fc_out's K =
# 3072 (48 k-tiles) splits, where even 64 × 64 tiles are few
PLANS = {
    "qkv": [(128, 192, 1), (64, 192, 1), (64, 128, 1), (64, 64, 1), (64, 64, 1)],
    "wo": [(64, 128, 1), (64, 64, 1), (64, 64, 1), (64, 64, 1), (64, 64, 1)],
    "fc_in": [(128, 192, 1), (64, 192, 1), (64, 128, 1), (64, 64, 1), (64, 64, 1)],
    "fc_out": [(64, 128, 1), (64, 64, 1), (64, 64, 2), (64, 64, 3), (64, 64, 4)],
}


def _cover(m, n, k, p):
    """How many CTAs compute each cell of 64 rows × 64 columns × one k-tile
    (every tile and split edge lies on these, or on M and K)."""
    count = np.zeros((-(-m // 64), n // 64, -(-k // K_VALUES)), np.int64)
    for rows, cols, ks in GP.cta_ranges(m, n, k, p, elem_bytes=2):
        assert len(rows) and len(cols) and len(ks)
        assert rows.start % 64 == 0 and cols.start % 64 == 0 and ks.start % K_VALUES == 0
        count[rows.start // 64 : -(-rows.stop // 64), cols.start // 64 : cols.stop // 64,
              ks.start // K_VALUES : -(-ks.stop // K_VALUES)] += 1
    return count


@pytest.mark.parametrize("gemm", list(GEMMS))
@pytest.mark.parametrize("m", ROWS)
def test_plan_covers_the_gemm_once(gemm, m):
    n, k = GEMMS[gemm]
    nk = GP.BF16_RULE.k_tiles(k)
    p = GP.plan(m, n, k, BF16)
    GP.validate(p, m, n, k, BF16)
    assert (p.bm, p.bn) in GP.BF16_RULE.tiles and 1 <= p.splits <= nk
    if gemm in PLANS:
        assert (p.bm, p.bn, p.splits) == PLANS[gemm][ROWS.index(m)]
    assert (_cover(m, n, k, p) == 1).all()
    ranges = list(GP.cta_ranges(m, n, k, p, elem_bytes=2))
    assert len(ranges) == p.ctas(m, n)
    assert max(r.stop for r, _, _ in ranges) == m and max(ks.stop for _, _, ks in ranges) == k
    # a split only where 64 × 64 tiles hold under BF16_FILL CTAs, each split keeping 12 k-tiles
    assert p.splits == 1 or ((p.bm, p.bn) == (64, 64) and p.tiles(m, n) < GP.BF16_FILL
                             and nk // p.splits >= GP.BF16_RULE.min_split_k_tiles)
    assert p.ctas(m, n) >= GP.BF16_FILL or p.splits == nk // GP.BF16_RULE.min_split_k_tiles or (p.bm, p.bn) == (64, 64)
    assert p.partial_elems(m, n) == (p.tiles(m, n) * p.splits * p.bm * p.bn if p.splits > 1 else 0)
    assert GP.Plan(p.code & 0x3FF, p.code >> 10 & 0x3FF, p.code >> 20) == p  # the C entry's decoding


def test_plan_takes_wide_tiles_where_they_fill_the_card():
    """B = 8 at bucket 512 (M = 4096): 128 × 192 tiles for every GEMM; at
    M = 1024 for QKV (96 CTAs) and fc_in (128), not Wo or fc_out (32); a
    width N % 192 != 0 takes the 128-wide tiles."""
    for n, k in GEMMS.values():
        assert GP.plan(4096, n, k, BF16) == GP.Plan(128, 192, 1)
    assert GP.plan(1024, 2304, 768, BF16) == GP.plan(1024, 3072, 768, BF16) == GP.Plan(128, 192, 1)
    assert GP.plan(1024, 768, 768, BF16) == GP.Plan(64, 128, 1)
    assert GP.plan(4096, 1024, 1024, BF16) == GP.Plan(128, 128, 1)
    assert GP.plan(1024, 1024, 1024, BF16) == GP.Plan(64, 128, 1)


@pytest.mark.parametrize("m, n, k", [(100, 256, 416), (1, 128, 8), (257, 384, 2088), (77, 640, 3000)])
def test_plan_covers_ragged_shapes_once(m, n, k):
    """Rows past a tile, K past a k-tile (H·DP = 13·32 = 416, K = 8): still
    one CTA a cell; the kernel zero-fills the rest and stores nothing past
    M. Every tile the kernel is built for, at one split and at the most."""
    for bm, bn in GP.BF16_RULE.tiles:
        if n % bn:
            continue
        for splits in {1, GP.BF16_RULE.k_tiles(k)}:
            p = GP.Plan(bm, bn, splits)
            GP.validate(p, m, n, k, BF16)
            assert (_cover(m, n, k, p) == 1).all()
    assert (_cover(m, n, k, GP.plan(m, n, k, BF16)) == 1).all()


def test_plan_refuses_what_the_kernel_does_not_take():
    for bad in ((64, 192, 768), (64, 768, 40 + 4), (0, 768, 768), (64, 768, 0)):
        with pytest.raises(ValueError):
            GP.plan(*bad, BF16)
    for p, shape in (
        (GP.Plan(32, 64, 1), (64, 768, 768)),  # no such tile
        (GP.Plan(128, 256, 1), (64, 768, 768)),
        (GP.Plan(64, 192, 1), (64, 1024, 768)),  # 1024 % 192
        (GP.Plan(64, 64, 0), (64, 768, 768)),  # no split
        (GP.Plan(64, 64, 13), (64, 768, 768)),  # more splits than k-tiles (12)
    ):
        with pytest.raises(ValueError):
            GP.validate(p, *shape, BF16)
    GP.validate(GP.Plan(64, 64, 12), 64, 768, 768, BF16)  # one k-tile a split


def _partials(a, w, m, n, k, p):
    """Each split's f32 partial sums of a·wᵀ over its run of K, as the
    kernel's CTAs leave them in the workspace: [splits, M, N]."""
    splits = sorted({(ks.start, ks.stop) for _, _, ks in GP.cta_ranges(m, n, k, p, elem_bytes=2)})
    assert len(splits) == p.splits
    return torch.stack([a[:, k0:k1].float() @ w[:, k0:k1].float().t() for k0, k1 in splits])


def _last_cta_sum(parts, arrival):
    """The tile's last CTA to arrive (the last of ``arrival``) reads every
    split's partial and adds them in split order 0 … S−1."""
    assert sorted(arrival) == list(range(len(parts)))
    acc = parts[0].clone()
    for s in range(1, len(parts)):
        acc = acc + parts[s]
    return acc


@pytest.mark.parametrize("m, splits", [(256, None), (128, None), (64, None), (500, 3), (64, 48)])
def test_split_k_sum_in_split_order_is_deterministic(m, splits):
    """fc_out (N = 768, K = 3072) on the planner's splits (2 at M = 256, 3
    at 128, 4 at 64) and on others the kernel takes (3; 48: one k-tile
    each): the same bits under shuffled arrival orders; adding the
    partials in arrival order instead moves the last bit from three splits
    on, so the order matters and the test can fail."""
    n, k = GEMMS["fc_out"]
    p = GP.plan(m, n, k, BF16) if splits is None else GP.Plan(64, 64, splits)
    assert p.splits > 1
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(BF16)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32) / np.sqrt(k)).to(BF16)
    parts = _partials(a, w, m, n, k, p)
    orders = [list(range(p.splits))] + [list(rng.permutation(p.splits)) for _ in range(4)]
    sums = [_last_cta_sum(parts, order) for order in orders]
    assert all(torch.equal(s, sums[0]) for s in sums)
    exact = (a.double() @ w.double().t()).float()
    assert (sums[0] - exact).abs().max().item() < 1e-3
    in_arrival = []
    for order in orders[1:]:
        acc = parts[order[0]].clone()
        for s in order[1:]:
            acc = acc + parts[s]
        in_arrival.append(acc)
    # two partials add alike in either order (f32 addition commutes); from
    # three on, the order of additions moves the rounding
    assert any(not torch.equal(s, sums[0]) for s in in_arrival) == (p.splits > 2)


def _weights(rng, out_f, in_f):
    return torch.from_numpy((rng.standard_normal((out_f, in_f)) / np.sqrt(in_f)).astype(np.float32)).to(BF16)


def test_gemm_bf16_plain_is_the_ffn_plain_products():
    """ffn_plain = fc_out(bf16(gelu(fc_in(x)))), each a gemm_bf16_plain,
    bit for bit; on the CPU the wrapper is its plain version, whatever the
    plan."""
    rng = np.random.default_rng(1)
    d, f = 128, 256
    x = torch.from_numpy(rng.standard_normal((70, d)).astype(np.float32)).to(BF16)
    w1, w2 = _weights(rng, f, d), _weights(rng, d, f)
    b1, b2 = (torch.from_numpy(0.1 * rng.standard_normal(s).astype(np.float32)).to(BF16) for s in (f, d))
    h = GB.gemm_bf16(x, w1, b1, gelu=True)
    assert h.dtype == BF16 and torch.equal(h, GB.gemm_bf16_plain(x, w1, b1, gelu=True))
    assert torch.equal(GB.gemm_bf16(h, w2, b2, GP.Plan(64, 64, 4)), F.ffn_plain(x, w1, b1, w2, b2))


def test_gemm_bf16_plain_is_the_attention_block_plain_products():
    """attention_block_plain = Wo(attend(bf16(QKV(x)))), both projections
    gemm_bf16_plain with f32 biases, bit for bit (T = 128: no padding)."""
    rng = np.random.default_rng(2)
    b, t, dm, h = 2, 128, 128, 2
    x = torch.from_numpy(rng.standard_normal((b, t, dm)).astype(np.float32)).to(BF16)
    w_qkv, w_out = _weights(rng, 3 * dm, dm), _weights(rng, dm, dm)
    b_qkv, b_out = (torch.from_numpy(0.1 * rng.standard_normal(s).astype(np.float32)) for s in (3 * dm, dm))
    mask = torch.ones(b, t)
    mask[1, 90:] = 0.0
    qkv = GB.gemm_bf16_plain(x.reshape(b * t, dm), w_qkv, b_qkv)
    attn = A._attend(qkv.float().view(b, t, 3 * dm), mask, h, BF16, A._block_scale(w_qkv, h, None))
    out = GB.gemm_bf16_plain(attn.reshape(b * t, dm), w_out, b_out).view(b, t, dm)
    assert torch.equal(out, A.attention_block_plain(x, w_qkv, b_qkv, w_out, b_out, mask, h))


# --- the card path on meta tensors ----------------------------------------------


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
    for mod in (A, F, GB):
        monkeypatch.setattr(mod.build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=0))
    return lib


def _meta(*shape, dtype=BF16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_rows_8_and_10_pass_the_planners_codes_on_the_card_path(card):
    dm, dff, heads = 768, 3072, 12
    before = GB.gemm_bf16.launches
    F.ffn_fused(_meta(500, dm), _meta(dff, dm), _meta(dff), _meta(dm, dff), _meta(dm))
    A.attention_block(_meta(2, 512, dm), _meta(3 * dm, dm), _meta(3 * dm, dtype=torch.float32), _meta(dm, dm),
                      _meta(dm, dtype=torch.float32), _meta(2, 512, dtype=torch.float32), heads)
    (ffn_name, ffn), (att_name, att) = card.calls
    assert (ffn_name, att_name) == ("msa_ffn_fused", "msa_attention_block")
    assert ffn[-6:-1] == (500, dm, dff, GP.plan(500, dff, dm, BF16).code, GP.plan(500, dm, dff, BF16).code)
    assert att[11:16] == (2, 512, dm, heads, 64)
    assert att[-4:-2] == (GP.plan(1024, 3 * dm, dm, BF16).code, GP.plan(1024, dm, dm, BF16).code)
    assert GB.gemm_bf16.launches == before + 4


def test_gemm_bf16_alone_on_the_card_path(card):
    """The entry gets the plan's code, the bias dtype flag and the GELU
    flag; a plan the kernel is not built for raises before any launch."""
    before = GB.gemm_bf16.launches
    out = GB.gemm_bf16(_meta(64, 768), _meta(768, 3072 // 4), _meta(768), gelu=True)
    assert tuple(out.shape) == (64, 768) and out.dtype == BF16
    (name, args), = card.calls
    assert name == "msa_gemm_bf16" and args[3] == 1 and args[7:12] == (64, 768, 768, GP.plan(64, 768, 768, BF16).code, 1)
    GB.gemm_bf16(_meta(64, 768), _meta(768, 768), _meta(768, dtype=torch.float32), GP.Plan(64, 64, 12))
    assert card.calls[-1][1][3] == 0 and card.calls[-1][1][10] == GP.Plan(64, 64, 12).code
    with pytest.raises(ValueError):
        GB.gemm_bf16(_meta(64, 768), _meta(768, 768), _meta(768), GP.Plan(64, 64, 13))
    with pytest.raises(ValueError):
        GB.gemm_bf16(_meta(64, 768), _meta(256, 768), _meta(256), GP.Plan(64, 192, 1))
    assert GB.gemm_bf16.launches == before + 2 and len(card.calls) == 2
