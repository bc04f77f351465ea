"""The int8 GEMM's planner and its exact split-K sum, on the CPU.

``msa_tpu_torch/csrc/gemm_s8.cuh`` (rows 7 and 9 on the card) runs each
GEMM on the tile and K split that ``ops/kernels/gemm_s8.py:plan`` picks;
the CUDA kernel runs only on the card (``chip_smoke.py`` phase 3 holds it
against ``torch._int_mm`` exactly), so these tests hold what surrounds it:

- every plan's grid, by the kernel's own index arithmetic
  (``cta_ranges``), covers M × N × K exactly once; at M ≥ 256 it holds 132
  CTAs or more wherever a split of K paid on the card (``plan``'s rule,
  read off ``profile_slice.py --gemm-s8``: at K = 768 every split was
  slower, e.g. Wo at M = 500 0.0043 ms on 96 CTAs, 0.0071 on 192 with two
  splits, on an H100 80GB HBM3 at 700 W);
- a model of the kernel's split-K sum (each split's int32 partial, added
  in int32 in any order, converted to f32 once) equals ``int8_matmul``
  bit for bit on codes at ±127 with K = 3072; a model that converts each
  split to f32 before adding differs on a crafted row, so the test can
  fail.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from msa_tpu_torch.ops import quant as Q
from msa_tpu_torch.ops.kernels import ffn as F
from msa_tpu_torch.ops.kernels import gemm_s8 as GS
from msa_tpu_torch.ops.kernels import quant as KQ

import torch_parity  # noqa: F401  (its import shares the CPU among xdist workers)

# (N, K) of the encoders' four GEMMs at d_model 768, d_ff 3072 (any head dim
# of 32, 64 or 128 gives H·DP = 768), and of a D = 192 block (DP 256, 4
# heads: QKV N = 3072, Wo K = 1024)
GEMMS = {"qkv": (2304, 768), "wo": (768, 768), "fc_in": (3072, 768), "fc_out": (768, 3072),
         "qkv_d192": (3072, 768), "wo_d192": (768, 1024)}
ROWS = (1024, 500, 256, 128, 64)  # B·T_pad of the main path: text 512 and audio 5 s at B=2, the stream at B=1


def _cover(m, n, k, p):
    """How many CTAs compute each cell of 64 rows × 64 columns × 128 bytes
    of K (every tile and split edge lies on these, or on M and K)."""
    count = np.zeros((-(-m // 64), n // 64, -(-k // GS.K_TILE)), np.int64)
    for rows, cols, ks in GS.cta_ranges(m, n, k, p):
        assert len(rows) and len(cols) and len(ks)
        assert rows.start % 64 == 0 and cols.start % 64 == 0 and ks.start % GS.K_TILE == 0
        count[rows.start // 64 : -(-rows.stop // 64), cols.start // 64 : cols.stop // 64,
              ks.start // GS.K_TILE : -(-ks.stop // GS.K_TILE)] += 1
    return count


# the planner's (tile, splits) at the main path's GEMMs, M = 1024, 500, 256,
# 128, 64: 128 × 128 tiles where they alone fill the SMs, else 64 × 64;
# fc_out's K (24 k-tiles) split where its tiles are few
PLANS = {"qkv": [(128, 1)] + [(64, 1)] * 4, "wo": [(64, 1)] * 5, "fc_in": [(128, 1)] + [(64, 1)] * 4,
         "fc_out": [(64, 1), (64, 1), (64, 3), (64, 6), (64, 6)]}


@pytest.mark.parametrize("gemm", list(GEMMS))
@pytest.mark.parametrize("m", ROWS)
def test_plan_covers_the_gemm_once(gemm, m):
    n, k = GEMMS[gemm]
    nk = -(-k // GS.K_TILE)
    p = GS.plan(m, n, k)
    assert p.bm == p.bn and p.bm in GS.TILES and 1 <= p.splits <= nk
    if gemm in PLANS:
        assert (p.bm, p.splits) == PLANS[gemm][ROWS.index(m)]
    assert (_cover(m, n, k, p) == 1).all()
    ranges = list(GS.cta_ranges(m, n, k, p))
    assert len(ranges) == p.ctas(m, n)
    assert max(r.stop for r, _, _ in ranges) == m and max(ks.stop for _, _, ks in ranges) == k
    # a split only where the tiles hold under half the SMs, 4 k-tiles a split at the least
    assert p.splits == 1 or (2 * p.tiles(m, n) < GS.SMS and nk // p.splits >= GS.MIN_SPLIT_K_TILES)
    if m >= 256:  # the card filled, or no split that paid would fill it
        assert p.ctas(m, n) >= GS.SMS or 2 * p.tiles(m, n) >= GS.SMS or p.splits == nk // GS.MIN_SPLIT_K_TILES
    assert p.workspace_elems(m, n) == (p.tiles(m, n) * p.bm * p.bn if p.splits > 1 else 0)
    assert GS.Plan(p.code & 0x3FF, p.code >> 10 & 0x3FF, p.code >> 20) == p  # the C entries' decoding


def test_plan_takes_128_tiles_where_they_fill_the_card():
    """B = 8 at bucket 512 (M = 4096): 128 × 128 tiles for every GEMM (192
    for Wo and fc_out); at M = 1024 for fc_in (192) but not Wo (48)."""
    assert GS.plan(4096, 3072, 768) == GS.plan(4096, 768, 3072) == GS.plan(4096, 768, 768) == GS.Plan(128, 128, 1)
    assert GS.plan(1024, 3072, 768) == GS.Plan(128, 128, 1)
    assert GS.plan(1024, 768, 768) == GS.Plan(64, 64, 1)


@pytest.mark.parametrize("m, n, k", [(100, 256, 416), (1, 128, 16), (257, 384, 2080)])
def test_plan_covers_ragged_shapes_once(m, n, k):
    """Rows past a tile, K past a k-tile (H·DP = 13·32 = 416): still one CTA
    a cell; the kernel zero-fills the rest and stores nothing past M."""
    p = GS.plan(m, n, k)
    assert (_cover(m, n, k, p) == 1).all()


def test_plan_refuses_what_the_kernel_does_not_take():
    for bad in ((64, 192, 768), (64, 768, 40), (0, 768, 768)):
        with pytest.raises(ValueError):
            GS.plan(*bad)


def _partials(a, w, m, n, k, p):
    """Each split's int32 partial sums of a·wᵀ over its bytes of K, as the
    kernel's CTAs compute them: [splits, M, N]."""
    out = torch.zeros((p.splits, m, n), dtype=torch.int32)
    splits = sorted({(ks.start, ks.stop) for _, _, ks in GS.cta_ranges(m, n, k, p)})
    assert len(splits) == p.splits
    for s, (k0, k1) in enumerate(splits):
        exact = a[:, k0:k1].double() @ w[:, k0:k1].double().t()  # |sum| < 2^31 ≪ 2^53: exact
        out[s] = exact.to(torch.int32)
    return out


def _codes(rng, m, k):
    """Codes at ±127: rows of random sign, and rows of one sign, whose sums
    reach 127²·K (4.95·10^7 at K = 3072, past f32's 2^24)."""
    c = np.where(rng.random((m, k)) < 0.5, -127, 127).astype(np.int8)
    c[::3] = 127
    return torch.from_numpy(c)


@pytest.mark.parametrize("m, splits", [(256, None), (128, None), (64, None), (500, 2), (64, 11), (64, 24)])
def test_split_k_sum_in_int32_equals_int8_matmul(m, splits):
    """fc_out (N = 768, K = 3072) on the planner's splits (3 at M = 256, 6
    at M = 128 and 64) and on others the kernel takes (2, 11, and 24: one
    k-tile each): partials summed in int32 in shuffled orders, converted
    once."""
    n, k = GEMMS["fc_out"]
    p = GS.plan(m, n, k) if splits is None else GS.Plan(64, 64, splits)
    assert p.splits > 1
    rng = np.random.default_rng(0)
    a, w = _codes(rng, m, k), _codes(rng, n, k)
    want = Q.int8_matmul(a, w)
    parts = _partials(a, w, m, n, k, p)
    for order in [range(p.splits)] + [rng.permutation(p.splits) for _ in range(3)]:
        acc = torch.zeros((m, n), dtype=torch.int32)
        for s in order:
            acc += parts[s]
        assert torch.equal(acc.float(), want)
    assert want.abs().max() > 2**24  # the regime where an f32 sum of the partials could round


def test_split_k_sum_converted_per_split_would_round():
    """The crafted row: A all 127; W all 127 but for one code of 126 in the
    first split and two in the second, fc_out at M = 500 in two splits of
    1536 bytes. The partials 24,774,017 and 24,773,890 are exact in int32;
    f32(p1) + f32(p2) rounds to 49,547,904, the int32 sum converted once
    to 49,547,908, which int8_matmul gives."""
    m, (n, k) = 500, GEMMS["fc_out"]
    p = GS.Plan(64, 64, 2)
    a = torch.full((m, k), 127, dtype=torch.int8)
    w = torch.full((n, k), 127, dtype=torch.int8)
    w[0, 0] = w[0, 1536] = w[0, 1537] = 126
    parts = _partials(a, w, m, n, k, p)
    assert (parts[0, 0, 0].item(), parts[1, 0, 0].item()) == (24_774_017, 24_773_890)
    want = Q.int8_matmul(a, w)
    exact = parts.sum(0, dtype=torch.int32).float()
    per_split = parts[0].float() + parts[1].float()
    assert torch.equal(exact, want)
    assert want[0, 0].item() == 49_547_908.0 and per_split[0, 0].item() == 49_547_904.0
    assert not torch.equal(per_split, want)


def test_gemm_s8_plain_dequantizes_in_the_kernels_order():
    """The GEMM alone on the CPU: (f32(a·wᵀ)·rs)·cs + bias, in f32; with
    gelu, fc_in's epilogue and each row's max |h| as f32 bits, from which
    the row quantization gives the codes and scales of its own amax."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(-127, 128, (70, 256), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (128, 256), dtype=np.int8))
    rs, cs = (torch.from_numpy(rng.random(s, dtype=np.float32) * 1e-3) for s in (70, 128))
    b = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    got = GS.gemm_s8(a, w, rs, cs, b)
    acc = (a.double() @ w.double().t()).float()
    want = (acc * rs[:, None]) * cs + b
    assert got.dtype == torch.float32 and torch.equal(got, want)
    h, amax = GS.gemm_s8(a, w, rs, cs, b, gelu=True)
    assert torch.equal(h, F.gelu_as(want)) and amax.dtype == torch.int32
    assert torch.equal(amax.view(torch.float32), h.abs().amax(dim=1))
    q, s = KQ.quantize_rows(h, amax)
    want_q, want_s = Q.quantize_rows(h)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert torch.equal(want_s[:, 0], torch.clamp(amax.view(torch.float32), min=1e-8) * Q.INV_127)
