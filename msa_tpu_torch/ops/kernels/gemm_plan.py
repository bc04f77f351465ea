"""Tiles and K splits of the port's two ``wgmma`` GEMMs, and their scratch.

``msa_tpu_torch/csrc/gemm_s8.cuh`` (int8, rows 7 and 9) and
``csrc/gemm_bf16.cuh`` (bf16, rows 8 and 10) compute ``epilogue(A·Wᵀ)``
for ``A [M, K]`` and ``W [N, K]`` on tiles of ``bm × bn`` rows and
columns, with K cut into ``splits`` runs of whole k-tiles of 128 bytes
(128 int8 or 64 bf16 values; ``csrc/wgmma.cuh``). :func:`plan` picks the
tile and the split per ``(M, N, K)`` and element type, each type by its own
rule, read off the card's timings of every candidate plan at the encoders'
GEMMs (``python3 -m msa_tpu_torch.profile_slice --gemm-s8`` and
``--gemm-bf16``; PERF.md §6). At these shapes a GEMM takes a launch and a
few k-tiles' latency, 4 to 13 µs, so the rules are about filling the 132
SMs without adding a round trip through L2:

- int8: 128 × 128 tiles where their grid alone gives every SM a CTA, else
  64 × 64; K split (exactly, int32 atomic sums into one tile) only where
  the tiles hold under half the SMs and each split keeps 4 k-tiles or
  more: fc_out (K = 3072) at M ≤ 256, never K = 768.
- bf16: the largest tile, 128 × 192 first, then 64 × 192, 128 × 128,
  64 × 128 (each where N is a multiple of its width), whose grid alone
  holds :data:`BF16_FILL` CTAs, else 64 × 64; at these shapes 72–132
  CTAs of a large tile beat more of a smaller one (a CTA's cost is its
  k-loop's cp.async and barrier steps, which a wider tile shares over
  more columns: QKV at M = 1024 96 CTAs of 128 × 192 0.0100 ms, 144 of
  128 × 128 0.0128; H100 80GB HBM3 at 700 W). K split only where even
  64 × 64 tiles hold under :data:`BF16_FILL` CTAs, into as many splits as
  bring the grid there while each keeps 12 k-tiles (768 values): fc_out
  (K = 3072) at M ≤ 256, never K = 768. The splits' f32 partials are
  summed in split order (deterministic), which a second launch did no
  faster.

The C entries take a plan as one int (:attr:`Plan.code`); :func:`launch_args`
gives them the split-K scratch of the current stream with it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, Tuple

import torch

from msa_tpu_torch.ops.kernels._common import scratch, zeroed

SMS = 132  # streaming multiprocessors of an H100 SXM
K_TILE = 128  # bytes of K a pipeline stage holds (one 128-byte swizzle row)


@dataclasses.dataclass(frozen=True)
class Plan:
    """A GEMM's tile (``bm`` rows × ``bn`` columns) and its K split."""

    bm: int
    bn: int
    splits: int

    @property
    def code(self) -> int:
        """The plan as the C entries take it: bm | bn << 10 | splits << 20."""
        return self.bm | self.bn << 10 | self.splits << 20

    def tiles(self, m: int, n: int) -> int:
        return -(-m // self.bm) * (n // self.bn)

    def ctas(self, m: int, n: int) -> int:
        return self.tiles(m, n) * self.splits

    def workspace_elems(self, m: int, n: int) -> int:
        """int32 sums the int8 split-K tiles need (one tile a tile: the
        splits add into it; none without a split)."""
        return self.tiles(m, n) * self.bm * self.bn if self.splits > 1 else 0

    def partial_elems(self, m: int, n: int) -> int:
        """f32 partials the bf16 split-K tiles need (one tile a split of
        each tile, summed in split order; none without a split)."""
        return self.tiles(m, n) * self.splits * self.bm * self.bn if self.splits > 1 else 0


@dataclasses.dataclass(frozen=True)
class Rule:
    """How one element type's GEMM is planned and what its kernel takes."""

    name: str
    elem_bytes: int
    tiles: Tuple[Tuple[int, int], ...]  # the (bm, bn) the kernel is built for
    k_align: int  # K % k_align == 0 (whole 16-byte chunks)
    min_split_k_tiles: int  # k-tiles a split keeps at the least

    def k_tiles(self, k: int) -> int:
        return -(-k * self.elem_bytes // K_TILE)


S8_RULE = Rule("int8", 1, ((64, 64), (128, 128)), 16, 4)
# bf16: its tiles in the order the planner tries them, 64 × 64 the last
BF16_RULE = Rule("bf16", 2, ((128, 192), (64, 192), (128, 128), (64, 128), (64, 64)), 8, 12)
BF16_FILL = 72  # CTAs a bf16 grid should hold (the card's timings: module note)
RULES = {torch.int8: S8_RULE, torch.bfloat16: BF16_RULE}


def _check(rule: Rule, m: int, n: int, k: int) -> None:
    if n % 128 or k % rule.k_align or k < rule.k_align or m < 1:
        raise ValueError(
            f"the {rule.name} GEMM takes N % 128 == 0, K % {rule.k_align} == 0 and M ≥ 1, got {m}, {n}, {k}"
        )


def _plan_s8(m: int, n: int, k: int) -> Plan:
    t = 128 if -(-m // 128) * (n // 128) >= SMS else 64
    tiles = -(-m // t) * (n // t)
    splits = 1
    if 2 * tiles < SMS:
        splits = max(1, min(-(-SMS // tiles), S8_RULE.k_tiles(k) // S8_RULE.min_split_k_tiles))
    return Plan(t, t, splits)


def _plan_bf16(m: int, n: int, k: int) -> Plan:
    for bm, bn in BF16_RULE.tiles:
        tiles = -(-m // bm) * (n // bn)
        if n % bn == 0 and tiles >= BF16_FILL:
            return Plan(bm, bn, 1)
    splits = max(1, min(-(-BF16_FILL // tiles), BF16_RULE.k_tiles(k) // BF16_RULE.min_split_k_tiles))
    return Plan(64, 64, splits)


@functools.lru_cache(maxsize=None)
def plan(m: int, n: int, k: int, dtype: torch.dtype) -> Plan:
    """The tile and split for ``A [m, k] · W [n, k]ᵀ`` in ``dtype`` (int8
    or bf16): each type's rule (the module's note); raises on a shape its
    kernel does not take."""
    rule = RULES[dtype]
    _check(rule, m, n, k)
    return (_plan_s8 if rule is S8_RULE else _plan_bf16)(m, n, k)


def cta_ranges(m: int, n: int, k: int, p: Plan, elem_bytes: int = 1) -> Iterator[Tuple[range, range, range]]:
    """The rows, columns and K (in elements) each CTA of the grid computes,
    by the kernels' own index arithmetic (``blockIdx.x`` the tile,
    row-major over ``n / bn`` columns; ``blockIdx.y`` the split, over
    k-tiles ``split·nk/S`` to ``(split+1)·nk/S`` of 128 bytes)."""
    n_tiles, per_tile = n // p.bn, K_TILE // elem_bytes
    nk = -(-k // per_tile)
    for tile in range(p.tiles(m, n)):
        m0, n0 = (tile // n_tiles) * p.bm, (tile % n_tiles) * p.bn
        for split in range(p.splits):
            k0, k1 = split * nk // p.splits * per_tile, (split + 1) * nk // p.splits * per_tile
            yield range(m0, min(m0 + p.bm, m)), range(n0, n0 + p.bn), range(k0, min(k1, k))


def validate(p: Plan, m: int, n: int, k: int, dtype: torch.dtype) -> None:
    """Raise unless ``dtype``'s kernel is built for ``p`` at this shape."""
    rule = RULES[dtype]
    _check(rule, m, n, k)
    if (p.bm, p.bn) not in rule.tiles or n % p.bn or not 1 <= p.splits <= rule.k_tiles(k):
        raise ValueError(f"the {rule.name} GEMM has no plan {p} at M={m} N={n} K={k}")


def launch_args(device: torch.device, *shapes: Tuple[int, int, int], dtype: torch.dtype,
                plans=None) -> Tuple[int, ...]:
    """For the GEMMs of one entry, each ``(M, N, K)`` in ``dtype``: the
    split-K workspace and the per-tile counters of the current stream,
    grown to the largest GEMM's need, then each plan's code (``plans``, or
    :func:`plan`'s): ``(ws pointer, counters pointer, code, ...)``. int8
    adds its splits into one zeroed int32 tile a tile (``gemm_s8_ws``);
    bf16 stores one f32 partial a split into a plain buffer
    (``gemm_bf16_ws``); the counters (``gemm_s8_counters``,
    ``gemm_bf16_counters``) are zero at rest."""
    plans = plans or [plan(*s, dtype) for s in shapes]
    if dtype == torch.int8:
        ws = zeroed("gemm_s8_ws", device, max(p.workspace_elems(m, n) for p, (m, n, _) in zip(plans, shapes)))
        cnt_name = "gemm_s8_counters"
    else:
        elems = max(p.partial_elems(m, n) for p, (m, n, _) in zip(plans, shapes))
        ws = scratch("gemm_bf16_ws", device, elems, torch.float32)
        cnt_name = "gemm_bf16_counters"
    cnt = zeroed(cnt_name, device, max(p.tiles(m, n) for p, (m, n, _) in zip(plans, shapes)))
    return (ws.data_ptr(), cnt.data_ptr(), *(p.code for p in plans))
