"""Tiles and K splits of the port's three GEMMs, and their scratch.

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

``csrc/gemm_f32.cuh`` (f32 on the CUDA cores, rows 10, 8 and 11 in f32)
cuts the work by stream-K instead: a :class:`StreamPlan` names the tile and
a grid of ``ctas`` CTAs, over which the tiles' k-steps of 32 values
(:data:`F32_K_STEP`), taken in tile order, are shared out evenly
(``ctas`` = 0: one CTA a tile, whole K). A tile's runs from several CTAs
are added in k order by its last CTA to arrive. The f32 rule, read off
the card's timings of every tile at one CTA a tile and at grids of 132 to
528 CTAs (``profile_slice.py --gemm-f32``; PERF.md §6):

- w ``[N, K]``: 64 × 128 tiles (8 × 8 outputs a thread, two CTAs an SM),
  which beat or came within 3% of every other plan at the parity
  forward's GEMMs (128 × 128 on one CTA an SM among them, no longer
  built); where they number under :data:`F32_WIDE_TILES` (N = 768 at M ≤
  512), 128 × 64 (8 × 4 a thread, 16 warps an SM), 7–10% faster there.
  w ``[K, N]`` (row 11): 128 × 128 on one CTA an SM, which beat 128 × 64
  and 64 × 128 there.
- The grid: whole waves of 132 CTAs, as many as the tile's CTAs an SM
  (1 or 2) while each run keeps :data:`F32_MIN_RUN` k-steps or more (a
  grid of 144 left 12 SMs with two CTAs: Wo at M = 512 0.0392 ms against
  0.0286 on 132); where not even one wave does, one CTA a tile. Stream-K
  beat one CTA a tile at every GEMM of the parity forward (1.1–2.6×).

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

F32_K_STEP = 32  # k values a ring stage of the f32 GEMM holds
F32_TILES = ((64, 128), (128, 64))  # the f32 GEMM's tiles with w [N, K]
F32_KN_TILES = ((128, 128),)  # and with w [K, N] (row 11's weight)
F32_MAX_CTAS = 2047  # the plan code's 11 bits above bit 20
F32_WIDE_TILES = 96  # 64 × 128 tiles a GEMM needs to take them (the f32 rule)
F32_MIN_RUN = 8  # k-steps a stream-K run keeps at the least
F32_CTAS_AN_SM = {(64, 128): 2, (128, 64): 2, (128, 128): 1}  # as the kernel's launch bounds allow


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """The f32 GEMM's tile (``bm`` rows × ``bn`` columns) and its stream-K
    grid: ``ctas`` CTAs share the tiles' k-steps evenly; 0 is one CTA a
    tile."""

    bm: int
    bn: int
    ctas: int

    @property
    def code(self) -> int:
        """The plan as the C entry takes it: bm | bn << 10 | ctas << 20."""
        return self.bm | self.bn << 10 | self.ctas << 20

    def tiles(self, m: int, n: int, batch: int = 1) -> int:
        return -(-m // self.bm) * (n // self.bn) * batch

    def grid(self, m: int, n: int, batch: int = 1) -> int:
        """CTAs the kernel launches."""
        return self.ctas or self.tiles(m, n, batch)

    def steps(self, m: int, n: int, k: int, batch: int = 1) -> int:
        """k-steps of all tiles: what the CTAs share."""
        return self.tiles(m, n, batch) * -(-k // F32_K_STEP)

    def partial_elems(self, m: int, n: int, batch: int = 1) -> int:
        """f32 partials the runs need (two tile slots a CTA: its first and
        last tile; none where every CTA takes whole tiles)."""
        return 2 * self.ctas * self.bm * self.bn if self.ctas not in (0, self.tiles(m, n, batch)) else 0


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


def _check_f32(m: int, n: int, k: int, batch: int) -> None:
    if n % 128 or k % 4 or k < 4 or m < 1 or batch < 1:
        raise ValueError(f"the f32 GEMM takes N % 128 == 0, K % 4 == 0, M ≥ 1 and batch ≥ 1, got {m}, {n}, {k}, {batch}")


@functools.lru_cache(maxsize=None)
def plan_f32(m: int, n: int, k: int, batch: int = 1, w_nk: bool = True) -> StreamPlan:
    """The f32 GEMM's tile and stream-K grid for ``batch`` products ``A [m,
    k] · W`` (``W [n, k]`` where ``w_nk``, else ``[k, n]``): the f32 rule
    (the module's note); raises on a shape the kernel does not take."""
    _check_f32(m, n, k, batch)
    if not w_nk:
        bm, bn = 128, 128
    elif StreamPlan(64, 128, 0).tiles(m, n, batch) >= F32_WIDE_TILES:
        bm, bn = 64, 128
    else:
        bm, bn = 128, 64
    waves = min(F32_CTAS_AN_SM[bm, bn], StreamPlan(bm, bn, 0).steps(m, n, k, batch) // (F32_MIN_RUN * SMS))
    return StreamPlan(bm, bn, waves * SMS)


@functools.lru_cache(maxsize=None)
def plan(m: int, n: int, k: int, dtype: torch.dtype):
    """The tile and split for ``A [m, k] · W [n, k]ᵀ`` in ``dtype`` (int8,
    bf16, or f32: :func:`plan_f32`'s :class:`StreamPlan`): each type's rule
    (the module's note); raises on a shape its kernel does not take."""
    if dtype == torch.float32:
        return plan_f32(m, n, k)
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


def stream_runs(m: int, n: int, k: int, p: StreamPlan, batch: int = 1) -> Iterator[Tuple[int, int, range, range, range]]:
    """Each CTA's run of the f32 GEMM, tile by tile, by the kernel's own
    index arithmetic: ``(cta, batch row, rows, columns, K)`` in the order
    the CTAs and their k-steps come (CTA g takes k-steps ⌊g·I/G⌋ to
    ⌊(g+1)·I/G⌋ of the I = tiles · ⌈K/32⌉, tile t's steps t·⌈K/32⌉ on; tile
    t is batch row t // (m_tiles·n_tiles), then row-major over ``n / bn``
    columns)."""
    ipt, n_tiles, m_tiles = -(-k // F32_K_STEP), n // p.bn, -(-m // p.bm)
    total, grid = p.steps(m, n, k, batch), p.grid(m, n, batch)
    for g in range(grid):
        it, end = g * total // grid, (g + 1) * total // grid
        while it < end:
            t = it // ipt
            stop = min(end, (t + 1) * ipt)
            z, m0, n0 = t // (m_tiles * n_tiles), (t // n_tiles) % m_tiles * p.bm, t % n_tiles * p.bn
            k0, k1 = (it - t * ipt) * F32_K_STEP, min((stop - t * ipt) * F32_K_STEP, k)
            yield g, z, range(m0, min(m0 + p.bm, m)), range(n0, n0 + p.bn), range(k0, k1)
            it = stop


def validate(p, m: int, n: int, k: int, dtype: torch.dtype, batch: int = 1, w_nk: bool = True) -> None:
    """Raise unless ``dtype``'s kernel is built for ``p`` at this shape."""
    if dtype == torch.float32:
        _check_f32(m, n, k, batch)
        tiles = F32_TILES if w_nk else F32_KN_TILES
        if (not isinstance(p, StreamPlan) or (p.bm, p.bn) not in tiles or n % p.bn
                or not 0 <= p.ctas <= min(F32_MAX_CTAS, p.steps(m, n, k, batch)) or p.steps(m, n, k, batch) >= 2**31):
            raise ValueError(f"the f32 GEMM has no plan {p} at M={m} N={n} K={k} batch={batch}")
        return
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
    (``gemm_bf16_ws``), f32 two a CTA (``gemm_f32_ws``); the counters
    (``gemm_s8_counters``, ``gemm_bf16_counters``, ``gemm_f32_counters``)
    are zero at rest."""
    plans = plans or [plan(*s, dtype) for s in shapes]
    if dtype == torch.float32:
        elems = max(p.partial_elems(m, n) for p, (m, n, _) in zip(plans, shapes))
        ws = scratch("gemm_f32_ws", device, elems, torch.float32)
        cnt = zeroed("gemm_f32_counters", device, max(p.tiles(m, n) for p, (m, n, _) in zip(plans, shapes)))
        return (ws.data_ptr(), cnt.data_ptr(), *(p.code for p in plans))
    if dtype == torch.int8:
        ws = zeroed("gemm_s8_ws", device, max(p.workspace_elems(m, n) for p, (m, n, _) in zip(plans, shapes)))
        cnt_name = "gemm_s8_counters"
    else:
        elems = max(p.partial_elems(m, n) for p, (m, n, _) in zip(plans, shapes))
        ws = scratch("gemm_bf16_ws", device, elems, torch.float32)
        cnt_name = "gemm_bf16_counters"
    cnt = zeroed(cnt_name, device, max(p.tiles(m, n) for p, (m, n, _) in zip(plans, shapes)))
    return (ws.data_ptr(), cnt.data_ptr(), *(p.code for p in plans))
