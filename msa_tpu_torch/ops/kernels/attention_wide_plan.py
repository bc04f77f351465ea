"""The grid of the f32 attention forward above head dim 128, and its
tickets and workspace.

``msa_tpu_torch/csrc/attention_wide.cu``'s ``wide_f32_kernel`` (the f32
forward rows 1, 2, 5, 6 and the f32 cores of rows 7 and 8 at D > 128)
gives each block ``bq`` query rows (64, 32 or 16: 8, 4 or 2 rows a warp)
of one (batch row, head), a column tile of :data:`COL_TILE` columns of o
(one at D ≤ 256) and one of ``splits`` runs of the 128-key blocks: split
``s`` of ``nkb = ⌈T/128⌉`` takes key blocks ``s·nkb/S`` to ``(s+1)·nkb/S``.
One block runs on an SM at a time (8 warps, up to 225 KB of shared
memory), so the grid's ``B·H·⌈T/bq⌉·⌈D/256⌉·splits`` blocks run in waves
of :data:`SMS`. :func:`plan` picks the pair of least modelled time
``waves · (key blocks a split · TILE_COST[bq] + overhead)``: a 32- or
16-row block runs its key block at :data:`TILE_COST` times a 64-row one's
time (fewer FMAs, fewer of them per shared-memory load), and a block pays
:data:`BLOCK_OVERHEAD` key blocks of set-up and output, or
:data:`SPLIT_OVERHEAD` where its split is combined with the others. Ties
go to the fewer blocks. The costs are read off the card's timings of every
plan (``python3 -m msa_tpu_torch.profile_slice --attn-wide-f32-plans``;
PERF.md §6, H100 80GB HBM3, 700 W): at B=2 T=512 H=4 D=192 a 32-row key
block took 0.64 of a 64-row one, at B=2 H=2 T=100 a 16-row one 0.43; the
plan was the fastest of all at every shape below but T=749 (4% off). At
the full-width shapes (H100 SXM, 132 SMs):

- B=2 T=512 H=4 D=192 and H=3 D=256: 64 rows, 2 splits, 128 and 96 blocks;
- B=8 T=512 H=4 D=192: 64 rows, no split, 256 blocks;
- B=2 T=749 H=4 D=192: 64 rows, no split, 96 blocks;
- B=2 H=2 T=100: 16 rows, 28 blocks (one key block: no split).

A split stores its unnormalised o, m and l in a per-stream workspace
(``attention_wide_f32_ws``, :meth:`WidePlan.ws_elems` floats), and the
last of a (b, h, query tile, column tile)'s blocks to count itself in the
group's ticket (``attention_wide_f32_tickets``, zero at rest: the kernel
leaves it so) combines them in split order. The C entry takes a plan as
one int (:attr:`WidePlan.code`) and refuses one it cannot take.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, Tuple

import torch

from msa_tpu_torch.ops.kernels._common import scratch, zeroed

SMS = 132  # streaming multiprocessors of an H100 SXM
KEY_BLOCK = 128  # keys a step of the key loop: row 6's key block
COL_TILE = 256  # columns of o a block
QUERY_TILES = (64, 32, 16)  # query rows a block, as the kernel is built
MIN_D = 129  # the f32 rows take this kernel above D = 128
TILE_COST = {64: 1.0, 32: 0.65, 16: 0.45}  # a block's key block, against a 64-row one's
BLOCK_OVERHEAD = 0.25  # a block's set-up and output, in key blocks
SPLIT_OVERHEAD = 0.5  # the same where its split is stored and combined


@dataclasses.dataclass(frozen=True)
class WidePlan:
    """The query rows a block owns (``bq``) and the runs the key loop is
    cut into (``splits``)."""

    bq: int
    splits: int

    @property
    def code(self) -> int:
        """The plan as the C entry takes it: bq | splits << 10."""
        return self.bq | self.splits << 10

    def query_tiles(self, t: int) -> int:
        return -(-t // self.bq)

    def groups(self, b: int, h: int, t: int, d: int) -> int:
        """(b, h, query tile, column tile) groups: each one's splits are
        combined under one ticket."""
        return b * h * self.query_tiles(t) * col_tiles(d)

    def blocks(self, b: int, h: int, t: int, d: int) -> int:
        return self.groups(b, h, t, d) * self.splits

    def ticket_elems(self, b: int, h: int, t: int, d: int) -> int:
        """int32 tickets the kernel takes: one a group where the key loop
        is split, none without a split."""
        return self.groups(b, h, t, d) if self.splits > 1 else 0

    def ws_elems(self, b: int, h: int, t: int, d: int) -> int:
        """f32 partials of a split plan: o [bq × 256], m [bq] and l [bq] a
        block."""
        return self.blocks(b, h, t, d) * (self.bq * COL_TILE + 2 * self.bq) if self.splits > 1 else 0


def key_blocks(t: int) -> int:
    return -(-t // KEY_BLOCK)


def col_tiles(d: int) -> int:
    return -(-d // COL_TILE)


def _check(b: int, h: int, t: int, d: int) -> None:
    if b < 1 or h < 1 or t < 1 or d < MIN_D or d % 8:
        raise ValueError(f"the wide f32 attention takes B, H, T ≥ 1 and D % 8 == 0, D ≥ {MIN_D}; "
                         f"got B={b} H={h} T={t} D={d}")


def cost(p: WidePlan, b: int, h: int, t: int, d: int) -> float:
    """The modelled time of a plan, in 64-row key blocks (the module's note)."""
    waves = -(-p.blocks(b, h, t, d) // SMS)
    per_block = -(-key_blocks(t) // p.splits) * TILE_COST[p.bq]
    return waves * (per_block + (SPLIT_OVERHEAD if p.splits > 1 else BLOCK_OVERHEAD))


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, t: int, d: int) -> WidePlan:
    """The query tile and key split for the f32 forward of q [b, h, t, d]
    (the module's rule); raises on a shape the kernel does not take."""
    _check(b, h, t, d)
    cands = [WidePlan(bq, s) for bq in QUERY_TILES for s in range(1, key_blocks(t) + 1)]
    return min(cands, key=lambda p: (cost(p, b, h, t, d), p.blocks(b, h, t, d)))


def validate(p: WidePlan, b: int, h: int, t: int, d: int) -> None:
    """Raise unless the kernel takes plan ``p`` at this shape."""
    _check(b, h, t, d)
    if p.bq not in QUERY_TILES or not 1 <= p.splits <= key_blocks(t) or p.blocks(b, h, t, d) >= 2**31:
        raise ValueError(f"the wide f32 attention has no plan {p} at B={b} H={h} T={t} D={d}")


def wave_fill(p: WidePlan, b: int, h: int, t: int, d: int) -> float:
    """The share of the last wave's SMs that hold a block."""
    blocks = p.blocks(b, h, t, d)
    return (blocks - (-(-blocks // SMS) - 1) * SMS) / SMS


def work_items(p: WidePlan, b: int, h: int, t: int, d: int) -> Iterator[Tuple[int, int, range, range, range]]:
    """What each block computes, by the kernel's own index arithmetic (its
    block id: split fastest, then the column tile, the query tile, (b, h)):
    (batch row, head, its query rows, its keys, its columns of o)."""
    nqt, nct, nkb = p.query_tiles(t), col_tiles(d), key_blocks(t)
    for blk in range(p.blocks(b, h, t, d)):
        sp, grp = blk % p.splits, blk // p.splits
        ct, qt, bh = grp % nct, grp // nct % nqt, grp // nct // nqt
        kb0, kb1 = sp * nkb // p.splits, (sp + 1) * nkb // p.splits
        yield (bh // h, bh % h, range(qt * p.bq, min((qt + 1) * p.bq, t)),
               range(kb0 * KEY_BLOCK, min(kb1 * KEY_BLOCK, t)), range(ct * COL_TILE, min((ct + 1) * COL_TILE, d)))


def launch_args(device: torch.device, p: WidePlan, b: int, h: int, t: int, d: int) -> Tuple[int, int, int]:
    """(the plan's code, the ticket buffer's pointer, the workspace's) for a
    launch on the current stream: ``attention_wide_f32_tickets`` and
    ``attention_wide_f32_ws`` grown to the plan's need, both 0 (null)
    without a split."""
    if p.splits == 1:
        return p.code, 0, 0
    tickets = zeroed("attention_wide_f32_tickets", device, p.ticket_elems(b, h, t, d))
    ws = scratch("attention_wide_f32_ws", device, p.ws_elems(b, h, t, d), torch.float32)
    return p.code, tickets.data_ptr(), ws.data_ptr()
