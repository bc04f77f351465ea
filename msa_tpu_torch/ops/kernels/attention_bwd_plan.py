"""The grid of the one-pass f32 attention backward, and its tickets.

``msa_tpu_torch/csrc/attention_bwd_f32.cu``'s one pass
(``msa_attention_bwd_onepass_f32``, f32 at any D % 8 == 0) gives each block
``bk`` keys of one (batch row, head) and one of ``splits`` runs of the
query loop's steps: split ``s`` of ``nq`` steps takes steps ``s·nq/S`` to
``(s+1)·nq/S``. Two kernels, by D:

- D ≤ 64, ``onepass_f32_kernel``: ``bk`` 64 or 128, steps of
  :data:`QUERY_STEP` = 64 queries;
- D > 64, ``wide_onepass_f32_kernel``: ``bk`` 64 at D ≤ 128 and 32 above
  (:func:`key_tiles_for`: dK and dV of the block's keys, 8192 values of a
  column tile, stay in registers), steps of :data:`WIDE_QUERY_STEP` = 32
  queries, and above D = 256 column tiles of :data:`COL_TILE`
  (:func:`col_tiles`), each a block of its own.

For D ≤ 64: one block
runs on an SM at a time (its shared memory and 8 warps at ``bk`` = 128, 4
at 64), so the grid's ``B·H·⌈T/bk⌉·splits`` blocks run in waves of
:data:`SMS`. :func:`plan` picks the pair of least modelled time
``waves · (steps a block + STEP_OVERHEAD) · (bk / 128) · (1 or
HALF_TILE_COST)``: a block pays a step's worth of set-up and ordered sums
besides its steps, and a 64-key block runs its step at ``HALF_TILE_COST``
times half a 128-key one's time (4 warps an SM hide less latency). Ties go
to the fewer blocks. Both constants are read off the card's timings of
every plan (``python3 -m msa_tpu_torch.profile_slice --attn-bwd-f32``,
PERF.md §6; H100 80GB HBM3, 700 W): at
B=2 T=749 128-key blocks without a split read 0.511 ms, with 2, 3 and 4
splits 0.409, 0.385 and 0.390 (the model: 26, 21, 20 and 20 steps), and
64-key blocks 1.38–1.45 times the model's half. At the served f32 training
shapes (H = 12, D = 64):

- B=8 T=512: 128 keys, no split, 384 blocks (2.91 waves);
- B=8 T=250 (the 5 s audio step): 128 keys, 2 splits, 384 blocks;
- B=2 T=749 (the 15 s audio step): 128 keys, 3 splits, 432 blocks (3.27
  waves; without a split 144, 1.09);
- B=2 T=40 H=4 (the custom widths): 64 keys, 8 blocks.

Above D = 64 the key tile follows from D and the plan picks the split
alone, on the same model with a step of 32 queries as its unit. At B=8
T=512 (H=4 D=192, H=3 D=256, H=6 D=128): no split, 512, 384 and 384
blocks; at B=2 H=2 T=100 D=192: 4 splits, 64 blocks. On the card
(``--attn-wide-f32-plans``) no split read 1.07–1.09× faster than 2 at
those full-width shapes, and 4 splits 1.63× faster than none at T=100.

The C entry takes a plan as one int (:attr:`BwdPlan.code`) and refuses one
it cannot take; :func:`launch_args` gives it with the per-stream ticket
buffer (``attention_bwd_f32_tickets``, zero at rest: the kernel leaves it
so).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, Tuple

import torch

from msa_tpu_torch.ops.kernels._common import zeroed

SMS = 132  # streaming multiprocessors of an H100 SXM
QUERY_STEP = 64  # queries a step of a block's loop
KEY_TILES = (128, 64)  # the keys a block owns, as the kernel is built
NARROW_MAX_D = 64  # onepass_f32_kernel's D; above it wide_onepass_f32_kernel
WIDE_QUERY_STEP = 32  # queries a step of the wide kernel's loop
COL_TILE = 256  # columns of dK, dV and dQ a wide block above D = 256
STEP_OVERHEAD = 1.0  # a block's set-up and ordered sums, in steps
HALF_TILE_COST = 1.4  # a 64-key step over half a 128-key one's time


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The keys a block owns (``bk``) and the runs the query loop is cut
    into (``splits``)."""

    bk: int
    splits: int

    @property
    def code(self) -> int:
        """The plan as the C entry takes it: bk | splits << 10."""
        return self.bk | self.splits << 10

    def key_tiles(self, t: int) -> int:
        return -(-t // self.bk)

    def blocks(self, b: int, h: int, t: int, d: int = NARROW_MAX_D) -> int:
        return b * h * self.key_tiles(t) * col_tiles(d) * self.splits

    def ticket_elems(self, b: int, h: int, t: int, d: int = NARROW_MAX_D) -> int:
        """int32 tickets the kernel takes: its work and finished-block
        counters, one a (b, h, column tile, query step) for dQ and one a
        (b, h, column tile, key tile) for dK/dV."""
        return 2 + b * h * col_tiles(d) * (query_steps(t, d) + self.key_tiles(t))


def query_step(d: int) -> int:
    """Queries a step of the loop of the kernel of head dim ``d``."""
    return QUERY_STEP if d <= NARROW_MAX_D else WIDE_QUERY_STEP


def query_steps(t: int, d: int = NARROW_MAX_D) -> int:
    return -(-t // query_step(d))


def key_tiles_for(d: int) -> Tuple[int, ...]:
    """The key tiles the kernel of head dim ``d`` is built for."""
    return KEY_TILES if d <= NARROW_MAX_D else (64,) if d <= 128 else (32,)


def col_tiles(d: int) -> int:
    """Column tiles of dK, dV and dQ: one at D ≤ 256, each forming S and
    dP again above."""
    return 1 if d <= COL_TILE else -(-d // COL_TILE)


def _check(b: int, h: int, t: int, d: int) -> None:
    if b < 1 or h < 1 or t < 1 or d < 8 or d % 8:
        raise ValueError(f"the one-pass f32 backward takes B, H, T ≥ 1 and D % 8 == 0, D ≥ 8; got B={b} H={h} T={t} D={d}")


def cost(p: BwdPlan, b: int, h: int, t: int, d: int = NARROW_MAX_D) -> float:
    """The modelled time of a plan, in 128-key steps (the module's note);
    above D = 64 in steps of the one key tile that D takes."""
    waves = -(-p.blocks(b, h, t, d) // SMS)
    steps = -(-query_steps(t, d) // p.splits)
    per_step = 1.0 if d > NARROW_MAX_D else p.bk / 128 * (1.0 if p.bk == 128 else HALF_TILE_COST)
    return waves * (steps + STEP_OVERHEAD) * per_step


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, t: int, d: int) -> BwdPlan:
    """The key tile and query split for the backward of q [b, h, t, d]
    (the module's rule); raises on a shape the kernel does not take."""
    _check(b, h, t, d)
    cands = [BwdPlan(bk, s) for bk in key_tiles_for(d) for s in range(1, query_steps(t, d) + 1)]
    return min(cands, key=lambda p: (cost(p, b, h, t, d), p.blocks(b, h, t, d)))


def validate(p: BwdPlan, b: int, h: int, t: int, d: int) -> None:
    """Raise unless the kernel takes plan ``p`` at this shape."""
    _check(b, h, t, d)
    if p.bk not in key_tiles_for(d) or not 1 <= p.splits <= query_steps(t, d) or p.blocks(b, h, t, d) >= 2**31:
        raise ValueError(f"the one-pass f32 backward has no plan {p} at B={b} H={h} T={t} D={d}")


def wave_fill(p: BwdPlan, b: int, h: int, t: int, d: int = NARROW_MAX_D) -> float:
    """The share of the last wave's SMs that hold a block."""
    blocks = p.blocks(b, h, t, d)
    return (blocks - (-(-blocks // SMS) - 1) * SMS) / SMS


def tiles(p: BwdPlan, b: int, h: int, t: int, d: int) -> Iterator[Tuple[int, int, range, range, range]]:
    """What each block computes, by the kernel's own index arithmetic (its
    work id w: key tile w % nkt, column tile (w / nkt) % nct, split
    (w / nkt / nct) % splits, (b, h) w / nkt / nct / splits): (batch row,
    head, its keys, its queries, its columns of dK, dV and dQ)."""
    nkt, nq, nct, step = p.key_tiles(t), query_steps(t, d), col_tiles(d), query_step(d)
    width = d if nct == 1 else COL_TILE
    for w in range(p.blocks(b, h, t, d)):
        kt, ct, sp, bh = w % nkt, w // nkt % nct, w // nkt // nct % p.splits, w // nkt // nct // p.splits
        j0, j1 = sp * nq // p.splits, (sp + 1) * nq // p.splits
        yield (bh // h, bh % h, range(kt * p.bk, min((kt + 1) * p.bk, t)), range(j0 * step, min(j1 * step, t)),
               range(ct * width, min((ct + 1) * width, d)))


def work_items(p: BwdPlan, b: int, h: int, t: int, d: int = NARROW_MAX_D) -> Iterator[Tuple[int, int, range, range]]:
    """:func:`tiles` without the columns: (batch row, head, its keys, its
    queries)."""
    for bi, hi, keys, queries, _ in tiles(p, b, h, t, d):
        yield bi, hi, keys, queries


def launch_args(device: torch.device, p: BwdPlan, b: int, h: int, t: int, d: int = NARROW_MAX_D) -> Tuple[int, int]:
    """(the ticket buffer's pointer, the plan's code) for a launch on the
    current stream: the buffer ``attention_bwd_f32_tickets`` grown to the
    plan's need before use."""
    return zeroed("attention_bwd_f32_tickets", device, p.ticket_elems(b, h, t, d)).data_ptr(), p.code
