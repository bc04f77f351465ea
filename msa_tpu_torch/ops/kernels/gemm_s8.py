"""The int8 GEMM under the W8A8 kernels (rows 7 and 9): its planner, its
split-K workspace, and the GEMM alone.

``msa_tpu_torch/csrc/gemm_s8.cuh`` computes ``epilogue(A·Wᵀ)`` for
``A [M, K]`` and ``W [N, K]`` int8 with ``wgmma`` on square tiles of 64 or
128, with K cut into ``splits`` runs of whole 128-byte k-tiles. The int32
partial sums of a split are exact, so the splits add them into one int32
tile in any order and the tile's last CTA converts the sum to f32 once:
the result is bit-equal to :func:`msa_tpu_torch.ops.quant.int8_matmul`
whatever the plan.

:func:`plan` picks the tile and the split per ``(M, N, K)`` by a rule
read off the card's timings of every candidate plan at the encoders'
GEMMs (``python3 -m msa_tpu_torch.profile_slice --gemm-s8``; PERF.md
§6): at these shapes a GEMM takes a launch and a few k-tiles' latency, 4
to 13 µs; 128 × 128 tiles are the faster where their grid alone gives
every SM a CTA (fc_in at M = 1024, every GEMM at M = 4096), 64 × 64 tiles,
one warpgroup a CTA, below that. A split of K adds a round trip through
L2 (the atomic int32 sums, a fence, the tile's counter), which pays only
where the tiles hold under half the SMs and each split keeps 4 k-tiles or
more: fc_out (K = 3072) at M ≤ 256; never at K = 768.

:func:`gemm_s8` launches the GEMM alone (f32 out; with ``gelu``, fc_in's
epilogue and its row amax): the smoke holds it against ``torch._int_mm``
exactly. The W8A8 wrappers launch it from C, twice a call, and add those
launches to ``gemm_s8.launches``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, Tuple

import torch

from msa_tpu_torch.ops import quant as Q
from msa_tpu_torch.ops.kernels import build
from msa_tpu_torch.ops.kernels._common import require, zeroed

SMS = 132  # streaming multiprocessors of an H100 SXM
K_TILE = 128  # bytes of K a pipeline stage holds (one 128-byte swizzle row)
TILES = (64, 128)  # the square tiles the kernel is built for
MIN_SPLIT_K_TILES = 4  # k-tiles a split keeps at the least


@dataclasses.dataclass(frozen=True)
class Plan:
    """A GEMM's tile (``bm`` rows × ``bn`` columns) and its K split."""

    bm: int
    bn: int
    splits: int

    @property
    def code(self) -> int:
        """The plan as the C entries take it: bm | bn << 8 | splits << 16."""
        return self.bm | self.bn << 8 | self.splits << 16

    def tiles(self, m: int, n: int) -> int:
        return -(-m // self.bm) * (n // self.bn)

    def ctas(self, m: int, n: int) -> int:
        return self.tiles(m, n) * self.splits

    def workspace_elems(self, m: int, n: int) -> int:
        """int32 sums the split-K tiles need (none without a split)."""
        return self.tiles(m, n) * self.bm * self.bn if self.splits > 1 else 0


@functools.lru_cache(maxsize=None)
def plan(m: int, n: int, k: int) -> Plan:
    """The tile and split for ``A [m, k] · W [n, k]ᵀ`` (n % 128 == 0): 128 ×
    128 tiles where they alone give every SM a CTA, else 64 × 64; K
    split only where the tiles hold under half the SMs, into as many splits
    as bring the grid to :data:`SMS` CTAs while each keeps
    :data:`MIN_SPLIT_K_TILES` k-tiles."""
    if n % 128 or k % 16 or m < 1:
        raise ValueError(f"the int8 GEMM takes N % 128 == 0, K % 16 == 0 and M ≥ 1, got {m}, {n}, {k}")
    t = 128 if -(-m // 128) * (n // 128) >= SMS else 64
    tiles = -(-m // t) * (n // t)
    splits = 1
    if 2 * tiles < SMS:
        splits = max(1, min(-(-SMS // tiles), -(-k // K_TILE) // MIN_SPLIT_K_TILES))
    return Plan(t, t, splits)


def cta_ranges(m: int, n: int, k: int, p: Plan) -> Iterator[Tuple[range, range, range]]:
    """The rows, columns and bytes of K each CTA of the grid computes, by
    the kernel's own index arithmetic (``gemm_s8_kernel``: ``blockIdx.x``
    the tile, row-major over ``n / bn`` columns; ``blockIdx.y`` the split,
    over k-tiles ``split·nk/S`` to ``(split+1)·nk/S``)."""
    n_tiles, nk = n // p.bn, -(-k // K_TILE)
    for tile in range(p.tiles(m, n)):
        m0, n0 = (tile // n_tiles) * p.bm, (tile % n_tiles) * p.bn
        for split in range(p.splits):
            k0, k1 = split * nk // p.splits * K_TILE, (split + 1) * nk // p.splits * K_TILE
            yield range(m0, min(m0 + p.bm, m)), range(n0, n0 + p.bn), range(k0, min(k1, k))


def launch_args(device: torch.device, *shapes: Tuple[int, int, int], plans=None) -> Tuple[int, ...]:
    """For the GEMMs of one entry, each ``(M, N, K)``: the split-K
    workspace and the per-tile counters (:func:`zeroed` buffers of the
    current stream, grown to the largest GEMM's need), then each plan's
    code (``plans``, or :func:`plan`'s): ``(ws pointer, counters pointer,
    code, ...)``."""
    plans = plans or [plan(*s) for s in shapes]
    ws = zeroed("gemm_s8_ws", device, max(p.workspace_elems(m, n) for p, (m, n, _) in zip(plans, shapes)))
    cnt = zeroed("gemm_s8_counters", device, max(p.tiles(m, n) for p, (m, n, _) in zip(plans, shapes)))
    return (ws.data_ptr(), cnt.data_ptr(), *(p.code for p in plans))


def gemm_s8_plain(a, w, row_scale, col_scale, bias, gelu: bool = False):
    """Plain PyTorch version: ``(f32(a·wᵀ)·rs)·cs + bias`` in f32; with
    ``gelu``, ``(gelu_as(that), each row's max |value| as f32 bits in
    int32)``."""
    out = Q.int8_matmul(a, w) * row_scale.float()[:, None] * col_scale.float() + bias.float()
    if not gelu:
        return out
    from msa_tpu_torch.ops.kernels.ffn import gelu_as

    out = gelu_as(out)
    return out, out.abs().amax(dim=1).view(torch.int32)


def gemm_s8(a: torch.Tensor, w: torch.Tensor, row_scale: torch.Tensor, col_scale: torch.Tensor,
            bias: torch.Tensor, p: Plan | None = None, gelu: bool = False):
    """a [M, K] int8, w [N, K] int8, row_scale [M], col_scale [N], bias [N]
    f32 → [M, N] f32 (with ``gelu``, fc_in's epilogue: ``(out, amax)``, as
    :func:`gemm_s8_plain`). CPU tensors take the plain version; CUDA
    tensors launch the kernel on ``p`` or :func:`plan`'s tile and split
    (N % 128 == 0, K % 16 == 0; the C entry refuses a plan the kernel is
    not built for)."""
    if a.device.type == "cpu":
        return gemm_s8_plain(a, w, row_scale, col_scale, bias, gelu)
    m, k = a.shape
    n = w.shape[0]
    if n % 128 or k % 16:
        raise ValueError(f"gemm_s8 kernel needs N % 128 == 0 and K % 16 == 0, got {n}, {k}")
    dev, f32 = a.device, torch.float32
    for name, t, dtype, shape in (
        ("a", a, torch.int8, (m, k)), ("w", w, torch.int8, (n, k)), ("row_scale", row_scale, f32, (m,)),
        ("col_scale", col_scale, f32, (n,)), ("bias", bias, f32, (n,)),
    ):
        require(t, name, dtype, shape, dev)
    out = torch.empty((m, n), dtype=f32, device=dev)
    amax = torch.zeros(m, dtype=torch.int32, device=dev) if gelu else None
    ws, cnt, code = launch_args(dev, (m, n, k), plans=[p] if p else None)
    rc = build.library().msa_gemm_s8(
        a.data_ptr(), w.data_ptr(), row_scale.data_ptr(), col_scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        ws, cnt, amax.data_ptr() if gelu else None, m, n, k, code, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(rc, "gemm_s8")
    gemm_s8.launches += 1
    return (out, amax) if gelu else out


gemm_s8.launches = 0  # kernel launches since the last reset, the W8A8 wrappers' two a call included
