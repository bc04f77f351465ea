"""The int8 GEMM under the W8A8 kernels (rows 7 and 9): its plan, its
split-K workspace, and the GEMM alone.

``msa_tpu_torch/csrc/gemm_s8.cuh`` computes ``epilogue(A·Wᵀ)`` for
``A [M, K]`` and ``W [N, K]`` int8 with ``wgmma`` on square tiles of 64 or
128, with K cut into ``splits`` runs of whole 128-byte k-tiles. The int32
partial sums of a split are exact, so the splits add them into one int32
tile in any order and the tile's last CTA converts the sum to f32 once:
the result is bit-equal to :func:`msa_tpu_torch.ops.quant.int8_matmul`
whatever the plan.

:func:`plan` is :func:`msa_tpu_torch.ops.kernels.gemm_plan.plan` for int8,
whose rule was read off the card's timings of every candidate plan at the
encoders' GEMMs (``python3 -m msa_tpu_torch.profile_slice --gemm-s8``;
PERF.md §6): at these shapes a GEMM takes a launch and a few k-tiles'
latency, 4 to 13 µs; 128 × 128 tiles are the faster where their grid
alone gives every SM a CTA (fc_in at M = 1024, every GEMM at M = 4096),
64 × 64 tiles, one warpgroup a CTA, below that. A split of K adds a round
trip through L2 (the atomic int32 sums, a fence, the tile's counter),
which pays only where the tiles hold under half the SMs and each split
keeps 4 k-tiles or more: fc_out (K = 3072) at M ≤ 256; never at K = 768.

:func:`gemm_s8` launches the GEMM alone (f32 out; with ``gelu``, fc_in's
epilogue and its row amax): the smoke holds it against ``torch._int_mm``
exactly. The W8A8 wrappers launch it from C, twice a call, and add those
launches to ``gemm_s8.launches``.
"""

from __future__ import annotations

import torch

from msa_tpu_torch.ops import quant as Q
from msa_tpu_torch.ops.kernels import build
from msa_tpu_torch.ops.kernels import gemm_plan as GP
from msa_tpu_torch.ops.kernels._common import require
from msa_tpu_torch.ops.kernels.gemm_plan import K_TILE, SMS, Plan, cta_ranges  # noqa: F401 (this module's API)

TILES = tuple(t for t, _ in GP.S8_RULE.tiles)  # the square tiles the kernel is built for
MIN_SPLIT_K_TILES = GP.S8_RULE.min_split_k_tiles  # k-tiles a split keeps at the least


def plan(m: int, n: int, k: int) -> Plan:
    """The tile and split for ``A [m, k] · W [n, k]ᵀ`` in int8 (n % 128 ==
    0, k % 16 == 0): 128 × 128 tiles where they alone give every SM a CTA,
    else 64 × 64; K split only where the tiles hold under half the SMs,
    into as many splits as bring the grid to :data:`SMS` CTAs while each
    keeps :data:`MIN_SPLIT_K_TILES` k-tiles."""
    return GP.plan(m, n, k, torch.int8)



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
    ws, cnt, code = GP.launch_args(dev, (m, n, k), dtype=torch.int8, plans=[p] if p else None)
    rc = build.library().msa_gemm_s8(
        a.data_ptr(), w.data_ptr(), row_scale.data_ptr(), col_scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        ws, cnt, amax.data_ptr() if gelu else None, m, n, k, code, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(rc, "gemm_s8")
    gemm_s8.launches += 1
    return (out, amax) if gelu else out


gemm_s8.launches = 0  # kernel launches since the last reset, the W8A8 wrappers' two a call included
