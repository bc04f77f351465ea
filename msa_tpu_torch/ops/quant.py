"""Symmetric int8 quantization for the W8A8 serving recipe (port of
``msa_tpu/ops/quant.py``).

Weights quantize per output channel, activations per row: ``scale =
max(amax, 1e-8) · f32(1/127)``, ``code = clip(round_half_even(x / scale),
±127)``, with ``x / scale`` an IEEE float32 division.

The codes and scales are bit-equal to the JAX package's as it runs them:
inside ``jax.jit`` (every caller of ``msa_tpu/ops/quant.py`` is jitted), where
XLA turns the source's ``amax / 127.0`` into a multiplication by the float32
constant 1/127, and keeps ``x / scale`` a division. Called eagerly, the JAX
functions divide by 127 instead, and some scales differ from the jitted
ones by one ulp. ``amax`` is exact either way. The division by
``scale`` takes a tensor divisor: CUDA PyTorch turns a division by a Python
scalar into a multiplication by its reciprocal, which moves ties. The
row-quantize CUDA kernel (``csrc/quant.cu``) computes :func:`quantize_rows`
the same way.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_FLOOR = 1e-8  # rounded to float32 where it meets a tensor, as in JAX
INV_127 = float(np.float32(1.0 / 127.0))  # the constant XLA multiplies by


def _quantize(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=torch.tensor(_FLOOR, dtype=torch.float32, device=x.device))
    scale = scale * INV_127
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return codes, scale


def quantize_weight_cols(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 of a ``[in, out]`` kernel (flax layout):
    ``(w_i8 [in, out], scale [out] f32)`` with ``w ≈ w_i8 · scale``."""
    codes, scale = _quantize(w, 0)
    return codes, scale[0]


def quantize_weight_axis(w: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 reducing over ``axis`` (the contraction dim); the scales keep a
    singleton ``axis``. On a PyTorch Linear weight ``[out, in]``,
    ``axis=1`` gives one scale per output channel, ``[out, 1]``."""
    return _quantize(w, axis)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 of an activation: ``(x_i8, scale [..., 1] f32)``."""
    return _quantize(x, -1)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 · b [N, K]ᵀ int8`` → the int32 sums as float32.

    Computed in float64, which is exact here (|sum| ≤ 127²·K ≪ 2⁵³); the
    conversion to float32 rounds to nearest even, as the kernels' and
    JAX's int32 → float32 conversion does. PyTorch's CPU ``int8 @ int8``
    returns int8 and wraps, and integer matmul does not reach cuBLAS."""
    return (a.double() @ b.double().t()).float()
