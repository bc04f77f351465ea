"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

from typing import Sequence

import torch


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Sequence[int], device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte-aligned tensor of the
    given dtype and shape on ``device`` — what the C kernels assume."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")
