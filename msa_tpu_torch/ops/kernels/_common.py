"""Argument checks and scratch shared by the kernel wrappers."""

from __future__ import annotations

from typing import Sequence

import torch


_ZEROED: dict = {}
_SCRATCH: dict = {}


def scratch(name: str, device: torch.device, elems: int, dtype: torch.dtype) -> torch.Tensor:
    """The scratch buffer ``name`` of the current stream on ``device``, of
    at least ``elems`` elements of ``dtype``, contents undefined: the
    kernels of one stream, which run in order, share it. Grown, never
    shrunk."""
    key = (name, device, torch.cuda.current_stream(device).cuda_stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < elems:
        buf = _SCRATCH[key] = torch.empty(max(elems, 1), dtype=dtype, device=device)
    return buf


def zeroed(name: str, device: torch.device, elems: int) -> torch.Tensor:
    """The int32 buffer ``name`` of the current stream on ``device``, of at
    least ``elems`` elements: made with zeros, and zero again after every
    launch that uses it (the kernels restore it), so the kernels of one
    stream, which run in order, share it. Grown, never shrunk."""
    key = (name, device, torch.cuda.current_stream(device).cuda_stream)
    buf = _ZEROED.get(key)
    if buf is None or buf.numel() < elems:
        buf = _ZEROED[key] = torch.zeros(max(elems, 1), dtype=torch.int32, device=device)
    return buf


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
