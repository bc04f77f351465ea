"""Float32 as JAX computes it: the f32 paths of the port run inside
:func:`exact_fp32`."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for the f32 convolutions, matmuls and feature math (cuDNN
    convolutions default to TF32, which keeps ~3 digits)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
