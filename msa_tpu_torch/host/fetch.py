"""Results that go back to the host while the caller does other work."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def to_host_async(t: torch.Tensor) -> Callable[[], np.ndarray]:
    """Start copying ``t`` to the host without blocking (into pinned
    memory, after the work queued so far); the returned callable waits for
    the copy and gives the numpy array. A CPU tensor is returned as is."""
    if t.device.type != "cuda":
        return lambda: t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def fetch() -> np.ndarray:
        done.synchronize()
        return host.numpy()

    return fetch
