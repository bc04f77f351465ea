"""flax param trees (nested dicts of numpy arrays) → this package's modules.

The port's modules use the flax tree's names, so one walk maps every leaf:

- ``kernel`` → ``weight``: a Dense kernel ``[in, out]`` becomes a Linear
  weight ``[out, in]``; a Conv kernel ``[k…, in, out]`` (NWC/NHWC) becomes
  ``[out, in, k…]`` (NCW/NCHW); a 1×1 conv kernel feeding a Linear head is
  reshaped to ``[out, in]``;
- ``scale`` → ``weight`` (LayerNorm/GroupNorm), ``embedding`` → ``weight``;
- ``bias`` and scalar leaves keep their names.

Values are cast to each parameter's own dtype (bf16 conv kernels round to
nearest even, as JAX's ``astype`` does; the encoder matrices are f32
masters). A load ends in :func:`derive_weights_`, so each encoder layer's
int8 or compute-dtype weights follow its masters. JAX's flax init itself is
rebuilt in :mod:`msa_tpu_torch.flax_init`, which walks the same names.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _convert(name: str, value: np.ndarray, target: torch.Tensor) -> torch.Tensor:
    v = np.asarray(value)
    if name == "kernel":
        if v.ndim == 2:
            v = v.T
        else:  # [k..., in, out] → [out, in, k...]
            v = np.transpose(v, (v.ndim - 1, v.ndim - 2) + tuple(range(v.ndim - 2)))
        if v.shape != tuple(target.shape) and v.size == target.numel():
            v = v.reshape(target.shape)  # 1×1 conv head applied as a Linear
    if v.shape != tuple(target.shape):
        raise ValueError(f"{name}: flax shape {np.shape(value)} does not fit {tuple(target.shape)}")
    return torch.from_numpy(np.array(v)).to(device=target.device, dtype=target.dtype)


def derive_weights_(module: nn.Module) -> None:
    """Re-derive what each layer under ``module`` consumes from its f32
    masters (int8 codes and scales, or compute-dtype copies)."""
    for m in module.modules():
        if hasattr(m, "derive_weights_"):
            m.derive_weights_()


@torch.no_grad()
def load_flax_tree(module: nn.Module, tree: Mapping[str, Any]) -> None:
    """Copy every leaf of ``tree`` into the same-named parameter of
    ``module``. Raises on a leaf without a parameter or a shape mismatch."""
    _load(module, tree, "")
    derive_weights_(module)


def _load(module: nn.Module, tree: Mapping[str, Any], prefix: str) -> None:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            child = getattr(module, key, None)
            if not isinstance(child, nn.Module):
                raise KeyError(f"{prefix}{key}: no such submodule in {type(module).__name__}")
            _load(child, value, f"{prefix}{key}.")
            continue
        target = getattr(module, _RENAME.get(key, key), None)
        if not isinstance(target, torch.Tensor):
            raise KeyError(f"{prefix}{key}: no such parameter in {type(module).__name__}")
        target.copy_(_convert(key, value, target))
