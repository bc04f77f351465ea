"""flax param trees (nested dicts of numpy arrays) → this package's modules.

The port's modules use the flax tree's names, so one walk maps every leaf:

- ``kernel`` → ``weight``: a Dense kernel ``[in, out]`` becomes a Linear
  weight ``[out, in]``; a Conv kernel ``[k…, in, out]`` (NWC/NHWC) becomes
  ``[out, in, k…]`` (NCW/NCHW); a 1×1 conv kernel feeding a Linear head is
  reshaped to ``[out, in]``;
- ``scale`` → ``weight`` (LayerNorm/GroupNorm), ``embedding`` → ``weight``;
- ``bias`` and scalar leaves keep their names.

Every parameter is an f32 master, as flax's params are; the modules cast
to their compute dtype in the forward (the audio convs) or derive serving
copies (the encoder layers). A load ends in :func:`derive_weights_`, so
each encoder layer's int8 or compute-dtype weights follow its masters.
JAX's flax init itself is rebuilt in :mod:`msa_tpu_torch.flax_init`, which
walks the same names. :func:`flax_tree` is the inverse of
:func:`load_flax_tree`: a module's parameters as a flax tree.
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
    masters (int8 codes and scales, or compute-dtype copies). Run it after
    the masters change, e.g. after an optimizer step, before serving: the
    serving paths read these copies, the training path the masters."""
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


def flax_tree(module: nn.Module, of=None) -> dict:
    """Every parameter of ``module`` as a nested dict of f32 numpy arrays in
    flax's names and layouts (the leaves :func:`msa_tpu_torch.flax_init.leaves`
    names): the inverse of :func:`load_flax_tree`. ``of(p)`` gives what to
    store for parameter ``p`` in its layout (an optimizer's moment, say);
    by default ``p`` itself."""
    from msa_tpu_torch import flax_init

    tree: dict = {}
    for leaf, p in flax_init.leaves(module):
        v = (p if of is None else of(p)).detach().float().cpu()
        if leaf.path[-1] == "kernel":
            v = v.t() if v.dim() == 2 else v.permute(*range(2, v.dim()), 1, 0)
        node = tree
        for name in leaf.path[:-1]:
            node = node.setdefault(name, {})
        node[leaf.path[-1]] = v.reshape(leaf.shape).contiguous().numpy().copy()
    return tree


def device_of(module: nn.Module) -> torch.device:
    """The device of ``module``'s parameters."""
    return next(module.parameters()).device


def missing_leaves(module: nn.Module, tree: Mapping[str, Any]) -> list:
    """The flax paths of ``module``'s parameters that ``tree`` lacks."""
    from msa_tpu_torch import flax_init

    def has(path):
        node = tree
        for name in path:
            if not isinstance(node, Mapping) or name not in node:
                return False
            node = node[name]
        return True

    return ["/".join(leaf.path) for leaf, _ in flax_init.leaves(module) if not has(leaf.path)]
