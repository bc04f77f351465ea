"""The JAX package's flax init, rebuilt in PyTorch without JAX.

:func:`init_module_` fills a module of this package with what
``model.init(jax.random.PRNGKey(seed), …)["params"]`` gives the matching
flax module, so the trunks the shipped heads were trained over come out the
same from a seed alone. The pieces, each a copy of the installed JAX 0.9 /
flax 0.12 algorithm:

- **threefry2x32** (``jax/_src/prng.py``), in int64 arithmetic masked to 32
  bits: exact on any device. Random bits follow
  ``jax_threefry_partitionable=True`` (JAX's default): element ``i`` of a
  leaf (row-major over the flax shape) is ``x0 ^ x1`` of
  ``threefry2x32(key, (0, i))``.
- **The per-leaf key** (``flax/core/scope.py`` ``_fold_in_static`` and
  ``make_rng``): ``fold_in(root, int(sha1(names…, counter)[:4]))``, where
  the names are the module path and ``counter`` counts the ``self.param``
  calls of the leaf's own module in declaration order (kernel or scale 1,
  bias 2).
- **The initializers** (``jax/_src/nn/initializers.py``, ``random.py``):
  ``lecun_normal`` (a normal truncated at ±2 over the fan-in), flax's
  ``Embed`` normal (std 1/√features), the fusion MLP's ``xavier_uniform``,
  and ones/zeros. A uniform comes from the mantissa bits; a normal is
  ``√2·erf_inv(u)``, with erf_inv the f32 polynomial XLA uses
  (``w = −log1p(−x²)``, each Horner step rounded once, as a fused
  multiply-add is).

Every step after the integer stream is float32 in JAX's order of
operations. XLA's own ``log1p`` is not reproduced, so a float leaf lands
within a few f32 ulp of JAX's, most elements bit-equal
(``tests/test_torch_flax_init.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Iterator, Tuple

import numpy as np
import torch
from torch import nn

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_CHUNK = 1 << 22  # elements per pass of the integer stream


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x0, x1)
    under the key (k0, k1). Works on Python ints and on int64 tensors that
    hold unsigned 32-bit values."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed {seed}: expected 0 ≤ seed < 2**31")
    return 0, seed


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in(key, data)``: threefry of the counter (0, data)."""
    return threefry2x32(key[0], key[1], 0, data & _M32)


def split(key: Tuple[int, int], num: int = 2) -> Tuple[Tuple[int, int], ...]:
    """``jax.random.split(key, num)`` on JAX's partitionable threefry
    stream: key i is threefry of the counter (0, i), both words — the same
    as ``fold_in(key, i)``."""
    return tuple(fold_in(key, i) for i in range(num))


def randint(key: Tuple[int, int], count: int, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, (count,), minval, maxval)`` for int32, bit
    for bit (``jax/_src/random.py`` ``_randint``): two 32-bit words from
    ``split(key)``, each reduced modulo the span, combined with the
    multiplier ``(2**16 mod span)² mod span``, in uint32 arithmetic that
    wraps (as JAX's, also where the square reaches 2**32). An
    int64 tensor on the CPU."""
    k1, k2 = split(key)
    hi, lo = random_bits(k1, 0, count, "cpu"), random_bits(k2, 0, count, "cpu")
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = ((2**16 % span) ** 2 & _M32) % span
    offset = (((hi % span) * mult) & _M32) + lo % span
    return minval + (offset & _M32) % span


def fold_in_names(key: Tuple[int, int], *parts) -> Tuple[int, int]:
    """flax's ``_fold_in_static``: fold the first 4 bytes (big-endian) of
    the SHA-1 of the parts (strings as UTF-8, ints as minimal big-endian
    bytes, no separator) into ``key``."""
    m = hashlib.sha1()
    for x in parts:
        m.update(x.encode() if isinstance(x, str) else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], "big"))


def random_bits(key: Tuple[int, int], start: int, count: int, device) -> torch.Tensor:
    """32 random bits (int64, one per element) for the flat indices
    ``start … start+count-1`` of a leaf."""
    lo = torch.arange(start, start + count, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return y0 ^ y1


def _f32(x) -> float:
    return float(np.float32(x))


def _fma(a, b, c) -> torch.Tensor:
    """``a·b + c`` rounded once to f32: in float64 the product of two f32
    values is exact."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double() + torch.as_tensor(c).double()).float()


def _horner(coefs, x: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(x, _f32(coefs[0]))
    for c in coefs[1:]:
        p = _fma(p, x, _f32(c))
    return p


# XLA's f32 log on the CPU (Cephes: mantissa in [√½, √2) − 1, a degree-8
# polynomial in three fused parts, the exponent times ln 2 split in two)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
          -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _log(t: torch.Tensor) -> torch.Tensor:
    m, e = torch.frexp(t)  # m in [0.5, 1)
    e = e.float()
    below = m < _f32(0.707106781186547524)
    x = (m - 1.0) + torch.where(below, m, 0.0)
    e = e - below.float()
    x2 = x * x
    x3 = x2 * x
    P = [_f32(c) for c in _LOG_P]
    y0, y1, y2 = _fma(x, P[0], P[1]), _fma(x, P[3], P[4]), _fma(x, P[6], P[7])
    y0, y1, y2 = _fma(y0, x, P[2]), _fma(y1, x, P[5]), _fma(y2, x, P[8])
    y = _fma(_fma(y0, x3, y1), x3, y2) * x3
    y = y + e * _f32(-2.12194440e-4)
    x = (x - x2 * 0.5) + y
    return x + e * _f32(0.693359375)


# its log1p: a Cephes rational below |x| < √2 − 1, log(1 + x) above
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
              2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
              3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    small = x + ((-0.5 * x2) + (x * x2) * (_horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)))
    return torch.where(x.abs() < _f32(0.41421356237309504880), small, _log(1.0 + x))


# XLA's f32 erf_inv (Giles' single-precision approximation), for w < 5 and w ≥ 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                 -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                 -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """f32 erf_inv for |x| < 1, as XLA computes it on the CPU:
    ``w = −log1p(−x²)``, then a Horner polynomial whose steps are fused
    multiply-adds."""
    w = -_log1p(-(x * x))
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, _f32(_ERFINV_SMALL[0]), _f32(_ERFINV_LARGE[0]))
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = _fma(p, w, torch.where(small, _f32(a), _f32(b)))
    return p * x


_SQRT2 = _f32(np.sqrt(2))
_ERF_LO, _ERF_HI = _f32(-0.9544997), _f32(0.9544997)  # XLA's f32 erf(∓2/√2)
_CLIP = (float(np.nextafter(np.float32(-2), np.float32(np.inf))), float(np.nextafter(np.float32(2), np.float32(-np.inf))))
_NORMAL_LO = float(np.nextafter(np.float32(-1), np.float32(0)))


def _uniform(bits: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform`` in [lo, hi) from 32 random bits: 23 mantissa
    bits under exponent 0 give [1, 2), minus 1, then ``f·(hi − lo) + lo``
    rounded once (XLA on the CPU fuses it into a multiply-add)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(_fma(f, _f32(np.float32(hi) - np.float32(lo)), lo), lo)


def _sample(kind: str, bits: torch.Tensor, scale: float) -> torch.Tensor:
    if kind == "truncated_normal":
        u = _uniform(bits, _ERF_LO, _ERF_HI)
        return torch.clamp(_SQRT2 * erf_inv(u), *_CLIP) * scale
    if kind == "normal":
        return (_SQRT2 * erf_inv(_uniform(bits, _NORMAL_LO, 1.0))) * scale
    return _uniform(bits, -1.0, 1.0) * scale  # uniform


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One flax param: its path of names (leaf name last), its flax shape,
    its initializer and, for a constant, the value."""

    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    init: str  # "lecun_normal" | "xavier_uniform" | "embed_normal" | "normal" | "const"
    value: float = 0.0  # the constant, or the normal's std

    @property
    def counter(self) -> int:
        """The leaf's ``make_rng`` count in its module: biases are declared
        second, every other leaf first."""
        return 2 if self.path[-1] == "bias" else 1


def _scale_of(leaf: Leaf) -> Tuple[str, float]:
    """(distribution, f32 multiplier) of a random leaf, as
    ``variance_scaling`` computes them."""
    if leaf.init == "embed_normal":  # fan_in = features (in_axis -1, out_axis 0)
        return "normal", float(np.sqrt(np.float32(1.0 / leaf.shape[-1])))
    if leaf.init == "normal":  # nn.initializers.normal(std)
        return "normal", float(np.float32(leaf.value))
    receptive = math.prod(leaf.shape[:-2])
    fan_in, fan_out = leaf.shape[-2] * receptive, leaf.shape[-1] * receptive
    if leaf.init == "lecun_normal":
        std = np.sqrt(np.float32(1.0 / fan_in)) / np.float32(0.87962566103423978)
        return "truncated_normal", float(std)
    variance = np.float32(1.0 / ((fan_in + fan_out) / 2))  # xavier_uniform
    return "uniform", float(np.sqrt(np.float32(3) * variance))


def leaf_values(leaf: Leaf, seed: int, device) -> torch.Tensor:
    """The leaf as ``init(PRNGKey(seed))`` gives it: f32, in its flax
    shape, on ``device``."""
    n = math.prod(leaf.shape)
    if leaf.init == "const":
        return torch.full(leaf.shape, leaf.value, dtype=torch.float32, device=device)
    key = fold_in_names(prng_key(seed), *leaf.path[:-1], leaf.counter)
    kind, scale = _scale_of(leaf)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for start in range(0, n, _CHUNK):
        count = min(_CHUNK, n - start)
        out[start : start + count] = _sample(kind, random_bits(key, start, count, device), scale)
    return out.view(leaf.shape)


def to_port(leaf: Leaf, values: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """A leaf in its flax layout → ``param``'s layout (the
    :mod:`msa_tpu_torch.weights` mapping: a Dense kernel [in, out] is a
    Linear weight [out, in]; a conv kernel [k…, in, out] is [out, in, k…])."""
    if leaf.path[-1] == "kernel":
        if param.dim() == 2:
            values = values.reshape(-1, values.shape[-1]).t()
        else:
            values = values.permute(values.dim() - 1, values.dim() - 2, *range(values.dim() - 2))
    return values.reshape(param.shape)


# the fusion MLP's modality weights (msa_tpu/models/fusion.py:117-125)
_FUSION_CONSTANTS = {"audio_weight": 0.3, "text_weight": 0.3, "face_weight": 0.4}


def leaves(module: nn.Module) -> Iterator[Tuple[Leaf, torch.Tensor]]:
    """Every parameter of ``module`` with its flax leaf. Module names are
    the flax names; the leaf names and initializers follow the owning
    module's type. The fusion MLP's Dense layers take ``xavier_uniform``."""
    from msa_tpu_torch.models.face import Conv1x1, FlaxGroupNorm
    from msa_tpu_torch.models.fusion import FusionMLP
    from msa_tpu_torch.models.transformer import LayerNorm

    dense_init = "xavier_uniform" if isinstance(module, FusionMLP) else "lecun_normal"
    for mname, owner in module.named_modules():
        path = tuple(mname.split(".")) if mname else ()
        for pname, p in owner.named_parameters(recurse=False):
            if pname == "bias":
                yield Leaf(path + ("bias",), tuple(p.shape), "const", 0.0), p
            elif isinstance(owner, nn.Linear):
                one_by_one = (1, 1) if isinstance(owner, Conv1x1) else ()
                yield Leaf(path + ("kernel",), (*one_by_one, p.shape[1], p.shape[0]), dense_init), p
            elif isinstance(owner, (nn.Conv1d, nn.Conv2d)):
                yield Leaf(path + ("kernel",), (*p.shape[2:], p.shape[1], p.shape[0]), "lecun_normal"), p
            elif isinstance(owner, nn.Embedding):
                yield Leaf(path + ("embedding",), tuple(p.shape), "embed_normal"), p
            elif isinstance(owner, (LayerNorm, FlaxGroupNorm, nn.GroupNorm)):
                yield Leaf(path + ("scale",), tuple(p.shape), "const", 1.0), p
            elif pname == "embed_positions":  # the whisper decoder's learned positions
                yield Leaf(path + (pname,), tuple(p.shape), "normal", 0.02), p
            elif isinstance(owner, FusionMLP) and pname in _FUSION_CONSTANTS:
                yield Leaf(path + (pname,), (), "const", _FUSION_CONSTANTS[pname]), p
            else:
                raise TypeError(f"{mname}.{pname}: no flax initializer known for {type(owner).__name__}")


@torch.no_grad()
def init_module_(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter of ``module`` as the matching flax module's
    ``init(PRNGKey(seed))`` does, on the parameters' device, then derive
    the encoder layers' int8 or compute-dtype weights from the new f32
    masters. Returns ``module``."""
    from msa_tpu_torch import weights

    for leaf, p in leaves(module):
        p.copy_(to_port(leaf, leaf_values(leaf, seed, p.device), p))
    weights.derive_weights_(module)
    return module
