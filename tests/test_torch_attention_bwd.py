"""Rows 2, 3 and 4 of the kernel table, and the two differentiable wrappers
over them, against the JAX package on the CPU.

On the CPU the wrappers run their kernels' plain versions; JAX runs its
Pallas kernels in interpret mode. ``attention_bwd`` (rows 3 and 4) is held
against JAX's ``attention_bwd`` on the same q, k, v, o, lse and cotangent;
``mha_attention`` (row 2) against ``_mha_attention_lse``; the wrappers'
gradients against ``jax.grad`` of JAX's ``packed_qkv_attention`` and
``attention_with_vjp`` under a non-uniform cotangent (``_grad_pair`` in
tests/test_pallas_attention.py).

Tolerances are the JAX tests' own (tests/test_pallas_attention.py): f32
2e-4, and 3e-4 at T = 640 (:259, :294, :335); bf16 atol and rtol 5e-2
(:315-320); row 2's o and lse 2e-5 (:22-42).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tpu.ops.pallas.attention import _flash_attention_lse, _mha_attention_lse
from msa_tpu.ops.pallas.attention import attention_bwd as jax_attention_bwd
from msa_tpu.ops.pallas.attention import attention_with_vjp as jax_attention_with_vjp
from msa_tpu.ops.pallas.attention import packed_qkv_attention as jax_packed_qkv_attention
from msa_tpu_torch.ops.kernels import attention as A
from torch_parity import TORCH_DTYPES, f32, t

F32_ATOL = {640: 3e-4}  # else 2e-4


def _close(got, want, dtype, t_len, what):
    got, want = f32(got), f32(want)
    assert np.isfinite(got).all(), what
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL.get(t_len, 2e-4), err_msg=what)
    else:
        np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2, err_msg=what)


def _mask(b, T, kind):
    mask = np.ones((b, T), np.float32)
    mask[0, T * 4 // 5 :] = 0.0  # a ragged valid length: masked keys
    if kind == "no_valid_key":
        mask[1, :] = 0.0  # lse ≈ −1e9: the gradient spreads over every padded key
    return mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,T,d,kind",
    [(2, 2, 250, 64, "ragged"), (2, 3, 100, 24, "no_valid_key"), (2, 2, 128, 64, "no_valid_key"), (1, 1, 640, 32, "ragged")],
)
def test_attention_bwd_plain_matches_pallas(rng, dtype, b, h, T, d, kind):
    jdt = jnp.dtype(dtype)
    q, k, v, g = (jnp.asarray(rng.normal(size=(b, h, T, d)).astype(np.float32)).astype(jdt) for _ in range(4))
    mask = jnp.asarray(_mask(b, T, kind))
    fwd = _flash_attention_lse if T > 512 else _mha_attention_lse
    o, lse = fwd(q, k, v, mask, interpret=True)
    want = jax_attention_bwd(q, k, v, mask, lse, o, g, interpret=True)
    tdt = TORCH_DTYPES[dtype]
    got = A.attention_bwd(t(q, tdt), t(k, tdt), t(v, tdt), t(mask), t(lse), t(o, tdt), t(g, tdt))
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        assert gt.dtype == tdt and tuple(gt.shape) == (b, h, T, d)
        _close(gt, wt, dtype, T, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,T,d", [(12, 512, 64), (2, 250, 64), (3, 100, 32)])
def test_mha_attention_plain_matches_pallas(rng, dtype, h, T, d):
    jdt = jnp.dtype(dtype)
    q, k, v = (jnp.asarray(rng.normal(size=(2, h, T, d)).astype(np.float32)).astype(jdt) for _ in range(3))
    mask = np.ones((2, T), np.float32)
    mask[1, T // 3 :] = 0.0
    want_o, want_lse = _mha_attention_lse(q, k, v, jnp.asarray(mask), interpret=True)
    tdt = TORCH_DTYPES[dtype]
    got_o, got_lse = A.mha_attention(t(q, tdt), t(k, tdt), t(v, tdt), t(mask))
    assert got_o.dtype == tdt and tuple(got_o.shape) == (2, h, T, d)
    if dtype == "float32":
        np.testing.assert_allclose(f32(got_o), f32(want_o), atol=2e-5)
        np.testing.assert_allclose(f32(got_lse), f32(want_lse), atol=2e-5)
    else:  # both round p / denom to bf16 at the same point (tests/test_torch_flash.py)
        np.testing.assert_allclose(f32(got_o), f32(want_o), atol=0.15, rtol=0.1)
        np.testing.assert_allclose(f32(got_lse), f32(want_lse), atol=1e-3)


def _torch_grads(fn, tensors, w):
    leaves = [x.clone().requires_grad_(True) for x in tensors]
    (fn(*leaves).float() * w).sum().backward()
    return [x.grad for x in leaves]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,d", [(100, 24), (200, 64)])
def test_packed_qkv_attention_with_vjp_grads_match_jax(rng, dtype, T, d):
    """JAX's packed_qkv_attention custom VJP (row 5 → rows 3-4) against
    the port's autograd.Function: the same gradient, dqkv [B, T, 3, H, D]."""
    b, h = 2, 2
    jdt = jnp.dtype(dtype)
    qkv = jnp.asarray(rng.normal(size=(b, T, 3, h, d)).astype(np.float32)).astype(jdt)
    mask = np.ones((b, T), np.float32)
    mask[1, T * 3 // 5 :] = 0.0
    w = np.arange(h * d, dtype=np.float32) / (h * d)  # non-uniform cotangent
    want = jax.grad(lambda x: jnp.sum(jax_packed_qkv_attention(x, jnp.asarray(mask), True).astype(jnp.float32) * w))(qkv)
    (got,) = _torch_grads(
        lambda x: A.packed_qkv_attention(x, t(mask)), [t(qkv, TORCH_DTYPES[dtype])], torch.from_numpy(w)
    )
    assert got.dtype == TORCH_DTYPES[dtype] and tuple(got.shape) == (b, T, 3, h, d)
    _close(got, want, dtype, T, "dqkv")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_wrapper_beyond_512_matches_jax_attention_with_vjp(rng, dtype):
    """Beyond T = 512 the packed wrapper's forward is row 6: JAX's encoder
    there takes attention_with_vjp on q, k, v transposed out of the same
    projection (msa_tpu/models/transformer.py:150-156). The same dqkv."""
    b, h, T, d = 1, 2, 640, 32
    jdt = jnp.dtype(dtype)
    qkv = jnp.asarray(rng.normal(size=(b, T, 3, h, d)).astype(np.float32)).astype(jdt)
    mask = np.ones((b, T), np.float32)
    mask[0, T * 5 // 6 :] = 0.0
    w = np.arange(h * d, dtype=np.float32) / (h * d)  # non-uniform cotangent

    def loss(x):
        q, k, v = (x[:, :, i].transpose(0, 2, 1, 3) for i in range(3))
        o = jax_attention_with_vjp(q, k, v, jnp.asarray(mask), True).transpose(0, 2, 1, 3)
        return jnp.sum(o.reshape(b, T, h * d).astype(jnp.float32) * w)

    want = jax.grad(loss)(qkv)
    (got,) = _torch_grads(
        lambda x: A.packed_qkv_attention(x, t(mask)), [t(qkv, TORCH_DTYPES[dtype])], torch.from_numpy(w)
    )
    assert got.dtype == TORCH_DTYPES[dtype] and tuple(got.shape) == (b, T, 3, h, d)
    _close(got, want, dtype, T, "dqkv")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,T,d", [(1, 2, 128, 128), (2, 2, 250, 64), (1, 1, 640, 32)])
def test_attention_with_vjp_grads_match_jax(rng, dtype, b, h, T, d):
    """JAX's attention_with_vjp (row 2 at T ≤ 512, row 6 beyond, then rows
    3-4) against the port's autograd.Function under _grad_pair's cotangent."""
    jdt = jnp.dtype(dtype)
    q, k, v = (jnp.asarray(rng.normal(size=(b, h, T, d)).astype(np.float32)).astype(jdt) for _ in range(3))
    mask = np.ones((b, T), np.float32)
    mask[0, T * 5 // 6 :] = 0.0
    w = np.arange(d, dtype=np.float32) / d

    def loss(q, k, v):
        return jnp.sum(jax_attention_with_vjp(q, k, v, jnp.asarray(mask), True).astype(jnp.float32) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tdt = TORCH_DTYPES[dtype]
    got = _torch_grads(
        lambda q, k, v: A.attention_with_vjp(q, k, v, t(mask)), [t(x, tdt) for x in (q, k, v)], torch.from_numpy(w)
    )
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        assert gt.dtype == tdt
        _close(gt, wt, dtype, T, name)


def test_cpu_wrappers_launch_no_kernel(rng):
    """On CPU tensors the forward and backward take the plain versions."""
    counters = (A.mha_attention, A.packed_qkv_attention_lse, A.flash_attention_lse, A.attention_bwd_dq, A.attention_bwd_dkv,
                A.attention_bwd_onepass)
    before = [c.launches for c in counters]
    qkv = torch.from_numpy(rng.normal(size=(1, 40, 3, 2, 16)).astype(np.float32)).requires_grad_(True)
    A.packed_qkv_attention(qkv, torch.ones(1, 40)).sum().backward()
    q = torch.randn(1, 2, 40, 16, requires_grad=True)
    A.attention_with_vjp(q, q.detach(), q.detach(), torch.ones(1, 40)).sum().backward()
    assert [c.launches for c in counters] == before
    assert torch.isfinite(qkv.grad).all() and torch.isfinite(q.grad).all()
