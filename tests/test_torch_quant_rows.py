"""The row quantization of the int8 chains (rows 7 and 9) against the JAX
package on the CPU, and the chains' C entries on the card path.

- The plain ``quantize_rows`` (``msa_tpu_torch/ops/quant.py``), which the
  CUDA kernel (``csrc/quant.cu``, one read a row) reproduces bit for bit on
  the card, against JAX's jitted ``quantize_rows``
  (``msa_tpu/ops/quant.py:47``) at the widths the chains quantize: 128
  (custom widths), 768 (x and the attention output at d_model 768), 1024
  (the attention output at H·DP = 1024) and 3072 (the FFN's hidden tile),
  in bf16 and f32, with all-zero rows (the 1e-8 floor) and values on
  rounding ties (f32; bf16 holds no exact tie of the quantizer's scale,
  so its rows sit on the bf16 values next to them). Codes and scales
  bit-equal.
- The card path on meta tensors with a stand-in library (the fixture of
  ``tests/test_torch_wide_heads.py``): the chains launch under
  programmatic dependent launch inside the entries, and the wrappers still
  pass each entry exactly the arguments of its ctypes signature
  (``build._SIGNATURES``), with the shapes and plans of the call, and
  count every kernel of the chain once: two row quantizations and two int8
  GEMMs a call, the core above DP = 128 in its own counter.
  ``tests/test_torch_int8_f32.py`` checks which entry each x dtype takes.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tpu.ops import quant as JQ
from msa_tpu_torch.ops import quant as PQ
from msa_tpu_torch.ops.kernels import attention as A
from msa_tpu_torch.ops.kernels import build
from msa_tpu_torch.ops.kernels import ffn as F
from msa_tpu_torch.ops.kernels import gemm_s8 as GS
from msa_tpu_torch.ops.kernels import quant as KQ
from test_torch_wide_heads import card  # noqa: F401 (the stand-in kernel library, a fixture)

import torch_parity  # noqa: F401  (its import shares the CPU among xdist workers)

_JAX_ROWS = jax.jit(JQ.quantize_rows)
# the scale the quantizer takes for a row of amax 127: 127 · f32(1/127) = 1 − 2^-24
_S127 = np.float32(np.float32(127.0) * np.float32(1.0 / 127.0))
_TIES = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5], np.float32)


def _rows(cols: int, dtype: torch.dtype) -> torch.Tensor:
    """37 rows of ``cols`` values from a numpy seed, each at its own
    magnitude; rows 5 and 30 zero; rows 2 and 3 on rounding ties (the tie
    pattern repeated along the row, row 3 negated)."""
    rng = np.random.default_rng(cols)
    x = (rng.standard_normal((37, cols)) * rng.uniform(1e-3, 10, size=(37, 1))).astype(np.float32)
    x[[5, 30]] = 0.0
    x[2] = np.tile(_TIES * _S127, cols // 8)
    x[3] = -x[2]
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cols", [128, 768, 1024, 3072])
def test_quantize_rows_bit_equal_to_jax_at_the_chains_widths(dtype, cols):
    x = _rows(cols, getattr(torch, dtype))
    pq, ps = PQ.quantize_rows(x)
    jq, js = _JAX_ROWS(jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype)))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32 and tuple(ps.shape) == (37, 1)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert not pq[[5, 30]].any() and float(ps[5, 0]) == float(np.float32(np.float32(1e-8) * np.float32(1 / 127)))
    if dtype == "float32":  # the ties round half to even on both sides
        np.testing.assert_array_equal(pq[2, :8].numpy(), [127, 0, 2, 2, 0, -2, -2, 126])
        np.testing.assert_array_equal(pq[3, :8].numpy(), [-127, 0, -2, -2, 0, 2, 2, -126])
    # the wrapper of the CUDA kernel takes the plain version for a CPU tensor, uncounted
    n0 = KQ.quantize_rows.launches
    kq, ks = KQ.quantize_rows(x)
    assert torch.equal(kq, pq) and torch.equal(ks, ps) and KQ.quantize_rows.launches == n0


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _as_signature(name: str, args: tuple) -> None:
    """Each argument is of the kind the entry's ctypes signature declares."""
    sig = build._SIGNATURES[name]
    assert len(args) == len(sig), (name, len(args), len(sig))
    for i, (a, kind) in enumerate(zip(args, sig)):
        if kind is ctypes.c_float:
            assert isinstance(a, float), (name, i, a)
        else:  # c_int and c_void_p: Python ints (a null pointer as None)
            assert a is None or (isinstance(a, int) and not isinstance(a, bool)), (name, i, a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 192])
@pytest.mark.parametrize("row", [7, 9])
def test_int8_chain_entries_keep_their_arguments_on_the_card_path(card, dtype, d, row):
    """Rows 7 and 9 at head dim 64 (DP 64) and 192 (DP 256): one entry call
    with the arguments of its signature, the plans of its two GEMMs, and
    the counters of every kernel of the chain advanced once."""
    tdt = getattr(torch, dtype)
    is_f32 = tdt == torch.float32
    h, b, t = 2, 2, 100
    dp = A.block_head_dim(d)
    dm, hd = h * d, h * dp
    dm = -(-dm // 128) * 128
    dff = 4 * dm
    counter = "launches_f32" if is_f32 else "launches"
    fn = A.attention_block_int8 if row == 7 else F.ffn_fused_int8
    before = (getattr(fn, counter), KQ.quantize_rows.launches, GS.gemm_s8.launches, A.wide_mma.launches,
              A.wide_f32.launches)
    i8 = torch.int8
    if row == 7:
        out = A.attention_block_int8(_meta(b, t, dm, dtype=tdt), _meta(3 * hd, dm, dtype=i8), _meta(3 * hd),
                                     _meta(3 * hd), _meta(dm, hd, dtype=i8), _meta(dm), _meta(dm), _meta(b, t), h, d)
        assert out.dtype == tdt and tuple(out.shape) == (b, t, dm)
    else:
        out = F.ffn_fused_int8(_meta(b * t, dm, dtype=tdt), _meta(dff, dm, dtype=i8), _meta(dff), _meta(dff),
                               _meta(dm, dff, dtype=i8), _meta(dm), _meta(dm))
        assert out.dtype == tdt and tuple(out.shape) == (b * t, dm)
    (name, args), = card.calls
    sfx = "_f32" if is_f32 else ""
    assert name == ("msa_attention_block_int8" if row == 7 else "msa_ffn_fused_int8") + sfx
    _as_signature(name, args)
    if row == 7:
        m, t_pad = b * 128, 128  # T padded to the 128-row grid
        wide = 3 if is_f32 else 0
        assert args[-9 - wide : -4 - wide] == (b, t_pad, dm, h, dp)
        assert args[-4 - wide : -2 - wide] == (GS.plan(m, 3 * hd, dm).code, GS.plan(m, dm, hd).code)
        assert args[-2] == float(np.float32(1.0 / np.sqrt(d)))
        if is_f32:  # the wide f32 core's plan above DP = 128, zeros at or below it
            assert (args[-5] != 0) == (dp > 128)
        wide_mma, wide_f32 = int(not is_f32 and dp > 128), int(is_f32 and dp > 128)
    else:
        m = b * t
        assert args[-6:-1] == (m, dm, dff, GS.plan(m, dff, dm).code, GS.plan(m, dm, dff).code)
        wide_mma = wide_f32 = 0
    after = (getattr(fn, counter), KQ.quantize_rows.launches, GS.gemm_s8.launches, A.wide_mma.launches,
             A.wide_f32.launches)
    assert [a - b_ for a, b_ in zip(after, before)] == [1, 2, 2, wide_mma, wide_f32]
