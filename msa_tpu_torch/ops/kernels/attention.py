"""Fused attention block: fused QKV projection → masked per-head softmax
attention → output projection, for one encoder layer.

Replaces the TPU kernel ``msa_tpu/ops/pallas/attention.py:attention_block``
(``pl.pallas_call`` at :819, body ``_attn_block_body`` :574-695) in bf16
and in f32 (:func:`attention_block` on f32 operands, the parity mode's
encoders). The CUDA kernels are ``msa_tpu_torch/csrc/attention.cu`` (with
the bf16 ``wgmma`` GEMM of ``csrc/gemm_bf16.cuh``, on the plans of
:func:`gemm_plan.plan`, and the f32 GEMM of ``csrc/gemm_f32.cuh`` on the
stream-K plans of :func:`gemm_plan.plan_f32`); its note says what bounds
them on the card and what the design does about it.

Layouts: ``x [B, T, dm]`` in the compute dtype; ``w_qkv [3·H·DP, dm]`` and
``w_out [dm, H·DP]`` in PyTorch's Linear layout and the compute dtype;
``b_qkv``/``b_out`` float32; ``key_mask [B, T]`` float32, 1 = attend. T is
padded to a multiple of 128 inside, as the TPU wrapper does, and must be
≤ 512 after padding (the encoder sends longer inputs to
:func:`flash_attention_lse`). Any head dim D: the kernels' head dim DP is
32, 64, 128 or, above 128, a multiple of 128 (the tensor-core kernel of
``csrc/attention_wide_mma.cu`` takes the bf16 core's place there, the
wide f32 kernel of ``csrc/attention_wide.cu`` the f32 one's), and weights of
another D are padded to the next DP once, by :func:`pad_block_weights`
(zero rows of ``w_qkv``/``b_qkv`` per head, zero columns of ``w_out``);
``head_dim`` then names the unpadded D, whose 1/√D the scores take.

Rounding points, shared by the kernel and :func:`attention_block_plain`:
q, k and v are projected in f32 (+ f32 bias) and rounded to the compute
dtype; the score dot accumulates in f32; masked keys add −1e9 (not −inf: a
row with no valid key stays finite); P = exp(s − rowmax) is summed in f32
and rounded for P·V; o/denom is rounded before the f32-accumulated output
projection; the result is rounded once. In f32 every rounding is the
identity.

:func:`attention_block_int8` is the W8A8 variant, replacing
``attention_block(int8=True)`` (``pl.pallas_call`` at :779, wrapper
:760-815). Its weights come quantized per output channel
(:mod:`msa_tpu_torch.ops.quant`, from the f32 masters): ``w_qkv_q
[3·H·DP, dm]`` int8 with ``s_qkv [3·H·DP]`` f32 scales, ``w_out_q
[dm, H·DP]`` int8 with ``s_out [dm]`` (padded after quantization: int8
zeros, scale 1.0). x and the attention output are quantized per row;
the projections dequantize in f32 in the TPU kernel's order of products,
``acc·xs·s + b`` for q and v and ``acc·s·xs + b`` for k (``:605-657``),
``acc·as·so + bo`` for the output; the attention core is the one of the
compute dtype: bf16 on bf16 x, and on f32 x (``compute_dtype="float32",
quantize="int8"``, where JAX's dots run in f32) the f32 one, with q, k, v,
the attention output and the result in f32.

Two attention-only kernels serve the shapes ``attention_block`` does not
take (the encoder then projects QKV and the output in plain PyTorch, as
JAX does in XLA). Both read ``qkv [B, T, 3, H, D]``, the free view of the
fused projection, and return ``(o [B, T, H·D], lse [B, H, T])``; their
names are JAX's private ones:

- :func:`packed_qkv_attention_lse` (``d_model % 128 ≠ 0`` at T ≤ 512)
  replaces ``_packed_qkv_attention_lse`` (``pl.pallas_call`` at :489,
  kernel :425-462); CUDA in ``csrc/attention_packed.cu``. Exact row max
  over all keys, P normalised *before* P·V: ``(p/denom)`` is rounded to
  qkv's dtype.
- :func:`flash_attention_lse` (T > 512) replaces ``_flash_attention_lse``
  (``pl.pallas_call`` at :948, kernel :880-926), which JAX's encoder
  reaches through ``attention_with_vjp``; CUDA in
  ``csrc/attention_flash.cu``. Online softmax over 128-key blocks: the
  *unnormalised* p is rounded for P·V, ``acc = acc·α + pv``, and ``o = acc
  / max(l, 1e-30)`` at the end.

In f32 both run row 1's one-pass f32 core (``csrc/attention_fused.cu``,
:func:`_packed_f32`): rounding p to f32 is the identity, so the three
orders differ only in f32 rounding. Both pad T to a multiple of 128 with
zero rows under masked keys, so a row with no valid key averages V over
all padded rows, as on the TPU; the lse is ``max + log(denom)`` in f32.
Any D: a D that is not a multiple of 8 is zero-padded on the card
(:func:`_pad_head_dim`), as JAX pads D, with the scale of the unpadded D.
Above D = 128 every bf16 forward row (1, 2, 5, 6, 7, 8) runs the
tensor-core kernel of ``csrc/attention_wide_mma.cu`` (any D: Q's tile in
shared memory up to D = 512 and streamed beside K above it, K and V
through a ring of 64-column chunks, 128- or 192-column tiles of o) and every f32 one the wide f32 kernel of
``csrc/attention_wide.cu`` (S formed once per 128-key block at D ≤ 256, o
in registers, the query tile and a split of the key loop from
:func:`attention_wide_plan.plan`); both round where each row's kernel
rounds. Each wrapper counts such a bf16 launch in :data:`wide_mma`, an
f32 one in :data:`wide_f32`, beside its own count.

JAX's public names keep JAX's contracts: :func:`packed_qkv_attention`
(qkv → o, differentiable: ``attention.py:510-540``) and
:func:`flash_attention` (q, k, v [B, H, T, D] → o, ``:975``).
:func:`mha_attention` (row 2, ``_mha_attention_lse``, ``pl.pallas_call``
at :150) is row 5's function on q, k, v [B, H, T, D], through the same
CUDA core with its own entry point (in f32, row 1's f32 core, which
computes the same function). :func:`fused_attention` /
:func:`fused_attention_lse` (row 1, ``_fused_attention_lse``,
``pl.pallas_call`` at :206) is the same function again at any T and in f32
as well as bf16 (``csrc/attention_fused.cu``: bf16 through rows 5 and 2's
core, f32 through a one-pass kernel of its own); no path of the system
reaches it, as in JAX.

Training (``_bwd_dq_kernel``/``_bwd_dkv_kernel``, ``pl.pallas_call`` at
:370 and :395, rows 3 and 4): :func:`attention_bwd` takes the forward's
operands, o, lse and the output's gradient and returns (dq, dk, dv) through
the two kernels of ``csrc/attention_bwd.cu``, :func:`attention_bwd_dq` and
:func:`attention_bwd_dkv`; :func:`attention_bwd_plain` is their plain
version, 128×128 blocks in the TPU kernels' order. On f32 operands (the
f32 training step, ``compute_dtype="float32"``) the backward runs
``csrc/attention_bwd_f32.cu`` (exact f32 FMA, no rounding in f32): one
pass computes dq, dk and dv in one launch at every D,
:func:`attention_bwd_onepass`, on the grid of
:func:`attention_bwd_plan.plan` (above D = 64 its wide kernel, counted in
:data:`wide_onepass_f32` too); the two f32 entries, which run that file's
D-tiled SIMT pair, serve direct calls only. In bf16 above D = 128 (any D) the two entries
run the tensor-core pair of ``csrc/attention_bwd_wide.cu``, counted in
:data:`wide_bwd_dq` and :data:`wide_bwd_dkv` beside ``launches``. Two
``torch.autograd.Function`` wrappers run
them as JAX's custom VJPs do: :func:`packed_qkv_attention` (row 5 forward,
dqkv back in the packed layout; row 6 forward beyond T = 512) and
:func:`attention_with_vjp` (:842-868: row 2 at T ≤ 512, row 6 beyond), in
bf16 or f32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from msa_tpu_torch.ops import quant as Q
from msa_tpu_torch.ops.kernels import attention_bwd_plan as BP
from msa_tpu_torch.ops.kernels import attention_wide_plan as WP
from msa_tpu_torch.ops.kernels import build
from msa_tpu_torch.ops.kernels import gemm_bf16 as GB
from msa_tpu_torch.ops.kernels import gemm_f32 as GF
from msa_tpu_torch.ops.kernels import gemm_plan as GP
from msa_tpu_torch.ops.kernels import gemm_s8 as GS
from msa_tpu_torch.ops.kernels._common import require
from msa_tpu_torch.ops.kernels.quant import quantize_rows

LANE = 128
SINGLE_PASS_MAX_T = 512
BLOCK_HEAD_DIMS = (32, 64, 128)  # the attention_block core's DP up to 128; above, multiples of 128


class _Launches:
    """The launch count of a kernel that wrappers reach through another C
    entry point (the smoke resets and reads ``launches``)."""

    launches = 0


# the bf16 tensor-core kernels above head dim 128: the forward
# (csrc/attention_wide_mma.cu), reached from rows 1, 2, 5, 6, 7 and 8's
# entries, and the backward pair (csrc/attention_bwd_wide.cu), from rows 3
# and 4's; each wrapper counts its launch here beside its own count
wide_mma, wide_bwd_dq, wide_bwd_dkv = _Launches(), _Launches(), _Launches()
# the f32 kernels above head dim 128 (the forward, csrc/attention_wide.cu,
# from the f32 rows 1, 2, 5, 6, 7 and 8) and above 64 (the one-pass
# backward's wide_onepass_f32_kernel, from attention_bwd_onepass), counted
# likewise beside each wrapper's own count
wide_f32, wide_onepass_f32 = _Launches(), _Launches()


def _wide(d: int, dtype: torch.dtype) -> bool:
    """Whether a launch at head dim ``d`` (a multiple of 8) in ``dtype``
    runs the bf16 tensor-core kernels above D = 128 (any D)."""
    return dtype == torch.bfloat16 and d > 128


def _wide_f32_args(dev: torch.device, b: int, h: int, t: int, d: int) -> tuple:
    """(plan code, tickets, workspace) of the f32 core's launch at head dim
    ``d``: the wide kernel's (:func:`attention_wide_plan.plan`) above D =
    128, zeros (unused) at or below it."""
    if d <= 128:
        return 0, 0, 0
    return WP.launch_args(dev, WP.plan(b, h, t, d), b, h, t, d)


def block_head_dim(d: int) -> int:
    """The head dim DP of the attention_block core that serves head dim
    ``d``: the least of 32, 64 and 128 that is ≥ d, and above 128 the least
    multiple of 128, as JAX pads D."""
    if d < 1:
        raise ValueError(f"head dim {d}")
    return next((dp for dp in BLOCK_HEAD_DIMS if d <= dp), -(-d // LANE) * LANE)


def pad_block_weights(w_qkv, b_qkv, w_out, num_heads: int, s_qkv=None):
    """Weights of head dim D as the attention_block kernels take them, at
    head dim DP = :func:`block_head_dim` (D): each head's rows of ``w_qkv``
    [3·H·D, dm] and of ``b_qkv`` (and of the int8 scales ``s_qkv``, padded
    with 1.0 so that no scale is 0) padded to DP with zeros, and ``w_out``
    [dm, H·D] given zero columns for the padded dims. Works on f32, bf16 or
    int8 codes, so int8 weights are padded after quantization. → (w_qkv,
    b_qkv, w_out, s_qkv); the same tensors where D == DP."""
    dm = w_out.shape[0]
    d = w_qkv.shape[0] // (3 * num_heads)
    dp = block_head_dim(d)
    if dp == d:
        return w_qkv, b_qkv, w_out, s_qkv

    def heads(x, fill=0):  # [3·H·D, ...] → [3·H·DP, ...]
        out = torch.full((3, num_heads, dp, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        out[:, :, :d] = x.reshape(3, num_heads, d, *x.shape[1:])
        return out.reshape(3 * num_heads * dp, *x.shape[1:])

    w_out_p = torch.zeros((dm, num_heads, dp), dtype=w_out.dtype, device=w_out.device)
    w_out_p[:, :, :d] = w_out.reshape(dm, num_heads, d)
    return heads(w_qkv), heads(b_qkv), w_out_p.reshape(dm, num_heads * dp), None if s_qkv is None else heads(s_qkv, 1)


def _pad_t(x: torch.Tensor, key_mask: torch.Tensor):
    t = x.shape[1]
    t_pad = -(-t // LANE) * LANE
    if t_pad > SINGLE_PASS_MAX_T:
        raise NotImplementedError(
            f"attention_block covers T ≤ {SINGLE_PASS_MAX_T}; longer inputs need the flash kernel"
        )
    if t_pad != t:
        x = F.pad(x, (0, 0, 0, t_pad - t))
        key_mask = F.pad(key_mask, (0, t_pad - t))
    return x, key_mask, t_pad


def _kernel_inputs(x: torch.Tensor, key_mask: torch.Tensor, w_qkv: torch.Tensor, num_heads: int, what: str):
    """Check the head layout the kernels take (the weights' per-head width
    DP one of :data:`BLOCK_HEAD_DIMS` or a multiple of 128, dm % 128 == 0)
    and pad T: → (x, key_mask, T_pad, DP), contiguous."""
    dm = x.shape[-1]
    dp = w_qkv.shape[0] // (3 * num_heads)
    if block_head_dim(max(dp, 1)) != dp or 3 * num_heads * dp != w_qkv.shape[0] or dm % LANE:
        raise ValueError(
            f"{what} kernel needs weights of head dim 32, 64 or a multiple of 128 (pad_block_weights pads them) and "
            f"dm % 128 == 0, got w_qkv {tuple(w_qkv.shape)}, {num_heads} heads, dm {dm}"
        )
    xp, mask_p, t_pad = _pad_t(x, key_mask)
    return xp.contiguous(), mask_p.contiguous(), t_pad, dp


def _scale(dh: int) -> float:
    return float(np.float32(1.0 / np.sqrt(dh)))


def _attend(qkv: torch.Tensor, key_mask: torch.Tensor, num_heads: int, dt: torch.dtype, scale: float) -> torch.Tensor:
    """The attention core of both variants: qkv [b, t, 3·H·dh] (f32 values
    already rounded to ``dt``) → o/denom rounded to ``dt``, [b, t, H·dh]."""
    b, t, w3 = qkv.shape
    dh = w3 // (3 * num_heads)
    q, k, v = qkv.view(b, t, 3, num_heads, dh).unbind(dim=2)  # [b, t, h, dh] each
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    bias = torch.where(key_mask > 0, 0.0, -1e9).float()
    s = s * scale + bias[:, None, None, :]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(dt).float(), v)
    return (o / denom).to(dt).permute(0, 2, 1, 3).reshape(b, t, num_heads * dh)


def _block_scale(w_qkv: torch.Tensor, num_heads: int, head_dim) -> float:
    """1/√D of the unpadded head dim (``head_dim``, or the weights' own)."""
    return _scale(head_dim or w_qkv.shape[0] // (3 * num_heads))


def attention_block_plain(x, w_qkv, b_qkv, w_out, b_out, key_mask, num_heads: int, head_dim=None) -> torch.Tensor:
    """Plain PyTorch version of the kernels (same rounding points), on
    padded or unpadded weights."""
    t = x.shape[1]
    dt = x.dtype
    x, key_mask, _ = _pad_t(x, key_mask)
    qkv = x.float() @ w_qkv.float().t() + b_qkv.float()
    attn = _attend(qkv.to(dt).float(), key_mask, num_heads, dt, _block_scale(w_qkv, num_heads, head_dim))
    out = attn.float() @ w_out.float().t() + b_out.float()
    return out.to(dt)[:, :t]


def _block_checks(x, w_qkv, b_qkv, w_out, b_out, key_mask, num_heads, what, dtype):
    b, t, dm = x.shape
    xp, mask_p, t_pad, dp = _kernel_inputs(x, key_mask, w_qkv, num_heads, what)
    hd = num_heads * dp
    for name, tens, dt, shape in (
        ("x", xp, dtype, (b, t_pad, dm)),
        ("w_qkv", w_qkv, dtype, (3 * hd, dm)),
        ("b_qkv", b_qkv, torch.float32, (3 * hd,)),
        ("w_out", w_out, dtype, (dm, hd)),
        ("b_out", b_out, torch.float32, (dm,)),
        ("key_mask", mask_p, torch.float32, (b, t_pad)),
    ):
        require(tens, name, dt, shape, x.device)
    return xp, mask_p, t_pad, dp


def attention_block(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    w_out: torch.Tensor,
    b_out: torch.Tensor,
    key_mask: torch.Tensor,
    num_heads: int,
    head_dim=None,
) -> torch.Tensor:
    """[B, T, dm] → [B, T, dm] (pre-residual). CPU tensors take
    :func:`attention_block_plain`; CUDA tensors launch the bf16 kernel (its
    two GEMMs counted in ``gemm_bf16.launches``), or for f32 x the f32 one
    (:func:`_attention_block_f32`). ``head_dim`` is the unpadded head dim
    of weights padded by :func:`pad_block_weights`."""
    if x.device.type == "cpu":
        return attention_block_plain(x, w_qkv, b_qkv, w_out, b_out, key_mask, num_heads, head_dim)
    if x.dtype == torch.float32:
        return _attention_block_f32(x, w_qkv, b_qkv, w_out, b_out, key_mask, num_heads, head_dim)
    b, t, dm = x.shape
    bf16 = torch.bfloat16
    xp, mask_p, t_pad, dp = _block_checks(x, w_qkv, b_qkv, w_out, b_out, key_mask, num_heads, "attention_block", bf16)
    wide = _wide(dp, bf16)
    dev, hd = x.device, num_heads * dp
    qkv = torch.empty((b * t_pad, 3 * hd), dtype=bf16, device=dev)
    attn = torch.empty((b * t_pad, hd), dtype=bf16, device=dev)
    out = torch.empty((b, t_pad, dm), dtype=bf16, device=dev)
    m = b * t_pad
    ws, cnt, plan_qkv, plan_out = GP.launch_args(dev, (m, 3 * hd, dm), (m, dm, hd), dtype=bf16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = build.library().msa_attention_block(
        xp.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
        mask_p.data_ptr(), qkv.data_ptr(), attn.data_ptr(), out.data_ptr(), ws, cnt,
        b, t_pad, dm, num_heads, dp, plan_qkv, plan_out, _block_scale(w_qkv, num_heads, head_dim), stream,
    )
    build.check(rc, "attention_block")
    attention_block.launches += 1
    wide_mma.launches += wide  # the core above D = 128, launched from C
    GB.gemm_bf16.launches += 2  # QKV and Wo, launched from C
    return out[:, :t]


# kernel launches since the last reset, bf16 and f32 (the smoke reads them)
attention_block.launches = attention_block.launches_f32 = 0


def _attention_block_f32(x, w_qkv, b_qkv, w_out, b_out, key_mask, num_heads: int, head_dim) -> torch.Tensor:
    """:func:`attention_block` on f32 CUDA tensors (x, weights and biases
    f32): ``msa_attention_block_f32`` (the f32 SIMT GEMM on the planner's
    stream-K plan, row 1's f32 core, the GEMM again; the two GEMMs counted
    in ``gemm_f32.launches``)."""
    b, t, dm = x.shape
    f32 = torch.float32
    xp, mask_p, t_pad, dp = _block_checks(x, w_qkv, b_qkv, w_out, b_out, key_mask, num_heads, "attention_block_f32", f32)
    dev, hd = x.device, num_heads * dp
    qkv = torch.empty((b * t_pad, 3 * hd), dtype=f32, device=dev)
    attn = torch.empty((b * t_pad, hd), dtype=f32, device=dev)
    lse = torch.empty((b, num_heads, t_pad), dtype=f32, device=dev)
    out = torch.empty((b, t_pad, dm), dtype=f32, device=dev)
    m = b * t_pad
    ws, cnt, plan_qkv, plan_out = GP.launch_args(dev, (m, 3 * hd, dm), (m, dm, hd), dtype=f32)
    wide = _wide_f32_args(dev, b, num_heads, t_pad, dp)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = build.library().msa_attention_block_f32(
        xp.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
        mask_p.data_ptr(), qkv.data_ptr(), attn.data_ptr(), lse.data_ptr(), out.data_ptr(), ws, cnt,
        b, t_pad, dm, num_heads, dp, plan_qkv, plan_out, *wide, _block_scale(w_qkv, num_heads, head_dim), stream,
    )
    build.check(rc, "attention_block_f32")
    attention_block.launches_f32 += 1
    wide_f32.launches += dp > 128  # the core above D = 128, launched from C
    GF.gemm_f32.launches += 2  # QKV and Wo, launched from C
    return out[:, :t]


def attention_block_int8_plain(x, w_qkv_q, s_qkv, b_qkv, w_out_q, s_out, b_out, key_mask, num_heads: int, head_dim=None):
    """Plain PyTorch version of the int8 kernel (same rounding points; the
    int32 sums are exact, see :func:`msa_tpu_torch.ops.quant.int8_matmul`),
    on padded or unpadded weights."""
    b, t, dm = x.shape
    dt = x.dtype
    hd = w_qkv_q.shape[0] // 3
    x, key_mask, t_pad = _pad_t(x, key_mask)
    xq, xs = Q.quantize_rows(x.reshape(b * t_pad, dm))
    acc = Q.int8_matmul(xq, w_qkv_q)  # [M, 3·hd]
    s = s_qkv.float()
    bias = b_qkv.float()
    q = acc[:, :hd] * xs * s[:hd] + bias[:hd]
    k = acc[:, hd : 2 * hd] * s[hd : 2 * hd] * xs + bias[hd : 2 * hd]
    v = acc[:, 2 * hd :] * xs * s[2 * hd :] + bias[2 * hd :]
    qkv = torch.cat([q, k, v], dim=-1).to(dt).float().view(b, t_pad, 3 * hd)
    attn = _attend(qkv, key_mask, num_heads, dt, _block_scale(w_qkv_q, num_heads, head_dim)).reshape(b * t_pad, hd)
    aq, as_ = Q.quantize_rows(attn)
    out = Q.int8_matmul(aq, w_out_q) * as_ * s_out.float() + b_out.float()
    return out.to(dt).view(b, t_pad, dm)[:, :t]


def attention_block_int8(
    x: torch.Tensor,
    w_qkv_q: torch.Tensor,
    s_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    w_out_q: torch.Tensor,
    s_out: torch.Tensor,
    b_out: torch.Tensor,
    key_mask: torch.Tensor,
    num_heads: int,
    head_dim=None,
) -> torch.Tensor:
    """[B, T, dm] → [B, T, dm] (pre-residual), W8A8. CPU tensors take
    :func:`attention_block_int8_plain`; CUDA tensors launch the kernel
    (weights padded by :func:`pad_block_weights`): on bf16 x
    ``msa_attention_block_int8``, on f32 x (f32 compute)
    ``msa_attention_block_int8_f32``, counted in ``launches_f32``. The
    entry launches its five kernels as one chain, the last four under
    programmatic dependent launch (``csrc/attention.cu``); the counters
    below count each launch once, as before."""
    if x.device.type == "cpu":
        return attention_block_int8_plain(x, w_qkv_q, s_qkv, b_qkv, w_out_q, s_out, b_out, key_mask, num_heads, head_dim)
    b, t, dm = x.shape
    xp, mask_p, t_pad, dp = _kernel_inputs(x, key_mask, w_qkv_q, num_heads, "attention_block_int8")
    dev, f32, i8 = x.device, torch.float32, torch.int8
    dt = torch.float32 if x.dtype == f32 else torch.bfloat16
    hd = num_heads * dp
    for name, tens, dtype, shape in (
        ("x", xp, dt, (b, t_pad, dm)),
        ("w_qkv_q", w_qkv_q, i8, (3 * hd, dm)),
        ("s_qkv", s_qkv, f32, (3 * hd,)),
        ("b_qkv", b_qkv, f32, (3 * hd,)),
        ("w_out_q", w_out_q, i8, (dm, hd)),
        ("s_out", s_out, f32, (dm,)),
        ("b_out", b_out, f32, (dm,)),
        ("key_mask", mask_p, f32, (b, t_pad)),
    ):
        require(tens, name, dtype, shape, dev)
    wide = _wide(dp, dt)
    m = b * t_pad
    xq = torch.empty((m, dm), dtype=i8, device=dev)
    aq = torch.empty((m, hd), dtype=i8, device=dev)
    xs, as_ = (torch.empty((m,), dtype=f32, device=dev) for _ in range(2))
    qkv = torch.empty((m, 3 * hd), dtype=dt, device=dev)
    attn = torch.empty((m, hd), dtype=dt, device=dev)
    out = torch.empty((b, t_pad, dm), dtype=dt, device=dev)
    scratch = [xq, xs, qkv, attn]
    if dt == f32:  # the f32 core's lse
        scratch.append(torch.empty((b, num_heads, t_pad), dtype=f32, device=dev))
    entry = "msa_attention_block_int8_f32" if dt == f32 else "msa_attention_block_int8"
    ws, cnt, plan_qkv, plan_out = GP.launch_args(dev, (m, 3 * hd, dm), (m, dm, hd), dtype=i8)
    wide_args = _wide_f32_args(dev, b, num_heads, t_pad, dp) if dt == f32 else ()  # the f32 core's
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(build.library(), entry)(
        xp.data_ptr(), w_qkv_q.data_ptr(), s_qkv.data_ptr(), b_qkv.data_ptr(), w_out_q.data_ptr(),
        s_out.data_ptr(), b_out.data_ptr(), mask_p.data_ptr(), *(t.data_ptr() for t in scratch), aq.data_ptr(),
        as_.data_ptr(), out.data_ptr(), ws, cnt, b, t_pad, dm, num_heads, dp, plan_qkv, plan_out, *wide_args,
        _block_scale(w_qkv_q, num_heads, head_dim), stream,
    )
    build.check(rc, entry)
    if dt == f32:
        attention_block_int8.launches_f32 += 1
        wide_f32.launches += dp > 128  # the core above D = 128, launched from C
    else:
        attention_block_int8.launches += 1
        wide_mma.launches += wide  # the core above D = 128, launched from C
    quantize_rows.launches += 2  # x and the attention output, launched from C
    GS.gemm_s8.launches += 2  # QKV and Wo, launched from C
    return out[:, :t]


# kernel launches since the last reset, bf16 and f32 x (the smoke reads them)
attention_block_int8.launches = attention_block_int8.launches_f32 = 0


# --- attention on the packed QKV projection (rows 5 and 6) ---------------------

FLASH_BLOCK_K = 128  # the TPU kernel's key block: the online softmax rescales per block


def _pad_packed(qkv: torch.Tensor, key_mask: torch.Tensor):
    """Pad T of qkv [B, T, 3, H, D] and key_mask [B, T] to a multiple of 128
    with zero rows under masked keys. → (qkv, key_mask, T_pad)."""
    t = qkv.shape[1]
    t_pad = -(-t // LANE) * LANE
    if t_pad != t:
        qkv = F.pad(qkv, (0, 0, 0, 0, 0, 0, 0, t_pad - t))
        key_mask = F.pad(key_mask, (0, t_pad - t))
    return qkv, key_mask, t_pad


def _mask_bias(key_mask: torch.Tensor) -> torch.Tensor:
    return torch.where(key_mask > 0, 0.0, -1e9).float()


def packed_qkv_attention_lse_plain(qkv: torch.Tensor, key_mask: torch.Tensor, scale=None):
    """Plain PyTorch version of the row-5 kernel (same rounding points).
    ``scale`` is 1/√D of the head dim by default, that of the unpadded D
    for a D zero-padded as the card's wrappers pad it (rows 1–6)."""
    b, t, _, h, d = qkv.shape
    dt = qkv.dtype
    scale = _scale(d) if scale is None else scale
    qkv, key_mask, t_pad = _pad_packed(qkv, key_mask)
    q, k, v = qkv.float().unbind(dim=2)  # [b, t_pad, h, d]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + _mask_bias(key_mask)[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", (p / denom).to(dt).float(), v).to(dt)
    lse = (m + torch.log(denom))[..., 0]
    return o.reshape(b, t_pad, h * d)[:, :t], lse[:, :, :t]


def flash_attention_lse_plain(qkv: torch.Tensor, key_mask: torch.Tensor, scale=None):
    """Plain PyTorch version of the row-6 kernel: the same online softmax
    over the same 128-key blocks, in the same order of operations
    (``scale`` as :func:`packed_qkv_attention_lse_plain`'s)."""
    b, t, _, h, d = qkv.shape
    scale = _scale(d) if scale is None else scale
    dt = qkv.dtype
    qkv, key_mask, t_pad = _pad_packed(qkv, key_mask)
    q, k, v = qkv.float().permute(2, 0, 3, 1, 4).unbind(0)  # [b, h, t_pad, d]
    bias = _mask_bias(key_mask)
    m = torch.full((b, h, t_pad, 1), -1e30, device=qkv.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, t_pad, d), device=qkv.device)
    for k0 in range(0, t_pad, FLASH_BLOCK_K):
        kb = slice(k0, k0 + FLASH_BLOCK_K)
        s = q @ k[:, :, kb].transpose(-1, -2) * scale + bias[:, None, None, kb]
        m_cur = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(dt).float() @ v[:, :, kb]
        m = m_cur
    l = torch.clamp_min(l, 1e-30)
    o = (acc / l).to(dt).permute(0, 2, 1, 3).reshape(b, t_pad, h * d)
    return o[:, :t], (m + torch.log(l))[..., 0][:, :, :t]


FUSED_D_MULTIPLE = 8  # the kernels copy D in 16-byte pieces of bf16


def _pad_head_dim(*xs: torch.Tensor):
    """Zero-pad the last dimension (D) of each of xs to a multiple of
    :data:`FUSED_D_MULTIPLE`, as JAX's wrappers pad D: the zeros add nothing
    to either product, so o's first D columns and the lse are unchanged
    (with the scale of the unpadded D)."""
    pad = -xs[0].shape[-1] % FUSED_D_MULTIPLE
    return xs if not pad else tuple(F.pad(x, (0, pad)) for x in xs)


def _launch_packed(entry: str, what: str, qkv: torch.Tensor, key_mask: torch.Tensor, dtype: torch.dtype):
    """Check the inputs of a packed-QKV kernel and launch it on the card:
    D zero-padded to a multiple of 8 where it is not one, the output sliced
    back to D; a bf16 launch above D = 128 counted in :data:`wide_mma`."""
    b, t, three, h, d = qkv.shape
    if three != 3:
        raise ValueError(f"{what} kernel needs qkv [B, T, 3, H, D], got {tuple(qkv.shape)}")
    dev = qkv.device
    (qkv_p,) = _pad_head_dim(qkv)
    dp = qkv_p.shape[-1]
    require(qkv_p, "qkv", dtype, (b, t, 3, h, dp), dev)
    require(key_mask, "key_mask", torch.float32, (b, t), dev)
    wide = _wide(dp, dtype)
    o = torch.empty((b, t, h * dp), dtype=dtype, device=dev)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    f32 = dtype == torch.float32
    wide_args = _wide_f32_args(dev, b, h, t, dp) if f32 else ()  # the f32 core's
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(build.library(), entry)(
        qkv_p.data_ptr(), key_mask.data_ptr(), o.data_ptr(), lse.data_ptr(), b, t, h, dp, *wide_args, _scale(d), stream
    )
    build.check(rc, what)
    wide_mma.launches += wide
    wide_f32.launches += f32 and dp > 128
    if dp != d:
        o = o.view(b, t, h, dp)[..., :d].reshape(b, t, h * d)
    return o, lse


def _check_single_pass(qkv: torch.Tensor, what: str) -> None:
    if qkv.shape[1] > SINGLE_PASS_MAX_T:  # JAX's dispatch sends longer inputs to row 6
        raise ValueError(f"{what} covers T ≤ {SINGLE_PASS_MAX_T}, got {qkv.shape[1]}")


def packed_qkv_attention_lse(qkv: torch.Tensor, key_mask: torch.Tensor):
    """JAX's ``_packed_qkv_attention_lse``: qkv [B, T ≤ 512, 3, H, D],
    key_mask [B, T] f32 (1 = attend) → (o [B, T, H·D] in qkv's dtype, lse
    [B, H, T] f32). CPU tensors take
    :func:`packed_qkv_attention_lse_plain`; CUDA tensors launch the bf16
    kernel, or for f32 row 1's f32 core (:func:`_packed_f32`)."""
    if qkv.device.type == "cpu":
        return packed_qkv_attention_lse_plain(qkv, key_mask)
    _check_single_pass(qkv, "packed_qkv_attention_lse")
    if qkv.dtype == torch.float32:
        return _packed_f32(qkv, key_mask, packed_qkv_attention_lse)
    out = _launch_packed("msa_packed_qkv_attention", "packed_qkv_attention_lse", qkv, key_mask, torch.bfloat16)
    packed_qkv_attention_lse.launches += 1
    return out


# kernel launches since the last reset, bf16 and f32 (the smoke reads them)
packed_qkv_attention_lse.launches = packed_qkv_attention_lse.launches_f32 = 0


def flash_attention_lse(qkv: torch.Tensor, key_mask: torch.Tensor):
    """JAX's ``_flash_attention_lse`` on the packed projection: blockwise
    attention for any T, qkv [B, T, 3, H, D], key_mask [B, T] → (o [B, T,
    H·D], lse [B, H, T]). CPU tensors take :func:`flash_attention_lse_plain`;
    CUDA tensors launch the bf16 kernel, or for f32 row 1's f32 core
    (:func:`_packed_f32`)."""
    if qkv.device.type == "cpu":
        return flash_attention_lse_plain(qkv, key_mask)
    if qkv.dtype == torch.float32:
        return _packed_f32(qkv, key_mask, flash_attention_lse)
    out = _launch_packed("msa_flash_attention", "flash_attention_lse", qkv, key_mask, torch.bfloat16)
    flash_attention_lse.launches += 1
    return out


# kernel launches since the last reset, bf16 and f32 (the smoke reads them)
flash_attention_lse.launches = flash_attention_lse.launches_f32 = 0


def _packed_f32(qkv: torch.Tensor, key_mask: torch.Tensor, row) -> tuple:
    """Rows 5 and 6 on f32 CUDA tensors: row 1's one-pass f32 core
    (``msa_packed_attention_f32``) on the packed layout, counted on
    ``row`` (the dispatcher, :func:`packed_qkv_attention_lse` or
    :func:`flash_attention_lse`). Its online rescale per 64-key chunk
    differs from row 5's single pass and row 6's 128-key blocks only in
    f32 rounding."""
    out = _launch_packed("msa_packed_attention_f32", row.__name__, qkv, key_mask, torch.float32)
    row.launches_f32 += 1
    return out


# --- row 2: row 5's function on q, k, v [B, H, T, D] ----------------------------


def _to_packed(q, k, v):
    """q, k, v [B, H, T, D] → qkv [B, T, 3, H, D] (one copy)."""
    return torch.stack((q, k, v), dim=1).permute(0, 3, 1, 2, 4).contiguous()


def _heads_first(o: torch.Tensor, h: int) -> torch.Tensor:
    """o [B, T, H·D] → [B, H, T, D] (a view where o's layout allows)."""
    b, t, hd = o.shape
    return o.reshape(b, t, h, hd // h).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
    """JAX's public ``flash_attention`` (``attention.py:975``): blockwise
    attention with an online softmax, q, k, v [B, H, T, D], key_mask
    [B, T] (1 = attend) → o [B, H, T, D] in q's dtype, at any T. Row 6
    (:func:`flash_attention_lse`) on the packed copy of q, k and v. Not
    differentiable, as JAX's is not."""
    return _heads_first(flash_attention_lse(_to_packed(q, k, v), key_mask)[0], q.shape[1])


def mha_attention_plain(q, k, v, key_mask):
    """Plain PyTorch version of the row-2 kernel: row 5's arithmetic on
    [B, H, T, D] operands → (o [B, H, T, D], lse [B, H, T])."""
    o, lse = packed_qkv_attention_lse_plain(_to_packed(q, k, v), key_mask)
    return _heads_first(o, q.shape[1]), lse


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor):
    """q, k, v [B, H, T ≤ 512, D], key_mask [B, T] f32 (1 = attend) →
    (o [B, H, T, D] in q's dtype, lse [B, H, T] f32). CPU tensors take
    :func:`mha_attention_plain`; CUDA tensors launch the kernel (contiguous;
    D zero-padded to a multiple of 8 where it is not one): bf16 on rows 5
    and 2's core, f32 on row 1's f32 core, which computes row 2's function
    (``msa_fused_attention``), counted in ``launches_f32``."""
    if q.device.type == "cpu":
        return mha_attention_plain(q, k, v, key_mask)
    b, h, t, d = q.shape
    if t > SINGLE_PASS_MAX_T:
        raise ValueError(f"mha_attention kernel needs T ≤ {SINGLE_PASS_MAX_T}, got {tuple(q.shape)}")
    dev, dtype = q.device, q.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mha_attention kernel takes f32 or bf16, got {dtype}")
    q, k, v = _pad_head_dim(q, k, v)
    if q.shape[-1] != d:
        q, k, v = (x.contiguous() for x in (q, k, v))
    dp = q.shape[-1]
    for name, x in (("q", q), ("k", k), ("v", v)):
        require(x, name, dtype, (b, h, t, dp), dev)
    require(key_mask, "key_mask", torch.float32, (b, t), dev)
    wide = _wide(dp, dtype)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), o.data_ptr(), lse.data_ptr(), b, t, h, dp)
    if dtype == torch.float32:
        rc = build.library().msa_fused_attention(*ptrs, 0, *_wide_f32_args(dev, b, h, t, dp), _scale(d), stream)
        build.check(rc, "mha_attention_f32")
        mha_attention.launches_f32 += 1
        wide_f32.launches += dp > 128
    else:
        rc = build.library().msa_mha_attention(*ptrs, _scale(d), stream)
        build.check(rc, "mha_attention")
        mha_attention.launches += 1
        wide_mma.launches += wide
    return (o if dp == d else o[..., :d]), lse


# kernel launches since the last reset, bf16 and f32 (the smoke reads them)
mha_attention.launches = mha_attention.launches_f32 = 0


# --- row 1: the public fused_attention, any T, f32 or bf16 ------------------------

# Row 1 computes rows 2 and 5's function (exact row max, p/denom rounded to
# v's dtype before P·V) with neither one's limits: any T, f32 as well as
# bf16. Its plain version is theirs.
fused_attention_plain = mha_attention_plain


def fused_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor, block_q: int = 256, pad_d: bool = False):
    """JAX's ``_fused_attention_lse``: q, k, v [B, H, T, D] (f32 or bf16,
    any T, any D), key_mask [B, T] f32 (1 = attend) → (o [B, H, T, D] in
    q's dtype, lse [B, H, T] f32). ``block_q`` and ``pad_d`` are the TPU
    kernel's tiling knobs; zero padding is exact, so they change nothing
    and are ignored. CPU tensors take :func:`fused_attention_plain`; CUDA
    tensors launch the kernel of ``csrc/attention_fused.cu`` (bf16: rows 5
    and 2's core; f32: a one-pass kernel), with D zero-padded to a multiple
    of 8 on the card where it is not one."""
    del block_q, pad_d
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, key_mask)
    b, h, t, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_attention kernel takes f32 or bf16, got {q.dtype}")
    dev = q.device
    q, k, v = (x.contiguous() for x in _pad_head_dim(q, k, v))
    d_pad = q.shape[-1]
    for name, x in (("q", q), ("k", k), ("v", v)):
        require(x, name, q.dtype, (b, h, t, d_pad), dev)
    key_mask = key_mask.float().contiguous()
    require(key_mask, "key_mask", torch.float32, (b, t), dev)
    wide = _wide(d_pad, q.dtype)
    f32 = q.dtype == torch.float32
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = build.library().msa_fused_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, t, h, d_pad, int(not f32), *(_wide_f32_args(dev, b, h, t, d_pad) if f32 else (0, 0, 0)), _scale(d), stream,
    )
    build.check(rc, "fused_attention")
    fused_attention_lse.launches += 1
    wide_mma.launches += wide
    wide_f32.launches += f32 and d_pad > 128
    return (o if d_pad == d else o[..., :d].contiguous()), lse


fused_attention_lse.launches = 0  # kernel launches since the last reset (the smoke reads it)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor, block_q: int = 256) -> torch.Tensor:
    """softmax(q·kᵀ/√d + mask_bias)·v: q, k, v [B, H, T, D], key_mask
    [B, T] (1 = attend) → [B, H, T, D] in q's dtype (JAX's public
    ``fused_attention``; :func:`fused_attention_lse` without the lse)."""
    return fused_attention_lse(q, k, v, key_mask, block_q)[0]


def reference_attention(q, k, v, key_mask):
    """JAX's plain-XLA ``reference_attention``: scores in the operands'
    dtype, an f32 softmax over the −1e9-masked scores, P rounded to v's
    dtype for P·V. Unpadded: a row with no valid key averages V over its
    T keys."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * _scale(q.shape[-1])
    s = s + _mask_bias(key_mask)[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


# --- the backward (rows 3 and 4) -------------------------------------------------

BWD_BLOCK = 128  # the TPU kernels' query and key blocks


def _delta(o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO ∘ O) in f32, [B, H, T] (XLA in JAX, ``attention.py:360``)."""
    return (g.float() * o.float()).sum(-1).contiguous()


def attention_bwd_plain(q, k, v, key_mask, lse, o, g, scale=None):
    """Plain PyTorch version of rows 3 and 4: the same arithmetic over the
    same 128×128 blocks in the same order. q, k, v, o, g [B, H, T, D],
    key_mask [B, T], lse [B, H, T] → (dq, dk, dv) in the operands' dtypes
    (``scale`` as :func:`packed_qkv_attention_lse_plain`'s)."""
    b, h, t, d = q.shape
    scale = _scale(d) if scale is None else scale
    t_pad = -(-t // LANE) * LANE
    qf, kf, vf, gf = (F.pad(x, (0, 0, 0, t_pad - t)).float() for x in (q, k, v, g))
    lse_p, delta_p = (F.pad(x.float(), (0, t_pad - t))[..., None] for x in (lse, _delta(o, g)))
    bias = _mask_bias(F.pad(key_mask, (0, t_pad - t)))[:, None, None, :]
    dq, dk, dv = (torch.zeros_like(qf) for _ in range(3))
    for i in range(0, t_pad, BWD_BLOCK):
        qi = slice(i, i + BWD_BLOCK)
        for j in range(0, t_pad, BWD_BLOCK):
            kj = slice(j, j + BWD_BLOCK)
            s = qf[:, :, qi] @ kf[:, :, kj].transpose(-1, -2) * scale + bias[..., kj]
            p = torch.exp(s - lse_p[:, :, qi])
            dp = gf[:, :, qi] @ vf[:, :, kj].transpose(-1, -2)
            ds = p * (dp - delta_p[:, :, qi])
            dq[:, :, qi] += ds.to(k.dtype).float() @ kf[:, :, kj]
            dv[:, :, kj] += p.transpose(-1, -2).to(g.dtype).float() @ gf[:, :, qi]
            dk[:, :, kj] += ds.transpose(-1, -2).to(q.dtype).float() @ qf[:, :, qi]
    return (
        (dq * scale)[:, :, :t].to(q.dtype),
        (dk * scale)[:, :, :t].to(k.dtype),
        dv[:, :, :t].to(v.dtype),
    )


def _bwd_args(q, k, v, g, lse, delta, key_mask, outs, scale: float):
    """Check what the backward kernels take and return the C arguments:
    q, k, v and the outputs [B, H, T, D] views of one dtype (bf16 or f32)
    with one set of strides (D contiguous, rows 16-byte aligned, D % 8 ==
    0), g with its own; lse, delta [B, H, T] and key_mask [B, T] f32,
    contiguous."""
    b, h, t, d = q.shape
    if d % 8:
        raise ValueError(f"attention_bwd kernels need D % 8 == 0 (attention_bwd pads D), got {tuple(q.shape)}")
    dev, dtype = q.device, q.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention_bwd kernels take bf16 or f32, got {dtype}")
    align = 16 // q.element_size()  # elements in 16 bytes

    def strides(x):  # a dimension of size 1 is never stepped along
        return tuple(st if n > 1 else 0 for st, n in zip(x.stride(), x.shape))

    sx = strides(q)
    for name, x in (("q", q), ("k", k), ("v", v), ("g", g), *((f"out{i}", y) for i, y in enumerate(outs))):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != (b, h, t, d):
            raise ValueError(f"attention_bwd {name}: {x.dtype} {tuple(x.shape)} on {x.device}, expected {dtype} {(b, h, t, d)} on {dev}")
        if strides(x)[3] != 1 or any(st % align for st in strides(x)[:3]) or x.data_ptr() % 16:
            raise ValueError(f"attention_bwd {name}: D must be contiguous and rows 16-byte aligned, strides {x.stride()}")
        if name != "g" and strides(x) != sx:
            raise ValueError(f"attention_bwd {name}: strides {x.stride()} differ from q's {sx}")
    require(lse, "lse", torch.float32, (b, h, t), dev)
    require(delta, "delta", torch.float32, (b, h, t), dev)
    require(key_mask, "key_mask", torch.float32, (b, t), dev)
    ptrs = [x.data_ptr() for x in (q, k, v, g, lse, delta, key_mask, *outs)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    return (*ptrs, b, t, h, d, *sx[:3], *strides(g)[:3], scale, stream)


def _launch_bwd_kernel(fn, wide_count, entry: str, q, k, v, g, lse, delta, key_mask, outs, scale) -> None:
    """One backward kernel on the card: ``entry`` on bf16 operands,
    ``entry_f32`` (``csrc/attention_bwd_f32.cu``) on f32 ones, counted on
    ``fn`` (``launches`` or ``launches_f32``), and a bf16 launch above D =
    128 (``csrc/attention_bwd_wide.cu``) on ``wide_count`` too."""
    scale = _scale(q.shape[-1]) if scale is None else scale
    f32 = q.dtype == torch.float32
    name = entry + "_f32" if f32 else entry
    args = _bwd_args(q, k, v, g, lse, delta, key_mask, outs, scale)
    wide = _wide(q.shape[-1], q.dtype)
    rc = getattr(build.library(), name)(*args)
    build.check(rc, fn.__name__ + ("_f32" if f32 else ""))
    if f32:
        fn.launches_f32 += 1
    else:
        fn.launches += 1
        wide_count.launches += wide


def attention_bwd_dq(q, k, v, g, lse, delta, key_mask, dq, scale=None) -> None:
    """Launch row 3 on the card: dq ← scale·Σ_k [P∘(dO·Vᵀ − Δ)]·K, written
    into the view ``dq`` (arguments as :func:`_bwd_args` checks them;
    ``scale`` 1/√D of the unpadded D, by default q's)."""
    _launch_bwd_kernel(attention_bwd_dq, wide_bwd_dq, "msa_attention_bwd_dq", q, k, v, g, lse, delta, key_mask, (dq,), scale)


def attention_bwd_dkv(q, k, v, g, lse, delta, key_mask, dk, dv, scale=None) -> None:
    """Launch row 4 on the card: dv ← Σ_q Pᵀ·dO and dk ← scale·Σ_q
    [P∘(dO·Vᵀ − Δ)]ᵀ·Q, written into the views ``dk`` and ``dv``."""
    _launch_bwd_kernel(attention_bwd_dkv, wide_bwd_dkv, "msa_attention_bwd_dkv", q, k, v, g, lse, delta, key_mask, (dk, dv),
                       scale)


def attention_bwd_onepass(q, k, v, g, lse, delta, key_mask, dq, dk, dv, scale=None, plan=None) -> None:
    """Launch rows 3 and 4 on f32 operands as one kernel at any D
    (``msa_attention_bwd_onepass_f32``: ``onepass_f32_kernel`` at D ≤ 64,
    ``wide_onepass_f32_kernel`` above, counted in :data:`wide_onepass_f32`
    too): dq, dk and dv written into the views (arguments as
    :func:`_bwd_args` checks them), on ``plan`` (by default
    :func:`attention_bwd_plan.plan`'s), with the current stream's ticket
    buffer."""
    if q.dtype != torch.float32:
        raise ValueError(f"the one-pass attention backward takes f32, got {q.dtype}")
    b, h, t, d = q.shape
    plan = plan or BP.plan(b, h, t, d)
    BP.validate(plan, b, h, t, d)
    scale = _scale(d) if scale is None else scale
    args = _bwd_args(q, k, v, g, lse, delta, key_mask, (dq, dk, dv), scale)
    tickets, code = BP.launch_args(q.device, plan, b, h, t, d)
    # (10 pointers, tickets, B, T, H, D, 6 strides, plan, scale, stream)
    rc = build.library().msa_attention_bwd_onepass_f32(*args[:10], tickets, *args[10:20], code, *args[20:])
    build.check(rc, "attention_bwd_onepass")
    attention_bwd_onepass.launches += 1
    wide_onepass_f32.launches += d > BP.NARROW_MAX_D


# kernel launches since the last reset, bf16 and f32 (the smoke reads them)
attention_bwd_dq.launches = attention_bwd_dq.launches_f32 = 0
attention_bwd_dkv.launches = attention_bwd_dkv.launches_f32 = 0
attention_bwd_onepass.launches = 0


def _attention_bwd_into(q, k, v, key_mask, lse, o, g, dq, dk, dv) -> None:
    """The backward into the [B, H, T, D] views dq, dk, dv: the kernels on
    CUDA tensors, the plain version on CPU tensors. On the card a D that is
    not a multiple of 8 is zero-padded, as in the forward (the padded
    columns' gradients are dropped), with the scale of the unpadded D."""
    if q.device.type == "cpu":
        for out, got in zip((dq, dk, dv), attention_bwd_plain(q, k, v, key_mask, lse, o, g)):
            out.copy_(got)
        return
    d = q.shape[-1]
    if d % FUSED_D_MULTIPLE:
        q, k, v, o, g = (x.contiguous() for x in _pad_head_dim(q, k, v, o, g))
        outs = [torch.empty_like(q) for _ in range(3)]
        _launch_bwd(q, k, v, key_mask, lse, o, g, *outs, _scale(d))
        for out, got in zip((dq, dk, dv), outs):
            out.copy_(got[..., :d])
        return
    _launch_bwd(q, k, v, key_mask, lse, o, g, dq, dk, dv, _scale(d))


def _launch_bwd(q, k, v, key_mask, lse, o, g, dq, dk, dv, scale: float) -> None:
    """The backward's launches, by dtype: f32 one pass at every D
    (:func:`attention_bwd_onepass`), bf16 the dQ and the dK/dV entries."""
    if g.stride(-1) != 1:
        g = g.contiguous()
    lse = lse.contiguous()  # a caller's lse may be a slice of a padded one
    delta = _delta(o, g)
    if q.dtype == torch.float32:
        attention_bwd_onepass(q, k, v, g, lse, delta, key_mask, dq, dk, dv, scale)
        return
    attention_bwd_dq(q, k, v, g, lse, delta, key_mask, dq, scale)
    attention_bwd_dkv(q, k, v, g, lse, delta, key_mask, dk, dv, scale)


def attention_bwd(q, k, v, key_mask, lse, o, g):
    """JAX's ``attention_bwd``: the forward's q, k, v [B, H, T, D], key_mask
    [B, T], its lse [B, H, T] and o, and the gradient g of o → (dq, dk,
    dv) in the operands' dtypes. CPU tensors take
    :func:`attention_bwd_plain`; CUDA tensors launch rows 3 and 4 (bf16, or
    f32: one pass)."""
    if q.device.type != "cpu":
        q, k, v = (x.contiguous() for x in (q, k, v))
    dq, dk, dv = (torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in (q, k, v))
    _attention_bwd_into(q, k, v, key_mask, lse, o, g, dq, dk, dv)
    return dq, dk, dv


# --- the differentiable wrappers ----------------------------------------------------


class _PackedQKVAttention(torch.autograd.Function):
    """JAX's ``packed_qkv_attention`` custom VJP (``attention.py:511-540``),
    and beyond T = 512 its ``attention_with_vjp`` (``:842-868``) on the
    same packed layout."""

    @staticmethod
    def forward(ctx, qkv, key_mask):
        attend = packed_qkv_attention_lse if qkv.shape[1] <= SINGLE_PASS_MAX_T else flash_attention_lse
        o, lse = attend(qkv, key_mask)
        ctx.save_for_backward(qkv, key_mask, lse, o)
        return o

    @staticmethod
    def backward(ctx, g):
        qkv, key_mask, lse, o = ctx.saved_tensors
        h = qkv.shape[3]
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        # [B, H, T, D] views into the packed layouts: the kernels read and
        # write them in place
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        dq, dk, dv = (dqkv[:, :, i].transpose(1, 2) for i in range(3))
        _attention_bwd_into(q, k, v, key_mask, lse, _heads_first(o, h), _heads_first(g, h), dq, dk, dv)
        return dqkv, None


def packed_qkv_attention(qkv: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
    """JAX's public ``packed_qkv_attention`` (``attention.py:510-540``):
    differentiable attention on the packed projection, qkv [B, T, 3, H, D],
    key_mask [B, T] (1 = attend) → o [B, T, H·D]. Forward
    :func:`packed_qkv_attention_lse` (row 5) at T ≤ 512 and
    :func:`flash_attention_lse` (row 6) beyond; backward rows 3 and 4, dqkv
    in the packed layout."""
    return _PackedQKVAttention.apply(qkv.contiguous(), key_mask)


class _AttentionWithVJP(torch.autograd.Function):
    """JAX's ``attention_with_vjp`` custom VJP (``attention.py:842-868``)."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask):
        if q.shape[2] > SINGLE_PASS_MAX_T:  # row 6 reads the packed layout
            o, lse = flash_attention_lse(_to_packed(q, k, v), key_mask)
            o = _heads_first(o, q.shape[1])
        else:
            q, k, v = (x.contiguous() for x in (q, k, v))
            o, lse = mha_attention(q, k, v, key_mask)
        ctx.save_for_backward(q, k, v, key_mask, lse, o)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, lse, o = ctx.saved_tensors
        return (*attention_bwd(q, k, v, key_mask, lse, o, g), None)


def attention_with_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
    """Differentiable attention: q, k, v [B, H, T, D], key_mask [B, T] →
    o [B, H, T, D]. Forward :func:`mha_attention` (row 2) at T ≤ 512 and
    :func:`flash_attention_lse` (row 6) beyond; backward rows 3 and 4. The
    counterpart of JAX's API; the encoders take
    :func:`packed_qkv_attention`, which needs no layout copy."""
    return _AttentionWithVJP.apply(q, k, v, key_mask)
