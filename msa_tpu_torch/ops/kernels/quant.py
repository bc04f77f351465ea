"""Row quantization: per-row symmetric int8 of an activation.

Replaces ``msa_tpu/ops/quant.py:quantize_rows`` where the TPU W8A8 kernels
run it: on their input in XLA (``ops/pallas/attention.py:776``,
``ffn.py:160``) and inside the kernel on the attention output
(``attention.py:677``) and on the FFN hidden tile (``ffn.py:126``). The CUDA
kernel is ``msa_tpu_torch/csrc/quant.cu``; its note says what bounds it
(bytes: it reads each row once, cols / 8 threads a row, 8 values a thread
in registers). Its plain version is
:func:`msa_tpu_torch.ops.quant.quantize_rows`, and the two are bit-equal
(codes and scales).

The int8 attention and FFN entries launch a row quantization twice each
from C (input and inner activation); their wrappers add those launches to
``quantize_rows.launches``. The FFN's inner one is the kernel's second
form: on f32 rows whose amax the fc_in GEMM's epilogue has already
reduced (``quantize_rows(x, amax)``), elementwise, no reduction; the
codes and scales are the same. Inside those entries the inner one runs
under programmatic dependent launch (it waits for the kernel before it);
a call from here launches in plain stream order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from msa_tpu_torch.ops import quant as Q
from msa_tpu_torch.ops.kernels import build
from msa_tpu_torch.ops.kernels._common import require


def quantize_rows(x: torch.Tensor, amax: torch.Tensor | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [rows, cols] f32 or bf16 → (int8 [rows, cols], scale [rows, 1]
    f32). CPU tensors take the plain version; CUDA tensors launch the
    kernel (cols % 8 == 0): with ``amax`` (int32 [rows], each row's max
    |x| as f32 bits, as fc_in's epilogue leaves it; f32 x), the
    elementwise form that runs no reduction."""
    if x.device.type == "cpu":
        return Q.quantize_rows(x)
    rows, cols = x.shape
    if cols % 8 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quantize_rows kernel needs f32/bf16 and cols % 8 == 0, got {x.dtype}, {cols}")
    require(x, "x", torch.float32 if amax is not None else x.dtype, (rows, cols), x.device)
    q = torch.empty((rows, cols), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if amax is not None:
        require(amax, "amax", torch.int32, (rows,), x.device)
        rc = build.library().msa_quantize_rows_amax(
            x.data_ptr(), amax.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, cols, stream
        )
    else:
        rc = build.library().msa_quantize_rows(
            x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(), scale.data_ptr(), rows, cols, stream
        )
    build.check(rc, "quantize_rows")
    quantize_rows.launches += 1
    return q, scale


quantize_rows.launches = 0  # kernel launches since the last reset (the smoke reads it)
