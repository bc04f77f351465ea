"""Build and bind the port's CUDA kernels.

One ``nvcc`` for each ``msa_tpu_torch/csrc/*.cu`` (with the ``*.cuh``
headers it includes), all started together, compiles it to an object, and
one more links the objects into one shared library with a plain C
interface, which is loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -c -o <obj dir>/<source>.o csrc/<source>.cu          (each source, in parallel)
    nvcc -shared -o msa_tpu_torch/_build/libmsa_kernels_<hash>.so <obj dir>/*.o

No PyTorch headers, no ``torch.utils.cpp_extension``, no ninja. The library
name carries a hash of the sources and flags, so an unchanged tree reuses
the library it built before. The build runs at first use (the first kernel
launch, or :func:`build`), never at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, w1, b1, w2, b2, hidden, out, ws, counters, M, D, F, plan_in,
    # plan_out, stream (ws and counters the bf16 GEMM's split-K partials and
    # per-tile counters, the plans ops/kernels/gemm_plan.py's codes)
    "msa_ffn_fused": (_P,) * 9 + (_I,) * 5 + (_P,),
    # all f32, with the f32 GEMM's stream-K partials, counters and plans
    "msa_ffn_fused_f32": (_P,) * 9 + (_I,) * 5 + (_P,),
    # x, wqkv, bqkv, wout, bout, mask, qkv, attn, out, ws, counters, B, T,
    # DM, H, DP, plan_qkv, plan_out, scale, stream (ws, counters and plans as
    # msa_ffn_fused's)
    "msa_attention_block": (_P,) * 11 + (_I,) * 7 + (_F, _P),
    # as above with the f32 core's lse scratch before out (ws, counters and
    # plans the f32 GEMM's), and the wide f32 core's plan, tickets and
    # workspace before scale (used above DP = 128)
    "msa_attention_block_f32": (_P,) * 12 + (_I,) * 7 + (_I, _P, _P) + (_F, _P),
    # x, x_is_bf16, q, scale, rows, cols, stream
    "msa_quantize_rows": (_P, _I, _P, _P, _I, _I, _P),
    # x, amax, q, scale, rows, cols, stream (f32 x whose row amax is known)
    "msa_quantize_rows_amax": (_P,) * 4 + (_I, _I, _P),
    # x, w1, s1, b1, w2, s2, b2, xq, xs, hidden, hq, hs, out, ws, counters,
    # amax, M, D, F, plan_in, plan_out, stream (x and out bf16; f32 under f32
    # compute; ws and counters the int8 GEMM's split-K workspace, amax the
    # hidden rows', the plans ops/kernels/gemm_s8.py's codes)
    "msa_ffn_fused_int8": (_P,) * 16 + (_I,) * 5 + (_P,),
    "msa_ffn_fused_int8_f32": (_P,) * 16 + (_I,) * 5 + (_P,),
    # x, wqkv, sqkv, bqkv, wout, sout, bout, mask, xq, xs, qkv, attn, aq, as,
    # out, ws, counters, B, T, DM, H, DP, plan_qkv, plan_out, scale, stream
    "msa_attention_block_int8": (_P,) * 17 + (_I,) * 7 + (_F, _P),
    # under f32 compute, with the f32 core's lse scratch after attn and the
    # wide f32 core's plan, tickets and workspace before scale
    "msa_attention_block_int8_f32": (_P,) * 18 + (_I,) * 7 + (_I, _P, _P) + (_F, _P),
    # the int8 GEMM alone: a, w, rs, cs, bias, c, ws, counters, amax (or
    # null: no GELU), M, N, K, plan, stream
    "msa_gemm_s8": (_P,) * 9 + (_I,) * 4 + (_P,),
    # the bf16 GEMM alone: a, w, bias, bias_is_bf16, c, ws, counters, M, N,
    # K, plan, gelu, stream
    "msa_gemm_bf16": (_P,) * 3 + (_I,) + (_P,) * 3 + (_I,) * 5 + (_P,),
    # the f32 GEMM alone (and row 11 on f32): a, w, bias (or null), c, ws,
    # counters, M, N, K, lda, w_nk, batch, a_batch, c_batch, plan, gelu, stream
    "msa_gemm_f32": (_P,) * 6 + (_I,) * 10 + (_P,),
    # qkv, mask, o, lse, B, T, H, D, scale, stream (rows 5 and 6 in bf16; both
    # in f32, with the wide f32 core's plan, tickets and workspace before scale)
    "msa_packed_qkv_attention": (_P,) * 4 + (_I,) * 4 + (_F, _P),
    "msa_packed_attention_f32": (_P,) * 4 + (_I,) * 4 + (_I, _P, _P) + (_F, _P),
    "msa_flash_attention": (_P,) * 4 + (_I,) * 4 + (_F, _P),
    # q, k, v, mask, o, lse, B, T, H, D, scale, stream
    "msa_mha_attention": (_P,) * 6 + (_I,) * 4 + (_F, _P),
    # q, k, v, dout, lse, delta, mask, dq, B, T, H, D, 3 strides of q/k/v/dq,
    # 3 of dout, scale, stream
    "msa_attention_bwd_dq": (_P,) * 8 + (_I,) * 10 + (_F, _P),
    # as above with dk, dv in place of dq
    "msa_attention_bwd_dkv": (_P,) * 9 + (_I,) * 10 + (_F, _P),
    # the same two on f32 operands (csrc/attention_bwd_f32.cu)
    "msa_attention_bwd_dq_f32": (_P,) * 8 + (_I,) * 10 + (_F, _P),
    "msa_attention_bwd_dkv_f32": (_P,) * 9 + (_I,) * 10 + (_F, _P),
    # the one pass on f32 at any D: q, k, v, dout, lse, delta, mask, dq,
    # dk, dv, tickets, B, T, H, D, the 6 strides, plan, scale, stream
    "msa_attention_bwd_onepass_f32": (_P,) * 11 + (_I,) * 11 + (_F, _P),
    # q, k, v, mask, o, lse, B, T, H, D, is_bf16, the wide f32 core's plan,
    # tickets and workspace (f32 above D = 128), scale, stream
    "msa_fused_attention": (_P,) * 6 + (_I,) * 5 + (_I, _P, _P) + (_F, _P),
    # the bf16 forward above D = 128 alone: q, k, v, mask, o, lse, B, T, H,
    # D, order, column tile, Q's place (0 the rule, 1 resident, 2 streamed),
    # scale, stream
    "msa_attention_wide_mma": (_P,) * 6 + (_I,) * 7 + (_F, _P),
    # the bf16 backward kernels above D = 128 alone: q, k, v, dout, lse,
    # delta, mask, dq, dk, dv, B, T, H, D, column tile, the owned tiles'
    # place (as Q's above), scale, stream
    "msa_attention_bwd_wide": (_P,) * 10 + (_I,) * 6 + (_F, _P),
    # bf16: x, wt [C', k·C], out, B, L, C, C', k, gelu, CTAs, stream
    "msa_conv_stride2": (_P,) * 3 + (_I,) * 7 + (_P,),
}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _sources() -> Tuple[Path, ...]:
    return tuple(sorted(CSRC.glob("*.cu")))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Tuple[Path, str]:
    """Compile the library if this source tree has not been built yet.
    Returns (library path, compiler output: the sources' logs in order).
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and spills per
    kernel; the binary is the same, so the name does not change)."""
    extra = ("-Xptxas", "-v") if verbose else ()
    lib = BUILD_DIR / f"libmsa_kernels_{_digest()}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    objs = BUILD_DIR / f"obj.{os.getpid()}"
    objs.mkdir(exist_ok=True)
    nvcc = _nvcc()
    try:
        compiles = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(objs / f"{src.stem}.o"), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in _sources()
        ]
        logs = [proc.communicate()[0] for proc in compiles]  # waits for every one
        failed = [f"{src.name} ({proc.returncode}):\n{log}" for src, proc, log in zip(_sources(), compiles, logs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *sorted(map(str, objs.glob("*.o")))],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    finally:
        shutil.rmtree(objs, ignore_errors=True)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib, "".join(logs) + link.stdout + link.stderr


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.msa_cuda_error_string.argtypes = [ctypes.c_int]
    lib.msa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = library().msa_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
