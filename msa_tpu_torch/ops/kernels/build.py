"""Build and bind the port's CUDA kernels.

One ``nvcc`` call compiles every ``msa_tpu_torch/csrc/*.cu`` (with the
``*.cuh`` headers they include) into one shared
library with a plain C interface, which is loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o msa_tpu_torch/_build/libmsa_kernels_<hash>.so csrc/*.cu

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
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, w1, b1, w2, b2, hidden, out, M, D, F, stream
    "msa_ffn_fused": (_P,) * 7 + (_I,) * 3 + (_P,),
    # x, wqkv, bqkv, wout, bout, mask, qkv, attn, out, B, T, DM, H, scale, stream
    "msa_attention_block": (_P,) * 9 + (_I,) * 4 + (_F, _P),
    # x, x_is_bf16, q, scale, rows, cols, stream
    "msa_quantize_rows": (_P, _I, _P, _P, _I, _I, _P),
    # x, w1, s1, b1, w2, s2, b2, xq, xs, hidden, hq, hs, out, M, D, F, stream
    "msa_ffn_fused_int8": (_P,) * 13 + (_I,) * 3 + (_P,),
    # x, wqkv, sqkv, bqkv, wout, sout, bout, mask, xq, xs, qkv, attn, aq, as,
    # out, B, T, DM, H, scale, stream
    "msa_attention_block_int8": (_P,) * 15 + (_I,) * 4 + (_F, _P),
    # qkv, mask, o, lse, B, T, H, D, scale, stream
    "msa_packed_qkv_attention": (_P,) * 4 + (_I,) * 4 + (_F, _P),
    "msa_flash_attention": (_P,) * 4 + (_I,) * 4 + (_F, _P),
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
    Returns (library path, compiler output). ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory and spills per kernel; the
    binary is the same, so the name does not change)."""
    extra = ("-Xptxas", "-v") if verbose else ()
    lib = BUILD_DIR / f"libmsa_kernels_{_digest()}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib, proc.stdout + proc.stderr


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
