"""ctypes bindings for the native host runtime (port of
``msa_tpu/runtime/native_lib.py``).

The C++ source is the JAX package's ``msa_tpu/runtime/native/msa_runtime.cpp``,
read by path (it is plain C++, no JAX): ``g++ -O3 -shared -fPIC -std=c++17``
builds it at first use into ``msa_tpu_torch/_build/libmsa_runtime_<hash>.so``,
named by a hash of the source, so the JAX package's own library is never
written. Every entry point keeps JAX's numpy version for where ``g++`` is
missing, and gives the same numbers.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "msa_tpu" / "runtime" / "native" / "msa_runtime.cpp"
BUILD_DIR = _ROOT / "msa_tpu_torch" / "_build"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[Path]:
    """The library for this source, compiled if it is not there yet; None
    where the source is missing or g++ fails."""
    try:
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    except OSError as e:
        logger.warning("native runtime source unreadable: %s", e)
        return None
    lib = BUILD_DIR / f"libmsa_runtime_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:  # g++ missing or stuck
        logger.warning("native build unavailable: %s", e)
        return None
    if proc.returncode != 0:
        logger.warning("native build failed: %s", proc.stderr.decode()[:500])
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            logger.warning("native load failed: %s", e)
            return None
        i64, f32p, i16p, i64p, voidp = (
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_void_p,
        )
        lib.msa_pcm16_to_f32.argtypes = [i16p, f32p, i64]
        lib.msa_pcm16_to_f32.restype = None
        lib.msa_slice_windows.argtypes = [f32p, i64, i64p, i64p, i64, i64, f32p]
        lib.msa_slice_windows.restype = None
        lib.msa_ring_create.restype = voidp
        lib.msa_ring_create.argtypes = [i64]
        lib.msa_ring_destroy.argtypes = [voidp]
        lib.msa_ring_destroy.restype = None
        lib.msa_ring_size.restype = i64
        lib.msa_ring_size.argtypes = [voidp]
        lib.msa_ring_push.restype = i64
        lib.msa_ring_push.argtypes = [voidp, f32p, i64]
        lib.msa_ring_pop.restype = i64
        lib.msa_ring_pop.argtypes = [voidp, f32p, i64]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native library built and loaded."""
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def pcm16_to_f32_numpy(pcm: np.ndarray) -> np.ndarray:
    """JAX's numpy version of :func:`pcm16_to_f32`."""
    return np.ascontiguousarray(pcm, np.int16).astype(np.float32) / 32768.0


def pcm16_to_f32(pcm: np.ndarray) -> np.ndarray:
    """int16 PCM → float32 in [-1, 1]."""
    pcm = np.ascontiguousarray(pcm, np.int16)
    lib = _load()
    if lib is None:
        return pcm16_to_f32_numpy(pcm)
    out = np.empty(pcm.shape[0], np.float32)
    lib.msa_pcm16_to_f32(pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), _fptr(out), pcm.shape[0])
    return out


def slice_windows_numpy(waveform: np.ndarray, starts: np.ndarray, ends: np.ndarray, window_samples: int) -> np.ndarray:
    """JAX's numpy version of :func:`slice_windows`."""
    out = np.zeros((len(starts), window_samples), np.float32)
    for i in range(len(starts)):
        lo = max(int(starts[i]), 0)
        hi = min(int(ends[i]), waveform.shape[0])
        m = min(max(hi - lo, 0), window_samples)
        out[i, :m] = waveform[lo : lo + m]
    return out


def slice_windows(waveform: np.ndarray, starts: np.ndarray, ends: np.ndarray, window_samples: int) -> np.ndarray:
    """[start, end) sample ranges → [num_segments, window_samples] float32
    windows, clamped to the waveform, zero-padded or cut: the host loop
    that feeds the device."""
    waveform = np.ascontiguousarray(waveform, np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    n = starts.shape[0]
    if ends.shape[0] != n:
        raise ValueError(f"{n} starts but {ends.shape[0]} ends")
    lib = _load()
    if lib is None:
        return slice_windows_numpy(waveform, starts, ends, window_samples)
    out = np.empty((n, window_samples), np.float32)
    lib.msa_slice_windows(
        _fptr(waveform),
        waveform.shape[0],
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        window_samples,
        _fptr(out),
    )
    return out


class NativeRingBuffer:
    """Lock-free SPSC float32 ring for the capture thread → processing loop
    hand-off; overflow drops the oldest samples. A Python deque of arrays
    takes its place where the native library is unavailable."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._lib = _load()
        if self._lib is not None:
            self._ring = self._lib.msa_ring_create(self.capacity)
            self._chunks = None
        else:
            self._ring = None
            self._chunks = collections.deque()
            self._size = 0
            self._py_lock = threading.Lock()

    def push(self, samples: np.ndarray) -> int:
        """Append samples; drops the oldest on overflow. → the dropped count."""
        samples = np.ascontiguousarray(samples, np.float32)
        if self._ring is not None:
            return int(self._lib.msa_ring_push(self._ring, _fptr(samples), samples.shape[0]))
        with self._py_lock:
            self._chunks.append(samples)
            self._size += samples.shape[0]
            dropped = 0
            while self._size > self.capacity:
                head = self._chunks[0]
                excess = self._size - self.capacity
                if head.shape[0] <= excess:
                    self._chunks.popleft()
                    self._size -= head.shape[0]
                    dropped += head.shape[0]
                else:
                    self._chunks[0] = head[excess:]
                    self._size -= excess
                    dropped += excess
            return dropped

    def __len__(self) -> int:
        if self._ring is not None:
            return int(self._lib.msa_ring_size(self._ring))
        with self._py_lock:
            return self._size

    def pop(self, n: int) -> np.ndarray:
        """Pop up to n samples (fewer if not available)."""
        if self._ring is not None:
            out = np.empty(n, np.float32)
            got = int(self._lib.msa_ring_pop(self._ring, _fptr(out), n))
            return out[:got]
        with self._py_lock:
            parts, need = [], n
            while need > 0 and self._chunks:
                head = self._chunks[0]
                if head.shape[0] <= need:
                    parts.append(head)
                    self._chunks.popleft()
                    need -= head.shape[0]
                else:
                    parts.append(head[:need])
                    self._chunks[0] = head[need:]
                    need = 0
            got = np.concatenate(parts) if parts else np.empty(0, np.float32)
            self._size -= got.shape[0]
            return got

    def drain(self) -> np.ndarray:
        return self.pop(len(self))

    def __del__(self):
        ring = getattr(self, "_ring", None)
        if ring is not None and self._lib is not None:
            self._lib.msa_ring_destroy(ring)
            self._ring = None
