"""Native (C++) host data plane: vocab encoding and batch row-gather.

The port's copy of ``rank_tpu/native`` (host code: it runs no device
work). The original repo runs its host-side data path in per-row Python;
here those hot loops live in ``src/rank_native.cpp`` (C ABI, loaded with
ctypes), compiled with ``g++`` at first use and cached under ``_build/``.

Public surface:
  * ``available()``: True if the shared library compiled and loaded.
  * ``Vocab(tokens)``: token i -> id i+1, OOV/missing -> 0 (exactly
    ``features.vocab_index``), with ``encode_tokens`` and ``encode_seq``
    (comma-separated rows, keep-tail ``max_len``).
  * ``take_rows(arr, idx)``: threaded row gather (numpy fancy-index
    replacement for batch assembly).

``RANK_TPU_NO_NATIVE=1`` forces the numpy paths everywhere (the
dispatchers in ``data/encode.py`` and ``data/loader.py`` honour it), for
this package and ``rank_tpu`` alike; any build or load failure degrades to
the same paths with a one-time warning rather than an error. Both paths
give the same bytes (``tests/test_torch_data_encode.py``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "rank_native.cpp")
_BUILD_DIR = os.path.join(_HERE, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "librank_native.so")
_ABI_VERSION = 1

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False

N_THREADS = max(1, min(8, os.cpu_count() or 1))


def _compile() -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, _LIB_PATH)  # atomic: concurrent builders race safely
    except subprocess.CalledProcessError as e:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"native build failed:\n{e.stderr}") from e


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.rt_vocab_create.restype = c.c_void_p
    lib.rt_vocab_create.argtypes = [c.c_char_p, c.c_int64]
    lib.rt_vocab_destroy.restype = None
    lib.rt_vocab_destroy.argtypes = [c.c_void_p]
    lib.rt_vocab_size.restype = c.c_int64
    lib.rt_vocab_size.argtypes = [c.c_void_p]
    lib.rt_encode_tokens.restype = c.c_int64
    lib.rt_encode_tokens.argtypes = [
        c.c_void_p, c.c_char_p, c.c_int64, c.c_int64, c.c_void_p, c.c_int32,
    ]
    lib.rt_encode_seq.restype = c.c_int64
    lib.rt_encode_seq.argtypes = [
        c.c_void_p, c.c_char_p, c.c_int64, c.c_int64, c.c_int32,
        c.c_void_p, c.c_void_p, c.c_int32,
    ]
    lib.rt_gather_rows.restype = None
    lib.rt_gather_rows.argtypes = [
        c.c_void_p, c.c_int64, c.c_void_p, c.c_int64, c.c_void_p, c.c_int32,
    ]
    lib.rt_abi_version.restype = c.c_int32
    lib.rt_abi_version.argtypes = []
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    if os.environ.get("RANK_TPU_NO_NATIVE") == "1":
        return None
    try:
        stale = (
            not os.path.exists(_LIB_PATH)
            or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)
        )
        if stale:
            _compile()
        lib = _bind(ctypes.CDLL(_LIB_PATH))
        if lib.rt_abi_version() != _ABI_VERSION:
            _compile()
            lib = _bind(ctypes.CDLL(_LIB_PATH))
        _lib = lib
    except Exception as e:  # degrade to the numpy path, once, loudly
        warnings.warn(
            f"rank_tpu_torch native library unavailable ({e}); using numpy fallbacks",
            RuntimeWarning,
        )
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _join_rows(rows: Sequence) -> Tuple[bytes, int]:
    """Normalise a column of str-or-missing into one newline-joined buffer.

    Non-strings (NaN/None) become "" (-> id 0), matching the numpy path.
    Rows containing a newline would desynchronise the split; the C side
    detects that via its row count and the caller falls back.
    """
    parts: List[str] = [t if isinstance(t, str) else "" for t in rows]
    return "\n".join(parts).encode("utf-8"), len(parts)


class Vocab:
    """token -> row id map living in native memory (row 0 = OOV)."""

    def __init__(self, tokens: Sequence[str]):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library not available")
        self._lib = lib
        buf = "\n".join(tokens).encode("utf-8")
        self._handle = lib.rt_vocab_create(buf, len(buf))
        self.size = int(lib.rt_vocab_size(self._handle))

    def __del__(self):
        h = getattr(self, "_handle", None)
        if h:
            self._lib.rt_vocab_destroy(h)
            self._handle = None

    def encode_tokens(self, rows: Sequence) -> np.ndarray:
        buf, n = _join_rows(rows)
        out = np.empty((n,), np.int32)
        found = self._lib.rt_encode_tokens(
            self._handle, buf, len(buf), n,
            out.ctypes.data_as(ctypes.c_void_p), N_THREADS,
        )
        if found != n:
            raise ValueError(f"row desync: expected {n} rows, found {found}")
        return out

    def encode_seq(self, rows: Sequence, max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        buf, n = _join_rows(rows)
        ids = np.zeros((n, max_len), np.int32)
        lens = np.zeros((n,), np.int32)
        found = self._lib.rt_encode_seq(
            self._handle, buf, len(buf), n, max_len,
            ids.ctypes.data_as(ctypes.c_void_p),
            lens.ctypes.data_as(ctypes.c_void_p), N_THREADS,
        )
        if found != n:
            raise ValueError(f"row desync: expected {n} rows, found {found}")
        return ids, lens


def take_rows(arr: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """out[j] = arr[idx[j]] along axis 0: threaded memcpy gather. numpy
    takes non-contiguous arrays, empty rows and negative or out-of-range
    indices, whose semantics are numpy's."""
    lib = _load()
    if (
        lib is None
        or not arr.flags.c_contiguous
        or arr.shape[0] == 0
        or arr.itemsize * int(np.prod(arr.shape[1:], dtype=np.int64)) == 0
    ):
        return arr[idx]
    idx64 = np.ascontiguousarray(idx, np.int64)
    if idx64.size and (idx64.min() < 0 or idx64.max() >= arr.shape[0]):
        return arr[idx]
    out = np.empty((idx64.shape[0],) + arr.shape[1:], arr.dtype)
    row_bytes = arr.strides[0]
    lib.rt_gather_rows(
        arr.ctypes.data_as(ctypes.c_void_p), row_bytes,
        idx64.ctypes.data_as(ctypes.c_void_p), idx64.shape[0],
        out.ctypes.data_as(ctypes.c_void_p), N_THREADS,
    )
    return out
