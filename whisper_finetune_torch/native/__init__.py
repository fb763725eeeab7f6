"""Loader for the native C++ core (BPE merge loop, Levenshtein).

Builds ``wf_native.cpp`` with g++ on first use into ``build/native/`` at
the root of the checkout (the file name carries a hash of the source, so an
edited source rebuilds) and exposes ctypes wrappers. Every consumer treats
the native path as a host accelerator: if g++ or the build is unavailable,
the pure-Python implementations keep working with identical results.
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Sequence

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "wf_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"wf_native_{digest}.so")


def _build(so_path: str) -> None:
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.build"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so_path)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None if unavailable."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            so_path = _so_path()
            if not os.path.exists(so_path):
                _build(so_path)
            lib = ctypes.CDLL(so_path)
            lib.wf_bpe_create.restype = ctypes.c_void_p
            lib.wf_bpe_create.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
            ]
            lib.wf_bpe_destroy.argtypes = [ctypes.c_void_p]
            lib.wf_bpe_encode_piece.restype = ctypes.c_int32
            lib.wf_bpe_encode_piece.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
                ctypes.c_float,
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.wf_levenshtein.restype = ctypes.c_int32
            lib.wf_levenshtein.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
            ]
            _lib = lib
        except Exception as e:  # noqa: BLE001 - any failure => python fallback
            print(f"native build unavailable ({e}); using pure-Python paths")
            _build_failed = True
    return _lib


class NativeBPE:
    """Handle over the C++ merge table. Symbols are vocab ids."""

    def __init__(self, merge_triples: Sequence):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        n = len(merge_triples)
        left = (ctypes.c_int32 * n)(*[t[0] for t in merge_triples])
        right = (ctypes.c_int32 * n)(*[t[1] for t in merge_triples])
        merged = (ctypes.c_int32 * n)(*[t[2] for t in merge_triples])
        self._handle = lib.wf_bpe_create(left, right, merged, n)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            try:
                self._lib.wf_bpe_destroy(handle)
            except Exception:
                pass

    def encode_piece(
        self, symbol_ids: Sequence[int], dropout: float = 0.0, seed: int = 0
    ) -> List[int]:
        n = len(symbol_ids)
        if n == 0:
            return []
        arr = (ctypes.c_int32 * n)(*symbol_ids)
        out = (ctypes.c_int32 * n)()
        count = self._lib.wf_bpe_encode_piece(
            self._handle, arr, n, float(dropout), seed & 0xFFFFFFFFFFFFFFFF, out
        )
        return list(out[:count])


def levenshtein_ids(a: Sequence[int], b: Sequence[int]) -> Optional[int]:
    """Native edit distance over int ids, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    aa = (ctypes.c_int32 * len(a))(*a)
    bb = (ctypes.c_int32 * len(b))(*b)
    return int(lib.wf_levenshtein(aa, len(a), bb, len(b)))
