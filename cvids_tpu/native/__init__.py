"""Native C++ helpers (max-clique, BoW inverted index) via ctypes.

The reference keeps these host-side in C++ (`include/fmc/*`,
`ThirdParty/DBoW/TemplatedDatabase.h`) because they are tiny and irregular —
the wrong shape for an accelerator kernel. Same decision here: a small C++ library,
built on demand with `make`, loaded with ctypes. Every entry point has a
pure-Python fallback so the package works without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

__all__ = ["available", "max_clique_native", "NativeBowIndex"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libcvids_native.so")
_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO):
        try:
            subprocess.run(["make", "-C", _DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO)
        lib.cvids_max_clique_exact.restype = ctypes.c_int
        lib.cvids_max_clique_heu.restype = ctypes.c_int
        lib.cvids_bow_create.restype = ctypes.c_void_p
        lib.cvids_bow_add.restype = ctypes.c_int
        lib.cvids_bow_count.restype = ctypes.c_int
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def max_clique_native(adj: np.ndarray, exact_threshold: int = 40) -> np.ndarray | None:
    """Native max clique; None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(np.asarray(adj, np.uint8))
    np.fill_diagonal(a, 0)
    n = a.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    out = np.zeros(n, np.int32)
    pa = a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    po = out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    if n <= exact_threshold:
        k = lib.cvids_max_clique_exact(pa, n, po)
    else:
        k = lib.cvids_max_clique_heu(pa, n, po, 30)
    return np.sort(out[:k]).astype(np.int64)


class NativeBowIndex:
    """Inverted-index BoW database (falls back is the dense scorer in
    `server.vocab.BowDatabase`)."""

    def __init__(self, num_words: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = ctypes.c_void_p(lib.cvids_bow_create(num_words))
        self.num_words = num_words

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.cvids_bow_destroy(self._h)
            self._h = None

    def add(self, vec: np.ndarray, client_id: int = 0) -> int:
        nz = np.nonzero(vec)[0].astype(np.int32)
        wts = np.ascontiguousarray(vec[nz], np.float32)
        return self._lib.cvids_bow_add(
            self._h, nz.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            wts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(nz), client_id)

    @property
    def count(self) -> int:
        return self._lib.cvids_bow_count(self._h)

    def query(self, vec: np.ndarray, exclude_from: int = -1) -> np.ndarray:
        n = self.count
        scores = np.zeros(max(n, 1), np.float32)
        nz = np.nonzero(vec)[0].astype(np.int32)
        wts = np.ascontiguousarray(vec[nz], np.float32)
        self._lib.cvids_bow_query(
            self._h, nz.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            wts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(nz), exclude_from,
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
        return scores[:n]
