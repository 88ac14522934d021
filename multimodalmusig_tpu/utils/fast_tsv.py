"""ctypes bindings for the native TSV count-matrix loader.

Builds native/tsv_loader.cpp on first use (g++ -O3 -shared) into
native/libtsv_loader.so, which git does not track, and records the SHA-256
of the source and flags beside it; a library whose record differs is
rebuilt. Falls back to a pure-numpy parser when no C++ toolchain is
available. The returned layout matches the reference's input convention
(README.md:7): rows = vocabulary terms, columns = samples.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Tuple

import numpy as np

__all__ = ["read_counts_tsv", "native_available", "build_native"]

_NATIVE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SRC = os.path.join(_NATIVE, "tsv_loader.cpp")
_LIB_PATH = os.path.join(_NATIVE, "libtsv_loader.so")
# Portable flags: the library is built where it runs, but a checkout copied
# to another host carries it along.
_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_tried = False


def _source_key(src: str) -> str:
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    return h.hexdigest()


def build_native(src: str = _SRC, lib_path: str = _LIB_PATH) -> str:
    """Build the loader library from `src` unless `lib_path` was already
    built from the same source and flags (its `.sha256` record says so).
    Returns `lib_path`; raises CalledProcessError/OSError on failure."""
    key = _source_key(src)
    stamp = lib_path + ".sha256"
    try:
        with open(stamp) as f:
            built = f.read().strip()
    except OSError:
        built = None
    if built == key and os.path.exists(lib_path):
        return lib_path
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    subprocess.run(
        ["g++", *_FLAGS, src, "-o", tmp], check=True, capture_output=True
    )
    os.replace(tmp, lib_path)
    with open(tmp, "w") as f:
        f.write(key + "\n")
    os.replace(tmp, stamp)
    return lib_path


def _build_and_load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(build_native())
            lib.tsv_parse.restype = ctypes.c_void_p
            lib.tsv_parse.argtypes = [ctypes.c_char_p]
            for fn in ("tsv_num_terms", "tsv_num_samples", "tsv_terms_bytes", "tsv_header_bytes"):
                getattr(lib, fn).restype = ctypes.c_long
                getattr(lib, fn).argtypes = [ctypes.c_void_p]
            lib.tsv_copy_counts.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
            lib.tsv_copy_terms.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.tsv_copy_header.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.tsv_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _lib = None
        return _lib


def native_available() -> bool:
    return _build_and_load() is not None


def _read_native(path: str):
    lib = _build_and_load()
    h = lib.tsv_parse(path.encode())
    if not h:
        raise OSError(f"failed to parse {path!r}")
    try:
        V = lib.tsv_num_terms(h)
        D = lib.tsv_num_samples(h)
        counts = np.empty((V, D), dtype=np.float64)
        lib.tsv_copy_counts(h, counts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        tbytes = lib.tsv_terms_bytes(h)
        tbuf = ctypes.create_string_buffer(tbytes)
        lib.tsv_copy_terms(h, tbuf)
        terms = tbuf.raw[:tbytes].decode().split("\n") if tbytes else []
        hbytes = lib.tsv_header_bytes(h)
        hbuf = ctypes.create_string_buffer(hbytes)
        lib.tsv_copy_header(h, hbuf)
        samples = hbuf.raw[:hbytes].decode().split("\n") if hbytes else []
        return counts, terms, samples
    finally:
        lib.tsv_free(h)


def _read_python(path: str):
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        samples = header[1:]
        terms: List[str] = []
        rows: List[np.ndarray] = []
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            terms.append(fields[0])
            rows.append(np.asarray(fields[1:], dtype=np.float64))
    counts = np.stack(rows) if rows else np.zeros((0, len(samples)))
    return counts, terms, samples


def read_counts_tsv(path: str, prefer_native: bool = True) -> Tuple[np.ndarray, List[str], List[str]]:
    """Parse a counts TSV -> (counts (V, D) float64, terms, sample ids).

    Uses the C++ loader when available; pure-Python fallback otherwise.
    """
    if prefer_native and native_available():
        return _read_native(path)
    return _read_python(path)
