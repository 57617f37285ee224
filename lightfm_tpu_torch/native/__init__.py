"""Loader for the native ingest engine (see ingest.cpp).

Counterpart of ``lightfm_tpu/native/__init__.py``, with the same functions
(:func:`map_ids`, :func:`lookup_ids`, :func:`parse_interactions`) and the
same feature flag, ``AVAILABLE``, that callers check before taking the
native path.  It differs in when and where it builds:

* at first use, not at import: reading ``AVAILABLE`` or calling one of the
  functions compiles ``ingest.cpp`` with ``g++ -O3 -shared -fPIC
  -std=c++17`` and loads it with ctypes;
* into ``lightfm_tpu_torch/_build/`` (listed in ``.gitignore``), under a
  name that carries a hash of the source and the flags (as
  ``ops/_build.py`` names the CUDA libraries), so an edited source
  rebuilds and an unchanged one is reused;
* to a temporary name first, then ``os.replace``, so that several
  processes building at once agree.

A build that fails raises with the compiler's output.  Only a machine
without ``g++`` (and without a built library) has ``AVAILABLE`` false; the
package then takes its pure-Python paths, which give the same results.

``INT64_MIN`` is the engine's empty-slot marker in its hash map, so it
cannot be an id: :func:`map_ids` and :func:`lookup_ids` raise
``ValueError`` for it (``data.Dataset`` sends such arrays through its
pure-Python path instead).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "ingest.cpp"
BUILD_DIR = SRC.parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
INT64_MIN = int(np.iinfo(np.int64).min)

_LOCK = threading.Lock()
_lib = None


def target() -> Path:
    """The library's path: ``_build/ingest_<hash of source and flags>.so``."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{SRC.stem}_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``ingest.cpp`` unless its library exists; return its path.
    Raises ``RuntimeError`` with the compiler's output when the build fails."""
    out = target()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; it builds lightfm_tpu_torch's ingest engine")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"{out.stem}.", suffix=".tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load():
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))

        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)

        lib.lf_map_ids.restype = ctypes.c_int64
        lib.lf_map_ids.argtypes = [i64p, ctypes.c_int64, i64p, ctypes.c_int64, i64p]
        lib.lf_lookup_ids.restype = ctypes.c_int64
        lib.lf_lookup_ids.argtypes = [i64p, ctypes.c_int64, i64p, ctypes.c_int64, i32p]
        lib.lf_parse_interactions.restype = ctypes.c_int64
        lib.lf_parse_interactions.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, i64p, i64p, f32p,
        ]
        lib.lf_count_lines.restype = ctypes.c_int64
        lib.lf_count_lines.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        _lib = lib
        return lib


def available() -> bool:
    """True once the engine is loaded, building it if needed; False only
    when there is neither a built library nor ``g++``.  A failed build
    raises."""
    if _lib is None and shutil.which("g++") is None and not target().exists():
        return False
    _load()
    return True


def __getattr__(name):
    # ``AVAILABLE`` is computed on first read, so importing builds nothing.
    if name == "AVAILABLE":
        return available()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _refuse_sentinel(*arrays) -> None:
    for a in arrays:
        if a.size and a.min() == INT64_MIN:
            raise ValueError(
                "INT64_MIN is the native engine's empty-slot marker and cannot be an id"
            )


def map_ids(existing: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """New unique ids of ``ids`` in first-seen order, given ``existing``
    already-mapped ids (also first-seen order).  int64 in, int64 out."""
    lib = _load()
    existing = np.ascontiguousarray(existing, dtype=np.int64)
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    _refuse_sentinel(existing, ids)
    out = np.empty(len(ids), dtype=np.int64)
    n_new = lib.lf_map_ids(
        _ptr(existing, ctypes.c_int64), len(existing),
        _ptr(ids, ctypes.c_int64), len(ids),
        _ptr(out, ctypes.c_int64),
    )
    return out[:n_new]


def lookup_ids(mapping_keys: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Dense indices of ``keys`` within ``mapping_keys`` (first-seen order
    defines the index); -1 where missing."""
    lib = _load()
    mapping_keys = np.ascontiguousarray(mapping_keys, dtype=np.int64)
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    _refuse_sentinel(mapping_keys, keys)
    out = np.empty(len(keys), dtype=np.int32)
    lib.lf_lookup_ids(
        _ptr(mapping_keys, ctypes.c_int64), len(mapping_keys),
        _ptr(keys, ctypes.c_int64), len(keys),
        _ptr(out, ctypes.c_int32),
    )
    return out


def parse_interactions(data: bytes, delim: bytes = b"\t"):
    """Parse ``uid<delim>iid[<delim>value...]`` lines to numpy arrays.

    Returns ``(uids int64, iids int64, values float32)``; malformed lines
    are skipped; a missing value field parses as 1.0.
    """
    lib = _load()
    n_max = lib.lf_count_lines(data, len(data))
    uids = np.empty(n_max, dtype=np.int64)
    iids = np.empty(n_max, dtype=np.int64)
    vals = np.empty(n_max, dtype=np.float32)
    n = lib.lf_parse_interactions(
        data, len(data), ctypes.c_char(delim),
        _ptr(uids, ctypes.c_int64), _ptr(iids, ctypes.c_int64),
        _ptr(vals, ctypes.c_float),
    )
    return uids[:n], iids[:n], vals[:n]
