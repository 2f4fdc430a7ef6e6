"""Native (C++) data loader bindings via ctypes.

Builds ``libp3native-<digest>.so`` from ``packer.cpp`` on first use, next
to the source (git-ignored).  The digest covers the source and the compile
command, so an edited source builds a new library and a stale binary is
never loaded.  Falls back to the numpy parser in ``io/reads.py`` when no
compiler is available -- the two paths implement the same contract and are
cross-checked by ``tests/test_native.py``; ``ReadBatch.parser`` records
which one ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "packer.cpp")
_CXX = ["g++", "-O3", "-shared", "-fPIC", "-pthread"]

_lib = None
_tried = False


def lib_path() -> str:
    """Path of the library built from the current source and flags."""
    h = hashlib.sha256(" ".join(_CXX).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_DIR, f"libp3native-{h.hexdigest()[:12]}.so")


def _build(path: str) -> bool:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(_CXX + ["-o", tmp, _SRC], capture_output=True,
                           timeout=240)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if r.returncode != 0:
        return False
    os.replace(tmp, path)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    path = lib_path()
    if not os.path.exists(path) and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.p3_open.restype = ctypes.c_void_p
    lib.p3_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    for f in ("p3_num_chunks", "p3_num_reads", "p3_all_bases"):
        getattr(lib, f).restype = ctypes.c_uint64
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.p3_fill.restype = None
    lib.p3_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 7 + [
        ctypes.c_int]
    lib.p3_close.restype = None
    lib.p3_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def load_reads_native(path: str, k: int, chunk_len: int, threads: int = 8):
    """Parse + pack via the native library; None if unavailable.

    Returns a ``platanus3_tpu.io.reads.ReadBatch``.
    """
    lib = get_lib()
    if lib is None:
        return None
    from platanus3_tpu.io.reads import ReadBatch

    h = lib.p3_open(path.encode(), k, chunk_len)
    if not h:
        return None
    try:
        c = int(lib.p3_num_chunks(h))
        num_reads = int(lib.p3_num_reads(h))
        all_bases = int(lib.p3_all_bases(h))
        if c == 0:
            return ReadBatch(
                packed=np.zeros((1, chunk_len // 16), np.uint32),
                valid_len=np.zeros(1, np.int32),
                read_id=np.zeros(1, np.int32),
                start=np.zeros(1, np.int32),
                read_len=np.zeros(1, np.int32),
                prev_base=np.full(1, 4, np.uint8),
                next_base=np.full(1, 4, np.uint8),
                chunk_len=chunk_len, k=k, all_bases=all_bases,
                num_reads=num_reads, parser="native")
        packed = np.empty((c, chunk_len // 16), np.uint32)
        valid_len = np.empty(c, np.int32)
        read_id = np.empty(c, np.int32)
        start = np.empty(c, np.int32)
        read_len = np.empty(c, np.int32)
        prev_base = np.empty(c, np.uint8)
        next_base = np.empty(c, np.uint8)
        ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        lib.p3_fill(h, ptr(packed), ptr(valid_len), ptr(read_id),
                    ptr(start), ptr(read_len), ptr(prev_base),
                    ptr(next_base), threads)
        return ReadBatch(
            packed=packed, valid_len=valid_len, read_id=read_id,
            start=start, read_len=read_len, prev_base=prev_base,
            next_base=next_base, chunk_len=chunk_len, k=k,
            all_bases=all_bases, num_reads=num_reads, parser="native")
    finally:
        lib.p3_close(h)
