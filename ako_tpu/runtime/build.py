"""Build-and-load for the native runtime library.

Compiles ako_tpu/runtime/native/akort.c on first use into a shared
library whose file name carries a hash of everything the machine code
depends on: the source, the compiler, the flags and the host CPU that
`-march=native` resolves against. A library built on another machine
(or from another source) therefore has another name and is never
loaded; the first load on a new host builds its own. No pip/apt
dependencies: plain cc + libm.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "akort.c")
_OUT_DIR = os.path.join(_HERE, "native")

_lock = threading.Lock()
_lib = None


def _cc() -> str:
    return os.environ.get("CC", "cc")


def _flags() -> list:
    # -O3 -march=native: same output bytes as -O2, faster native coder;
    # AKO_CC_FLAGS overrides, and unsupported flags fall back to -O2
    return os.environ.get("AKO_CC_FLAGS", "-O3 -march=native").split()


def _cpu_id() -> str:
    """The host CPU's model and feature flags (what -march=native
    selects code for)."""
    try:
        with open("/proc/cpuinfo", encoding="utf-8", errors="replace") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.processor()
    picked = {}
    for line in lines:
        key, _, val = line.partition(":")
        key = key.strip()
        if key in ("model name", "flags", "Features", "CPU part") and key not in picked:
            picked[key] = val.strip()
    return repr(sorted(picked.items())) if picked else platform.processor()


def build_key() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    for part in (_cc(), " ".join(_flags()), platform.machine(), _cpu_id()):
        h.update(b"\0" + part.encode())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(_OUT_DIR, f"_akort-{build_key()}.so")


def _compile(path: str) -> None:
    # pid-unique temp: concurrent processes (pytest-xdist workers) may
    # race to build; os.replace keeps the install atomic either way
    tmp = f"{path}.{os.getpid()}.tmp"
    base = ["-fPIC", "-shared", "-fvisibility=hidden", _SRC, "-lm", "-o", tmp]
    try:
        subprocess.run([_cc(), *_flags(), *base], check=True, capture_output=True)
    except subprocess.CalledProcessError:
        subprocess.run([_cc(), "-O2", *base], check=True, capture_output=True)
    os.replace(tmp, path)


def ensure_built() -> str:
    """Path of this host's library, compiled first if absent."""
    path = library_path()
    if not os.path.exists(path):
        _compile(path)
    return path


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(ensure_built())

        lib.akort_quantization.restype = ctypes.c_int32
        lib.akort_quantization.argtypes = [
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.c_uint64,
        ]
        lib.akort_gate.restype = ctypes.c_int32
        lib.akort_gate.argtypes = lib.akort_quantization.argtypes

        lib.akort_kagari_encode.restype = ctypes.c_size_t
        lib.akort_kagari_encode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        lib.akort_kagari_decode.restype = ctypes.c_size_t
        lib.akort_kagari_decode.argtypes = [
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        lib.akort_kagari_sync.restype = ctypes.c_size_t
        lib.akort_kagari_sync.argtypes = [
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_size_t,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]

        lib.akort_tile_unlift.restype = ctypes.c_int32
        lib.akort_tile_unlift.argtypes = [
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_void_p,
        ]
        lib.akort_planes_to_u8.restype = None
        lib.akort_planes_to_u8.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_void_p,
        ]

        lib.akort_tile_lift.restype = ctypes.c_int32
        lib.akort_tile_lift.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        lib.akort_manba_encode.restype = ctypes.c_size_t
        lib.akort_manba_encode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        lib.akort_manba_decode.restype = ctypes.c_size_t
        lib.akort_manba_decode.argtypes = [
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        lib.akort_manba_sync.restype = ctypes.c_size_t
        lib.akort_manba_sync.argtypes = [
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.akort_u8_to_planes.restype = None
        lib.akort_u8_to_planes.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_void_p,
        ]
        lib.akort_tile_encode_block.restype = ctypes.c_size_t
        lib.akort_tile_encode_block.argtypes = [
            ctypes.c_void_p,  # tile u8
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_void_p,  # qs
            ctypes.c_void_p,  # gs
            ctypes.c_size_t,  # stream elems
            ctypes.c_void_p,  # out
            ctypes.c_size_t,  # out capacity
            ctypes.c_void_p,  # rc out
        ]
        lib.akort_tile_decode_block.restype = ctypes.c_int32
        lib.akort_tile_decode_block.argtypes = [
            ctypes.c_void_p,  # payload
            ctypes.c_size_t,
            ctypes.c_size_t,  # count
            ctypes.c_size_t,  # output capacity bytes
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_void_p,  # pixels out
        ]
        lib.akort_tile_encode_spans.restype = ctypes.c_int32
        lib.akort_tile_encode_spans.argtypes = [
            ctypes.c_void_p,  # image u8
            ctypes.c_int64,  # row stride bytes
            ctypes.c_int32,  # channels
            ctypes.c_int32,  # wavelet
            ctypes.c_int32,  # wrap
            ctypes.c_int32,  # color
            ctypes.c_int32,  # discard_nv
            ctypes.c_int32,  # n tiles
            ctypes.c_void_p,  # rects i32 (n, 4)
            ctypes.c_void_p,  # qg offsets i64 (n)
            ctypes.c_void_p,  # qs
            ctypes.c_void_p,  # gs
            ctypes.c_void_p,  # counts i64 (n)
            ctypes.c_void_p,  # caps i64 (n)
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # out offsets i64 (n)
            ctypes.c_void_p,  # sizes out i64 (n)
        ]
        lib.akort_tile_decode_spans.restype = ctypes.c_int32
        lib.akort_tile_decode_spans.argtypes = [
            ctypes.c_void_p,  # blob
            ctypes.c_void_p,  # payload offsets i64 (n)
            ctypes.c_void_p,  # payload sizes i64 (n)
            ctypes.c_void_p,  # counts i64 (n)
            ctypes.c_void_p,  # caps i64 (n)
            ctypes.c_int32,  # n tiles
            ctypes.c_void_p,  # rects i32 (n, 4)
            ctypes.c_int64,  # row stride bytes
            ctypes.c_int32,  # channels
            ctypes.c_int32,  # wavelet
            ctypes.c_int32,  # wrap
            ctypes.c_int32,  # color
            ctypes.c_void_p,  # image out
        ]
        _lib = lib
        return _lib
