"""Build the port's host-side C++ library (recordio.cpp) at first use.

One `g++ -O2 -std=c++17 -shared -fPIC` of `native/recordio.cpp` into
the repo's `build/paddle_tpu_torch/` directory (where the CUDA kernels'
builds go, `_build.BUILD_DIR`), never beside the sources. The library
name carries a hash of the source and the flags, so an edited source
never loads a stale build; a build writes a file named for its process
(and thread) and then renames it into place, so processes that build
at once (xdist workers) do not collide. Nothing here runs at import
time. A failed build raises: there is no pure-Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from .._build import BUILD_DIR

__all__ = ["library_path", "build", "load", "SOURCES", "GXX_FLAGS"]

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("recordio.cpp",)
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def library_path():
    """The hashed path of the library the current sources build."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libpaddle_tpu_torch_native-"
                        f"{digest.hexdigest()[:12]}.so")


def build():
    """Compile the sources if their hashed build is missing; returns the
    library's path. Raises RuntimeError with g++'s output on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *GXX_FLAGS, "-o", tmp,
           *(os.path.join(_DIR, name) for name in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"native build failed: g++ not found ({e}); "
                           "recordio needs a C++ compiler") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed (g++ exit "
                           f"{proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def load():
    """The ctypes handle of the library, built on first use and cached
    for the process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _lib = lib
        return _lib


def _declare(lib):
    C = ctypes
    lib.ptrio_open_write.restype = C.c_void_p
    lib.ptrio_open_write.argtypes = [C.c_char_p]
    lib.ptrio_write.restype = C.c_int
    lib.ptrio_write.argtypes = [C.c_void_p, C.c_char_p, C.c_int]
    lib.ptrio_close_write.argtypes = [C.c_void_p]
    lib.ptrio_open_read.restype = C.c_void_p
    lib.ptrio_open_read.argtypes = [C.c_char_p]
    lib.ptrio_next.restype = C.c_int
    lib.ptrio_next.argtypes = [C.c_void_p, C.c_char_p, C.c_int]
    lib.ptrio_skip.restype = C.c_int
    lib.ptrio_skip.argtypes = [C.c_void_p, C.c_int]
    lib.ptrio_close_read.argtypes = [C.c_void_p]
    lib.ptrio_count.restype = C.c_int
    lib.ptrio_count.argtypes = [C.c_char_p]
