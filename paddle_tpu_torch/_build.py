"""Build the port's CUDA kernels from the repo's sources at first use.

Each kernel is one `csrc/*.cu` file with a plain C interface, compiled
by `nvcc` for `sm_90a` into a shared library under the repo's
`build/paddle_tpu_torch/` directory and loaded with ctypes. The library
name carries a hash of the source and the flags, so an edited source
never loads a stale build. Nothing here runs at import time: the tests
import every module on machines with no `nvcc` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["load_library", "build_library", "BUILD_DIR", "CSRC_DIR"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "paddle_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the port's kernels are built "
                       "from csrc/ on a machine with the CUDA toolkit")


def build_library(name):
    """Compile `csrc/<name>.cu` (if its hashed build is missing) and
    return the path of the shared library."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} (exit "
                           f"{proc.returncode}):\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    return out


def load_library(name):
    """ctypes handle of the built `csrc/<name>.cu`, built on first use
    and cached for the process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_library(name))
            _loaded[name] = lib
        return lib
