"""Build the port's CUDA kernels from the repo's sources at first use.

Each kernel is one `csrc/*.cu` file with a plain C interface, compiled
by `nvcc` for `sm_90a` into a shared library under the repo's
`build/paddle_tpu_torch/` directory and loaded with ctypes. The library
name carries a hash of the source, the headers beside it and the
flags, so an edited source or header never loads a stale build.
Nothing here runs at import time: the tests import every module on
machines with no `nvcc` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["load_library", "build_library", "build_libraries",
           "KERNEL_SOURCES", "BUILD_DIR", "CSRC_DIR"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "paddle_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# every csrc/*.cu the port's paths launch
KERNEL_SOURCES = ("flash_attn_fwd", "flash_attn_bwd", "lm_head_lse",
                  "int8_matmul", "flash_attn_bf16", "lm_head_lse_bf16")

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


def _target(name):
    src = os.path.join(CSRC_DIR, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and every header beside it (a .cu includes them by name)
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")
    return src, out


def build_libraries(names):
    """Compile every `csrc/<name>.cu` whose hashed build is missing, one
    nvcc process per source, all started together; returns
    {name: library path}. Raises naming each source that failed."""
    targets = {name: _target(name) for name in names}
    procs = {}
    t0 = time.perf_counter()
    for name, (src, out) in targets.items():
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {targets[name][0]} (exit "
                          f"{proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
        # a kernel build is the port's counterpart of a compile (the
        # seconds from the builds' start to this one's end)
        from . import monitor
        if monitor.enabled():
            monitor.introspect.note_compile(f"kernel_build:{name}",
                                            time.perf_counter() - t0)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: out for name, (_, out) in targets.items()}


def build_library(name):
    """Compile `csrc/<name>.cu` (if its hashed build is missing) and
    return the path of the shared library."""
    return build_libraries([name])[name]


def load_library(name):
    """ctypes handle of the built `csrc/<name>.cu`, built on first use
    and cached for the process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_library(name))
            _loaded[name] = lib
        return lib
