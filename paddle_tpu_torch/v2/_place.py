"""The v2 API's device: what `init(use_gpu=...)` chose."""

from __future__ import annotations

from .._device import resolve_device
from ..framework import CPUPlace, CUDAPlace

_use_gpu = None


def set_use_gpu(use_gpu):
    """None or True: the CUDA card (raises when none is visible);
    False: the CPU, asked for by the caller."""
    global _use_gpu
    _use_gpu = use_gpu is None or bool(use_gpu)
    if _use_gpu:
        resolve_device(None)


def default_place():
    """The place of a v2 entry point given none: the CPU only after
    `init(use_gpu=False)`, else the card (raises without one)."""
    if _use_gpu is False:
        return CPUPlace()
    dev = resolve_device(None)
    return CUDAPlace(dev.index or 0)
