"""Flash-attention forward (K1) for the LM server: wrapper, plain
version and launch counter.

`flash_attn_fwd(q, k, v, kv_len, q_start, causal, scale)` computes
attention over head-major `[B, n, T, D]` float32 operands with the mask

    col < kv_len[b]  and  (not causal or col <= q_start[b] + row)

and returns `(o [B, n, Tq, D], lse [B, n, Tq])`. It is the function of
`paddle_tpu/ops/pallas_attention.py::_kernel` (K1) with one extension,
the per-batch query offset `q_start`: cold prefill has q_start = 0 (K1
exactly), decode has Tq = 1, q_start = pos, kv_len = pos + 1, and a
prefix-hit prefill has q_start = the first computed position. A fully
masked row gives o = 0 and lse = -1e30, as K1's finalize does.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel
(`csrc/flash_attn_fwd.cu`, built by nvcc on first use) or raises; it
never falls back. The plain PyTorch version `flash_attn_fwd_plain` is
the reference the kernel is held to, and the path for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["flash_attn_fwd", "flash_attn_fwd_plain", "KERNEL_HEAD_DIMS",
           "NEG"]

NEG = -1e30
KERNEL_HEAD_DIMS = (32, 64)


def flash_attn_fwd_plain(q, k, v, kv_len, q_start, causal=True,
                         scale=None):
    """Masked f32 softmax over the full key axis — the arithmetic of
    `_cached_block` (transformer_ops.py) with K1's zeroing of fully
    masked rows. Same signature and outputs as `flash_attn_fwd`."""
    B, n, Tq, D = q.shape
    Tk = k.shape[2]
    if scale is None:
        scale = 1.0 / float(np.sqrt(D))
    dev = q.device
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    col = torch.arange(Tk, device=dev)
    limit = kv_len.to(dev, torch.int64).clamp(max=Tk)[:, None]  # [B, 1]
    if causal:
        row = torch.arange(Tq, device=dev)
        limit = torch.minimum(
            limit, q_start.to(dev, torch.int64)[:, None] + row[None] + 1)
    else:
        limit = limit.expand(B, Tq)
    mask = col[None, None, None, :] < limit[:, None, :, None]  # [B,1,Tq,Tk]
    s = torch.where(mask, s, torch.full((), NEG, device=dev))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p / den, v.float())
    lse = (m + torch.log(den))[..., 0]
    live = mask.any(dim=-1)                                     # [B,1,Tq]
    o = torch.where(live[..., None], o, torch.zeros((), device=dev))
    lse = torch.where(live, lse, torch.full((), NEG, device=dev))
    return o.to(q.dtype), lse


def _check(q, k, v, kv_len, q_start):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attn_fwd takes [B, n, T, D] q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, n, Tq, D = q.shape
    if k.shape[:2] != (B, n) or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} shapes disagree")
    for name, t in (("kv_len", kv_len), ("q_start", q_start)):
        if t.shape != (B,):
            raise ValueError(f"{name} must be [B]={B}, got "
                             f"{tuple(t.shape)}")
    devs = {t.device for t in (q, k, v, kv_len, q_start)}
    if len(devs) != 1:
        raise ValueError(f"flash_attn_fwd operands on several devices: "
                         f"{sorted(map(str, devs))}")


def _check_kernel_operands(q, k, v, kv_len, q_start):
    """What the CUDA kernel takes; raises on anything else."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attn_fwd kernel takes float32 {name}, "
                            f"got {t.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along D "
                             f"(stride {t.stride(3)})")
        if any(s % 4 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} strides {t.stride()} / pointer must "
                             "be 16-byte aligned rows (strides multiple "
                             "of 4 elements)")
    for name, t in (("kv_len", kv_len), ("q_start", q_start)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous int32 tensor, "
                            f"got {t.dtype}")
    D = q.shape[3]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attn_fwd kernel supports head dims "
                         f"{KERNEL_HEAD_DIMS}, got D={D}")


def _lib():
    from .._build import load_library
    lib = load_library("flash_attn_fwd")
    fn = lib.pt_flash_attn_fwd_f32
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] * 7 + [i] * 5 + [ll] * 12
                       + [i, ctypes.c_float, vp])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, kv_len, q_start, causal, scale):
    """Allocate outputs and launch the kernel on the current stream.
    O is allocated in the packed [B, Tq, n, D] plane and returned as its
    [B, n, Tq, D] view, so the caller's merge of heads is free."""
    B, n, Tq, D = q.shape
    Tk = k.shape[2]
    o_plane = torch.empty((B, Tq, n, D), dtype=torch.float32,
                          device=q.device)
    lse = torch.empty((B, n, Tq), dtype=torch.float32, device=q.device)
    o = o_plane.permute(0, 2, 1, 3)
    if B == 0 or n == 0 or Tq == 0:
        return o, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                kv_len.data_ptr(), q_start.data_ptr(), o.data_ptr(),
                lse.data_ptr(), B, n, Tq, Tk, D,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *o.stride()[:3], int(bool(causal)), float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd kernel launch failed: "
                           f"{'unsupported head dim' if rc == -1 else ''}"
                           f"cudaError {rc} (B={B}, n={n}, Tq={Tq}, "
                           f"Tk={Tk}, D={D})")
    flash_attn_fwd.launches += 1
    return o, lse


def flash_attn_fwd(q, k, v, kv_len, q_start, causal=True, scale=None):
    """Attention forward with per-batch kv_len and query offset; see the
    module docstring. CUDA tensors run the Hopper kernel (or raise),
    CPU tensors run `flash_attn_fwd_plain`."""
    _check(q, k, v, kv_len, q_start)
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[3]))
    if q.device.type == "cpu":
        return flash_attn_fwd_plain(q, k, v, kv_len, q_start, causal,
                                    scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_fwd: unsupported device {q.device}")
    _check_kernel_operands(q, k, v, kv_len, q_start)
    return _launch(q, k, v, kv_len, q_start, causal, scale)


# kernel launches made through this wrapper (the main-path proof)
flash_attn_fwd.launches = 0
