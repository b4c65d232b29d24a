"""Fused LM-head + softmax-cross-entropy (the port of
`paddle_tpu/ops/chunked_ce.py`), with K5, the lm-head log-sum-exp, as a
hand-written Hopper kernel.

loss[i] = logsumexp(x[i] @ w) - (x[i] @ w)[labels[i]], with the [N, V]
logits never materialized in the forward: the picked logit is one
row-gather of w^T and a rowwise dot, and the lse comes from
`lm_head_lse` — K5 (`csrc/lm_head_lse.cu` for f32 operands, 3xTF32
tensor-core products over a split vocabulary whose per-split (max,
denominator) a second pass merges in order; `csrc/lm_head_lse_bf16.cu`
for bf16 amp operands; the counterparts of `_lse_kernel`) on a CUDA
tensor, its plain chunked version on a CPU tensor. The reference elects its Pallas lse with a flag and a VMEM gate
(`resolve_lse_mode`, `_lse_supports`); the port uses the kernel whenever
the tensors are on the card. The backward (`_xent_bwd`) is plain torch
matmuls over vocab chunks, as the reference leaves it to XLA: it reads
only the lse residual and recomputes each chunk's logits. Under amp the
operands are bf16 and every product gives f32 (`_mm_f32`), the
reference's preferred_element_type.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .registry import register_op

__all__ = ["lm_head_lse", "lm_head_lse_bf16", "lm_head_lse_plain",
           "chunked_lm_head_xent", "auto_chunks", "lse_splits", "LSE_MAX_H"]

LSE_MAX_H = 768         # the H the K5 kernels take
LSE_ROWS = LSE_COLS = 128   # the f32 K5's block tile (csrc/lm_head_lse.cu)


def auto_chunks(V):
    """Chunk count of the backward's vocab sweep: ~8k columns per chunk
    keeps the [N, Vc] f32 transient bounded (the reference's rule)."""
    if V <= 16384:
        return 1
    return max(1, round(V / 8192.0))


def lm_head_lse_plain(x, w, chunk=4096, splits=1):
    """lse[i] = logsumexp_c (x @ w)[i, c], as an online max/denominator
    over vocab chunks (the kernel's arithmetic in chunk-sized steps).
    With `splits` > 1 the vocabulary is cut into ranges of ceil(V /
    splits) columns, each range's (max, denominator) is taken that way
    and the ranges are merged in order: the f32 K5's split and merge."""
    N, V = x.shape[0], w.shape[1]
    width = max(1, -(-V // splits))
    parts = []
    for v0 in range(0, V, width):
        v1 = min(v0 + width, V)
        m = torch.full((N,), -float("inf"), dtype=torch.float32,
                       device=x.device)
        s = torch.zeros((N,), dtype=torch.float32, device=x.device)
        for c0 in range(v0, v1, chunk):
            lg = torch.matmul(x.float(), w[:, c0:min(c0 + chunk, v1)].float())
            mn = torch.maximum(m, lg.amax(dim=1))
            s = s * torch.exp(m - mn) + torch.exp(lg - mn[:, None]).sum(dim=1)
            m = mn
        parts.append((m, s))
    if len(parts) == 1:
        m, s = parts[0]
        return m + torch.log(s)
    mx = torch.stack([m for m, _ in parts]).amax(dim=0)
    s = torch.zeros_like(mx)
    for m, sj in parts:
        s = s + sj * torch.exp(m - mx)
    return mx + torch.log(s)


def lse_splits(N, V, sms):
    """The vocab splits the f32 K5 runs: (row block, split) blocks for
    about 16 a streaming multiprocessor (one is resident at a time, so
    the last wave is a small share of the run), at most one split a
    128-column vocab tile."""
    row_blocks = max(1, -(-N // LSE_ROWS))
    tiles = max(1, -(-V // LSE_COLS))
    return max(1, min(tiles, -(-16 * sms // row_blocks)))


def _lse_lib(dtype):
    """The C entry of K5 for `dtype`: bf16 (`lm_head_lse_bf16.cu`: x, w,
    lse, N, H, V, the row strides, the stream) or f32 (`lm_head_lse.cu`:
    the same with the split scratch after lse and the split count before
    the stream)."""
    from .._build import load_library
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if dtype == torch.bfloat16:
        fn = load_library("lm_head_lse_bf16").pt_lm_head_lse_bf16
        argtypes = [vp, vp, vp, i, i, i, ll, ll, vp]
    else:
        fn = load_library("lm_head_lse").pt_lm_head_lse_f32
        argtypes = [vp, vp, vp, vp, i, i, i, ll, ll, i, vp]
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_operands(x, w):
    """What K5 takes (x and w both float32 or both bfloat16, row-major,
    16-byte aligned rows, H up to LSE_MAX_H); raises on anything
    else."""
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"lm_head_lse kernel takes float32 or bfloat16 x "
                        f"and w of one dtype, got {x.dtype} and {w.dtype}")
    if x.stride(1) != 1 or w.stride(1) != 1:
        raise ValueError("lm_head_lse kernel takes row-major x and w")
    per16 = 16 // x.element_size()
    H = x.shape[1]
    if H % per16 or x.stride(0) % per16 or x.data_ptr() % 16 \
            or H > LSE_MAX_H:
        raise ValueError(f"lm_head_lse kernel takes H a multiple of "
                         f"{per16} up to {LSE_MAX_H} with 16-byte aligned "
                         f"rows, got H={H}, row stride {x.stride(0)}")
    if x.dtype == torch.bfloat16 and (w.shape[1] % per16 or w.stride(0)
                                      % per16 or w.data_ptr() % 16):
        raise ValueError(f"the bf16 lm_head_lse kernel streams w in 16-byte "
                         f"rows: V and w's row stride must be multiples of "
                         f"{per16}, got V={w.shape[1]}, row stride "
                         f"{w.stride(0)}")


def lm_head_lse(x, w):
    """Per-row log-sum-exp of x [N, H] @ w [H, V] -> [N] f32. CUDA
    tensors run K5 of their dtype (or raise), CPU tensors the plain
    version, meta tensors give the shape."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"lm_head_lse takes x [N, H] and w [H, V], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"lm_head_lse operands on {x.device} and "
                         f"{w.device}")
    N, H = x.shape
    V = w.shape[1]
    if x.device.type == "cpu":
        return lm_head_lse_plain(x, w)
    if x.device.type == "meta":
        return torch.empty((N,), dtype=torch.float32, device="meta")
    if x.device.type != "cuda":
        raise ValueError(f"lm_head_lse: unsupported device {x.device}")
    _check_kernel_operands(x, w)
    lse = torch.empty((N,), dtype=torch.float32, device=x.device)
    if N == 0 or V == 0:
        return lse
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        rc = _lse_lib(x.dtype)(x.data_ptr(), w.data_ptr(), lse.data_ptr(),
                               N, H, V, x.stride(0), w.stride(0), stream)
    else:
        # each vocab split's (max, denominator) per row, merged in order
        splits = lse_splits(N, V, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
        scratch = torch.empty((2, splits, N), dtype=torch.float32,
                              device=x.device)
        rc = _lse_lib(x.dtype)(x.data_ptr(), w.data_ptr(), lse.data_ptr(),
                               scratch.data_ptr(), N, H, V, x.stride(0),
                               w.stride(0), splits, stream)
    if rc != 0:
        raise RuntimeError(f"lm_head_lse ({x.dtype}) kernel launch failed: "
                           f"cudaError {rc} (N={N}, H={H}, V={V})")
    (lm_head_lse_bf16 if bf16 else lm_head_lse).launches += 1
    return lse


def lm_head_lse_bf16(x, w):
    """`lm_head_lse` for bf16 operands (TypeError for any other); its
    `launches` counts the bf16 K5's launches."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"lm_head_lse_bf16 takes bfloat16 x and w, got "
                        f"{x.dtype}")
    return lm_head_lse(x, w)


# kernel launches made through these wrappers (the main-path proof): the
# f32 K5 on lm_head_lse, the bf16 K5 on lm_head_lse_bf16
lm_head_lse.launches = 0
lm_head_lse_bf16.launches = 0


def _mm_f32(a, b):
    """a @ b with an f32 result, whatever the operands' float type: bf16
    operands on the card run cuBLAS's bf16 tensor-core product with f32
    output (the reference's preferred_element_type=f32); on the CPU, and
    for f32 operands, the operands are upcast (a bf16 x bf16 product is
    exact in f32)."""
    if a.dtype == torch.bfloat16 and a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def _xent_bwd(x, w, labels, lse, g, C):
    """d_logits = (softmax - onehot) * g, formed chunk-wise from
    recomputed chunk logits (the reference's `_xent_bwd`): dx
    accumulates over the chunks, each chunk writes its [H, Vc] slice of
    dw. The products take x's dtype and give f32; d is rounded to x's
    dtype before its two products, dx returns in x's dtype and dw in
    w's, as the reference's."""
    N, H = x.shape
    V = w.shape[1]
    Vc = -(-V // C)
    gf = g.float()
    dx = torch.zeros((N, H), dtype=torch.float32, device=x.device)
    dw = torch.empty((H, V), dtype=torch.float32, device=x.device)
    for c0 in range(0, V, Vc):
        wc = w[:, c0:c0 + Vc]
        p = torch.exp(_mm_f32(x, wc) - lse[:, None])
        # minus the one-hot of each label that falls in this chunk
        local = labels - c0
        hit = (local >= 0) & (local < wc.shape[1])
        p.scatter_add_(1, local.clamp(0, wc.shape[1] - 1)[:, None],
                       -hit.to(p.dtype)[:, None])
        d = (p * gf[:, None]).to(x.dtype)
        dx += _mm_f32(d, wc.t())
        dw[:, c0:c0 + Vc] = _mm_f32(x.t(), d)
    return dx.to(x.dtype), dw.to(w.dtype)


class _ChunkedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels, C):
        labels = labels.to(torch.int64)
        # the picked logit x[i] . w[:, lab_i]: one row-gather of w^T and a
        # rowwise dot instead of a per-chunk gather over the logits
        picked = (x.float() * w.t()[labels].float()).sum(dim=1)
        lse = lm_head_lse(x, w)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.C = C
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        dx, dw = _xent_bwd(x, w, labels, lse, g, ctx.C)
        return dx, dw, None, None


def chunked_lm_head_xent(x, w, labels, num_chunks):
    """loss[i] = logsumexp(x[i] @ w) - (x[i] @ w)[labels[i]].

    x [N, H] float, w [H, V] float, labels [N] int. Returns [N] f32,
    differentiable in x and w."""
    if x.device.type == "meta":
        return torch.empty((x.shape[0],), dtype=torch.float32,
                           device="meta")
    return _ChunkedXent.apply(x, w, labels, num_chunks)


@register_op("fused_lm_head_xent")
def _fused_lm_head_xent(ctx, ins, attrs):
    """X [.., H] hidden states, W [H, V] head weight, Label [.., 1] int
    -> Loss [.., 1] f32 per-position cross-entropy. `cache_logits` (the
    reference's option to keep the chunk logits for the backward) is
    not ported: the port always recomputes them, which is the
    reference's default ("auto")."""
    x = ins["X"][0]
    w = ins["W"][0]
    label = ins["Label"][0]
    if attrs.get("cache_logits", "auto") not in ("auto", False, 0):
        raise NotImplementedError("fused_lm_head_xent: cache_logits=True "
                                  "is not ported")
    lead = tuple(x.shape[:-1])
    N = int(np.prod(lead)) if lead else 1
    V = int(w.shape[1])
    C = int(attrs.get("num_chunks", 0)) or auto_chunks(V)
    loss = chunked_lm_head_xent(x.reshape(N, x.shape[-1]), w,
                                label.reshape(N), C)
    return {"Loss": [loss.reshape(lead + (1,))]}
