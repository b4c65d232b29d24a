"""Flash attention: K1 forward (LM server and training) and the K2-K4
backward (training), with their plain versions and launch counters.

`flash_attn_fwd(q, k, v, kv_len, q_start, causal, scale)` computes
attention over head-major `[B, n, T, D]` float32 operands with the mask

    col < kv_len[b]  and  (not causal or col <= q_start[b] + row)

and returns `(o [B, n, Tq, D], lse [B, n, Tq])`. It is the function of
`paddle_tpu/ops/pallas_attention.py::_kernel` (K1) with one extension,
the per-batch query offset `q_start`: cold prefill and training have
q_start = 0 (K1 exactly), decode has Tq = 1, q_start = pos, kv_len =
pos + 1, and a prefix-hit prefill has q_start = the first computed
position. A fully masked row gives o = 0 and lse = -1e30, as K1's
finalize does.

The backward is the route of the reference's `_flash_backward`: delta =
rowsum(dO * O) is computed outside the kernels, then either the
single-sweep K2 (`flash_attn_bwd_fused`: dk, dv and per-kv-tile dq
partials, summed after) or the split pair K3 (`flash_attn_bwd_dq`) and
K4 (`flash_attn_bwd_dkv`). The reference takes K2 when its kv block
count is <= 4; the port keeps the rule on its own 64-key tiles
(`bwd_route`), so Tk <= 256 takes K2 and the training length T = 1024
takes K3 + K4.

`flash_attention_plane` is the training op's entry: a
`torch.autograd.Function` over the packed `[B, T, n*D]` planes (viewed
head-major by strides, no copy) whose forward is K1 and whose backward
is the route above.

Operands are float32 or bfloat16 (amp training). bf16 runs the
reference's roundings: products take bf16 operands and accumulate in
f32; P (forward, and K4's P^T.dO) and dS (K3, K4) are rounded to bf16
before the next product; O and the gradients are rounded once at the
end; LSE and delta stay f32. K1 (Tq > 1), K2, K3 and K4 have bf16
kernels (`csrc/flash_attn_bf16.cu`) with their own launch counters
(`flash_attn_fwd_bf16`, `flash_attn_bwd_fused_bf16`,
`flash_attn_bwd_dq_bf16`, `flash_attn_bwd_dkv_bf16`). K2 keeps dq's
contributions of the kv tiles in f32 and casts their sum once: the f32
K2 writes f32 partials that `sum_dq_partials` sums in a fixed order
(each allocation counted on `flash_attn_bwd_fused.dq_partials`), the
bf16 K2 sums them on chip in a fixed order and writes dq once, in bf16,
allocating no partials. The decode step (Tq = 1) has no bf16 kernel yet
and raises for bf16 on the card.

Head dims: the kernels take D in `KERNEL_HEAD_DIMS` (the f32 forward),
`BF16_FWD_HEAD_DIMS` (the bf16 forward, whose wgmma tiles are 64 wide)
and `BWD_HEAD_DIMS` (backward); on the card a smaller D is zero-padded up
to the next of them, as the reference's `_pad_d` does (padded columns
add zero to q.k; O's and the gradients' padded columns are zero and
sliced off; the softmax scale is the original D's). D > 64 raises.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(`csrc/flash_attn_fwd.cu`, `csrc/flash_attn_bwd.cu`,
`csrc/flash_attn_bf16.cu`, built by nvcc on first use) or raises; it
never falls back. The plain PyTorch versions are the references the
kernels are held to, and the path for CPU tensors only; on `meta`
tensors (build-time shape inference) the wrappers compute shapes only.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["flash_attn_fwd", "flash_attn_fwd_plain", "flash_attn_bwd",
           "flash_attn_bwd_fused", "flash_attn_bwd_dq", "flash_attn_bwd_dkv",
           "flash_attn_bwd_dq_plain", "flash_attn_bwd_dkv_plain",
           "flash_attn_bwd_fused_plain", "flash_attention_plane",
           "flash_attn_fwd_bf16", "flash_attn_bwd_fused_bf16",
           "flash_attn_bwd_dq_bf16", "flash_attn_bwd_dkv_bf16",
           "sum_dq_partials", "flash_attn_fwd_padded",
           "flash_attn_bwd_padded", "kernel_head_dim", "bwd_route",
           "fwd_head_dims", "KERNEL_HEAD_DIMS", "BF16_FWD_HEAD_DIMS",
           "BWD_HEAD_DIMS", "BWD_TILE", "NEG"]

NEG = -1e30
KERNEL_HEAD_DIMS = (32, 64)
BF16_FWD_HEAD_DIMS = (64,)   # the bf16 forward's tiles are 64 x 64
BWD_HEAD_DIMS = (64,)   # the backward kernels' tiles are 64 x 64
BWD_TILE = 64           # q rows / keys per backward kernel tile
FUSED_MAX_TILES = 4     # the reference's nk <= 4 rule for the fused K2


def flash_attn_fwd_plain(q, k, v, kv_len, q_start, causal=True,
                         scale=None):
    """Masked f32 softmax over the full key axis — the arithmetic of
    `_cached_block` (transformer_ops.py) with K1's zeroing of fully
    masked rows; bf16 operands take K1's roundings (module docstring).
    Same signature and outputs as `flash_attn_fwd`."""
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
    if q.dtype == torch.float32:
        o = torch.matmul(p / den, v.float())
    else:   # K1's roundings: P to the operand type before P.V, / den after
        o = torch.matmul(p.to(q.dtype).float(), v.float()) / den
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


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check_kernel_operands(q, k, v, kv_len, q_start, dims=KERNEL_HEAD_DIMS):
    """What the CUDA kernels take (float32 or bfloat16 q/k/v of one
    dtype, 16-byte aligned rows, D in `dims`); raises on anything
    else."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _KERNEL_DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash-attention kernels take float32 or "
                            f"bfloat16 q/k/v of one dtype, got {name} "
                            f"{t.dtype} (q {q.dtype})")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along D "
                             f"(stride {t.stride(3)})")
        per16 = 16 // t.element_size()
        if any(s % per16 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} strides {t.stride()} / pointer must "
                             f"be 16-byte aligned rows (strides multiple "
                             f"of {per16} elements)")
    for name, t in (("kv_len", kv_len), ("q_start", q_start)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous int32 tensor, "
                            f"got {t.dtype}")
    D = q.shape[3]
    if D not in dims:
        raise ValueError(f"flash-attention kernels support head dims "
                         f"{dims}, got D={D}")


def kernel_head_dim(D, dims):
    """The head dim the kernels run D at: the smallest of `dims` that
    is >= D (the reference's `_pad_d` pads D the same way, to its own
    lane multiple). Raises for D above the largest."""
    for Dp in dims:
        if D <= Dp:
            return Dp
    raise ValueError(f"flash-attention kernels support head dims up to "
                     f"{dims[-1]} (a smaller D is zero-padded to one of "
                     f"{dims}), got D={D}")


def _pad_d(ts, Dp):
    """Zero-pad [..., D] tensors along D to Dp (a copy only when
    D != Dp)."""
    return [t if t.shape[-1] == Dp else
            torch.nn.functional.pad(t, (0, Dp - t.shape[-1])) for t in ts]


def fwd_head_dims(dtype):
    """The head dims the forward kernel of `dtype` takes."""
    return BF16_FWD_HEAD_DIMS if dtype == torch.bfloat16 else \
        KERNEL_HEAD_DIMS


def flash_attn_fwd_padded(fwd, q, k, v, kv_len, q_start, causal, scale):
    """`fwd` (a forward wrapper or its plain version) run at the kernel
    head dim of q's dtype: q, k, v zero-padded along D, O's padded
    columns sliced off. `scale` is the original D's; padded columns add
    zero to q.k, so S, P, the LSE and O's first D columns are
    unchanged."""
    D = q.shape[3]
    Dp = kernel_head_dim(D, fwd_head_dims(q.dtype))
    if Dp == D:
        return fwd(q, k, v, kv_len, q_start, causal, scale)
    o, lse = fwd(*_pad_d((q, k, v), Dp), kv_len, q_start, causal, scale)
    return o[..., :D], lse


def _lib(dtype):
    """The C entry of the forward kernel for `dtype`: the f32 K1
    (`flash_attn_fwd.cu`) or the bf16 K1 (`flash_attn_bf16.cu`); both
    take the same arguments."""
    from .._build import load_library
    if dtype == torch.bfloat16:
        fn = load_library("flash_attn_bf16").pt_flash_attn_fwd_bf16
    else:
        fn = load_library("flash_attn_fwd").pt_flash_attn_fwd_f32
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] * 7 + [i] * 5 + [ll] * 12
                       + [i, ctypes.c_float, vp])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, kv_len, q_start, causal, scale):
    """Allocate outputs and launch the kernel of q's dtype on the
    current stream, counting the launch on that kernel's wrapper. O is
    allocated in the packed [B, Tq, n, D] plane and returned as its
    [B, n, Tq, D] view, so the caller's merge of heads is free."""
    B, n, Tq, D = q.shape
    Tk = k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    if bf16 and Tq == 1:
        raise NotImplementedError(
            "flash_attn_fwd: the bf16 K1 takes Tq > 1; the bf16 decode "
            "step (Tq = 1) has no kernel yet")
    o_plane = torch.empty((B, Tq, n, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, n, Tq), dtype=torch.float32, device=q.device)
    o = o_plane.permute(0, 2, 1, 3)
    if B == 0 or n == 0 or Tq == 0:
        return o, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       kv_len.data_ptr(), q_start.data_ptr(), o.data_ptr(),
                       lse.data_ptr(), B, n, Tq, Tk, D,
                       *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       *o.stride()[:3], int(bool(causal)), float(scale),
                       stream)
    if rc != 0:
        what = ("cuTensorMapEncodeTiled refused a TMA tensor map"
                if rc == -3 else
                f"{'unsupported shape ' if rc < 0 else ''}cudaError {rc}")
        raise RuntimeError(f"flash_attn_fwd ({q.dtype}) kernel launch "
                           f"failed: {what} (B={B}, n={n}, Tq={Tq}, "
                           f"Tk={Tk}, D={D})")
    (flash_attn_fwd_bf16 if bf16 else flash_attn_fwd).launches += 1
    return o, lse


def _checked_launch(q, k, v, kv_len, q_start, causal, scale):
    _check_kernel_operands(q, k, v, kv_len, q_start, fwd_head_dims(q.dtype))
    return _launch(q, k, v, kv_len, q_start, causal, scale)


def flash_attn_fwd(q, k, v, kv_len, q_start, causal=True, scale=None):
    """Attention forward with per-batch kv_len and query offset; see the
    module docstring. CUDA tensors run the Hopper kernel of their dtype
    (or raise), CPU tensors run `flash_attn_fwd_plain`."""
    _check(q, k, v, kv_len, q_start)
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[3]))
    if q.device.type == "cpu":
        return flash_attn_fwd_plain(q, k, v, kv_len, q_start, causal,
                                    scale)
    if q.device.type == "meta":    # build-time shape inference
        B, n, Tq, _ = q.shape
        return (torch.empty(q.shape, dtype=q.dtype, device="meta"),
                torch.empty((B, n, Tq), dtype=torch.float32, device="meta"))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_fwd: unsupported device {q.device}")
    return flash_attn_fwd_padded(_checked_launch, q, k, v, kv_len, q_start,
                                 causal, scale)


def _bf16_only(wrapper, name):
    """The bf16 face of a dtype-dispatching wrapper: the same function
    for bf16 operands, a TypeError for any other; its `launches` counts
    the bf16 kernel's launches."""

    def bf16_wrapper(q, *args, **kwargs):
        if q.dtype != torch.bfloat16:
            raise TypeError(f"{name} takes bfloat16 operands, got "
                            f"{q.dtype}")
        return wrapper(q, *args, **kwargs)

    bf16_wrapper.launches = 0
    bf16_wrapper.__name__ = name
    return bf16_wrapper


# kernel launches made through this wrapper (the main-path proof): the
# f32 K1 here, the bf16 K1 on flash_attn_fwd_bf16
flash_attn_fwd.launches = 0
flash_attn_fwd_bf16 = _bf16_only(flash_attn_fwd, "flash_attn_fwd_bf16")


# -- backward: K2 (fused), K3 (dq), K4 (dk, dv) ------------------------------

def _bwd_probs(q, k, lse, kv_len, causal, scale):
    """p = exp(scale * q.k - lse) under K1's mask (q_start = 0), zero on
    rows whose lse is the fully-masked sentinel: the reference's
    rebuild of the forward's probabilities."""
    Tq, Tk = q.shape[2], k.shape[2]
    dev = q.device
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    col = torch.arange(Tk, device=dev)
    live = col[None, None, None, :] < kv_len.to(dev, torch.int64).clamp(
        max=Tk)[:, None, None, None]
    if causal:
        row = torch.arange(Tq, device=dev)
        live = live & (col[None, :] <= row[:, None])[None, None]
    live = live & (lse > NEG * 0.5)[..., None]
    return torch.where(live, torch.exp(s - lse[..., None]),
                       torch.zeros((), device=dev))


def flash_attn_bwd_fused_plain(q, k, v, do, lse, delta, kv_len,
                               causal=True, scale=None):
    """K2's function on full matrices, from one rebuild of p: ds = p *
    (dO.V^T - delta), dq = scale * ds.K, dk = scale * ds^T.Q, dv =
    p^T.dO. For bf16 operands p and ds are rounded to bf16 before the
    products they feed (dv, and dq / dk), as the reference kernels
    round them; for f32 the rounding is the identity."""
    scale = _scale_of(q, scale)
    p = _bwd_probs(q, k, lse, kv_len, causal, scale)
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2))
              - delta[..., None])
    ds, pr = (t.to(q.dtype).float() for t in (ds, p))
    dq = scale * torch.matmul(ds, k.float())
    dk = scale * torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(pr.transpose(-1, -2), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attn_bwd_dq_plain(*args, **kwargs):
    """K3's function: the dq of `flash_attn_bwd_fused_plain`."""
    return flash_attn_bwd_fused_plain(*args, **kwargs)[0]


def flash_attn_bwd_dkv_plain(*args, **kwargs):
    """K4's function: the (dk, dv) of `flash_attn_bwd_fused_plain`."""
    return flash_attn_bwd_fused_plain(*args, **kwargs)[1:]


def _scale_of(q, scale):
    return 1.0 / float(np.sqrt(q.shape[3])) if scale is None else scale


def bwd_route(Tk):
    """The reference's route rule on the port's own kv tiles: the fused
    single-sweep K2 when the kv tile count is <= 4 (Tk <= 256), the
    split K3 + K4 beyond."""
    nk = -(-Tk // BWD_TILE)
    return "fused" if nk <= FUSED_MAX_TILES else "split"


def _check_bwd(q, k, v, do, lse, delta, kv_len):
    _check(q, k, v, kv_len, kv_len)
    B, n, Tq, D = q.shape
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, n, Tq):
            raise ValueError(f"{name} must be [B, n, Tq]={(B, n, Tq)}, "
                             f"got {tuple(t.shape)}")
    if len({t.device for t in (q, do, lse, delta)}) != 1:
        raise ValueError("flash-attention backward operands on several "
                         "devices")


def _check_bwd_kernel(q, k, v, do, lse, delta, kv_len):
    _check_kernel_operands(q, k, v, kv_len, kv_len, BWD_HEAD_DIMS)
    _check_kernel_operands(do, k, v, kv_len, kv_len, BWD_HEAD_DIMS)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous float32 tensor")


def flash_attn_bwd_padded(bwd, q, k, v, do, lse, delta, kv_len, causal,
                          scale):
    """`bwd` (a backward wrapper or its plain version) run at the
    kernels' head dim: q, k, v, dO zero-padded along D, the gradients'
    padded columns (zero) sliced off. `scale` is the original D's, and
    delta = rowsum(dO * O) is the same with or without the zero
    columns."""
    D = q.shape[3]
    Dp = kernel_head_dim(D, BWD_HEAD_DIMS)
    if Dp == D:
        return bwd(q, k, v, do, lse, delta, kv_len, causal, scale)
    out = bwd(*_pad_d((q, k, v, do), Dp), lse, delta, kv_len, causal,
              scale)
    if isinstance(out, torch.Tensor):
        return out[..., :D]
    return tuple(g[..., :D] for g in out)


def _bwd_lib(dtype):
    """The C entry of the backward kernels for `dtype`: K2-K4 in f32
    (`flash_attn_bwd.cu`) or in bf16 (`flash_attn_bf16.cu`); both take
    the same arguments."""
    from .._build import load_library
    if dtype == torch.bfloat16:
        fn = load_library("flash_attn_bf16").pt_flash_attn_bwd_bf16
    else:
        fn = load_library("flash_attn_bwd").pt_flash_attn_bwd_f32
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([i] + [vp] * 10 + [i] * 5
                       + [ctypes.POINTER(ctypes.c_longlong), i,
                          ctypes.c_float, vp])
        fn.restype = ctypes.c_int
    return fn


_WHICH = {"fused": 0, "dq": 1, "dkv": 2}


def _plane_grad(B, n, T, D, dev, dtype):
    """A [B, n, T, D] gradient allocated in the packed [B, T, n, D]
    plane, so the caller's merge of heads is a free view."""
    return torch.empty((B, T, n, D), dtype=dtype,
                       device=dev).permute(0, 2, 1, 3)


def _bwd_launch(which, q, k, v, do, lse, delta, kv_len, dq, dk, dv,
                causal, scale, tile_stride=0):
    B, n, Tq, D = q.shape
    Tk = k.shape[2]
    none = (0, 0, 0)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *do.stride()[:3],
               *(dq.stride()[-4:-1] if dq is not None else none),
               *(dk.stride()[:3] if dk is not None else none),
               *(dv.stride()[:3] if dv is not None else none), tile_stride]
    arr = (ctypes.c_longlong * len(strides))(*strides)
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _bwd_lib(q.dtype)(_WHICH[which], q.data_ptr(), k.data_ptr(),
                           v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                           delta.data_ptr(), kv_len.data_ptr(), ptr(dq),
                           ptr(dk), ptr(dv), B, n, Tq, Tk, D, arr,
                           int(bool(causal)), float(scale), stream)
    if rc != 0:
        what = {-1: "unsupported shape (D 64; the bf16 K2: Tk <= 1024)",
                -3: "cuTensorMapEncodeTiled refused a TMA tensor map"}.get(
                    rc, f"cudaError {rc}")
        raise RuntimeError(f"flash-attention backward ({which}, "
                           f"{q.dtype}) kernel launch failed: {what} "
                           f"(B={B}, n={n}, Tq={Tq}, Tk={Tk}, D={D})")


def sum_dq_partials(part, dtype):
    """K2's dq from its f32 per-kv-tile partials `part` [nk, B, Tq, n,
    D]: summed over the kv tiles in the fixed order j = 0, 1, ..., nk - 1
    (so the result is deterministic), then cast once to the operands'
    dtype, as the reference's `jnp.sum(dq_part, 0).astype(q.dtype)`
    does; returned as the [B, n, Tq, D] view of a [B, Tq, n, D] plane."""
    dq = part[0]
    for j in range(1, part.shape[0]):
        dq = dq + part[j]
    return dq.to(dtype).permute(0, 2, 1, 3)


def _bwd_wrapper(which, plain):
    """The wrapper of one backward kernel: validates, routes CPU tensors
    to the plain version and meta tensors to shapes, launches the kernel
    of the operands' dtype on CUDA tensors (or raises; a D below the
    kernels' is zero-padded) and counts the launch on that kernel's
    wrapper."""

    def launch(q, k, v, do, lse, delta, kv_len, causal, scale):
        _check_bwd_kernel(q, k, v, do, lse, delta, kv_len)
        bf16 = q.dtype == torch.bfloat16
        counter = _BF16_TWINS[which] if bf16 else wrapper
        B, n, Tq, D = q.shape
        Tk = k.shape[2]
        dev = q.device
        if which == "dq":
            dq = _plane_grad(B, n, Tq, D, dev, q.dtype)
            if B and n and Tq:
                _bwd_launch("dq", q, k, v, do, lse, delta, kv_len, dq,
                            None, None, causal, scale)
                counter.launches += 1
            return dq
        dk = _plane_grad(B, n, Tk, D, dev, k.dtype)
        dv = _plane_grad(B, n, Tk, D, dev, v.dtype)
        if which == "dkv":
            if B and n and Tk:
                _bwd_launch("dkv", q, k, v, do, lse, delta, kv_len, None,
                            dk, dv, causal, scale)
                counter.launches += 1
            return dk, dv
        if bf16:
            # the bf16 K2 sums dq over its kv tiles on chip, in f32 in a
            # fixed order, and writes it once in bf16
            dq = _plane_grad(B, n, Tq, D, dev, q.dtype)
            if B and n and Tk:
                _bwd_launch("fused", q, k, v, do, lse, delta, kv_len, dq,
                            dk, dv, causal, scale)
                counter.launches += 1
            return dq, dk, dv
        nk = -(-Tk // BWD_TILE)
        # the f32 K2's per-kv-tile dq partials [nk, B, Tq, n, D], summed
        # below in a fixed order (the reference's way), so the result is
        # deterministic
        part = torch.empty((nk, B, Tq, n, D), dtype=torch.float32,
                           device=dev)
        wrapper.dq_partials += 1
        part_h = part.permute(0, 1, 3, 2, 4)          # [nk, B, n, Tq, D]
        if B and n and Tk:
            _bwd_launch("fused", q, k, v, do, lse, delta, kv_len, part_h,
                        dk, dv, causal, scale, tile_stride=part.stride(0))
            counter.launches += 1
        return sum_dq_partials(part, q.dtype), dk, dv

    def wrapper(q, k, v, do, lse, delta, kv_len, causal=True, scale=None):
        _check_bwd(q, k, v, do, lse, delta, kv_len)
        scale = _scale_of(q, scale)
        if q.device.type == "cpu":
            return plain(q, k, v, do, lse, delta, kv_len, causal, scale)
        if q.device.type == "meta":
            like = {"dq": (q,), "dkv": (k, v), "fused": (q, k, v)}[which]
            outs = tuple(torch.empty(t.shape, dtype=t.dtype, device="meta")
                         for t in like)
            return outs[0] if which == "dq" else outs
        if q.device.type != "cuda":
            raise ValueError(f"flash-attention backward: unsupported "
                             f"device {q.device}")
        return flash_attn_bwd_padded(launch, q, k, v, do, lse, delta,
                                     kv_len, causal, scale)

    wrapper.launches = 0        # kernel launches (the main-path proof)
    # f32 dq partial buffers allocated on the card (the fused f32 K2's;
    # the bf16 K2 allocates none)
    wrapper.dq_partials = 0
    wrapper.__name__ = f"flash_attn_bwd_{which}"
    return wrapper


flash_attn_bwd_fused = _bwd_wrapper("fused", flash_attn_bwd_fused_plain)
flash_attn_bwd_dq = _bwd_wrapper("dq", flash_attn_bwd_dq_plain)
flash_attn_bwd_dkv = _bwd_wrapper("dkv", flash_attn_bwd_dkv_plain)
# the bf16 K2, K3 and K4: the same wrappers for bf16 operands, each
# counting its own kernel's launches
flash_attn_bwd_fused_bf16 = _bf16_only(flash_attn_bwd_fused,
                                       "flash_attn_bwd_fused_bf16")
flash_attn_bwd_dq_bf16 = _bf16_only(flash_attn_bwd_dq,
                                    "flash_attn_bwd_dq_bf16")
flash_attn_bwd_dkv_bf16 = _bf16_only(flash_attn_bwd_dkv,
                                     "flash_attn_bwd_dkv_bf16")
_BF16_TWINS = {"fused": flash_attn_bwd_fused_bf16,
               "dq": flash_attn_bwd_dq_bf16, "dkv": flash_attn_bwd_dkv_bf16}


def flash_attn_bwd(q, k, v, o, lse, do, kv_len, causal=True, scale=None):
    """Gradients (dq, dk, dv) of `flash_attn_fwd` (q_start = 0) from its
    saved o and lse: delta = rowsum(dO * O) outside the kernels, then
    the fused K2 or the split K3 + K4, as `bwd_route(Tk)` picks."""
    delta = (do.float() * o.float()).sum(-1).contiguous()   # [B, n, Tq]
    if bwd_route(k.shape[2]) == "fused":
        return flash_attn_bwd_fused(q, k, v, do, lse, delta, kv_len,
                                    causal, scale)
    dq = flash_attn_bwd_dq(q, k, v, do, lse, delta, kv_len, causal, scale)
    dk, dv = flash_attn_bwd_dkv(q, k, v, do, lse, delta, kv_len, causal,
                                scale)
    return dq, dk, dv


# -- the training op's entry: an autograd Function over packed planes -------

def _heads(x, n):
    """[B, T, n*D] plane -> its [B, n, T, D] head view (strides only)."""
    B, T, nD = x.shape
    return x.view(B, T, n, nD // n).permute(0, 2, 1, 3)


def _merge(x):
    """[B, n, T, D] -> the [B, T, n*D] plane (a view when x lies in a
    plane, as every kernel output does)."""
    B, n, T, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, T, n * D)


class _FlashPlane(torch.autograd.Function):
    """K1 forward (saves O and LSE) and the K2 / K3 + K4 backward over
    [B, T, n*D] planes."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, n, causal, scale):
        B = q.shape[0]
        starts = torch.zeros(B, dtype=torch.int32, device=q.device)
        o, lse = flash_attn_fwd(_heads(q, n), _heads(k, n), _heads(v, n),
                                kv_len, starts, causal, scale)
        out = _merge(o)
        ctx.save_for_backward(q, k, v, out, lse, kv_len)
        ctx.n, ctx.causal, ctx.scale = n, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kv_len = ctx.saved_tensors
        n = ctx.n
        dq, dk, dv = flash_attn_bwd(
            _heads(q, n), _heads(k, n), _heads(v, n), _heads(out, n), lse,
            _heads(dout, n), kv_len, ctx.causal, ctx.scale)
        return _merge(dq), _merge(dk), _merge(dv), None, None, None, None


def flash_attention_plane(q, k, v, num_heads, causal=False, scale=None,
                          kv_len=None):
    """Attention over packed planes: q [B, Tq, n*D], k/v [B, Tk, n*D]
    (head h owns columns h*D:(h+1)*D) -> [B, Tq, n*D], differentiable in
    q, k and v. kv_len [B] (optional) masks keys >= kv_len[b]."""
    B, Tq, nD = q.shape
    Tk = k.shape[1]
    if nD % num_heads:
        raise ValueError(f"flash_attention_plane: plane width {nD} is not "
                         f"divisible by num_heads={num_heads}")
    if scale is None:
        scale = 1.0 / float(np.sqrt(nD // num_heads))
    if q.device.type == "meta":
        return torch.empty((B, Tq, nD), dtype=q.dtype, device="meta")
    if kv_len is None:
        kv_len = torch.full((B,), Tk, dtype=torch.int32, device=q.device)
    else:
        kv_len = kv_len.to(q.device, torch.int32).contiguous()
    return _FlashPlane.apply(q, k, v, kv_len, num_heads, bool(causal),
                             float(scale))
