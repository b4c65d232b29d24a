"""Quantized-op lowerings (the port of `paddle_tpu/ops/quant_ops.py`),
with K6, the int8 x int8 -> int32 matmul, as a hand-written Hopper
kernel.

The post-training quantizer (quant.py) rewrites eligible inference ops
(`mul` -> `quant_mul`, ...) so their weight input arrives as an int8
tensor plus a per-channel f32 scale (symmetric, zero-point 0). Each
lowering dequantizes AT THE OP BOUNDARY: everything upstream and
downstream sees the f32 values it saw before quantization.

The matmul planes (`quant_mul`, `quant_matmul`) run `int8_matmul`: the
activations are quantized per row on the fly (or with a calibrated
static scale), the int8 x int8 product accumulates exactly in int32,
and the accumulator is rescaled by (act_scale x weight_scale) — the
reference's f32 arithmetic, op for op. Which core computes the int32
product (`resolve_int8_core`):

    tensor  int8_matmul flag   core
    CUDA    any value          K6 (`int8_matmul_i32`, csrc/int8_matmul.cu)
    CPU     auto               dequant: x @ (wq * col) in f32, as the
                               reference computes off the TPU
    CPU     pallas or dot      the plain int8 core (`int8_matmul_plain`)

On the card there is no dequant route, no library int8 GEMM and no
plain fallback: K6 builds and launches, or the call raises. K6 takes
any M, K and N (ragged edges are bounds-checked and zero-filled), so no
shape is routed away, unlike the reference's `% 128` gate.

`quant_lookup_table` gathers int8 rows and their per-row scales and
dequantizes only the gathered rows. `quant_conv2d`,
`quant_depthwise_conv2d` and `quant_transformer_stack` wrap ops the
port does not have yet (conv2d, transformer_stack) and are not ported.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .registry import register_op, torch_dtype

__all__ = ["KERNEL_ID", "META_ATTRS", "dequantize", "resolve_int8_core",
           "quantize_activations", "rescale", "int8_matmul",
           "int8_matmul_i32", "int8_matmul_plain"]

# the one quantization scheme this runtime executes; recorded into op
# attrs so a FUTURE scheme degrades to the per-op dequant fallback
# (quant.ensure_loadable) instead of wrong math
KERNEL_ID = "int8.sym.perchannel/1"


def dequantize(wq, scale, dtype=None):
    """int8 weights x broadcastable per-channel scale -> float tensor.
    THE dequant definition: the lowerings and the load-time fallback
    (quant.ensure_loadable) both use it."""
    w = wq.to(scale.dtype) * scale
    return w.to(torch_dtype(dtype)) if dtype is not None else w


def resolve_int8_core(mode, device_type):
    """The int8-matmul core election: "dequant" (f32 matmul against the
    dequantized weight) or "int8" (quantized activations, an exact
    int8 x int8 -> int32 product through `int8_matmul_i32`: K6 on a CUDA
    tensor, its plain version on a CPU tensor). Every tensor off the CPU
    takes "int8", whatever the flag says; on the CPU, auto (the
    default) takes "dequant", pallas and dot take "int8"."""
    if device_type != "cpu":
        return "int8"
    return "dequant" if mode == "auto" else "int8"


def int8_matmul_plain(xq, wq):
    """xq [M, K] int8 @ wq [K, N] int8 -> int32 [M, N]: a float64 matmul
    of the int8 operands, exact (|sum| <= 127 * 127 * K, far below
    2^53), cast to int32."""
    return torch.matmul(xq.to(torch.float64),
                        wq.to(torch.float64)).to(torch.int32)


def _int8_lib():
    from .._build import load_library
    fn = load_library("int8_matmul").pt_int8_matmul_s8s8s32
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def int8_matmul_i32(xq, wq):
    """xq [M, K] int8 @ wq [K, N] int8 -> exact int32 [M, N]. CUDA
    tensors run K6 (or raise), CPU tensors the plain version, meta
    tensors give the shape."""
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"int8_matmul_i32 takes xq [M, K] and wq [K, N], "
                         f"got {tuple(xq.shape)} and {tuple(wq.shape)}")
    if xq.device != wq.device:
        raise ValueError(f"int8_matmul_i32 operands on {xq.device} and "
                         f"{wq.device}")
    M, K = xq.shape
    N = wq.shape[1]
    if xq.device.type == "cpu":
        return int8_matmul_plain(xq, wq)
    if xq.device.type == "meta":
        return torch.empty((M, N), dtype=torch.int32, device="meta")
    if xq.device.type != "cuda":
        raise ValueError(f"int8_matmul_i32: unsupported device {xq.device}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_matmul_i32 kernel takes int8 xq and wq, got "
                        f"{xq.dtype} and {wq.dtype}")
    if not (xq.is_contiguous() and wq.is_contiguous()):
        raise ValueError("int8_matmul_i32 kernel takes contiguous row-major "
                         "xq [M, K] and wq [K, N]")
    out = torch.empty((M, N), dtype=torch.int32, device=xq.device)
    if M == 0 or N == 0:
        return out
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    rc = _int8_lib()(xq.data_ptr(), wq.data_ptr(), out.data_ptr(), M, K, N,
                     stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: code {rc} "
                           f"(M={M}, K={K}, N={N})")
    int8_matmul_i32.launches += 1
    return out


# kernel launches made through this wrapper (the main-path proof)
int8_matmul_i32.launches = 0


# The reference writes the dynamic scale as `absmax / 127`; XLA's
# algebraic simplifier compiles a division by a constant into a
# multiplication by the constant's f32 reciprocal, so what its executor
# computes is absmax * fl32(1/127) (one ulp off the quotient for about
# 4 % of values).
_INV_127 = float(np.float32(1.0 / 127.0))


def quantize_activations(xf, act_scale=None):
    """(xq int8 [M, K], ax f32 [M, 1] or [1, 1]) of f32 activations
    xf [M, K]: the reference's arithmetic op for op as its executor runs
    it, so xq is bitwise the reference's for equal xf. Dynamic
    (act_scale None): per-row absmax times the f32 reciprocal of 127
    (see _INV_127), clamped below at finfo(f32).tiny; static: the
    calibrated scalar, clamped likewise. Then round (half to even in
    torch.round and jnp.round), clip to +-127, cast. Each product and
    quotient is tensor by tensor, in f32."""
    tiny = torch.finfo(torch.float32).tiny
    if act_scale is None:
        amax = xf.abs().amax(dim=-1, keepdim=True)
        ax = torch.clamp_min(amax * torch.full_like(amax, _INV_127), tiny)
    else:
        ax = torch.clamp_min(act_scale.to(torch.float32).reshape(1, 1), tiny)
    xq = torch.clamp(torch.round(xf / ax), -127.0, 127.0).to(torch.int8)
    return xq, ax


def rescale(acc, ax, col):
    """f32 [M, N] of the int32 accumulator: the reference's
    `acc * ax * col`, in that order."""
    return acc.to(torch.float32) * ax * col


def int8_matmul(x2, wq2, col_scale, act_scale=None):
    """The quantized matmul core: f32 [M, N] ~= x @ dequant(w).

    x2 [M, K] float activations; wq2 [K, N] int8 weights; col_scale
    [N]-broadcastable f32 per-output-channel weight scales; act_scale
    None = dynamic per-row absmax quantization of x, else a calibrated
    scalar (values beyond it saturate at +-127). The core follows
    `resolve_int8_core`; then `rescale`."""
    from .. import flags
    xf = x2.to(torch.float32)
    col = col_scale.to(torch.float32).reshape(1, -1)
    if resolve_int8_core(flags.get("int8_matmul"),
                         x2.device.type) == "dequant":
        return torch.matmul(xf, wq2.to(torch.float32) * col)
    xq, ax = quantize_activations(xf, act_scale)
    return rescale(int8_matmul_i32(xq, wq2), ax, col)


def _weight_and_scale(ins, slot):
    return ins[slot][0], ins[slot + "Scale"][0]


def _act_scale(ins):
    vals = ins.get("ActScale")
    return vals[0] if vals else None


@register_op("quant_mul", differentiable=False)
def _quant_mul(ctx, ins, attrs):
    """`mul` over an int8 per-channel weight: flatten exactly like the
    f32 op, run the int8 core, restore leading dims and dtype."""
    x = ins["X"][0]
    wq, ws = _weight_and_scale(ins, "Y")
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    x2 = x.reshape(math.prod(x.shape[:xnc]), -1)
    wq2 = wq.reshape(math.prod(wq.shape[:ync]), -1)
    out = int8_matmul(x2, wq2, ws.reshape(-1), act_scale=_act_scale(ins))
    out = out.to(x.dtype)
    out_shape = tuple(x.shape[:xnc]) + tuple(wq.shape[ync:])
    return {"Out": [out.reshape(out_shape)]}


@register_op("quant_matmul", differentiable=False)
def _quant_matmul(ctx, ins, attrs):
    """2-D `matmul` (no transpose_Y: the quantizer only elects that
    layout) over an int8 per-channel weight."""
    x = ins["X"][0]
    wq, ws = _weight_and_scale(ins, "Y")
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1])
    out = int8_matmul(x2, wq, ws.reshape(-1), act_scale=_act_scale(ins))
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out.to(x.dtype).reshape(lead + (wq.shape[-1],))]}


# op attrs the quantizer stamps (and the fallback path strips): they
# carry bookkeeping, not op semantics
META_ATTRS = ("quant_kernel", "quant_original_type", "quant_weights",
              "quant_w_dtype")


def _strip_quant(ins, attrs, weight_slots):
    """(f32_ins, f32_attrs) with every quantized weight dequantized and
    the quant bookkeeping removed — handed to the ORIGINAL lowering so
    the math stays the one implementation."""
    clean = {k: v for k, v in ins.items()
             if k != "ActScale" and not k.endswith("Scale")}
    for slot in weight_slots:
        wq, ws = _weight_and_scale(ins, slot)
        clean[slot] = [dequantize(wq, ws, "float32")]
    f32_attrs = {k: v for k, v in attrs.items() if k not in META_ATTRS}
    return clean, f32_attrs


@register_op("quant_lookup_table", differentiable=False)
def _quant_lookup_table(ctx, ins, attrs):
    """Embedding gather over an int8 per-ROW table: gather int8 rows and
    their scales, dequantize only the gathered rows."""
    wq, ws = _weight_and_scale(ins, "W")
    ids = ins["Ids"][0]
    if ids.dim() and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    dtype = torch_dtype(attrs.get("quant_w_dtype", "float32"))
    rows = wq[ids].to(torch.float32)
    scales = ws.reshape(-1)[ids][..., None]
    out = (rows * scales).to(dtype)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return {"Out": [out]}
