"""Quantized-op lowerings (the port of `paddle_tpu/ops/quant_ops.py`),
with K6, the int8 matmul, and the activation quantize that feeds it as
hand-written Hopper kernels.

The post-training quantizer (quant.py) rewrites eligible inference ops
(`mul` -> `quant_mul`, ...) so their weight input arrives as an int8
tensor plus a per-channel f32 scale (symmetric, zero-point 0). Each
lowering dequantizes AT THE OP BOUNDARY: everything upstream and
downstream sees the f32 values it saw before quantization.

The matmul planes (`quant_mul`, `quant_matmul`) run `int8_matmul`: the
activations are quantized per row on the fly (or with a calibrated
static scale), the int8 x int8 product accumulates exactly in int32,
and the accumulator is rescaled by (act_scale x weight_scale) — the
reference's f32 arithmetic, op for op. Which core computes it
(`resolve_int8_core`):

    tensor  int8_matmul flag   core
    CUDA    any value          the quantize kernel (`quantize_activations`)
                               then K6 with the rescale in its epilogue
                               (`int8_matmul_rescaled`), both in
                               csrc/int8_matmul.cu
    CPU     auto               dequant: x @ (wq * col) in f32, as the
                               reference computes off the TPU
    CPU     pallas or dot      the plain versions: quantize, the int8
                               core (`int8_matmul_plain`), `rescale`

On the card there is no dequant route, no library int8 GEMM and no
plain fallback: the kernels build and launch, or the call raises. K6
takes any M, K and N (ragged edges are masked, loads past them
zero-filled), so no shape is routed away, unlike the reference's `% 128`
gate. K6 reads the weight K-major: int8 weights live on the card
column-major (`quant.place_int8_weights`), and a row-major one is
transposed per call into a temporary, counted on the wrapper's
`repacks`. A K that is not a multiple of 16 (what TMA takes) is
zero-padded per call, counted on `k_pads`; zeros add nothing to an exact
integer sum.

`quant_lookup_table` gathers int8 rows and their per-row scales and
dequantizes only the gathered rows. `quant_transformer_stack`
dequantizes its four int8 planes one layer at a time inside the stack's
layer loop (K6 does not run on them, as the reference's dot path does
not). `quant_conv2d` and `quant_depthwise_conv2d` dequantize their
per-output-channel int8 filter and run the f32 conv (bf16 when the
activations are: the filter follows x), the reference's lowering; it is
not an int8 convolution. XLA folds an exported artifact's dequantize as
a constant; eager PyTorch pays it on every dispatch.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .launch_counts import count, counted
from .registry import register_op, torch_dtype

__all__ = ["KERNEL_ID", "META_ATTRS", "dequantize", "resolve_int8_core",
           "quantize_activations", "quantize_activations_plain", "rescale",
           "int8_matmul", "int8_matmul_i32", "int8_matmul_rescaled",
           "int8_matmul_plain", "is_column_major"]

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
    int8 x int8 -> int32 product, the rescale: the kernels on a CUDA
    tensor, their plain versions on a CPU tensor). Every tensor off the
    CPU takes "int8", whatever the flag says; on the CPU, auto (the
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


def _lib():
    from .._build import load_library
    lib = load_library("int8_matmul")
    if lib.pt_int8_matmul.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pt_int8_matmul.argtypes = [vp, ll, vp, ll, vp, vp, ll, vp, i, i,
                                       i, i, vp]
        lib.pt_int8_matmul.restype = ctypes.c_int
        lib.pt_quantize_rows.argtypes = [vp, ll, i, i, vp, vp, vp, vp]
        lib.pt_quantize_rows.restype = ctypes.c_int
    return lib


def is_column_major(w):
    """True when the 2-D w is stored column-major: its [N, K] transpose
    is contiguous (strides (1, K)), the layout K6 reads as it is."""
    return w.dim() == 2 and w.t().is_contiguous()


def _check_int8_operands(name, xq, wq):
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"{name} takes xq [M, K] and wq [K, N], got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    if xq.device != wq.device:
        raise ValueError(f"{name} operands on {xq.device} and {wq.device}")
    if xq.device.type not in ("cpu", "meta", "cuda"):
        raise ValueError(f"{name}: unsupported device {xq.device}")


def _k6_operands(wrapper, xq, wq):
    """(x, w^T, K) as K6 reads them: x [M, K] and w^T [N, K] int8 with
    16-byte aligned rows and K a multiple of 16. A column-major wq is
    read as it is; a row-major one is transposed into a temporary
    (counted on wrapper.repacks); any other layout raises. When K (or a
    pointer) is not what TMA takes, both operands are zero-padded along
    K (counted on wrapper.k_pads)."""
    name = wrapper.__name__
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"{name} kernel takes int8 xq and wq, got "
                        f"{xq.dtype} and {wq.dtype}")
    if not xq.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous row-major xq "
                         f"[M, K] (strides {xq.stride()})")
    if is_column_major(wq):
        wt = wq.t()
    elif wq.is_contiguous():
        wt = wq.t().contiguous()
        count(wrapper, "repacks")
    else:
        raise ValueError(f"{name} kernel takes wq [K, N] row-major or "
                         f"column-major, got strides {wq.stride()}")
    K = xq.shape[1]
    if (K % 16 or K == 0 or xq.data_ptr() % 16 or wt.data_ptr() % 16
            or _row_stride(wt) % 16):
        Kp = max(16, -(-K // 16) * 16)
        xq = torch.nn.functional.pad(xq, (0, Kp - K))
        wt = torch.nn.functional.pad(wt, (0, Kp - K))
        K = Kp
        count(wrapper, "k_pads")
    return xq, wt, K


def _row_stride(t):
    """The element stride between rows of a 2-D tensor (its width when
    it has one row, whose stride means nothing)."""
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def _k6_launch(wrapper, xq, wq, out, ax=None, col=None):
    """K6 into `out` [M, N] (int32, or f32 with ax and col)."""
    M, N = out.shape
    x, wt, K = _k6_operands(wrapper, xq, wq)
    f32 = out.dtype == torch.float32
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = _lib().pt_int8_matmul(
        x.data_ptr(), _row_stride(x), wt.data_ptr(), _row_stride(wt),
        out.data_ptr(), ax.data_ptr() if f32 else None,
        (0 if ax.numel() == 1 else 1) if f32 else 0,
        col.data_ptr() if f32 else None, M, K, N, int(f32), stream)
    if rc != 0:
        what = ("cuTensorMapEncodeTiled refused a TMA tensor map"
                if rc == -3 else f"code {rc}")
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: "
                           f"{what} (M={M}, K={K}, N={N})")
    count(wrapper, "launches")
    return out


def int8_matmul_i32(xq, wq):
    """xq [M, K] int8 @ wq [K, N] int8 -> exact int32 [M, N]. CUDA
    tensors run K6 with its int32 epilogue (or raise), CPU tensors the
    plain version, meta tensors give the shape."""
    _check_int8_operands("int8_matmul_i32", xq, wq)
    M, N = xq.shape[0], wq.shape[1]
    if xq.device.type == "cpu":
        return int8_matmul_plain(xq, wq)
    out = torch.empty((M, N), dtype=torch.int32, device=xq.device)
    if xq.device.type == "meta" or M == 0 or N == 0:
        return out
    return _k6_launch(int8_matmul_i32, xq, wq, out)


def _rescale_operands(name, ax, col, M, N):
    ax = ax.to(torch.float32).contiguous()
    col = col.to(torch.float32).contiguous()
    if ax.numel() not in (1, M) or col.numel() != N:
        raise ValueError(f"{name} takes ax of M={M} rows (or one static "
                         f"scale) and col of N={N} columns, got "
                         f"{tuple(ax.shape)} and {tuple(col.shape)}")
    return ax, col


def int8_matmul_rescaled(xq, wq, ax, col):
    """f32 [M, N] = f32(xq @ wq) * ax * col, in that order: ax [M, 1]
    (per row) or [1, 1] (a static scale), col the N per-column weight
    scales. CUDA tensors run K6 with the rescale in its epilogue (or
    raise), CPU tensors its plain version `rescale(int8_matmul_plain(xq,
    wq), ax, col)`, meta tensors give the shape."""
    name = "int8_matmul_rescaled"
    _check_int8_operands(name, xq, wq)
    M, N = xq.shape[0], wq.shape[1]
    if xq.device.type == "cpu":
        return rescale(int8_matmul_plain(xq, wq), ax,
                       col.to(torch.float32).reshape(1, -1))
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    if xq.device.type == "meta" or M == 0 or N == 0:
        return out
    ax, col = _rescale_operands(name, ax, col, M, N)
    return _k6_launch(int8_matmul_rescaled, xq, wq, out, ax, col)


# kernel launches made through these wrappers (the main-path proof), and
# the per-call operand fixes K6 needed: a row-major weight transposed, K
# zero-padded (both 0 on the serving path)
for _w in (int8_matmul_i32, int8_matmul_rescaled):
    counted(_w, "launches", "repacks", "k_pads")


# The reference writes the dynamic scale as `absmax / 127`; XLA's
# algebraic simplifier compiles a division by a constant into a
# multiplication by the constant's f32 reciprocal, so what its executor
# computes is absmax * fl32(1/127) (one ulp off the quotient for about
# 4 % of values).
_INV_127 = float(np.float32(1.0 / 127.0))


def quantize_activations_plain(xf, act_scale=None):
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


def quantize_activations(xf, act_scale=None):
    """`quantize_activations_plain`'s (xq, ax) of f32 activations xf
    [M, K]: CUDA tensors run the quantize kernel (one pass over each
    row, bitwise the plain version) or raise, CPU tensors the plain
    version, meta tensors give the shapes."""
    if xf.device.type == "cpu":
        return quantize_activations_plain(xf, act_scale)
    if xf.dim() != 2:
        raise ValueError(f"quantize_activations takes xf [M, K], got "
                         f"{tuple(xf.shape)}")
    M, K = xf.shape
    if xf.device.type not in ("cuda", "meta"):
        raise ValueError(f"quantize_activations: unsupported device "
                         f"{xf.device}")
    xq = torch.empty((M, K), dtype=torch.int8, device=xf.device)
    ax = torch.empty((1, 1) if act_scale is not None else (M, 1),
                     dtype=torch.float32, device=xf.device)
    if xf.device.type == "meta":
        return xq, ax
    if xf.dtype != torch.float32:
        raise TypeError(f"quantize_activations kernel takes float32 xf, "
                        f"got {xf.dtype}")
    if (K > 1 and xf.stride(1) != 1) or (M > 1 and xf.stride(0) < K):
        xf = xf.contiguous()
    static = (None if act_scale is None else
              act_scale.to(xf.device, torch.float32).reshape(1))
    stream = torch.cuda.current_stream(xf.device).cuda_stream
    rc = _lib().pt_quantize_rows(
        xf.data_ptr(), _row_stride(xf), M, K,
        static.data_ptr() if static is not None else None, xq.data_ptr(),
        ax.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"quantize_activations kernel launch failed: "
                           f"code {rc} (M={M}, K={K})")
    count(quantize_activations, "launches")
    return xq, ax


# kernel launches made through this wrapper (the main-path proof)
counted(quantize_activations, "launches")


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
    `resolve_int8_core`: on the card the quantize kernel, then K6 with
    the rescale in its epilogue; on the CPU the plain versions or the
    dequant route."""
    from .. import flags
    xf = x2.to(torch.float32)
    col = col_scale.to(torch.float32).reshape(1, -1)
    if resolve_int8_core(flags.get("int8_matmul"),
                         x2.device.type) == "dequant":
        return torch.matmul(xf, wq2.to(torch.float32) * col)
    xq, ax = quantize_activations(xf, act_scale)
    return int8_matmul_rescaled(xq, wq2, ax, col)


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


@register_op("quant_conv2d", differentiable=False)
def _quant_conv2d(ctx, ins, attrs):
    """conv2d over an int8 per-output-channel filter: dequantize at the
    boundary and reuse the f32 conv (the s2d stem rewrite included)."""
    from .nn_ops import _conv2d
    clean, f32_attrs = _strip_quant(ins, attrs, ("Filter",))
    x = ins["Input"][0]
    if x.dtype != torch.float32:
        # bf16 activations keep their dtype contract: filter follows x
        clean["Filter"] = [clean["Filter"][0].to(x.dtype)]
    return _conv2d(ctx, clean, f32_attrs)


@register_op("quant_depthwise_conv2d", differentiable=False)
def _quant_depthwise_conv2d(ctx, ins, attrs):
    attrs = dict(attrs)
    attrs["groups"] = int(ins["Input"][0].shape[1])
    return _quant_conv2d(ctx, ins, attrs)


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


@register_op("quant_transformer_stack", differentiable=False)
def _quant_transformer_stack(ctx, ins, attrs):
    """The transformer stack over int8 Wqkv / Wproj / Wup / Wdown planes
    with per-layer, per-output-channel scales ([L, 1, N]).

    The reference dequantizes the four planes at the op boundary and
    runs its scan. Here each layer's planes are dequantized inside the
    layer loop, just before the layer runs: dequantization is
    elementwise, so every value is the one the reference computes, but
    one layer's f32 planes are live at a time instead of all L layers'
    (at GPT-2-medium 302M f32 elements, 1.21 GB, in every captured
    bucket graph's pool)."""
    from .transformer_ops import _LEAVES, run_stack, stacked_layers
    scales = {s: ins[s + "Scale"][0] for s in ("Wqkv", "Wproj", "Wup",
                                               "Wdown")
              if s + "Scale" in ins}
    clean, f32_attrs = _strip_quant(ins, attrs, ())

    def layers():
        params = tuple(clean[name][0] for name in _LEAVES)
        for l, lp in enumerate(stacked_layers(params)):
            yield tuple(dequantize(w, scales[name][l], "float32")
                        if name in scales else w
                        for name, w in zip(_LEAVES, lp))

    out = run_stack(clean["X"][0], layers(), f32_attrs.get("num_heads", 1),
                    f32_attrs.get("causal", True))
    return {"Out": [out]}
