"""Vision ops of the port: every op of `paddle_tpu/ops/vision_ops.py`.

  * 3-D convolutions are `F.conv3d` / `F.conv_transpose3d` (cuDNN on the
    card, as conv2d in ops/nn_ops.py); `dynamic_conv2d`'s per-sample
    filters are one grouped `F.conv2d` with a group a sample.
  * `pool3d` and `spp` pool as ops/nn_ops.py's pool2d: max over a
    -inf padded input, whose gradient goes to a window's first maximum
    (ROADMAP C10), avg as a window sum over the count.
  * `max_pool{2,3}d_with_index` take the reference's formula: a window
    axis (the padded input unfolded), `torch.amax` over it, whose
    gradient splits equally among tied maxima as `jnp.max`'s does
    (C13's rule, not C10's: `F.max_pool2d(return_indices=True)` is not
    this op), and `Mask` the first maximum in window order as a flat
    index into the channel's map (ROADMAP C33).
  * `unpool` is a scatter-add divided by the hit count, `bilinear_interp`
    samples with corner-aligned ratios ((in - 1) / (out - 1)).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .nn_ops import _pad_arg, _tup, pool_nd
from .registry import register_op

# the most bytes a chunk of ROIs gathers at once (its windows' values)
_CHUNK_BYTES = 1 << 28


def _roi_windows(rois, scale, PH, PW, H, W):
    """Each ROI's bins as row / column ranges (roi_pool_op.cc): the
    corners rounded half to even after `spatial_scale`, the ROI at least
    1 x 1, bin ph spanning rows [floor(ph * rh / PH), ceil((ph + 1) * rh
    / PH)) from y1, clipped to the map. Returns (hstart, hend) [N, PH]
    and (wstart, wend) [N, PW], int64."""
    corners = torch.round(rois * scale).to(torch.int32).to(torch.int64)
    x1, y1, x2, y2 = (corners[:, i] for i in range(4))
    rh = torch.clamp_min(y2 - y1 + 1, 1)[:, None]
    rw = torch.clamp_min(x2 - x1 + 1, 1)[:, None]
    ph = torch.arange(PH, device=rois.device)[None, :]
    pw = torch.arange(PW, device=rois.device)[None, :]

    def fdiv(a, b):
        return torch.div(a, b, rounding_mode="floor")

    hstart = torch.clamp(fdiv(ph * rh, PH) + y1[:, None], 0, H)
    hend = torch.clamp(-fdiv(-((ph + 1) * rh), PH) + y1[:, None], 0, H)
    wstart = torch.clamp(fdiv(pw * rw, PW) + x1[:, None], 0, W)
    wend = torch.clamp(-fdiv(-((pw + 1) * rw), PW) + x1[:, None], 0, W)
    return hstart, hend, wstart, wend


class _Windows:
    """The bins of a batch of ROIs as fixed-size KH x KW windows (KH, KW
    the largest bin's height and width), gathered a chunk of ROIs at a
    time from the map laid out [B * H * W, C]."""

    def __init__(self, x, rois, batch_id, scale, PH, PW):
        B, C, H, W = x.shape
        self.shape = (B, C, H, W)
        self.PH, self.PW = PH, PW
        self.hs, self.he, self.ws, self.we = _roi_windows(
            rois, scale, PH, PW, H, W)
        # one read on the host a call: the window size
        kh, kw = (torch.stack([(self.he - self.hs).max(),
                               (self.we - self.ws).max()]).tolist()
                  if len(rois) else (1, 1))
        self.KH, self.KW = max(int(kh), 1), max(int(kw), 1)
        self.batch_id = batch_id
        per_roi = PH * PW * self.KH * self.KW * C * 4        # f32 values
        self.chunk = max(1, _CHUNK_BYTES // max(per_roi, 1))

    def chunk_index(self, lo, hi):
        """(row index into [B * H * W], flat h * W + w index, valid
        mask) of the windows of ROIs lo:hi, [n, PH, PW, KH * KW] each, in
        window order, which is the map's flat order."""
        B, C, H, W = self.shape
        dev = self.hs.device
        kh = torch.arange(self.KH, device=dev)
        kw = torch.arange(self.KW, device=dev)
        h = self.hs[lo:hi, :, None] + kh                     # [n, PH, KH]
        w = self.ws[lo:hi, :, None] + kw                     # [n, PW, KW]
        vh = h < self.he[lo:hi, :, None]
        vw = w < self.we[lo:hi, :, None]
        flat = (h.clamp(0, H - 1)[:, :, None, :, None] * W
                + w.clamp(0, W - 1)[:, None, :, None, :])    # [n,PH,PW,KH,KW]
        valid = vh[:, :, None, :, None] & vw[:, None, :, None, :]
        n = hi - lo
        flat = flat.reshape(n, self.PH, self.PW, -1)
        valid = valid.reshape(n, self.PH, self.PW, -1)
        rows = self.batch_id[lo:hi, None, None, None] * (H * W) + flat
        return rows, flat, valid


def _nhwc(x):
    B, C, H, W = x.shape
    return x.permute(0, 2, 3, 1).reshape(B * H * W, C)


class _RoiPoolMax(torch.autograd.Function):
    """Max over each ROI bin's window, taken as one reduction over the
    window (values in f32), the Argmax the first maximum in the map's
    flat order, 0 and -1 for an empty bin. The gradient of a bin splits
    evenly among the window's elements equal to its maximum, as the
    reference's jnp.max over the flattened window does (ties are common
    on relu zeros)."""

    @staticmethod
    def forward(ctx, x, win):
        B, C, H, W = x.shape
        N = len(win.batch_id)
        xr = _nhwc(x.to(torch.float32))
        out = x.new_zeros((N, win.PH, win.PW, C), dtype=torch.float32)
        arg = torch.full((N, win.PH, win.PW, C), -1, dtype=torch.int64,
                         device=x.device)
        neg = xr.new_full((), -float("inf"))
        for lo in range(0, N, win.chunk):
            hi = min(N, lo + win.chunk)
            rows, flat, valid = win.chunk_index(lo, hi)
            vals = torch.where(valid[..., None], xr[rows], neg)
            best = torch.amax(vals, dim=3)                    # [n,PH,PW,C]
            at = torch.argmax(vals, dim=3)                    # the first max
            empty = ~valid.any(dim=3)[..., None]
            out[lo:hi] = torch.where(empty, xr.new_zeros(()), best)
            arg[lo:hi] = torch.where(empty, arg.new_full((), -1),
                                     torch.gather(flat, 3, at))
        ctx.win = win
        ctx.save_for_backward(x, out)
        ctx.dtype = x.dtype
        arg = arg.permute(0, 3, 1, 2).contiguous()
        ctx.mark_non_differentiable(arg)
        return out.permute(0, 3, 1, 2).to(x.dtype), arg

    @staticmethod
    def backward(ctx, g_out, g_arg):
        x, out = ctx.saved_tensors
        win = ctx.win
        B, C, H, W = x.shape
        N = len(win.batch_id)
        xr = _nhwc(x.to(torch.float32))
        g = g_out.to(torch.float32).permute(0, 2, 3, 1)      # [N,PH,PW,C]
        dx = torch.zeros_like(xr)
        for lo in range(0, N, win.chunk):
            hi = min(N, lo + win.chunk)
            rows, _, valid = win.chunk_index(lo, hi)
            empty = ~valid.any(dim=3)[..., None, None]
            tie = ((xr[rows] == out[lo:hi, :, :, None, :])
                   & valid[..., None] & ~empty)
            counts = tie.sum(dim=3).to(torch.float32)
            share = g[lo:hi] / counts.clamp_min(1.0)
            contrib = tie.to(torch.float32) * share[:, :, :, None, :]
            dx.index_add_(0, rows.reshape(-1), contrib.reshape(-1, C))
        dx = dx.reshape(B, H, W, C).permute(0, 3, 1, 2).to(ctx.dtype)
        return dx, None


@register_op("roi_pool")
def _roi_pool(ctx, ins, attrs):
    """roi_pool_op.cc: quantised max pooling over ROI bins.

    X [B, C, H, W]; ROIs [N, 4] (x1, y1, x2, y2) corner boxes; the
    ROIs of each image arrive through the @SEQLEN channel (SeqLen [B]:
    ROIs per image, in order), else every ROI is on image 0. Out [N, C,
    PH, PW] and Argmax [N, C, PH, PW] int64 (the flat h * W + w index,
    -1 for an empty bin).

    Each bin is gathered as a window of the largest bin's size from the
    map laid out channels-last and reduced at once, a chunk of ROIs at a
    time (at most 256 MB of window values), never the reference's
    [C, PH, PW, H, W] mask of each ROI."""
    x = ins["X"][0]
    rois = ins["ROIs"][0]
    scale = attrs.get("spatial_scale", 1.0)
    PH = int(attrs["pooled_height"])
    PW = int(attrs["pooled_width"])
    B, C = int(x.shape[0]), int(x.shape[1])
    N = int(rois.shape[0])
    if x.device.type == "meta" or rois.device.type == "meta":
        return {"Out": [x.new_empty((N, C, PH, PW))],
                "Argmax": [torch.empty((N, C, PH, PW), dtype=torch.int64,
                                       device=x.device)]}
    if ins.get("SeqLen"):
        bounds = torch.cumsum(ins["SeqLen"][0].reshape(-1).to(torch.int64),
                              0)
        roi_idx = torch.arange(N, device=rois.device)
        batch_id = (roi_idx[:, None] >= bounds[None, :]).sum(1)
        batch_id = batch_id.clamp(max=B - 1)     # past the counts: the last
    else:
        batch_id = torch.zeros((N,), dtype=torch.int64, device=rois.device)
    win = _Windows(x, rois, batch_id, scale, PH, PW)
    out, arg = _RoiPoolMax.apply(x, win)
    return {"Out": [out], "Argmax": [arg]}


# -- 3-D convolution ---------------------------------------------------------

@register_op("conv3d")
def _conv3d(ctx, ins, attrs):
    """NCDHW conv with groups and dilation (conv_op.cc Conv3D)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    out = F.conv3d(x, w, stride=_tup(attrs.get("strides", [1, 1, 1]), 3),
                   padding=_tup(attrs.get("paddings", [0, 0, 0]), 3),
                   dilation=_tup(attrs.get("dilations", [1, 1, 1]), 3),
                   groups=attrs.get("groups", 1))
    return {"Output": [out.to(x.dtype)]}


@register_op("conv3d_transpose")
def _conv3d_transpose(ctx, ins, attrs):
    """Transposed 3-D conv with fluid's semantics, out = (I-1)*s - 2p +
    d*(k-1) + 1; Filter is [in, out, kd, kh, kw]."""
    x, w = ins["Input"][0], ins["Filter"][0]
    out = F.conv_transpose3d(
        x, w, stride=_tup(attrs.get("strides", [1, 1, 1]), 3),
        padding=_tup(attrs.get("paddings", [0, 0, 0]), 3),
        dilation=_tup(attrs.get("dilations", [1, 1, 1]), 3))
    return {"Output": [out.to(x.dtype)]}


# -- pooling -----------------------------------------------------------------

@register_op("pool3d")
def _pool3d(ctx, ins, attrs):
    return {"Out": [pool_nd(ins["X"][0], attrs, 3)]}


def _max_pool_with_index(x, attrs, nd):
    """(Out, Mask): each window's maximum, and the first maximum's flat
    index into the channel's (unpadded) spatial map. The input padded
    with float32's finite minimum (a pad cell never wins), unfolded into
    a window axis in the reference's patch order; amax over it."""
    ksize = _tup(attrs.get("ksize", [2] * nd), nd)
    strides = _tup(attrs.get("strides", ksize), nd)
    pads = _tup(attrs.get("paddings", [0] * nd), nd)
    spatial = tuple(int(s) for s in x.shape[2:])
    if attrs.get("global_pooling", False):
        ksize, strides, pads = spatial, spatial, (0,) * nd
    B, C = int(x.shape[0]), int(x.shape[1])
    xf = x.float()
    if any(pads):
        xf = F.pad(xf, _pad_arg(pads),
                   value=float(np.finfo(np.float32).min))
    patches = xf
    for d in range(nd):
        patches = patches.unfold(2 + d, ksize[d], strides[d])
    out_spatial = tuple(int(s) for s in patches.shape[2:2 + nd])
    K = math.prod(ksize)
    patches = patches.reshape((B, C) + out_spatial + (K,))
    vals = torch.amax(patches, dim=-1)
    arg = torch.argmax(patches.detach(), dim=-1)
    k_unravel = np.stack(np.unravel_index(np.arange(K), ksize), 0)
    flat = None
    for d in range(nd):
        shape = [1] * nd
        shape[d] = out_spatial[d]
        off = (torch.arange(out_spatial[d], device=x.device) * strides[d]
               - pads[d]).reshape(shape)
        coord = torch.from_numpy(k_unravel[d]).to(x.device)[arg] + off
        flat = coord if flat is None else flat * spatial[d] + coord
    return vals.to(x.dtype), flat.to(torch.int64)


@register_op("max_pool2d_with_index")
def _max_pool2d_with_index(ctx, ins, attrs):
    out, mask = _max_pool_with_index(ins["X"][0], attrs, 2)
    return {"Out": [out], "Mask": [mask]}


@register_op("max_pool3d_with_index")
def _max_pool3d_with_index(ctx, ins, attrs):
    out, mask = _max_pool_with_index(ins["X"][0], attrs, 3)
    return {"Out": [out], "Mask": [mask]}


@register_op("unpool")
def _unpool(ctx, ins, attrs):
    """Max-unpooling (unpool_op.cc): each input value at the flat index
    its pooling recorded, zero elsewhere; a scatter-add divided by the
    hit count, so a cell two overlapping windows recorded gets its
    value once and the gradient splits between them (the reference's
    formula)."""
    x = ins["X"][0]
    idx = ins["Indices"][0]
    ksize = _tup(attrs.get("ksize", [2, 2]), 2)
    strides = _tup(attrs.get("strides", ksize), 2)
    pads = _tup(attrs.get("paddings", [0, 0]), 2)
    B, C, H, W = (int(s) for s in x.shape)
    OH = (H - 1) * strides[0] - 2 * pads[0] + ksize[0]
    OW = (W - 1) * strides[1] - 2 * pads[1] + ksize[1]
    ind = idx.reshape(B, C, -1).to(torch.int64)
    vals = x.reshape(B, C, -1)
    flat = torch.zeros((B, C, OH * OW), dtype=x.dtype,
                       device=x.device).scatter_add(2, ind, vals)
    count = torch.zeros((B, C, OH * OW), dtype=x.dtype,
                        device=x.device).scatter_add(
                            2, ind, torch.ones_like(vals))
    flat = flat / torch.clamp_min(count, 1.0)
    return {"Out": [flat.reshape(B, C, OH, OW)]}


@register_op("spp")
def _spp(ctx, ins, attrs):
    """Spatial pyramid pooling (spp_op.h): level p pools the map into
    2^p x 2^p bins with ceil kernels and the reference's padding,
    flattened and concatenated -> [B, C * (4^P - 1) / 3]."""
    x = ins["X"][0]
    P = int(attrs["pyramid_height"])
    ptype = attrs.get("pooling_type", "max")
    B, C, H, W = (int(s) for s in x.shape)
    pieces = []
    for p in range(P):
        bins = 2 ** p
        kh, kw = -(-H // bins), -(-W // bins)
        ph, pw = (kh * bins - H + 1) // 2, (kw * bins - W + 1) // 2
        lvl = pool_nd(x, {"pooling_type": ptype, "ksize": [kh, kw],
                           "strides": [kh, kw], "paddings": [ph, pw],
                           "exclusive": True}, 2)
        pieces.append(lvl.reshape(B, -1))
    return {"Out": [torch.cat(pieces, dim=1)]}


@register_op("crop")
def _crop(ctx, ins, attrs):
    """A static-offset window of X, of the `shape` attr's (or Y's)
    shape; a shorter shape crops the trailing axes only."""
    x = ins["X"][0]
    if ins.get("Y"):
        shape = [int(s) for s in ins["Y"][0].shape]
    else:
        shape = [int(s) for s in attrs["shape"]]
    if len(shape) < x.dim():
        shape = [int(s) for s in x.shape[:x.dim() - len(shape)]] + shape
    offsets = [int(o) for o in attrs.get("offsets", [0] * x.dim())]
    if len(offsets) < x.dim():
        offsets = [0] * (x.dim() - len(offsets)) + offsets
    for o, s, n in zip(offsets, shape, x.shape):
        if o < 0 or o + s > int(n):
            raise ValueError(f"crop: window {offsets} + {shape} outside "
                             f"{tuple(x.shape)}")
    return {"Out": [x[tuple(slice(o, o + s)
                            for o, s in zip(offsets, shape))]]}


@register_op("norm")
def _norm(ctx, ins, attrs):
    """norm_op.h (SSD's Normalize): scale[c] * x / the l2 norm across
    channels at each position."""
    x = ins["X"][0]
    scale = ins["Scale"][0].reshape(1, -1, 1, 1)
    denom = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)
                       + attrs.get("epsilon", 1e-10))
    return {"Out": [scale * x / denom]}


def _axis_coords(n_in, n_out, device):
    """Corner-aligned sample positions ((in - 1) / (out - 1) apart, the
    reference's BilinearInterpLayer.cpp:43; not half-pixel centres):
    (lo, hi, frac)."""
    ratio = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    pos = torch.arange(n_out, dtype=torch.float32, device=device) * ratio
    lo = torch.floor(pos).to(torch.int32)
    hi = torch.clamp_max(lo + 1, n_in - 1)
    return lo.long(), hi.long(), pos - lo


@register_op("bilinear_interp")
def _bilinear_interp(ctx, ins, attrs):
    """NCHW bilinear resize to (out_h, out_w), in f32."""
    x = ins["X"][0]
    H, W = int(x.shape[2]), int(x.shape[3])
    ylo, yhi, yf = _axis_coords(H, int(attrs["out_h"]), x.device)
    xlo, xhi, xf = _axis_coords(W, int(attrs["out_w"]), x.device)
    x32 = x.float()
    xf, yf = xf[None, None, None, :], yf[None, None, :, None]
    top = (x32[:, :, ylo][:, :, :, xlo] * (1 - xf)
           + x32[:, :, ylo][:, :, :, xhi] * xf)
    bot = (x32[:, :, yhi][:, :, :, xlo] * (1 - xf)
           + x32[:, :, yhi][:, :, :, xhi] * xf)
    return {"Out": [(top * (1 - yf) + bot * yf).to(x.dtype)]}


@register_op("rotate")
def _rotate(ctx, ins, attrs):
    """RotateLayer: each CHW map turned 90 degrees clockwise
    (out[r][c] = in[H-1-c][r])."""
    return {"Out": [torch.rot90(ins["X"][0], k=-1, dims=(2, 3))]}


@register_op("scale_sub_region")
def _scale_sub_region(ctx, ins, attrs):
    """ScaleSubRegionLayer: each sample's [c1..c2, h1..h2, w1..w2] box
    (1-based, inclusive) multiplied by `value`."""
    x = ins["X"][0]
    idx = ins["Indices"][0].to(torch.int32)
    value = attrs.get("value", 1.0)
    B, C, H, W = (int(d) for d in x.shape)

    def iota(n, shape):
        return torch.arange(1, n + 1, dtype=torch.int32,
                            device=x.device).reshape(shape)

    def dim(i):
        return idx[:, i].reshape(B, 1, 1, 1)

    c, h, w = iota(C, (1, C, 1, 1)), iota(H, (1, 1, H, 1)), \
        iota(W, (1, 1, 1, W))
    mask = ((c >= dim(0)) & (c <= dim(1)) & (h >= dim(2))
            & (h <= dim(3)) & (w >= dim(4)) & (w <= dim(5)))
    return {"Out": [torch.where(mask, x * value, x)]}


@register_op("dynamic_conv2d")
def _dynamic_conv2d(ctx, ins, attrs):
    """ConvOperator: each sample convolved with its own [O, C, kh, kw]
    filter (a row of Filter), as one grouped conv with a group a sample;
    the output flattened to [B, O * OH * OW]."""
    x, f = ins["X"][0], ins["Filter"][0]
    O, C = int(attrs["num_filters"]), int(attrs["num_channels"])
    kh, kw = int(attrs["kh"]), int(attrs["kw"])
    B, H, W = int(x.shape[0]), int(x.shape[-2]), int(x.shape[-1])
    out = F.conv2d(x.reshape(1, B * C, H, W),
                   f.reshape(B * O, C, kh, kw),
                   stride=(int(attrs.get("sh", 1)), int(attrs.get("sw", 1))),
                   padding=(int(attrs.get("ph", 0)), int(attrs.get("pw", 0))),
                   groups=B)
    return {"Out": [out.reshape(B, -1).to(x.dtype)]}
