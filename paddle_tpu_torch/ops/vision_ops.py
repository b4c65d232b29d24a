"""Vision ops of the port: `roi_pool` (the port of the op of that name in
`paddle_tpu/ops/vision_ops.py`; the rest of that file is still to port).
"""

from __future__ import annotations

import torch

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
