"""NN op lowerings: activations, conv/pool, normalisation, losses, dropout.

The port of `paddle_tpu/ops/nn_ops.py`, every op of it, with the same
names, slots and attrs. The reference computes convolutions and pooling
through XLA (`jax.lax.conv_general_dilated`, `reduce_window`), not
Pallas; their counterparts here are `torch.nn.functional.conv2d` /
`conv_transpose2d` (cuDNN on the card) and the pooling functions, in
NCHW, as XLA's large products are `torch.matmul`.

The formulas are the reference's, written with the torch functions
whose gradients match JAX's at ties: `relu` is `maximum(x, 0)` (gradient
1/2 at 0, where `F.relu` gives 0) and a clip is a `minimum` of a
`maximum` (gradient 1/2 at either bound, where `clamp` gives 1). Max
pooling gives a window's gradient to its first maximum in scan order,
as XLA does. batch_norm takes the biased one-pass batch variance
E[x^2] - E[x]^2 in f32 and threads its running stats functionally:
MeanOut / VarianceOut are new values the executor writes back over the
same persistable vars; in test mode it normalises with the running
stats and returns them unchanged.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register_op


def _maximum(x, s):
    """jnp.maximum(x, s) for a scalar s: its gradient 1/2 at a tie."""
    return torch.maximum(x, x.new_full((), s))


def _minimum(x, s):
    return torch.minimum(x, x.new_full((), s))


def _clip(x, lo, hi):
    """jnp.clip: minimum(maximum(x, lo), hi), its gradient 1/2 at a
    bound."""
    return _minimum(_maximum(x, lo), hi)


def _logaddexp0(x):
    """jnp.logaddexp(0, x)."""
    return torch.logaddexp(torch.zeros_like(x), x)


# -- activations ------------------------------------------------------------

def _act(fn):
    def lowering(ctx, ins, attrs):
        return {"Out": [fn(ins["X"][0], attrs)]}
    return lowering


register_op("relu")(_act(lambda x, a: _maximum(x, 0)))
register_op("relu6")(_act(lambda x, a: _clip(x, 0, a.get("threshold", 6.0))))
register_op("sigmoid")(_act(lambda x, a: 1.0 / (1.0 + torch.exp(-x))))
register_op("logsigmoid")(_act(lambda x, a: -_logaddexp0(-x)))
register_op("tanh")(_act(lambda x, a: torch.tanh(x)))


@register_op("gelu")
def _gelu(ctx, ins, attrs):
    # jax.nn.gelu(approximate=True) is the tanh form
    approx = "tanh" if attrs.get("approximate", True) else "none"
    return {"Out": [F.gelu(ins["X"][0], approximate=approx)]}


register_op("leaky_relu")(_act(
    lambda x, a: torch.where(x > 0, x, x * a.get("alpha", 0.02))))
register_op("elu")(_act(
    lambda x, a: torch.where(x > 0, x,
                             a.get("alpha", 1.0) * (torch.exp(x) - 1))))
register_op("softplus")(_act(lambda x, a: _logaddexp0(x)))
register_op("softsign")(_act(lambda x, a: x / (1 + torch.abs(x))))


def _softshrink(x, a):
    lam = a.get("lambda", 0.5)
    zero = x.new_zeros(())
    return torch.where(x > lam, x - lam, torch.where(x < -lam, x + lam, zero))


register_op("softshrink")(_act(_softshrink))
register_op("hard_sigmoid")(_act(
    lambda x, a: _clip(a.get("slope", 0.2) * x + a.get("offset", 0.5),
                       0.0, 1.0)))
register_op("swish")(_act(
    lambda x, a: x / (1.0 + torch.exp(-a.get("beta", 1.0) * x))))
register_op("stanh")(_act(
    lambda x, a: a.get("scale_b", 1.7159)
    * torch.tanh(a.get("scale_a", 2.0 / 3.0) * x)))
register_op("thresholded_relu")(_act(
    lambda x, a: torch.where(x > a.get("threshold", 1.0), x,
                             x.new_zeros(()))))
register_op("brelu")(_act(
    lambda x, a: _clip(x, a.get("t_min", 0.0), a.get("t_max", 24.0))))


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    return {"Out": [torch.softmax(ins["X"][0], dim=-1)]}


@register_op("log_softmax")
def _log_softmax(ctx, ins, attrs):
    return {"Out": [torch.log_softmax(ins["X"][0], dim=-1)]}


# -- losses -----------------------------------------------------------------

def _pick(logp, label):
    """logp[..., label] with label [..., 1] or [...] integer."""
    if label.dim() == logp.dim():
        label = label.squeeze(-1)
    return torch.gather(logp, -1, label.long()[..., None])


@register_op("cross_entropy")
def _cross_entropy(ctx, ins, attrs):
    """X = probabilities [N, C]; Label = int index [N, 1] or soft
    [N, C]. Y [N, 1] = -log(clip(x, 1e-8, 1)) at the label."""
    x = ins["X"][0]
    label = ins["Label"][0]
    logp = torch.log(_clip(x, 1e-8, 1.0))
    if attrs.get("soft_label", False):
        return {"Y": [-torch.sum(label * logp, dim=-1, keepdim=True)]}
    return {"Y": [-_pick(logp, label)]}


@register_op("softmax_with_cross_entropy")
def _softmax_xent(ctx, ins, attrs):
    """Hard labels: loss = logsumexp - the picked logit, in f32, with
    both outputs in the logits dtype; soft labels: -sum(label *
    log_softmax)."""
    logits = ins["Logits"][0]
    label = ins["Label"][0]
    if attrs.get("soft_label", False):
        logp = torch.log_softmax(logits, dim=-1)
        loss = -torch.sum(label * logp, dim=-1, keepdim=True)
        return {"Softmax": [torch.exp(logp)], "Loss": [loss]}
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1, keepdim=True)
    loss = (lse - _pick(lf, label)).to(logits.dtype)
    return {"Softmax": [torch.exp(lf - lse).to(logits.dtype)],
            "Loss": [loss]}


@register_op("square_error_cost")
def _square_error_cost(ctx, ins, attrs):
    return {"Out": [(ins["X"][0] - ins["Y"][0]).square()]}


@register_op("sigmoid_cross_entropy_with_logits")
def _sigmoid_xent(ctx, ins, attrs):
    x = ins["X"][0]
    label = ins["Label"][0]
    loss = _maximum(x, 0) - x * label + _logaddexp0(-torch.abs(x))
    return {"Out": [loss]}


@register_op("smooth_l1_loss")
def _smooth_l1(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    d = x - y
    ad = torch.abs(d)
    elem = torch.where(ad < 1.0 / s2, 0.5 * s2 * d * d, ad - 0.5 / s2)
    out = torch.sum(elem, dim=tuple(range(1, x.dim())))
    return {"Out": [out[:, None]], "Diff": [d]}


@register_op("huber_loss")
def _huber(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    delta = attrs.get("delta", 1.0)
    d = y - x
    ad = torch.abs(d)
    out = torch.where(ad <= delta, 0.5 * d * d, delta * (ad - 0.5 * delta))
    return {"Out": [out], "Residual": [d]}


@register_op("hinge_loss")
def _hinge(ctx, ins, attrs):
    logits, label = ins["Logits"][0], ins["Labels"][0]
    return {"Loss": [_maximum(1.0 - (2.0 * label - 1.0) * logits, 0.0)]}


@register_op("rank_loss")
def _rank_loss(ctx, ins, attrs):
    label = ins["Label"][0]
    d = ins["Left"][0] - ins["Right"][0]
    return {"Out": [_logaddexp0(d) - label * d]}


# -- conv / pool ------------------------------------------------------------

def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _s2d_eligible(x, w, strides, pads, dilations, groups):
    """The space-to-depth stem rewrite applies to the classic image-stem
    shape: few input channels (<= 4), both strides equal and >= 2,
    kernel >= stride, no dilation or groups (the reference's test)."""
    s = strides[0]
    return (s == strides[1] and s >= 2 and groups == 1
            and dilations == (1, 1) and int(x.shape[1]) <= 4
            and int(w.shape[2]) >= s and int(w.shape[3]) >= s
            and int(x.shape[1]) * s * s <= 64)


def _conv2d_s2d(x, w, s, pads):
    """Exact rewrite of a stride-s conv as block-s space-to-depth and a
    stride-1 VALID conv (the reference's `_conv2d_s2d`):

      y[o,i,j] = sum_{c,u,v} W[o,c,u,v] x[c, s*i+u-p, s*j+v-p]

    with u = s*q + r splits into a sum over (c, r) channels at spatial
    offset q: a [O, C*s^2, ceil(k/s), ceil(k/s)] conv over the
    depth-stacked input. Gradients flow through the reshapes."""
    N = x.shape[0]
    C, H, W_ = (int(d) for d in x.shape[1:])
    O, _, kh, kw = (int(d) for d in w.shape)
    ph, pw = pads
    kh2, kw2 = -(-kh // s), -(-kw // s)           # ceil(k/s)
    # pad the input by the conv padding, then up to a multiple of s
    Hp, Wp = H + 2 * ph, W_ + 2 * pw
    Hs, Ws = -(-Hp // s) * s, -(-Wp // s) * s
    xp = F.pad(x, (pw, pw + Ws - Wp, ph, ph + Hs - Hp))
    # space-to-depth: [N, C, Hs/s, s, Ws/s, s] -> [N, C*s*s, Hs/s, Ws/s]
    xs = xp.reshape(N, C, Hs // s, s, Ws // s, s)
    xs = xs.permute(0, 1, 3, 5, 2, 4).reshape(N, C * s * s, Hs // s,
                                              Ws // s)
    # weights: pad k -> s*ceil(k/s), the same (c, r, rj) channel order
    wp = F.pad(w, (0, s * kw2 - kw, 0, s * kh2 - kh))
    ws = wp.reshape(O, C, kh2, s, kw2, s)
    ws = ws.permute(0, 1, 3, 5, 2, 4).reshape(O, C * s * s, kh2, kw2)
    out = F.conv2d(xs, ws)
    # VALID over the padded-to-multiple input can overshoot by one tap
    oh = (H + 2 * ph - kh) // s + 1
    ow = (W_ + 2 * pw - kw) // s + 1
    return out[:, :, :oh, :ow]


@register_op("conv2d")
def _conv2d(ctx, ins, attrs):
    """NCHW conv with groups and dilation; the output keeps the input
    dtype (a bf16 conv accumulates in f32). Image-stem convs go through
    the exact space-to-depth rewrite (see _conv2d_s2d) unless the
    `conv_s2d_stem` flag is off."""
    x = ins["Input"][0]
    w = ins["Filter"][0]
    strides = _pair(attrs.get("strides", [1, 1]))
    pads = _pair(attrs.get("paddings", [0, 0]))
    dilations = _pair(attrs.get("dilations", [1, 1]))
    groups = attrs.get("groups", 1)
    from .. import flags as flags_mod
    if (flags_mod.get("conv_s2d_stem")
            and _s2d_eligible(x, w, strides, pads, dilations, groups)):
        out = _conv2d_s2d(x, w, strides[0], pads)
    else:
        out = F.conv2d(x, w, stride=strides, padding=pads,
                       dilation=dilations, groups=groups)
    return {"Output": [out.to(x.dtype)]}


@register_op("depthwise_conv2d")
def _depthwise_conv2d(ctx, ins, attrs):
    attrs = dict(attrs)
    attrs["groups"] = int(ins["Input"][0].shape[1])
    return _conv2d(ctx, ins, attrs)


@register_op("conv2d_transpose")
def _conv2d_transpose(ctx, ins, attrs):
    """Transposed conv with fluid's semantics, out = (I-1)*s - 2p +
    d*(k-1) + 1; Filter is [in, out, kh, kw]."""
    x = ins["Input"][0]
    w = ins["Filter"][0]
    out = F.conv_transpose2d(
        x, w, stride=_pair(attrs.get("strides", [1, 1])),
        padding=_pair(attrs.get("paddings", [0, 0])),
        dilation=_pair(attrs.get("dilations", [1, 1])))
    return {"Output": [out.to(x.dtype)]}


def _tup(v, n):
    if isinstance(v, (list, tuple)):
        t = tuple(int(x) for x in v)
        return t if len(t) == n else t * n
    return (int(v),) * n


def _pad_arg(pads):
    """Symmetric per-axis pads -> F.pad's flat list (last axis first)."""
    out = []
    for p in reversed(pads):
        out += [p, p]
    return out


def _ceil_extra(n, k, s, p):
    """The bottom/right pad that rounds the pooled size up (ceil_mode)."""
    out = -(-(n + 2 * p - k) // s) + 1
    return max(0, (out - 1) * s + k - (n + 2 * p))


_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_SUM_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def pool_nd(x, attrs, nd, ceil_mode=False):
    """N-D pooling of an N, C + spatial tensor (math/pooling.cc): max
    over a -inf padded input; avg the reference's window sum over a zero
    padded input, divided by the count of real elements (`exclusive`
    with padding) or else by the window size, the ceil_mode pad
    included."""
    ptype = attrs.get("pooling_type", "max")
    ksize = _tup(attrs.get("ksize", [2] * nd), nd)
    strides = _tup(attrs.get("strides", ksize), nd)
    pads = _tup(attrs.get("paddings", [0] * nd), nd)
    spatial = tuple(int(s) for s in x.shape[2:])
    if attrs.get("global_pooling", False):
        ksize, strides, pads = spatial, spatial, (0,) * nd
    lo_hi = [[p, p] for p in pads]
    if ceil_mode:
        for d in range(nd):
            lo_hi[d][1] += _ceil_extra(spatial[d], ksize[d], strides[d],
                                       pads[d])
    padding = [v for pair in reversed(lo_hi) for v in pair]
    if ptype == "max":
        xp = F.pad(x, padding, value=float("-inf")) if any(padding) else x
        out = _MAX_POOL[nd](xp, ksize, strides)
    else:
        xp = F.pad(x, padding) if any(padding) else x
        summed = _SUM_POOL[nd](xp, ksize, strides, divisor_override=1)
        if attrs.get("exclusive", True) and any(pads):
            ones = F.pad(torch.ones((1, 1) + spatial, dtype=x.dtype,
                                    device=x.device), padding)
            out = summed / _SUM_POOL[nd](ones, ksize, strides,
                                         divisor_override=1)
        else:
            out = summed / float(math.prod(ksize))
    return out.to(x.dtype)


@register_op("pool2d")
def _pool2d(ctx, ins, attrs):
    return {"Out": [pool_nd(ins["X"][0], attrs, 2,
                            attrs.get("ceil_mode", False))]}


# -- normalisation ----------------------------------------------------------

@register_op("batch_norm", test_aware=True)
def _batch_norm(ctx, ins, attrs):
    """X NCHW (or [N, C]). Train: the batch statistics in f32 (the
    biased one-pass variance), MeanOut / VarianceOut = stat * momentum +
    batch * (1 - momentum) in the stats' dtype, SavedVariance the
    inverse std. Test: the running stats, returned unchanged. Y is
    computed in f32 and cast to X's dtype."""
    x = ins["X"][0]
    scale = ins["Scale"][0]
    bias = ins["Bias"][0]
    mean = ins["Mean"][0]
    var = ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    is_test = attrs.get("is_test", False) or ctx.is_test
    axes = (0,) if x.dim() == 2 else (0, 2, 3)
    shape = (1, -1) if x.dim() == 2 else (1, -1, 1, 1)
    if is_test:
        use_mean, use_var = mean, var
        mean_out, var_out = mean, var
        saved_mean = mean
        saved_inv_std = 1.0 / torch.sqrt(var.float() + eps)
    else:
        xf = x.float()
        bmean = xf.mean(dim=axes)
        bvar = xf.square().mean(dim=axes) - bmean.square()
        use_mean, use_var = bmean, bvar
        mean_out = mean * momentum + bmean.to(mean.dtype) * (1 - momentum)
        var_out = var * momentum + bvar.to(var.dtype) * (1 - momentum)
        saved_mean = bmean
        saved_inv_std = 1.0 / torch.sqrt(bvar + eps)
    inv = (1.0 / torch.sqrt(use_var.float() + eps)) * scale.float()
    y = ((x.float() - use_mean.reshape(shape)) * inv.reshape(shape)
         + bias.float().reshape(shape))
    return {"Y": [y.to(x.dtype)],
            "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [saved_mean], "SavedVariance": [saved_inv_std]}


@register_op("layer_norm")
def _layer_norm(ctx, ins, attrs):
    """Normalise over the axes from begin_norm_axis on, in f32; Mean and
    Variance are the per-row statistics (squeezed, as the reference)."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(begin, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    y = (xf - mean) / torch.sqrt(var + eps)
    norm_shape = (1,) * begin + tuple(x.shape[begin:])
    if ins.get("Scale"):
        y = y * ins["Scale"][0].float().reshape(norm_shape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].float().reshape(norm_shape)
    return {"Y": [y.to(x.dtype)],
            "Mean": [mean.squeeze()], "Variance": [var.squeeze()]}


@register_op("lrn")
def _lrn(ctx, ins, attrs):
    """Cross-map local response normalisation: the square summed over a
    window of n channels (the channel axis zero padded n//2 before and
    n-1-n//2 after)."""
    x = ins["X"][0]
    n = attrs.get("n", 5)
    alpha = attrs.get("alpha", 1e-4)
    beta = attrs.get("beta", 0.75)
    k = attrs.get("k", 1.0)
    half = n // 2
    sq = F.pad(x.square(), (0, 0, 0, 0, half, n - 1 - half))
    C = int(x.shape[1])
    acc = sq[:, 0:C]
    for i in range(1, n):
        acc = acc + sq[:, i:i + C]
    mid = torch.pow(k + alpha * acc, beta)
    return {"Out": [x / mid], "MidOut": [mid]}


@register_op("l2_normalize")
def _l2_normalize(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    eps = attrs.get("epsilon", 1e-10)
    norm = torch.sqrt(torch.sum(x.square(), dim=axis, keepdim=True))
    return {"Out": [x / _maximum(norm, eps)], "Norm": [norm]}


# -- dropout ----------------------------------------------------------------

@register_op("dropout", stateful=True, test_aware=True)
def _dropout(ctx, ins, attrs):
    """Inverted dropout (upscale in train, the identity in test); the
    keep mask draws from the context's generator, so its numbers are not
    the reference's."""
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    if attrs.get("is_test", False) or ctx.is_test or p == 0.0:
        return {"Out": [x], "Mask": [torch.ones_like(x)]}
    keep = 1.0 - p
    u = torch.rand(x.shape, generator=ctx.generator, dtype=torch.float32,
                   device=x.device)
    maskf = (u < keep).to(x.dtype)
    return {"Out": [x * maskf / keep], "Mask": [maskf]}


# -- misc -------------------------------------------------------------------

@register_op("one_hot", differentiable=False)
def _one_hot(ctx, ins, attrs):
    ids = ins["X"][0]
    if ids.dim() and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    depth = int(attrs["depth"])
    out = (ids.long()[..., None]
           == torch.arange(depth, device=ids.device)).to(torch.float32)
    return {"Out": [out]}


@register_op("maxout")
def _maxout(ctx, ins, attrs):
    """The max over each group of channels (amax: a tie shares the
    gradient equally, as jnp.max)."""
    x = ins["X"][0]
    g = attrs["groups"]
    n, c, h, w = x.shape
    return {"Out": [torch.amax(x.reshape(n, c // g, g, h, w), dim=2)]}


@register_op("im2sequence")
def _im2sequence(ctx, ins, attrs):
    """Sliding-window patches as a sequence: [N, C, H, W] -> the padded
    form [N, OH*OW, C*kh*kw], each patch channel-major."""
    x = ins["X"][0]
    kh, kw = _pair(attrs["kernels"])
    sh, sw = _pair(attrs.get("strides", [1, 1]))
    p = attrs.get("paddings", [0, 0, 0, 0])
    xp = F.pad(x, (p[1], p[3], p[0], p[2]))
    patches = F.unfold(xp, (kh, kw), stride=(sh, sw))
    return {"Out": [patches.transpose(1, 2)]}
