"""Sequence op lowerings (the port's copy of `paddle_tpu/ops/sequence_ops.py`).

A lod_level-1 tensor is (padded values [B, T, ...], lengths [B]); a
lod_level-2 tensor is (values [B, S, T, ...], outer lengths [B], inner
lengths [B, S]). Every sequence op takes the lengths through its
"SeqLen" slot and masks, so there is no pack/unpack of LoD rows. The
reductions follow the reference's tie and edge rules exactly:

  * MAX pooling masks with -1e9 and reduces with `torch.amax`, whose
    gradient splits equally among tied maxima, as JAX's reduce-max does
    ([1, 3, 3, 2] -> [0, .5, .5, 0]); `torch.max(x, dim)` would give it
    all to one index;
  * a zero-length row averages over max(len, 1) and its LAST step is
    step 0;
  * the top-k of `kmax_seq_score` puts the lower index first among equal
    scores, as `jax.lax.top_k` does (a stable descending sort).

None of them is a TPU kernel in the reference (all are XLA ops), so all
are plain torch.
"""

from __future__ import annotations

import torch

from .registry import register_op, torch_dtype

__all__ = ["time_mask", "topk_lower_index_first"]


def time_mask(seqlen, max_t, dtype=torch.float32):
    """[..., T] mask: 1 where t < len."""
    t = torch.arange(max_t, device=seqlen.device)
    return (t < seqlen[..., None]).to(dtype)


def _trailing(t, n):
    """`t` with n trailing size-1 axes."""
    return t.reshape(tuple(t.shape) + (1,) * n)


def _neg_fill(dtype):
    return -1e300 if dtype == torch.float64 else -1e9


@register_op("sequence_pool")
def _sequence_pool(ctx, ins, attrs):
    """pooltype SUM / AVERAGE / SQRT / MAX / LAST / FIRST over the time
    axis (operators/sequence_pool_op.cc). X [B, T, D...] with SeqLen [B];
    or nested X [B, S, T, D...] with the inner SeqLen [B, S], which pools
    the inner axis into a level-1 sequence."""
    x = ins["X"][0]
    seqlen = ins["SeqLen"][0]
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    ax = seqlen.dim()                 # the time axis being pooled
    T = x.shape[ax]
    rest = x.dim() - ax - 1
    m = _trailing(time_mask(seqlen, T, x.dtype), rest)
    lens = _trailing(torch.clamp_min(seqlen, 1).to(x.dtype), rest)
    if ptype == "SUM":
        out = torch.sum(x * m, dim=ax)
    elif ptype == "AVERAGE":
        out = torch.sum(x * m, dim=ax) / lens
    elif ptype == "SQRT":
        out = torch.sum(x * m, dim=ax) / torch.sqrt(lens)
    elif ptype == "MAX":
        neg = torch.full((), _neg_fill(x.dtype), dtype=x.dtype,
                         device=x.device)
        out = torch.amax(torch.where(m > 0, x, neg), dim=ax)
    elif ptype == "LAST":
        idx = torch.clamp_min(seqlen - 1, 0).to(torch.int64)
        idx = _trailing(idx, rest + 1)
        shape = list(x.shape)
        shape[ax] = 1
        out = torch.gather(x, ax, idx.expand(shape)).squeeze(ax)
    elif ptype == "FIRST":
        out = x.select(ax, 0)
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    return {"Out": [out]}


@register_op("sequence_softmax")
def _sequence_softmax(ctx, ins, attrs):
    """Softmax over valid timesteps only (operators/sequence_softmax_op.cc).
    X: [B, T] or [B, T, 1]; computed in float32."""
    x = ins["X"][0]
    seqlen = ins["SeqLen"][0]
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    if squeeze:
        x = x.squeeze(-1)
    mask = time_mask(seqlen, x.shape[1], torch.float32)
    xf = x.to(torch.float32)
    xf = torch.where(mask > 0, xf, torch.full((), -1e9, device=x.device))
    xf = xf - torch.amax(xf, dim=1, keepdim=True)
    e = torch.exp(xf) * mask
    out = e / torch.clamp_min(torch.sum(e, dim=1, keepdim=True), 1e-12)
    out = out.to(x.dtype)
    if squeeze:
        out = out[..., None]
    return {"Out": [out]}


@register_op("sequence_expand")
def _sequence_expand(ctx, ins, attrs):
    """Broadcast per-sequence rows X [B, D] along time to [B, T, D],
    Y's padded layout (operators/sequence_expand_op.cc)."""
    x = ins["X"][0]
    T = ins["Y"][0].shape[1]
    return {"Out": [x.unsqueeze(1).expand((x.shape[0], T)
                                          + tuple(x.shape[1:]))]}


@register_op("sequence_concat")
def _sequence_concat(ctx, ins, attrs):
    xs = ins["X"]
    axis = attrs.get("axis", 2) if xs[0].dim() > 2 else -1
    return {"Out": [torch.cat(xs, dim=axis)]}


@register_op("sequence_reshape")
def _sequence_reshape(ctx, ins, attrs):
    x = ins["X"][0]  # [B, T, D]
    new_dim = attrs["new_dim"]
    B, T, D = x.shape
    assert (T * D) % new_dim == 0
    return {"Out": [x.reshape(B, T * D // new_dim, new_dim)]}


@register_op("sequence_slice")
def _sequence_slice(ctx, ins, attrs):
    offset, length = attrs["offset"], attrs["length"]
    return {"Out": [ins["X"][0][:, offset:offset + length]]}


@register_op("sequence_erase", differentiable=False)
def _sequence_erase(ctx, ins, attrs):
    """Drop the tokens of the erase set and compact each row to the
    left (operators/sequence_erase_op.cc); the padding keeps its static
    shape and SeqLenOut gives the new lengths."""
    x = ins["X"][0]  # [B, T] int ids
    seqlen = ins["SeqLen"][0]
    keep = torch.ones_like(x, dtype=torch.bool)
    for t in attrs.get("tokens", []):
        keep = keep & (x != t)
    B, T = x.shape
    keep = keep & time_mask(seqlen, T, torch.bool)
    new_len = torch.sum(keep.to(torch.int32), dim=1)
    pos = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    pos = torch.where(keep, pos, torch.full_like(pos, T - 1))
    flat = (torch.arange(B, device=x.device)[:, None] * T + pos).reshape(-1)
    out = torch.zeros_like(x).reshape(-1)
    out = out.scatter_reduce(0, flat.to(torch.int64),
                             torch.where(keep, x, torch.zeros_like(x))
                             .reshape(-1), reduce="amax", include_self=True)
    return {"Out": [out.reshape(B, T)], "SeqLenOut": [new_len]}


@register_op("sequence_conv")
def _sequence_conv(ctx, ins, attrs):
    """Context-window convolution over time (operators/sequence_conv_op.cc):
    for each t, the rows [t + start, t + start + ctx) concatenated and
    projected by Filter [ctx*D, M]; out-of-range and padded rows are
    zero."""
    x = ins["X"][0]          # [B, T, D]
    w = ins["Filter"][0]     # [ctx*D, M]
    seqlen = ins["SeqLen"][0]
    ctx_len = attrs.get("contextLength", 3)
    ctx_start = attrs.get("contextStart", -(ctx_len // 2))
    B, T, D = x.shape
    mask = time_mask(seqlen, T, x.dtype)[..., None]
    xm = x * mask
    t = torch.arange(T, device=x.device)
    cols = []
    for k in range(ctx_len):
        shift = ctx_start + k
        rolled = torch.roll(xm, -shift, dims=1)
        valid = (t + shift >= 0) & (t + shift < T)
        cols.append(rolled * valid[None, :, None].to(x.dtype))
    stacked = torch.cat(cols, dim=-1)               # [B, T, ctx*D]
    out = torch.matmul(stacked, w)
    return {"Out": [out * mask]}


@register_op("sequence_first_step")
def _sequence_first_step(ctx, ins, attrs):
    x = ins["X"][0]
    if ins.get("SubSeqLen"):
        if attrs.get("inner_level"):
            # nested -> [B, S, ...]: first token of EACH subsequence
            return {"Out": [x[:, :, 0]]}
        return {"Out": [x[:, 0, 0]]}   # first token of first subseq
    return {"Out": [x[:, 0]]}


@register_op("sequence_last_step")
def _sequence_last_step(ctx, ins, attrs):
    x = ins["X"][0]
    seqlen = ins["SeqLen"][0]
    B = x.shape[0]
    b = torch.arange(B, device=x.device)
    s_idx = torch.clamp_min(seqlen - 1, 0).to(torch.int64)
    if ins.get("SubSeqLen"):
        sub = ins["SubSeqLen"][0]                       # [B, S]
        if attrs.get("inner_level"):
            # nested [B, S, T, ...] -> [B, S, ...]: the last valid token
            # of EACH subsequence
            t_idx = torch.clamp_min(sub - 1, 0).to(torch.int64)
            s_all = torch.arange(x.shape[1], device=x.device)[None, :]
            return {"Out": [x[b[:, None], s_all, t_idx]]}
        # nested -> [B, ...]: the last token of the LAST subsequence
        t_idx = torch.clamp_min(sub[b, s_idx] - 1, 0).to(torch.int64)
        return {"Out": [x[b, s_idx, t_idx]]}
    return {"Out": [x[b, s_idx]]}


@register_op("sequence_mask", differentiable=False)
def _sequence_mask(ctx, ins, attrs):
    """[B, T] 0/1 mask from a padded tensor X (or a `maxlen` attr) and
    its lengths."""
    seqlen = ins["SeqLen"][0]
    if "X" in ins:
        T = ins["X"][0].shape[1]
    elif "maxlen" in attrs:
        T = attrs["maxlen"]
    else:
        raise ValueError("sequence_mask needs an X input (padded tensor) "
                         "or a 'maxlen' attr")
    return {"Out": [time_mask(seqlen, T,
                              torch_dtype(attrs.get("dtype", "float32")))]}


@register_op("max_sequence_len", differentiable=False)
def _max_sequence_len(ctx, ins, attrs):
    return {"Out": [torch.amax(ins["SeqLen"][0]).reshape(1)
                    .to(torch.int64)]}


@register_op("sequence_scale")
def _sequence_scale(ctx, ins, attrs):
    """Scale each sequence's rows by a per-sequence scalar."""
    x = ins["X"][0]          # [B, T, ...]
    s = ins["Scale"][0]      # [B]
    return {"Out": [x * s.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
                    .to(x.dtype)]}


@register_op("edit_distance", differentiable=False)
def _edit_distance(ctx, ins, attrs):
    """Levenshtein distance between hypothesis and reference id
    sequences (operators/edit_distance_op.cc): the DP rows over the
    padded hypothesis axis, each row built left to right; rows past a
    hypothesis's length keep the previous row."""
    hyp, hyp_len = ins["Hyps"][0], ins["HypsLen"][0]
    ref, ref_len = ins["Refs"][0], ins["RefsLen"][0]
    if hyp.dim() == 3:
        hyp = hyp.squeeze(-1)
    if ref.dim() == 3:
        ref = ref.squeeze(-1)
    B, Th = hyp.shape
    Tr = ref.shape[1]
    dev = hyp.device
    f32 = torch.float32
    prev = torch.arange(Tr + 1, dtype=f32, device=dev).expand(B, Tr + 1)
    if dev.type != "meta":
        for i in range(Th):
            sub_cost = (ref != hyp[:, i:i + 1]).to(f32)         # [B, Tr]
            val = torch.full((B,), float(i + 1), dtype=f32, device=dev)
            cur = [val]
            for j in range(Tr):
                diag = prev[:, j] + sub_cost[:, j]
                up = prev[:, j + 1] + 1.0
                val = torch.minimum(torch.minimum(val + 1.0, up), diag)
                cur.append(val)
            cur = torch.stack(cur, dim=1)
            prev = torch.where((i < hyp_len)[:, None], cur, prev)
    dist = prev[torch.arange(B, device=dev), ref_len.to(torch.int64)]
    if attrs.get("normalized", True):
        dist = dist / torch.clamp_min(ref_len.to(f32), 1.0)
    return {"Out": [dist[:, None]],
            "SequenceNum": [torch.tensor([B], dtype=torch.int64,
                                         device=dev)]}


@register_op("row_conv")
def _row_conv(ctx, ins, attrs):
    """Lookahead row convolution (operators/row_conv_op.cc): out[t] =
    sum_{w < F, t + w < len} x[t + w] * filter[w], elementwise over
    features. X [B, T, D] with SeqLen; Filter [F, D]."""
    x = ins["X"][0]
    filt = ins["Filter"][0]
    seqlen = ins["SeqLen"][0] if ins.get("SeqLen") else None
    T = x.shape[1]
    if seqlen is not None:
        mask = time_mask(seqlen, T, x.dtype)[..., None]
        xm = x * mask
    else:
        xm = x
    out = torch.zeros_like(x)
    for w in range(filt.shape[0]):
        # x shifted left by w, zero-padded at the tail
        shifted = torch.nn.functional.pad(xm[:, w:, :], (0, 0, 0, w))
        out = out + shifted * filt[w][None, None, :]
    if seqlen is not None:
        out = out * mask
    return {"Out": [out]}


@register_op("sequence_expand_nested")
def _sequence_expand_nested(ctx, ins, attrs):
    """Each per-subsequence vector X[b, s] broadcast across its
    subsequence's timesteps: Ref's [B, S, T, ...] layout."""
    x = ins["X"][0]          # [B, S, H]
    T = ins["Ref"][0].shape[2]
    return {"Out": [x.unsqueeze(2).expand(tuple(x.shape[:2]) + (T,)
                                          + tuple(x.shape[2:]))]}


@register_op("sub_nested_seq")
def _sub_nested_seq(ctx, ins, attrs):
    """Select whole sub-sequences of a nested sequence by per-example
    indices (SubNestedSequenceLayer). X [B, S, T, ...] + InnerLens
    [B, S]; Ids [B, K], where the first -1 ends an example's selection.
    Out [B, K, T, ...], OutInner [B, K] (0 for unused slots), OutOuter
    [B] valid-selection counts."""
    x = ins["X"][0]
    inner = ins["InnerLens"][0]
    idx = ins["Ids"][0].to(torch.int64)          # [B, K]
    S = x.shape[1]
    valid = torch.cumprod((idx != -1).to(torch.int64), dim=1)
    safe = torch.clamp(idx, 0, S - 1)
    feat = tuple(x.shape[2:])
    gidx = safe.reshape(tuple(safe.shape) + (1,) * len(feat)).expand(
        tuple(safe.shape) + feat)
    out = torch.gather(x, 1, gidx) * _trailing(valid, len(feat)).to(x.dtype)
    inner_out = torch.where(valid > 0,
                            torch.gather(inner.to(torch.int64), 1, safe),
                            torch.zeros_like(safe))
    return {"Out": [out], "OutInner": [inner_out],
            "OutOuter": [torch.sum(valid, dim=1)]}


@register_op("seq_slice")
def _seq_slice(ctx, ins, attrs):
    """Per-sample start/end indices cut up to K spans out of every
    (sub-)sequence (SequenceSliceLayer). X [B, R, T, ...] (R = 1 wraps a
    level-1 sequence) + InnerLens [B, R]; Starts / Ends [B, R, K] (or
    [B, K], broadcast over R), where -1 ends that row's selection. Out
    [B, R*K, T, ...], OutInner [B, R*K] span lengths (0 = unused),
    OutOuter [B] valid-span counts; values past a span's length are
    zero, and ends clamp to each row's valid length."""
    x = ins["X"][0]
    inner = ins["InnerLens"][0].to(torch.int32)
    starts = ins["Starts"][0] if ins.get("Starts") else None
    ends = ins["Ends"][0] if ins.get("Ends") else None
    if inner.dim() == 1:                 # level-1 input: one row each
        x = x[:, None]
        inner = inner[:, None]
        if starts is not None and starts.dim() == 2:
            starts = starts[:, None]
        if ends is not None and ends.dim() == 2:
            ends = ends[:, None]
    B, R, T = x.shape[:3]
    if starts is not None and starts.dim() == 2:
        starts = starts[:, None, :].expand(B, R, starts.shape[-1])
    if ends is not None and ends.dim() == 2:
        ends = ends[:, None, :].expand(B, R, ends.shape[-1])
    K = (starts if starts is not None else ends).shape[-1]
    i32 = torch.int32
    live = None
    if starts is not None:
        s32 = starts.to(i32).reshape(B, R, K)
        live = torch.cumprod((s32 != -1).to(i32), dim=2).to(i32)
    if ends is not None:
        e32 = ends.to(i32).reshape(B, R, K)
        lv = torch.cumprod((e32 != -1).to(i32), dim=2).to(i32)
        live = lv if live is None else live * lv
    beg = torch.clamp(s32, 0, T - 1) if starts is not None \
        else torch.zeros((B, R, K), dtype=i32, device=x.device)
    if ends is not None:
        fin = torch.minimum(torch.clamp(e32, 0, T - 1),
                            torch.clamp_min(inner - 1, 0)[:, :, None])
    else:
        fin = (inner - 1)[:, :, None].expand(B, R, K)
    live = live * (inner[:, :, None] > 0)
    slen = torch.where(live > 0, fin - beg + 1, torch.zeros_like(beg))
    slen = torch.clamp_min(slen, 0)
    tt = torch.arange(T, dtype=i32, device=x.device)
    pos = torch.clamp(beg[..., None] + tt, 0, T - 1)      # [B, R, K, T]
    tmask = tt < slen[..., None]
    feat = tuple(x.shape[3:])
    full = (B, R, K, T) + feat
    gather = torch.gather(
        x[:, :, None].expand(full), 3,
        pos.to(torch.int64).reshape((B, R, K, T) + (1,) * len(feat))
        .expand(full))
    out = gather * _trailing(tmask, len(feat)).to(x.dtype)
    out = out.reshape((B, R * K, T) + feat)
    inner_out = slen.reshape(B, R * K).to(torch.int64)
    outer_out = torch.sum((slen > 0).to(torch.int64), dim=(1, 2))
    return {"Out": [out], "OutInner": [inner_out], "OutOuter": [outer_out]}


def _rows_view(x, lens):
    """(Sub-)sequence scores as rows [B, R, T] + lens [B, R]: level-1
    [B, T(, 1)] becomes R = 1; nested [B, S, T(, 1)] keeps S."""
    if x.dim() >= 3 and x.shape[-1] == 1:
        x = x[..., 0]
    if lens.dim() == 1:
        return x[:, None, :], lens[:, None]
    return x, lens


def topk_lower_index_first(x, k):
    """(values, indices) of the k largest entries of the last axis, the
    lower index first among equal values, as `jax.lax.top_k`: a stable
    descending sort. `torch.topk` promises no order among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register_op("kmax_seq_score", differentiable=False)
def _kmax_seq_score(ctx, ins, attrs):
    """Ids of the k = min(beam_size, len) highest scores per
    (sub-)sequence, tail slots -1 (KmaxSeqScoreLayer). X [B, T(,1)] +
    Lens [B] -> Out [B, K]; X [B, S, T(,1)] + Lens [B, S] -> Out
    [B, S, K]."""
    x = ins["X"][0]
    lens = ins["Lens"][0]
    K = int(attrs["beam_size"])
    nested = lens.dim() > 1
    rows, rlens = _rows_view(x, lens)
    T = rows.shape[-1]
    tmask = torch.arange(T, device=x.device) < rlens[..., None]
    masked = torch.where(tmask, rows.to(torch.float32),
                         torch.full((), -1e30, device=x.device))
    _, ids = topk_lower_index_first(masked, min(K, T))
    if K > T:
        ids = torch.nn.functional.pad(ids, (0, K - T))
    valid = torch.arange(K, device=x.device) < rlens[..., None]
    out = torch.where(valid, ids, torch.full_like(ids, -1)).to(torch.int64)
    return {"Out": [out if nested else out[:, 0, :]]}
