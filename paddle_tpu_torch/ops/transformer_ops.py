"""The stacked transformer: the training op, the program-level KV-cached
generation ops, and the LM server's device functions.

The port of `paddle_tpu/ops/transformer_ops.py`: `_block` and the
`transformer_stack` op (training), `transformer_decode_step` and
`transformer_decode` (generation inside a program), and the serving
half `_cached_block`, `_greedy_pick`, `slot_prefill`, `slot_decode_step`,
`_gather_pages`, `paged_prefill`, `paged_decode_step`, `page_copy`.

Weight layout contract (all leading axis L), as in the reference:
  Ln1G/Ln1B [L,H]  Wqkv [L,H,3H]  Bqkv [L,3H]  Wproj [L,H,H]  Bproj [L,H]
  Ln2G/Ln2B [L,H]  Wup [L,H,F]    Bup [L,F]    Wdown [L,F,H]  Bdown [L,H]
Wqkv/Bqkv columns are HEAD-MAJOR: [n_heads, (q,k,v), head_dim].

`transformer_stack` runs the L pre-norm blocks as a Python loop over the
layers (the reference scans them); attention goes through
`flash_attention_plane`, so K1 runs forward and K2 / K3 + K4 backward,
f32 or bf16 by the operands. Under amp the op's compute role casts X and
the twelve leaves to bf16 and the residual stream stays bf16 through all
L layers, as in the reference's scan. The stacked leaves are split into
layers once each by `torch.unbind`, whose backward stacks the L layer
gradients once (indexing `p[l]` would write a zero [L, ...] gradient per
layer). With the `remat` flag on and grad enabled, each layer runs under
`torch.utils.checkpoint` (non-reentrant: the executor's tape calls
`torch.autograd.grad`), so the backward recomputes it and launches K1
again; with grad off (inference, shape inference on meta tensors) the
plain loop runs, as `jax.checkpoint` does nothing without
differentiation. The port has no device mesh: `pp_axis`, `tp_axis`,
`num_microbatches` and `pp_schedule` are accepted, so the Program text
is the JAX front end's, and the plain loop runs, which is what the
reference runs without a mesh.

Differences from the JAX functions, none of them visible in the tokens:
  * the KV planes are updated IN PLACE (JAX returns new planes and the
    engine donates the old ones); the functions return only tokens;
  * attention goes through `flash_attn_fwd` (the K1 port) instead of
    the plain XLA softmax. K1 zeroes a fully masked row where the plain
    softmax would average it uniformly; the engine and
    `transformer_decode` never produce such a row (every prompt has
    plen >= 1, and pad rows and dead decode slots attend to column 0),
    so the two agree on every row they read;
  * the paged functions scatter the new K/V rows into their pages
    first and then attend, instead of writing into a gathered view and
    scattering back. Positions < plen read the same values either way;
    the rest are masked;
  * the paged decode step gathers nothing: its attention
    (`flash_attn_decode`) reads each row's keys through its page table
    straight from the pool planes. The paged prefill still gathers each
    row's page view (K1 at Tq > 1 takes contiguous views);
  * the slab prefill drops its pad rows' writes by sending each to a
    slot that no row writes, which takes its own values back (the
    reference scatters with mode="drop"), and `page_copy` takes its
    page ids as device tensors:
    no function reads a value back to the host, so the engine captures
    each as a CUDA graph (serving/graphs.py);
  * `transformer_decode` samples (temperature > 0) from the executor's
    `torch.Generator`, not JAX's key: the draws differ by design; its
    greedy tokens are the reference's. It skips the reference's last
    decode forward, whose token no output holds.
Float32 throughout the serving and generation functions, as the
reference engine.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .flash_attention import (flash_attention_plane, flash_attn_decode,
                              flash_attn_fwd)
from .flash_attention import gather_pages as _gather_pages
from .registry import register_op

__all__ = ["run_stack", "stacked_layers", "slot_prefill",
           "slot_decode_step", "paged_prefill", "paged_decode_step",
           "page_copy"]

_LEAVES = ["Ln1G", "Ln1B", "Wqkv", "Bqkv", "Wproj", "Bproj",
           "Ln2G", "Ln2B", "Wup", "Bup", "Wdown", "Bdown"]


def _ln_f32(v, g, b, eps=1e-5):
    """f32-statistics layer norm with the reference's explicit centered
    two-pass variance (not torch's fused layer_norm, whose summation
    differs)."""
    vf = v.float()
    mu = vf.mean(dim=-1, keepdim=True)
    var = (vf - mu).square().mean(dim=-1, keepdim=True)
    return ((vf - mu) / torch.sqrt(var + eps) * g + b).to(v.dtype)


def _layer(params, l):
    return tuple(p[l] for p in params)


def _block(params, x, num_heads, causal, eps=1e-5):
    """One pre-norm transformer block (the reference's `_block` without
    tensor parallelism); params = tuple in _LEAVES order.

    The head split is on the weight side: the [H, n, 3, D] qkv columns
    are sliced into per-role [H, n*D] planes, so the products give q, k
    and v as packed [B, T, n*D] planes, which `flash_attention_plane`
    views head-major by strides; no activation transpose is made."""
    (ln1g, ln1b, wqkv, bqkv, wproj, bproj,
     ln2g, ln2b, wup, bup, wdown, bdown) = params
    H = x.shape[-1]
    n = num_heads
    D = H // n

    h = _ln_f32(x, ln1g, ln1b, eps)
    wr = wqkv.view(H, n, 3, D)
    br = bqkv.view(n, 3, D)
    q, k, v = (torch.matmul(h, wr[:, :, m].reshape(H, n * D))
               + br[:, m].reshape(n * D) for m in range(3))
    attn = flash_attention_plane(q, k, v, n, causal=causal)
    x = x + torch.matmul(attn, wproj) + bproj

    h = _ln_f32(x, ln2g, ln2b, eps)
    up = F.gelu(torch.matmul(h, wup) + bup, approximate="tanh")
    return x + torch.matmul(up, wdown) + bdown


def stacked_layers(params):
    """The per-layer weight tuples of the stacked leaves (in _LEAVES
    order): one `torch.unbind` a leaf, whose backward stacks the layer
    gradients once."""
    return zip(*(torch.unbind(p, 0) for p in params))


def run_stack(x, layers, num_heads, causal=True):
    """x [B, T, H] through each layer's `_block`; `layers` iterates the
    per-layer weight tuples. Each layer is checkpointed when the `remat`
    flag is on and autograd records (not on meta tensors)."""
    from .. import flags
    H = x.shape[-1]
    if H % num_heads:
        raise ValueError(f"transformer_stack: hidden size {H} is not "
                         f"divisible by num_heads={num_heads}")
    remat = (flags.get("remat") and torch.is_grad_enabled()
             and x.device.type != "meta")
    for lp in layers:
        if remat:
            x = checkpoint(_block, lp, x, num_heads, causal,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block(lp, x, num_heads, causal)
    return x


@register_op("transformer_stack")
def _transformer_stack(ctx, ins, attrs):
    """X [B,T,H] + the twelve stacked leaves -> Out [B,T,H]. attrs:
    num_heads, causal; pp_axis, tp_axis, num_microbatches, pp_schedule
    (accepted; without a mesh the reference runs the plain scan too)."""
    params = tuple(ins[name][0] for name in _LEAVES)
    out = run_stack(ins["X"][0], stacked_layers(params),
                    attrs.get("num_heads", 1), attrs.get("causal", True))
    return {"Out": [out]}


def _cached_block(params, x, write_idx, attend_len, num_heads, store):
    """One pre-norm block with a KV cache (the port of the reference's
    `_cached_block`; same weight layout contract).

    x [B,S,H] new positions at global positions write_idx[b] + s;
    attend_len [B] valid cache entries after the write. `store(k, v)`
    takes the new K/V rows [B,n,S,D], writes them into the cache and
    returns what to attend over: the [B,n,Tk,D] K/V views (the slab
    planes, the gathered page views, or the new rows themselves for a
    fresh prefill cache), or, for the paged decode step (S = 1), the
    pool planes [P,n,page_len,D] and the page tables [B,m], which
    `flash_attn_decode` reads through. Causality inside the S window
    follows position order. Returns the block output [B,S,H]."""
    (ln1g, ln1b, wqkv, bqkv, wproj, bproj,
     ln2g, ln2b, wup, bup, wdown, bdown) = params
    B, S, H = x.shape
    n = num_heads
    D = H // n

    h = _ln_f32(x, ln1g, ln1b)
    qkv = (torch.matmul(h, wqkv) + bqkv).view(B, S, n, 3, D)
    q, k, v = (qkv[:, :, :, m].transpose(1, 2) for m in range(3))  # [B,n,S,D]
    kv = store(k, v)
    scale = 1.0 / float(np.sqrt(D))
    if len(kv) == 3:            # pool planes + page tables
        ck, cv, tables = kv
        attn, _ = flash_attn_decode(q, ck, cv, tables, ck.shape[2],
                                    attend_len, write_idx, scale)
    else:
        attn, _ = flash_attn_fwd(q, *kv, attend_len, write_idx, causal=True,
                                 scale=scale)
    attn = attn.transpose(1, 2).reshape(B, S, H)
    x = x + torch.matmul(attn, wproj) + bproj

    h = _ln_f32(x, ln2g, ln2b)
    up = F.gelu(torch.matmul(h, wup) + bup, approximate="tanh")
    return x + torch.matmul(up, wdown) + bdown


def _head_logits(h_vec, lnfg, lnfb, headw):
    """Final norm + head projection of [B, H] rows -> f32 [B, V]."""
    return torch.matmul(_ln_f32(h_vec, lnfg, lnfb).float(), headw.float())


def _greedy_pick(h_vec, lnfg, lnfb, headw):
    """Final norm + head projection + argmax over [B, H] rows (argmax
    returns the first maximum, as jnp.argmax)."""
    return torch.argmax(_head_logits(h_vec, lnfg, lnfb, headw),
                        dim=-1).to(torch.int32)


def _embed(emb, pos_tab, toks, pos):
    return emb[toks.long()] + pos_tab[pos.long()]


def _slot_targets(slots, S):
    """The slab prefill's writes without a value-dependent shape: (tgt
    [b] int64, writes [b] bool). A row writes its slot when the id is in
    [0, S) and it is the slot's first row; every other row (the pad rows
    and ids >= S, which the reference's scatter drops, or a second row
    on one slot) gets its own slot that no row writes, and writes that
    slot's own values back. So tgt holds b distinct slots (b <= S) and
    no two writes hit one slot."""
    b = slots.shape[0]
    if b > S:
        raise ValueError(f"slot_prefill: {b} rows for {S} slots")
    dev = slots.device
    dst = slots.long()
    rows = torch.arange(b, device=dev)
    hits = dst[None, :] == torch.arange(S, device=dev)[:, None]   # [S,b]
    used = hits.any(dim=1)
    first = hits.int().argmax(dim=1)                # each slot's writer
    inside = (dst >= 0) & (dst < S)
    writes = inside & (first[dst.clamp(0, S - 1)] == rows)
    # the k-th dropped row takes the k-th slot that no row writes
    k = torch.cumsum((~writes).long(), 0) - 1
    free = torch.cumsum((~used).long(), 0) - 1
    spare = ((free[None, :] == k[:, None]) & ~used[None, :]).int().argmax(1)
    return torch.where(writes, dst.clamp(0, S - 1), spare), writes


def slot_prefill(params, emb, pos_tab, lnfg, lnfb, headw, num_heads,
                 ck, cv, toks, plen, slots):
    """Prefill padded prompts into per-slot KV planes.

    ck/cv [L,S,n,Tcap,D] slot planes (updated in place); toks [b,t]
    right-padded prompts (b <= S), plen [b] valid lengths, slots [b]
    destination slot ids. Pad rows carry slot ids >= S: the reference
    drops their writes (scatter mode="drop"). Here every row copies its
    K/V into cache rows 0..t-1 of one slot of `_slot_targets`: its own,
    or a spare slot that takes its own values back, so no shape depends
    on the data (the dispatch can be captured in a CUDA graph) and no
    two writes hit one slot. Returns tok0 [b] int32, the greedy token
    at each row's last valid position."""
    b, t = toks.shape
    L, S = ck.shape[0], ck.shape[1]
    dev = toks.device
    zero = torch.zeros((b,), dtype=torch.int32, device=dev)
    x = _embed(emb, pos_tab, toks, torch.arange(t, device=dev)[None])
    tgt, writes = _slot_targets(slots, S)
    writes = writes[:, None, None, None]

    for l in range(L):
        def store(k, v, l=l):
            # attention runs over the fresh cache = exactly the new rows
            for c, new in ((ck, k), (cv, v)):
                view = c[l, :, :, :t]
                view.index_copy_(0, tgt, torch.where(
                    writes, new, view.index_select(0, tgt)))
            return k, v
        x = _cached_block(_layer(params, l), x, zero, plen, num_heads,
                          store)
    last = (plen.long() - 1).clamp(0, t - 1)
    h_last = x[torch.arange(b, device=dev), last]
    return _greedy_pick(h_last, lnfg, lnfb, headw)


def _decode_hidden(params, emb, pos_tab, num_heads, ck, cv, tok, pos_idx):
    """The last layer's output [S, H] of one decode step over slab planes
    ck/cv [L,S,n,Tcap,D] (updated in place): each row's K/V lands at its
    pos_idx and attends to cache positions <= pos_idx."""
    L, S, _, Tcap, _ = ck.shape
    dev = tok.device
    x = _embed(emb, pos_tab, tok, pos_idx)[:, None]          # [S,1,H]
    rows = torch.arange(S, device=dev)
    # dynamic_update_slice clamps its start index; mirror it
    wpos = pos_idx.long().clamp(0, Tcap - 1)

    for l in range(L):
        def store(k, v, l=l):
            ck[l, rows, :, wpos] = k[:, :, 0]
            cv[l, rows, :, wpos] = v[:, :, 0]
            return ck[l], cv[l]
        x = _cached_block(_layer(params, l), x, pos_idx, pos_idx + 1,
                          num_heads, store)
    return x[:, 0]


def slot_decode_step(params, emb, pos_tab, lnfg, lnfb, headw, num_heads,
                     ck, cv, tok, pos_idx, live):
    """One fused greedy decode step over ALL slots at the constant
    [max_slots] shape; every per-row op touches only its own row, so a
    row's result does not depend on which other slots are live.

    tok [S] last token per slot, pos_idx [S] the cache position its K/V
    lands in, live [S] bool. Dead slots write at their own plane's
    pos_idx (harmless: the next prefill overwrites and attend_len caps
    reads) and their next token is forced to 0. Returns nxt [S] int32."""
    h = _decode_hidden(params, emb, pos_tab, num_heads, ck, cv, tok,
                       pos_idx)
    nxt = _greedy_pick(h, lnfg, lnfb, headw)
    return torch.where(live, nxt, torch.zeros_like(nxt))


def _page_targets(tables, pos, valid, pl):
    """(page id, offset) per position, flattened; invalid positions
    (bucket padding, pad rows) go to the trash page 0."""
    m = tables.shape[1]
    slot = torch.div(pos, pl, rounding_mode="floor").clamp(0, m - 1)
    pid = torch.where(valid, torch.gather(tables.long(), 1, slot),
                      torch.zeros((), dtype=torch.long, device=pos.device))
    return pid.reshape(-1), (pos % pl).reshape(-1)


def paged_prefill(params, emb, pos_tab, lnfg, lnfb, headw, num_heads,
                  ck, cv, toks, start, plen, tables):
    """Prefill prompt suffixes through per-sequence page tables.

    ck/cv [L, P, n, page_len, D] page-pool planes (page 0 = trash),
    updated in place. toks [b, t] right-padded SUFFIX tokens, start [b]
    global position of each row's first suffix token (> 0 after a
    prefix-cache hit), plen [b] total valid length, tables [b, m] page
    ids covering positions [0, m*page_len), 0 on unbacked slots.
    Positions at or beyond plen write to the trash page. Returns tok0
    [b] int32 at each row's last valid position."""
    b, t = toks.shape
    L = ck.shape[0]
    n, pl, D = ck.shape[2], ck.shape[3], ck.shape[4]
    dev = toks.device
    pos = start.long()[:, None] + torch.arange(t, device=dev)[None, :]
    x = _embed(emb, pos_tab, toks, pos.clamp(0, pos_tab.shape[0] - 1))
    pid, off = _page_targets(tables, pos, pos < plen.long()[:, None], pl)

    for l in range(L):
        def store(k, v, l=l):
            # duplicate targets only ever hit the trash page
            ck[l, pid, :, off] = k.transpose(1, 2).reshape(b * t, n, D)
            cv[l, pid, :, off] = v.transpose(1, 2).reshape(b * t, n, D)
            return _gather_pages(ck[l], tables), _gather_pages(cv[l], tables)
        x = _cached_block(_layer(params, l), x, start, plen, num_heads,
                          store)
    last = (plen.long() - 1 - start.long()).clamp(0, t - 1)
    h_last = x[torch.arange(b, device=dev), last]
    return _greedy_pick(h_last, lnfg, lnfb, headw)


def paged_decode_step(params, emb, pos_tab, lnfg, lnfb, headw, num_heads,
                      ck, cv, tok, pos_idx, live, tables):
    """One fused greedy decode step through page tables at the constant
    [max_slots] shape. Attention reads each row's keys through its own
    table, straight from the pool planes (no gathered view), and cuts
    them by the row's own length only, so co-batched rows stay bitwise
    independent. Dead rows carry all-zero tables and live=False: their
    write lands on the trash page and their next token is forced to 0.
    Returns nxt [S] int32."""
    L = ck.shape[0]
    pl = ck.shape[3]
    x = _embed(emb, pos_tab, tok, pos_idx)[:, None]          # [S,1,H]
    pid, off = _page_targets(tables, pos_idx.long()[:, None],
                             live[:, None], pl)

    for l in range(L):
        def store(k, v, l=l):
            ck[l, pid, :, off] = k[:, :, 0]
            cv[l, pid, :, off] = v[:, :, 0]
            return ck[l], cv[l], tables
        x = _cached_block(_layer(params, l), x, pos_idx, pos_idx + 1,
                          num_heads, store)
    nxt = _greedy_pick(x[:, 0], lnfg, lnfb, headw)
    return torch.where(live, nxt, torch.zeros_like(nxt))


def page_copy(ck, cv, src, dst):
    """Copy one page's K/V rows across the pool planes in place — the
    copy-on-write split of a shared partial tail page. dst must be
    exclusively owned. src and dst are page ids: Python ints, or int64
    tensors [1] on the planes' device (the engine's captured rung reads
    them from its static inputs)."""
    src, dst = (torch.as_tensor(p, dtype=torch.long,
                                device=ck.device).reshape(1)
                for p in (src, dst))
    for c in (ck, cv):
        c.index_copy_(1, dst, c.index_select(1, src))


# -- the program-level generation ops -----------------------------------------

def _cache_out(ctx, ins, slot):
    """The cache plane `slot` that the op writes in place: the input
    itself when the op's output var is the input var, else a copy, so an
    input var never changes under the program."""
    op = getattr(ctx, "op", None)
    c = ins[slot][0]
    if op is not None and op.output(slot + "Out") == op.input(slot):
        return c
    return c.clone()


@register_op("transformer_decode_step", differentiable=False,
             stateful=True)
def _transformer_decode_step(ctx, ins, attrs):
    """One continuous-batching decode step over a slotted KV cache (the
    op-level spelling of the LM engine's slab decode step).

    ins: Tok [S] int, PosIdx [S] int, Live [S] bool/int,
         CacheK/CacheV [L,S,n,Tcap,D], Emb [V,H], Pos [maxcap,H],
         LnFG/LnFB [H], HeadW [H,V] + the _LEAVES stacked weights.
    attrs: num_heads.
    outs: Next [S] int64 (0 for dead slots), CacheKOut, CacheVOut: the
    planes with each slot's new K/V row written at its PosIdx, in place
    when the output var is the input var (else into a copy)."""
    tok = ins["Tok"][0]
    ck, cv = _cache_out(ctx, ins, "CacheK"), _cache_out(ctx, ins, "CacheV")
    if tok.device.type == "meta":
        return {"Next": [torch.empty(tok.shape, dtype=torch.int64,
                                     device="meta")],
                "CacheKOut": [ck], "CacheVOut": [cv]}
    params = tuple(ins[name][0] for name in _LEAVES)
    nxt = slot_decode_step(
        params, ins["Emb"][0], ins["Pos"][0], ins["LnFG"][0],
        ins["LnFB"][0], ins["HeadW"][0], int(attrs["num_heads"]), ck, cv,
        tok.to(torch.int32), ins["PosIdx"][0].to(torch.int32),
        ins["Live"][0].to(torch.bool))
    return {"Next": [nxt.to(torch.int64)], "CacheKOut": [ck],
            "CacheVOut": [cv]}


@register_op("transformer_decode", differentiable=False, stateful=True)
def _transformer_decode(ctx, ins, attrs):
    """KV-cached autoregressive decoding over the stacked-weight
    transformer LM: the ragged prompts prefill contiguous per-layer
    caches [L, B, n, Tp + max_new, D] in one pass (K1 at Tq = Tp), then
    one token a step (K1's decode kernel at Tq = 1).

    ins: Tokens [B,Tp] int (right-padded prompts), PromptLen [B],
         Emb [V,H], Pos [maxcap,H], LnFG/LnFB [H], HeadW [H,V],
         + the _LEAVES stacked weights.
    attrs: num_heads, max_new, eos_id (-1 = never stop),
           temperature (0 = greedy; > 0 samples from the executor's
           generator).
    outs: Ids [B,max_new] int64, Lens [B] int64 (tokens up to AND
          including the first eos)."""
    toks = ins["Tokens"][0]
    plen = ins["PromptLen"][0].reshape(-1).to(torch.int32)
    emb, pos = ins["Emb"][0], ins["Pos"][0]
    lnfg, lnfb, headw = ins["LnFG"][0], ins["LnFB"][0], ins["HeadW"][0]
    params = tuple(ins[name][0] for name in _LEAVES)
    n = int(attrs["num_heads"])
    max_new = int(attrs["max_new"])
    eos = int(attrs.get("eos_id", -1))
    temp = float(attrs.get("temperature", 0.0))

    B, Tp = toks.shape
    L, H = params[0].shape
    D = H // n
    Tcap = Tp + max_new
    if pos.shape[0] < Tcap:
        raise ValueError(
            f"transformer_decode: pos table {pos.shape[0]} is shorter "
            f"than prompt+max_new = {Tcap}")
    dev = toks.device
    if dev.type == "meta":
        return {"Ids": [torch.empty((B, max_new), dtype=torch.int64,
                                    device=dev)],
                "Lens": [torch.empty((B,), dtype=torch.int64, device=dev)]}
    ck = torch.zeros((L, B, n, Tcap, D), dtype=emb.dtype, device=dev)
    cv = torch.zeros_like(ck)

    def pick(h_vec):
        logits = _head_logits(h_vec, lnfg, lnfb, headw)
        if temp > 0:
            probs = torch.softmax(logits / temp, dim=-1)
            return torch.multinomial(probs, 1, generator=ctx.generator
                                     )[:, 0].to(torch.int32)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    # prefill: the whole padded prompt in one pass, attending over its
    # own new rows (every key it may see is among them)
    x = _embed(emb, pos, toks, torch.arange(Tp, device=dev)[None])
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    for l in range(L):
        def store(k, v, l=l):
            ck[l, :, :, :Tp] = k
            cv[l, :, :, :Tp] = v
            return k, v
        x = _cached_block(_layer(params, l), x, zero, plen, n, store)
    last = (plen.long() - 1).clamp(0, Tp - 1)
    tok = pick(x[torch.arange(B, device=dev), last])

    # `fin` = the sequence ended BEFORE `tok` was generated (tok is
    # eos-fill); tok itself may be the first eos, which still counts
    # toward the emitted length
    fin = torch.zeros((B,), dtype=torch.bool, device=dev)
    ids, fins = [tok], [fin]
    for t in range(max_new - 1):
        h = _decode_hidden(params, emb, pos, n, ck, cv, tok, plen + t)
        nxt = pick(h)
        if eos >= 0:
            fin = fin | (tok == eos)
            nxt = torch.where(fin, torch.full_like(nxt, eos), nxt)
        tok = nxt
        ids.append(tok)
        fins.append(fin)
    ids = torch.stack(ids, dim=1)[:, :max_new]
    lens = (~torch.stack(fins, dim=1)[:, :max_new]).sum(dim=1)
    return {"Ids": [ids.to(torch.int64)], "Lens": [lens.to(torch.int64)]}
