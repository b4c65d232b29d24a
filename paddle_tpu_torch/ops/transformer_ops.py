"""KV-cached transformer block and the LM server's device functions.

The port of `paddle_tpu/ops/transformer_ops.py`'s serving half:
`_cached_block`, `_greedy_pick`, `slot_prefill`, `slot_decode_step`,
`_gather_pages`, `paged_prefill`, `paged_decode_step`, `page_copy`.

Weight layout contract (all leading axis L), as in the reference:
  Ln1G/Ln1B [L,H]  Wqkv [L,H,3H]  Bqkv [L,3H]  Wproj [L,H,H]  Bproj [L,H]
  Ln2G/Ln2B [L,H]  Wup [L,H,F]    Bup [L,F]    Wdown [L,F,H]  Bdown [L,H]
Wqkv/Bqkv columns are HEAD-MAJOR: [n_heads, (q,k,v), head_dim].

Differences from the JAX functions, none of them visible in the tokens:
  * the KV planes are updated IN PLACE (JAX returns new planes and the
    engine donates the old ones); the functions return only tokens;
  * attention goes through `flash_attn_fwd` (the K1 port) instead of
    the plain XLA softmax. K1 zeroes a fully masked row where the plain
    softmax would average it uniformly; the engine never produces such
    a row (every prompt has plen >= 1, and pad rows and dead decode
    slots attend to column 0), so the two agree on every row it reads;
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
    each as a CUDA graph (serving/graphs.py).
Float32 throughout, as the reference engine.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .flash_attention import flash_attn_decode, flash_attn_fwd
from .flash_attention import gather_pages as _gather_pages

__all__ = ["slot_prefill", "slot_decode_step", "paged_prefill",
           "paged_decode_step", "page_copy"]

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


def _greedy_pick(h_vec, lnfg, lnfb, headw):
    """Final norm + head projection + argmax over [B, H] rows (argmax
    returns the first maximum, as jnp.argmax)."""
    logits = torch.matmul(_ln_f32(h_vec, lnfg, lnfb).float(), headw.float())
    return torch.argmax(logits, dim=-1).to(torch.int32)


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


def slot_decode_step(params, emb, pos_tab, lnfg, lnfb, headw, num_heads,
                     ck, cv, tok, pos_idx, live):
    """One fused greedy decode step over ALL slots at the constant
    [max_slots] shape; every per-row op touches only its own row, so a
    row's result does not depend on which other slots are live.

    tok [S] last token per slot, pos_idx [S] the cache position its K/V
    lands in, live [S] bool. Dead slots write at their own plane's
    pos_idx (harmless: the next prefill overwrites and attend_len caps
    reads) and their next token is forced to 0. Returns nxt [S] int32."""
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
    nxt = _greedy_pick(x[:, 0], lnfg, lnfb, headw)
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
