"""Beam search (the port's copy of `paddle_tpu/ops/beam_ops.py`): the
one-step op, the backtrack op, and the fused whole-decode op of the
seq2seq-attention NMT model.

The ops keep the reference's STATIC [batch, beam] layout: a finished
mask plays the part of the reference's shrinking LoD beam set. The
whole-decode op runs the decode loop (embedding, the SAME GRU cell as
training, Luong attention, the output projection, beam expansion,
backtrack) as a Python loop of torch ops over `max_len` steps.

Ties are broken as the reference breaks them, so the same scores give
the same ids:
  * the top-k of a step puts the lower flat index first among equal
    scores (`jax.lax.top_k`): finished beams and the masked beams of the
    first step produce -1e9 candidates in bulk, so ties are common;
  * the final ranking is a stable argsort of -scores (`jnp.argsort`);
  * a sentence's length stops at its first end token (`jnp.argmax`
    takes the first).
`torch.topk` promises no order among ties and `torch.argsort` is not
stable by default, so both go through a stable sort.

`legacy_beam_generate` (the v2 API's generator) and
`cross_entropy_over_beam` (a host-callback beam-training cost) of the
reference file are not ported (ROADMAP A8).
"""

from __future__ import annotations

import torch

from .registry import register_op
from .rnn_ops import gru_cell
from .sequence_ops import topk_lower_index_first

__all__ = ["beam_step", "backtrack", "rank_by_score",
           "gru_attention_beam_decode"]

_NEG = -1e9


def beam_step(pre_scores, logprobs, finished, end_id, beam_size,
              first_step=False):
    """One beam expansion on the static [B, K] layout.

    pre_scores [B, K] cumulative log-probs; logprobs [B, K, V] this
    step's token log-probs; finished [B, K] bool. Returns (tokens
    [B, K], parents [B, K], scores [B, K], finished [B, K]). A finished
    beam contributes exactly one candidate: end_id, its score unchanged
    (beam_search_op.cc prunes ended hypotheses)."""
    B, K, V = logprobs.shape
    dev = logprobs.device
    is_end = torch.arange(V, device=dev)[None, None, :] == end_id
    cont = torch.where(
        finished[..., None],
        torch.where(is_end, torch.zeros((), device=dev),
                    torch.full((), _NEG, device=dev)),
        logprobs)
    total = pre_scores[..., None] + cont                    # [B, K, V]
    if first_step:
        # all beams hold identical state; keep only beam 0's candidates
        mask = torch.where(torch.arange(K, device=dev) == 0,
                           torch.zeros((), device=dev),
                           torch.full((), _NEG, device=dev))
        total = total + mask[None, :, None]
    top_scores, top_idx = topk_lower_index_first(total.reshape(B, K * V),
                                                 beam_size)
    parents = top_idx // V
    tokens = top_idx % V
    new_finished = torch.gather(finished, 1, parents) | (tokens == end_id)
    return tokens, parents, top_scores, new_finished


def backtrack(ids_steps, parents_steps):
    """Per-step (token, parent) pairs -> sentences: ids_steps,
    parents_steps [L, B, K] -> [B, K, L], row k the k-th final beam's
    tokens (the beam_search_decode_op.cc backward walk)."""
    L, B, K = ids_steps.shape
    parent = torch.arange(K, device=ids_steps.device,
                          dtype=torch.int64)[None, :].expand(B, K)
    toks = [None] * L
    for t in range(L - 1, -1, -1):
        toks[t] = torch.gather(ids_steps[t], 1, parent)
        parent = torch.gather(parents_steps[t].to(torch.int64), 1, parent)
    return torch.stack(toks, dim=2)


def rank_by_score(sentences, scores):
    """Sentences [B, K, L] and scores [B, K] ranked by score, highest
    first; equal scores keep their beam order (the stable
    `jnp.argsort(-scores)`)."""
    order = torch.sort(-scores, dim=1, stable=True).indices   # [B, K]
    ranked = torch.gather(sentences, 1, order[..., None].expand(
        sentences.shape))
    return ranked, torch.gather(scores, 1, order)


@register_op("beam_search", differentiable=False)
def _beam_search(ctx, ins, attrs):
    """One step (beam_search_op.cc) on the static layout: PreScores
    [B, K], Probs [B, K, V] (post-softmax), PreFinished [B, K]. attrs:
    beam_size, end_id, is_first_step. Outputs SelectedIds / ParentIdx
    [B, K] int32, SelectedScores [B, K], Finished [B, K] int32."""
    pre_scores = ins["PreScores"][0].to(torch.float32)
    probs = ins["Probs"][0].to(torch.float32)
    fin = (ins["PreFinished"][0].to(torch.bool) if ins.get("PreFinished")
           else torch.zeros(pre_scores.shape, dtype=torch.bool,
                            device=probs.device))
    logp = torch.log(torch.clamp_min(probs, 1e-20))
    toks, parents, scores, fin = beam_step(
        pre_scores, logp, fin, attrs.get("end_id", 0),
        attrs.get("beam_size", probs.shape[1]),
        first_step=attrs.get("is_first_step", False))
    i32 = torch.int32
    return {"SelectedIds": [toks.to(i32)], "ParentIdx": [parents.to(i32)],
            "SelectedScores": [scores], "Finished": [fin.to(i32)]}


@register_op("beam_search_decode", differentiable=False)
def _beam_search_decode(ctx, ins, attrs):
    """Backtrack (beam_search_decode_op.cc): Ids / ParentIdx [L, B, K]
    from stacked beam_search steps, FinalScores [B, K]. Outputs
    SentenceIds [B, K, L] ranked by score (highest first) and
    SentenceScores [B, K]."""
    ids = ins["Ids"][0]
    sentences = backtrack(ids, ins["ParentIdx"][0])
    ranked, scores = rank_by_score(sentences, ins["FinalScores"][0])
    return {"SentenceIds": [ranked], "SentenceScores": [scores]}


def gru_attention_beam_decode(enc, src_mask, w, beam_size=4, max_len=32,
                              bos_id=1, end_id=2):
    """The whole beam decode of the seq2seq-attention model. `enc`
    [B, Ts, He] encoder states, `src_mask` [B, Ts], `w` the decoder
    weights by the op's slot names (TgtEmb [V, E], DecProjW [E, 3D],
    DecProjB [3D], GruW [D, 3D], GruB [1, 3D], AttQueryW [D, He],
    AttCombineW [D+He, D], AttCombineB [D], OutW [D, V], OutB [V]).
    Returns (SentenceIds [B, K, L] int32 ranked by score, SentenceScores
    [B, K], SentenceLen [B, K] int32: tokens up to and including the
    first end_id, else L). Everything in float32."""
    f32 = torch.float32
    enc = enc.to(f32)
    src_mask = src_mask.to(f32)
    w = {k: v.to(f32) for k, v in w.items()}
    emb, proj_w = w["TgtEmb"], w["DecProjW"]
    proj_b = w["DecProjB"].reshape(-1)
    gru_w, gru_b = w["GruW"], w["GruB"].reshape(-1)
    att_q, comb_w = w["AttQueryW"], w["AttCombineW"]
    comb_b = w["AttCombineB"].reshape(-1)
    out_w, out_b = w["OutW"], w["OutB"].reshape(-1)
    K, L = beam_size, max_len
    B, Ts, He = enc.shape
    D = gru_w.shape[0]
    V = out_w.shape[1]
    dev = enc.device
    scale = torch.tensor(float(He), dtype=f32, device=dev) ** -0.5

    enc_k = torch.repeat_interleave(enc, K, dim=0)          # [B*K, Ts, He]
    mask_k = torch.repeat_interleave(src_mask, K, dim=0)    # [B*K, Ts]
    neg_att = (mask_k - 1.0) * 1e9

    def cell(tokens, h):
        """tokens [B*K], h [B*K, D] -> (logprobs [B*K, V], h_new)."""
        e = emb[tokens]
        xg = torch.matmul(e, proj_w) + proj_b
        h = gru_cell(xg, h, gru_w, gru_b)
        q = torch.matmul(h, att_q)                          # [B*K, He]
        s = torch.matmul(enc_k, q[:, :, None])[:, :, 0] * scale + neg_att
        a = torch.softmax(s, dim=-1)
        ctx_v = torch.matmul(a[:, None, :], enc_k)[:, 0, :]
        ah = torch.tanh(torch.matmul(torch.cat([h, ctx_v], -1), comb_w)
                        + comb_b)
        logits = torch.matmul(ah, out_w) + out_b
        return torch.log_softmax(logits, dim=-1), h

    tokens = torch.full((B * K,), bos_id, dtype=torch.int64, device=dev)
    h = torch.zeros((B * K, D), dtype=f32, device=dev)
    scores = torch.zeros((B, K), dtype=f32, device=dev)
    fin = torch.zeros((B, K), dtype=torch.bool, device=dev)
    base = torch.arange(B, device=dev)[:, None] * K
    ids_steps, par_steps = [], []
    for t in range(L):
        logp, h_new = cell(tokens, h)
        toks, parents, scores, fin = beam_step(
            scores, logp.reshape(B, K, V), fin, end_id, K,
            first_step=(t == 0))
        # reorder the beam state by parent
        h = h_new[(base + parents).reshape(-1)]
        tokens = toks.reshape(-1)
        ids_steps.append(toks)
        par_steps.append(parents)
    sentences = backtrack(torch.stack(ids_steps), torch.stack(par_steps))
    ranked, rscores = rank_by_score(sentences, scores)
    is_eos = (ranked == end_id)
    first_eos = torch.argmax(is_eos.to(torch.int32), dim=-1)
    lens = torch.where(is_eos.any(dim=-1), first_eos + 1,
                       torch.full_like(first_eos, L))
    return (ranked.to(torch.int32), rscores, lens.to(torch.int32))


@register_op("gru_attention_beam_decode", differentiable=False)
def _gru_attention_beam_decode(ctx, ins, attrs):
    """Whole-decode op of the seq2seq-attention NMT model (the reference
    RecurrentGradientMachine's generateSequence / beamSearch, as one
    op). Inputs EncStates [B, Ts, He], SrcMask [B, Ts] and the training
    graph's decoder weights by name (see gru_attention_beam_decode);
    attrs beam_size, max_len, bos_id, end_id. Outputs SentenceIds
    [B, K, L] int32 (score-ranked), SentenceScores [B, K], SentenceLen
    [B, K] int32."""
    enc = ins["EncStates"][0]
    K, L = attrs.get("beam_size", 4), attrs.get("max_len", 32)
    if enc.device.type == "meta":
        B = enc.shape[0]
        return {"SentenceIds": [torch.empty((B, K, L), dtype=torch.int32,
                                            device="meta")],
                "SentenceScores": [torch.empty((B, K), device="meta")],
                "SentenceLen": [torch.empty((B, K), dtype=torch.int32,
                                            device="meta")]}
    w = {slot: vals[0] for slot, vals in ins.items()
         if slot not in ("EncStates", "SrcMask")}
    ids, scores, lens = gru_attention_beam_decode(
        enc, ins["SrcMask"][0], w, K, L, attrs.get("bos_id", 1),
        attrs.get("end_id", 2))
    return {"SentenceIds": [ids], "SentenceScores": [scores],
            "SentenceLen": [lens]}
