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

`legacy_beam_generate` is the legacy in-config generator
(trainer_config_helpers `beam_search` + `GeneratedInput`): the user's
step sub-block replayed `max_length` times in a Python loop, with no
host read inside. `cross_entropy_over_beam` is the beam-training cost:
the reference computes it on the host in float64 numpy, and so does the
port, at one device -> host copy a forward (`beam.host_syncs`).
"""

from __future__ import annotations

import numpy as np
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


@register_op("legacy_beam_generate", differentiable=False)
def _legacy_beam_generate(ctx, ins, attrs):
    """The legacy in-config generation API (trainer_config_helpers
    beam_search + GeneratedInput; RecurrentGradientMachine::
    generateSequence / beamSearch, RecurrentGradientMachine.h:307-309).
    The reference runs it as one `lax.scan`; here it is a Python loop of
    exactly `max_length` steps, no early exit and no host read: each
    step feeds the previous tokens' embeddings to the user step
    sub-block (`lower_block`, replicated per beam), beam_step picks the
    survivors, the memories are re-gathered by parent beam, and
    backtrack resolves the ranked sentences.

    ins: X (captured ancestor vars, tiled per beam), Xc (captured
    parameters, never tiled), Boot (memory boots, [B, ...]), BatchRef
    (a static input that sizes the batch), Emb (the GeneratedInput
    embedding table [V, E]).
    attrs: sub_block, x_names, const_names, emb_step_name, mem_names,
    mem_feedback, out_name, bos_id, end_id, beam_size, num_results,
    max_length.
    outs: SentenceIds [B, R, L] int64 (score-ranked), SentenceScores
    [B, R] float32, SentenceLens [B, R] int64 (length incl. the end
    token, else L)."""
    from .control_flow_ops import lower_block

    K = int(attrs.get("beam_size", 1))
    L = int(attrs.get("max_length", 100))
    R = int(attrs.get("num_results", K))
    bos = int(attrs.get("bos_id", 0))
    eos = int(attrs.get("end_id", 1))

    xs = ins.get("X", [])
    consts = ins.get("Xc", [])
    boots = ins.get("Boot", [])
    emb = ins["Emb"][0]
    x_names = list(attrs["x_names"])
    const_names = list(attrs.get("const_names", []))
    mem_names = list(attrs["mem_names"])
    feedback = list(attrs["mem_feedback"])

    if xs:
        B = int(xs[0].shape[0])
    elif boots:
        B = int(boots[0].shape[0])
    elif ins.get("BatchRef"):
        # a StaticInput the step net never reads still sizes the batch
        B = int(ins["BatchRef"][0].shape[0])
    else:
        raise ValueError("legacy beam_search needs at least one "
                         "StaticInput or memory boot to size the batch")
    dev = emb.device
    if dev.type == "meta":
        i64 = torch.int64
        return {"SentenceIds": [torch.empty((B, R, L), dtype=i64,
                                            device=dev)],
                "SentenceScores": [torch.empty((B, R), device=dev)],
                "SentenceLens": [torch.empty((B, R), dtype=i64,
                                             device=dev)]}

    def tile(v):
        # [B, ...] -> [B*K, ...] (row b repeated K times, beam-major)
        return torch.repeat_interleave(v, K, dim=0)

    base_env = {n: tile(v) for n, v in zip(x_names, xs)}
    base_env.update(zip(const_names, consts))   # params: never tiled
    mems = [tile(b) for b in boots]

    tokens = torch.full((B, K), bos, dtype=torch.int64, device=dev)
    # all K beams start identical: a -1e9 prior on beams 1..K-1 keeps
    # only beam 0's candidates in the first expansion (the reference's
    # spelling of beam_step's first_step flag)
    scores = torch.where(torch.arange(K, device=dev)[None, :] == 0,
                         torch.zeros((), device=dev),
                         torch.full((), _NEG, device=dev)).expand(B, K)
    fin = torch.zeros((B, K), dtype=torch.bool, device=dev)
    ids_steps, par_steps = [], []
    for _ in range(L):
        env = dict(base_env)
        env[attrs["emb_step_name"]] = emb[tokens.reshape(B * K)]
        env.update(zip(mem_names, mems))
        lower_block(ctx, attrs["sub_block"], env)
        out = env[attrs["out_name"]]                      # [B*K, V]
        logp = torch.log(torch.clamp_min(out.to(torch.float32), 1e-20))
        tokens, parents, scores, fin = beam_step(
            scores, logp.reshape(B, K, -1), fin, eos, K)
        # memories follow their surviving parent beams
        new_mems = []
        for name_ in feedback:
            m = env[name_].reshape((B, K) + tuple(env[name_].shape[1:]))
            idx = parents.reshape((B, K) + (1,) * (m.dim() - 2))
            sel = torch.gather(m, 1, idx.expand(m.shape))
            new_mems.append(sel.reshape((B * K,) + tuple(m.shape[2:])))
        mems = new_mems
        ids_steps.append(tokens)
        par_steps.append(parents)

    sentences = backtrack(torch.stack(ids_steps), torch.stack(par_steps))
    ranked, ranked_scores = rank_by_score(sentences, scores)
    ranked, ranked_scores = ranked[:, :R], ranked_scores[:, :R]
    is_eos = ranked == eos
    first_eos = torch.argmax(is_eos.to(torch.int32), dim=-1)
    lens = torch.where(is_eos.any(dim=-1), first_eos + 1,
                       torch.full_like(first_eos, L))
    return {"SentenceIds": [ranked.to(torch.int64)],
            "SentenceScores": [ranked_scores],
            "SentenceLens": [lens.to(torch.int64)]}


# ---------------------------------------------------------------------------
# cross_entropy_over_beam: the beam-level training loss (learning to search)
# ---------------------------------------------------------------------------

def _ce_over_beam_single(flat, starts, idmats, golds, beam_size):
    """CrossEntropyOverBeam for ONE batch element, pure numpy (the
    reference algorithm, CrossEntropyOverBeam.cpp:19-160): walk the
    expansion steps tracking where the gold lives on the beam, stop at
    the step where it falls off (the gold then rides as an extra path),
    enumerate every candidate path of the last valid expansion,
    back-trace each path's row in every earlier expansion, sum the
    per-step scores along each path, and take softmax cross entropy over
    the path totals with the gold path as the hard label.

    flat[i]    : 1-D scores of expansion i (valid rows concatenated)
    starts[i]  : row -> base offset into flat[i]
    idmats[i]  : [R_i, K] selected candidate ids (-1 padded)
    golds[i]   : gold candidate index within its row at step i
    Returns (loss, grads) with grads aligned to `flat`.
    """
    E = len(flat)
    K = beam_size
    gold_row = [0] * E
    gold_col = [-1] * E
    valid = 0
    for i in range(E):
        if i:
            prev = idmats[i - 1].ravel()
            upto = gold_row[i - 1] * K + gold_col[i - 1]
            gold_row[i] = int(np.sum(prev[:upto] != -1))
        valid += 1
        row = idmats[i][gold_row[i]] if gold_row[i] < len(idmats[i]) \
            else np.full((K,), -1.0)
        hits = np.nonzero(row == golds[i])[0]
        if len(hits) == 0:
            break                      # gold fell off the beam here
        gold_col[i] = int(hits[0])
    gold_as_extra = gold_col[valid - 1] == -1

    last = valid - 1
    ids = idmats[last]
    mask = ids.ravel() != -1
    path_count = int(mask.sum())
    n_paths = path_count + (1 if gold_as_extra else 0)
    # enumerate candidate paths of the last expansion row-major
    path_rows = np.zeros((valid, n_paths), dtype=np.int64)
    parents = np.zeros(n_paths, dtype=np.int64)
    cur = 0
    for r in range(ids.shape[0]):
        for c in range(K):
            cid = ids[r, c]
            if cid == -1:
                continue
            path_rows[last, cur] = int(cid) + starts[last][r]
            parents[cur] = r
            cur += 1
    if gold_as_extra:
        path_rows[last, -1] = golds[last] + starts[last][gold_row[last]]
        parents[-1] = gold_row[last]
        gold_path = n_paths - 1
    else:
        goff = gold_row[last] * K + gold_col[last]
        gold_path = int(np.sum(ids.ravel()[:goff] != -1))

    # back-trace every path through the earlier expansions: a path's row
    # at step i+1 IS the flat candidate slot that spawned it at step i
    for b in range(valid - 2, -1, -1):
        ids_b = idmats[b].ravel()
        n_trace = n_paths - 1 if gold_as_extra else n_paths
        for p in range(n_trace):
            flat_idx = parents[p]
            parent_row = int(flat_idx) // K
            path_rows[b, p] = int(ids_b[flat_idx]) + starts[b][parent_row]
            parents[p] = parent_row
        if gold_as_extra:
            path_rows[b, -1] = golds[b] + starts[b][gold_row[b]]

    totals = np.zeros(n_paths, dtype=np.float64)
    for i in range(valid):
        totals += flat[i][path_rows[i]]
    z = totals - totals.max()
    p = np.exp(z)
    p /= p.sum()
    loss = -np.log(max(p[gold_path], 1e-30))

    g = p.copy()
    g[gold_path] -= 1.0
    grads = [np.zeros_like(f) for f in flat]
    for i in range(valid):
        np.add.at(grads[i], path_rows[i], g)
    return loss, grads


def _ce_over_beam_batch(scores, row_lens, ids, golds, beam_size):
    """Batched wrapper over the padded encoding.

    scores[i]  : [B, R_i, T_i] float64 (R_0 == 1 for the level-1 step)
    row_lens[i]: [B, R_i] int   (0-length rows are absent, skipped)
    ids[i]     : [B, R_i, K]
    golds[i]   : [B]
    Returns (loss [B], grads list of [B, R_i, T_i]).
    """
    E = len(scores)
    B = scores[0].shape[0]
    losses = np.zeros(B, np.float32)
    out_grads = [np.zeros_like(s) for s in scores]
    for b in range(B):
        flat, starts, idmats, golds_b, keep = [], [], [], [], []
        for i in range(E):
            lens = row_lens[i][b].astype(np.int64)
            rows = [scores[i][b, r, :lens[r]] for r in range(len(lens))
                    if lens[r] > 0]
            kept = [r for r in range(len(lens)) if lens[r] > 0]
            base, acc = [], 0
            for rr in rows:
                base.append(acc)
                acc += len(rr)
            flat.append(np.concatenate(rows) if rows
                        else np.zeros(0, np.float64))
            starts.append(base)
            idmats.append(ids[i][b][kept] if kept
                          else np.full((1, beam_size), -1.0))
            golds_b.append(int(golds[i][b]))
            keep.append((kept, lens))
        loss, grads = _ce_over_beam_single(flat, starts, idmats, golds_b,
                                           beam_size)
        losses[b] = loss
        for i in range(min(len(grads), E)):
            kept, lens = keep[i]
            off = 0
            for r in kept:
                L = int(lens[r])
                out_grads[i][b, r, :L] = grads[i][off:off + L]
                off += L
    return losses, out_grads


def _to_host_once(tensors):
    """Every tensor's values as float64 numpy arrays through ONE device
    -> host copy: packed on the device into one flat float64 tensor
    (the int ids, lengths and golds are exact in float64)."""
    from .. import monitor
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    host = flat.cpu().numpy()
    if tensors[0].device.type == "cuda":
        monitor.counter_inc("beam.host_syncs")
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(host[off:off + n].reshape(tuple(t.shape)))
        off += n
    return out


class _BeamCost(torch.autograd.Function):
    """The beam cost on the host. Forward copies its operands to the
    host once, computes the loss and the score gradients in one pass of
    the reference's numpy bookkeeping and copies both back; backward
    scales the saved host gradients by the cotangent and reads nothing
    from the device. RowLens / Ids / Gold get no gradient (None: zero,
    as the reference's zeros)."""

    @staticmethod
    def forward(fctx, E, K, *args):
        host = _to_host_once(args)
        losses, grads = _ce_over_beam_batch(
            host[:E], host[E:2 * E], host[2 * E:3 * E], host[3 * E:], K)
        dev = args[0].device
        fctx.grads = [torch.from_numpy(g.astype(np.float32)).to(dev)
                      for g in grads]
        fctx.n_rest = len(args) - E
        return torch.from_numpy(losses).to(dev)

    @staticmethod
    def backward(fctx, ct):
        scaled = [g * ct[:, None, None] for g in fctx.grads]
        return (None, None, *scaled, *([None] * fctx.n_rest))


@register_op("cross_entropy_over_beam")
def _cross_entropy_over_beam(ctx, ins, attrs):
    """Beam-level softmax cross entropy (learning to search), computed on
    the host in float64 numpy as the reference computes it behind
    `pure_callback`: the path bookkeeping is ragged, data-dependent
    control flow, and the reference layer itself is CPU-only
    (CrossEntropyOverBeam.h: "the process of constructing beams is not
    friendly to GPU"). On the card a forward costs one device -> host
    copy, counted on `beam.host_syncs` with the monitor on; its backward
    costs none.

    Inputs (E beam expansions, padded encoding):
      Scores: E tensors [B, R_i, T_i]; RowLens: E tensors [B, R_i];
      Ids: E tensors [B, R_i, K]; Gold: E tensors [B].
    Out: per-sequence loss [B, 1]."""
    from .sequence_ops import _rows_view

    E = int(attrs["num_expansions"])
    K = int(attrs["beam_size"])
    scores, row_lens, ids = [], [], []
    for i in range(E):
        s, rl = _rows_view(ins["Scores"][i].to(torch.float32),
                           ins["RowLens"][i].to(torch.int32))
        idm = ins["Ids"][i].to(torch.float32)
        if idm.dim() == 2:
            idm = idm[:, None, :]
        scores.append(s)
        row_lens.append(rl)
        ids.append(idm)
    golds = [ins["Gold"][i].reshape(-1).to(torch.int32) for i in range(E)]
    B = scores[0].shape[0]
    if scores[0].device.type == "meta":
        return {"Out": [torch.empty((B, 1), device="meta")]}
    loss = _BeamCost.apply(E, K, *scores, *row_lens, *ids, *golds)
    return {"Out": [loss[:, None]]}
