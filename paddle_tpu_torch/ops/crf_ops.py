"""Linear-chain CRF ops: log-likelihood training + Viterbi decoding.

The port of `paddle_tpu/ops/crf_ops.py` (operators/linear_chain_crf_op
and crf_decoding_op in the reference, which has no CUDA kernel for
either). Both recursions run over the padded time axis as Python loops
of batched torch ops, masked per row by the lengths, where the
reference runs `lax.scan`.

Transition parameter layout (the reference's contract):
  Transition [K+2, K]: row 0 = start scores, row 1 = end scores,
  rows 2..K+2 = w[i, j], the score of tag i -> tag j.

linear_chain_crf outputs LogLikelihood [B, 1] = -(score - logZ), the
negative log-likelihood, so `mean(crf_cost)` is minimised directly; its
gradient is autograd through the forward recursion.

Ties in Viterbi: `jnp.argmax` takes the first maximum, and so does
`torch.argmax` (documented; held by a test with every score equal), in
the back-pointers and in the last tag (ROADMAP C20). Past a row's
length the back-pointer is the identity, so the backtrack carries the
last tag back to the row's last valid step.
"""

from __future__ import annotations

import torch

from .registry import register_op


def _split_transition(trans):
    return trans[0], trans[1], trans[2:]         # start [K], end [K], w [K, K]


def _labels(label):
    if label.dim() == 3:
        label = label.squeeze(-1)
    return label.to(torch.int64)


@register_op("linear_chain_crf")
def _linear_chain_crf(ctx, ins, attrs):
    """Emission [B, T, K] (unnormalised scores), Transition [K+2, K],
    Label [B, T] or [B, T, 1] int, SeqLen [B].
    Outputs LogLikelihood [B, 1] (= NLL), Alpha [B, T, K]."""
    em = ins["Emission"][0]
    trans = ins["Transition"][0]
    label = _labels(ins["Label"][0])
    seqlen = ins["SeqLen"][0].to(torch.int64)
    B, T, K = em.shape
    if em.device.type == "meta":           # build-time shape inference
        return {"LogLikelihood": [em.new_empty((B, 1))],
                "Alpha": [em.new_empty((B, T, K))]}
    start, end, w = _split_transition(trans)

    # partition function: the masked forward recursion in log space
    alpha = start[None, :] + em[:, 0]                            # [B, K]
    alphas = [alpha]
    active = (torch.arange(T, device=em.device)[:, None]
              < seqlen[None, :]).to(em.dtype)[:, :, None]        # [T, B, 1]
    for t in range(1, T):
        # logsumexp_i alpha[i] + w[i, j]
        new = torch.logsumexp(alpha[:, :, None] + w[None], dim=1) + em[:, t]
        m = active[t]
        alpha = new * m + alpha * (1 - m)
        alphas.append(alpha)
    log_z = torch.logsumexp(alpha + end[None, :], dim=1)         # [B]

    # the gold path's score, masked
    mask = active[:, :, 0].t()                                   # [B, T]
    em_score = (torch.gather(em, 2, label[..., None])[..., 0]
                * mask).sum(dim=1)
    trans_score = (w[label[:, :-1], label[:, 1:]] * mask[:, 1:]).sum(dim=1)
    last_idx = (seqlen - 1).clamp_min(0)
    last_tag = torch.gather(label, 1, last_idx[:, None])[:, 0]
    gold = em_score + trans_score + start[label[:, 0]] + end[last_tag]

    return {"LogLikelihood": [(log_z - gold)[:, None]],
            "Alpha": [torch.stack(alphas, dim=1)]}


@register_op("crf_decoding", differentiable=False)
def _crf_decoding(ctx, ins, attrs):
    """Viterbi decode. Emission [B, T, K], Transition [K+2, K], SeqLen
    [B]. Output ViterbiPath [B, T] int64 (zeros past each length). With
    a Label, the 0/1 correctness mask instead (the reference's
    crf_decoding_op.h behaviour)."""
    em = ins["Emission"][0]
    trans = ins["Transition"][0]
    seqlen = ins["SeqLen"][0].to(torch.int64)
    B, T, K = em.shape
    if em.device.type == "meta":           # build-time shape inference
        return {"ViterbiPath": [em.new_empty((B, T), dtype=torch.int64)]}
    start, end, w = _split_transition(trans)

    delta = start[None, :] + em[:, 0]                            # [B, K]
    active = (torch.arange(T, device=em.device)[:, None]
              < seqlen[None, :])[:, :, None]                     # [T, B, 1]
    ident = torch.arange(K, device=em.device).expand(B, K)
    backptrs = []
    for t in range(1, T):
        scores = delta[:, :, None] + w[None]                     # [B, K, K]
        new, best_prev = torch.max(scores, dim=1)
        delta = torch.where(active[t], new + em[:, t], delta)
        # a step past the length points back at the same tag
        backptrs.append(torch.where(active[t], best_prev, ident))
    tag = torch.argmax(delta + end[None, :], dim=1)              # [B]
    path = [tag]
    for bp in reversed(backptrs):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)
    mask = active[:, :, 0].t()
    path = torch.where(mask, path, 0)

    if ins.get("Label"):
        label = _labels(ins["Label"][0])
        return {"ViterbiPath": [(mask & (path == label)).to(torch.int64)]}
    return {"ViterbiPath": [path]}
