"""Seq2seq with attention, the NMT flagship (the port's copy of
`paddle_tpu/models/seq2seq.py`; the book's machine_translation.py /
rnn_encoder_decoder.py, the "seq2seq-attention" north-star config).

  * the encoder and decoder recurrences are fused-gate GRUs (time loops
    inside the gru op lowering) over padded [B, T, ...] batches; each
    gate projection is one large product over [B*T, E];
  * attention is global batched-matmul (Luong) attention for all
    decoder steps at once: scores [B, Tt, Ts] = dec @ enc^T, masked by
    the source lengths, softmaxed and applied as one more batched
    matmul;
  * the token loss is masked by the target lengths;
  * generation (`seq2seq_attention_infer`) is the fused
    gru_attention_beam_decode op: the whole beam-search loop as one op.

Parameters carry STABLE names (src_emb, dec_gru.w, ...) so the decode
graph can be built separately and read a trained scope.
"""

from __future__ import annotations

from .. import layers
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["encoder", "attention", "seq2seq_attention_cost",
           "seq2seq_attention", "seq2seq_attention_infer"]


def _p(name):
    return ParamAttr(name=name)


def encoder(src_word, src_vocab_size, emb_dim=512, hid_dim=512,
            bidirectional=True):
    """src_word: int64 ids, lod_level=1. Returns [B, Ts, H(*2)] states."""
    emb = layers.embedding(input=src_word, size=[src_vocab_size, emb_dim],
                           param_attr=_p("src_emb"))
    fwd_proj = layers.fc(input=emb, size=hid_dim * 3,
                         param_attr=_p("enc_fwd_proj.w"),
                         bias_attr=_p("enc_fwd_proj.b"))
    fwd = layers.dynamic_gru(input=fwd_proj, size=hid_dim,
                             param_attr=_p("enc_fwd_gru.w"),
                             bias_attr=_p("enc_fwd_gru.b"))
    if not bidirectional:
        return fwd
    bwd_proj = layers.fc(input=emb, size=hid_dim * 3,
                         param_attr=_p("enc_bwd_proj.w"),
                         bias_attr=_p("enc_bwd_proj.b"))
    bwd = layers.dynamic_gru(input=bwd_proj, size=hid_dim, is_reverse=True,
                             param_attr=_p("enc_bwd_gru.w"),
                             bias_attr=_p("enc_bwd_gru.b"))
    return layers.concat([fwd, bwd], axis=2)


def attention(dec_states, enc_states, src_mask):
    """Global Luong attention for all decoder positions at once.

    dec_states [B, Tt, H], enc_states [B, Ts, He], src_mask [B, Ts].
    Returns context [B, Tt, He].
    """
    # project decoder states into the encoder-state space for the score
    he = int(enc_states.shape[-1])
    query = layers.fc(input=dec_states, size=he, bias_attr=False,
                      num_flatten_dims=2, param_attr=_p("att_query.w"))
    scores = layers.matmul(query, enc_states, transpose_y=True,
                           alpha=float(he) ** -0.5)      # [B, Tt, Ts]
    neg = (layers.unsqueeze(src_mask, [1]) - 1.0) * 1e9   # [B, 1, Ts]
    weights = layers.softmax(scores + neg)
    return layers.matmul(weights, enc_states)             # [B, Tt, He]


def seq2seq_attention(src_word, tgt_word, src_vocab_size, tgt_vocab_size,
                      emb_dim=512, hid_dim=512):
    """Teacher-forced training graph. Returns per-token probs [B, Tt, V]."""
    enc_states = encoder(src_word, src_vocab_size, emb_dim, hid_dim)
    src_mask = layers.sequence_mask(src_word)

    tgt_emb = layers.embedding(input=tgt_word,
                               size=[tgt_vocab_size, emb_dim],
                               param_attr=_p("tgt_emb"))
    dec_proj = layers.fc(input=tgt_emb, size=hid_dim * 3,
                         param_attr=_p("dec_proj.w"),
                         bias_attr=_p("dec_proj.b"))
    dec_states = layers.dynamic_gru(input=dec_proj, size=hid_dim,
                                    param_attr=_p("dec_gru.w"),
                                    bias_attr=_p("dec_gru.b"))

    ctx = attention(dec_states, enc_states, src_mask)
    combined = layers.concat([dec_states, ctx], axis=2)
    attn_h = layers.fc(input=combined, size=hid_dim, act="tanh",
                       num_flatten_dims=2, param_attr=_p("att_combine.w"),
                       bias_attr=_p("att_combine.b"))
    return layers.fc(input=attn_h, size=tgt_vocab_size, act="softmax",
                     num_flatten_dims=2, param_attr=_p("out_proj.w"),
                     bias_attr=_p("out_proj.b"))


def seq2seq_attention_cost(src_word, tgt_word, tgt_next_word,
                           src_vocab_size, tgt_vocab_size,
                           emb_dim=512, hid_dim=512):
    """Masked mean cross-entropy over valid target tokens."""
    probs = seq2seq_attention(src_word, tgt_word, src_vocab_size,
                              tgt_vocab_size, emb_dim, hid_dim)
    token_cost = layers.cross_entropy(input=probs, label=tgt_next_word)
    token_cost = layers.squeeze(token_cost, axes=[2])     # [B, Tt]
    tgt_mask = layers.sequence_mask(tgt_word)             # [B, Tt]
    total = layers.reduce_sum(token_cost * tgt_mask)
    count = layers.reduce_sum(tgt_mask)
    return total / count


def seq2seq_attention_infer(src_word, src_vocab_size, tgt_vocab_size,
                            emb_dim=512, hid_dim=512, beam_size=4,
                            max_len=32, bos_id=1, end_id=2):
    """Beam-search translation graph (beam_size=1 = greedy).

    Builds the SAME encoder (same param names) and one fused
    gru_attention_beam_decode op consuming the training decoder's
    weights, so a trained checkpoint loads straight into this graph.
    Returns (sentence_ids [B,K,max_len], scores [B,K], lens [B,K]).
    """
    enc_states = encoder(src_word, src_vocab_size, emb_dim, hid_dim)
    src_mask = layers.sequence_mask(src_word)

    helper = LayerHelper("gru_attention_beam_decode")
    D, E, V = hid_dim, emb_dim, tgt_vocab_size
    He = int(enc_states.shape[-1])
    weight_shapes = {
        "TgtEmb": ("tgt_emb", [V, E]),
        "DecProjW": ("dec_proj.w", [E, 3 * D]),
        "DecProjB": ("dec_proj.b", [3 * D]),
        "GruW": ("dec_gru.w", [D, 3 * D]),
        "GruB": ("dec_gru.b", [1, 3 * D]),
        "AttQueryW": ("att_query.w", [D, He]),
        "AttCombineW": ("att_combine.w", [D + He, D]),
        "AttCombineB": ("att_combine.b", [D]),
        "OutW": ("out_proj.w", [D, V]),
        "OutB": ("out_proj.b", [V]),
    }
    ins = {"EncStates": [enc_states.name], "SrcMask": [src_mask.name]}
    for slot, (name, shape) in weight_shapes.items():
        p = helper.create_parameter(ParamAttr(name=name), shape, "float32")
        ins[slot] = [p.name]
    ids = helper.create_tmp_variable("int32")
    scores = helper.create_tmp_variable("float32")
    lens = helper.create_tmp_variable("int32")
    helper.append_op("gru_attention_beam_decode", ins,
                     {"SentenceIds": [ids.name],
                      "SentenceScores": [scores.name],
                      "SentenceLen": [lens.name]},
                     {"beam_size": beam_size, "max_len": max_len,
                      "bos_id": bos_id, "end_id": end_id})
    return ids, scores, lens
