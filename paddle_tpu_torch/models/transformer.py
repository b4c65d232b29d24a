"""Decoder-only transformer LM (the port's copy of the unstacked path
of `paddle_tpu/models/transformer.py`): pre-norm blocks whose attention
is the fused scaled_dot_product_attention op over the packed [B, T, n*D]
q/k/v planes; the logits head (`transformer_lm`, what the int8 serving
path quantizes) and the fused lm-head cross-entropy loss. The same
layer calls as the reference, so both packages build the same Program.
Not ported yet: the scan-stacked `transformer_stack` (and with it pipeline
parallelism), tensor/sequence/expert sharding, and the decode op.
"""

from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr

__all__ = ["transformer_block", "transformer_lm", "transformer_lm_cost"]


def transformer_block(x, hid, num_heads, idx, ffn_mult=4):
    """One pre-norm block in the PACKED activation layout: q/k/v stay
    [B, T, n*D] planes (head h owns columns h*D:(h+1)*D) from the qkv fc
    straight into the attention op, which views them head-major by
    strides."""
    pre = f"block{idx}"
    h = layers.layer_norm(x, begin_norm_axis=2, name=f"{pre}.ln1")
    qkv = layers.fc(input=h, size=3 * hid, num_flatten_dims=2,
                    param_attr=ParamAttr(name=f"{pre}.qkv.w"),
                    bias_attr=ParamAttr(name=f"{pre}.qkv.b"))
    q = layers.slice(qkv, axes=[2], starts=[0], ends=[hid])
    k = layers.slice(qkv, axes=[2], starts=[hid], ends=[2 * hid])
    v = layers.slice(qkv, axes=[2], starts=[2 * hid], ends=[3 * hid])
    attn = layers.scaled_dot_product_attention(
        q, k, v, num_heads=num_heads, causal=True)
    proj = layers.fc(input=attn, size=hid, num_flatten_dims=2,
                     param_attr=ParamAttr(name=f"{pre}.proj.w"),
                     bias_attr=ParamAttr(name=f"{pre}.proj.b"))
    x = x + proj

    h = layers.layer_norm(x, begin_norm_axis=2, name=f"{pre}.ln2")
    up = layers.fc(input=h, size=ffn_mult * hid, num_flatten_dims=2,
                   act="gelu", param_attr=ParamAttr(name=f"{pre}.ffn_up.w"),
                   bias_attr=ParamAttr(name=f"{pre}.ffn_up.b"))
    down = layers.fc(input=up, size=hid, num_flatten_dims=2,
                     param_attr=ParamAttr(name=f"{pre}.ffn_down.w"),
                     bias_attr=ParamAttr(name=f"{pre}.ffn_down.b"))
    return x + down


def _backbone(tokens, vocab_size, hid, num_layers, num_heads, max_len):
    """Embedding + blocks + final layer norm -> hidden states [B,T,H]."""
    T = int(tokens.shape[1])
    x = layers.embedding(input=tokens, size=[vocab_size, hid],
                         param_attr=ParamAttr(name="tok_emb"))
    pos = layers.create_parameter([max_len, hid], name="pos_emb")
    pos_t = layers.slice(pos, axes=[0], starts=[0], ends=[T])
    x = x + pos_t
    for i in range(num_layers):
        x = transformer_block(x, hid, num_heads, i)
    return layers.layer_norm(x, begin_norm_axis=2, name="ln_f")


def _head_logits(x, vocab_size):
    """The lm-head projection: one definition, so the logits path and
    the fused loss share the same `lm_head.w`."""
    return layers.fc(input=x, size=vocab_size, num_flatten_dims=2,
                     param_attr=ParamAttr(name="lm_head.w"), bias_attr=False)


def transformer_lm(tokens, vocab_size, hid=256, num_layers=4, num_heads=4,
                   max_len=512):
    """tokens [B, T] or [B, T, 1] int64. Returns logits [B, T, vocab]:
    the reference's `transformer_lm` with stacked=None and no mesh
    axes."""
    x = _backbone(tokens, vocab_size, hid, num_layers, num_heads, max_len)
    return _head_logits(x, vocab_size)


def transformer_lm_cost(tokens, next_tokens, vocab_size, hid=256,
                        num_layers=4, num_heads=4, max_len=512):
    """Causal LM loss (mean token cross-entropy, all positions) through
    the fused lm-head cross-entropy (layers.fused_lm_head_xent), which
    never materializes the [B, T, V] logits: the reference's
    `transformer_lm_cost` with stacked=None, no mesh axes and
    fused_head=None (which resolves to the fused head without tensor
    parallelism). tokens / next_tokens [B, T, 1] int64."""
    x = _backbone(tokens, vocab_size, hid, num_layers, num_heads, max_len)
    loss = layers.fused_lm_head_xent(x, next_tokens, vocab_size,
                                     param_attr=ParamAttr(name="lm_head.w"))
    return layers.mean(loss)
