"""Decoder-only transformer LM (the port's copy of
`paddle_tpu/models/transformer.py`): pre-norm blocks whose attention is
the fused scaled_dot_product_attention op over the packed [B, T, n*D]
q/k/v planes, or, with `stacked`, one `transformer_stack` op over
stacked [L, ...] weights; the logits head (`transformer_lm`, what the
int8 serving path quantizes), the fused lm-head cross-entropy loss, and
KV-cached generation from the stacked weights
(`transformer_lm_generate`). The same layer calls as the reference, so
both packages build the same Program. Not ported: tensor, sequence and
expert sharding (the port has no device mesh); `pp_axis` and its
pipeline options are recorded on the stacked op, which runs its layers
as the reference does without a mesh.
"""

from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr

__all__ = ["transformer_block", "transformer_lm", "transformer_lm_cost",
           "transformer_lm_generate"]


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


def _stack_param_specs(hid, num_layers, ffn_mult=4):
    """(shape, initializer) per stacked-weight leaf: the one place the
    transformer_stack layout contract lives; the trainer
    (_stacked_blocks) and the decoder (transformer_lm_generate) build
    their 'stack.*' parameters from it."""
    from ..initializer import ConstantInitializer, NormalInitializer

    L, H, F = num_layers, hid, ffn_mult * hid
    shapes = {"Ln1G": [L, H], "Ln1B": [L, H],
              "Wqkv": [L, H, 3 * H], "Bqkv": [L, 3 * H],
              "Wproj": [L, H, H], "Bproj": [L, H],
              "Ln2G": [L, H], "Ln2B": [L, H],
              "Wup": [L, H, F], "Bup": [L, F],
              "Wdown": [L, F, H], "Bdown": [L, H]}
    specs = {}
    for name, shape in shapes.items():
        init = (ConstantInitializer(1.0) if name in ("Ln1G", "Ln2G")
                else ConstantInitializer(0.0) if name.startswith(("B", "Ln"))
                else NormalInitializer(scale=0.02))
        specs[name] = (shape, init)
    return specs


def _stacked_blocks(x, hid, num_layers, num_heads, ffn_mult, pp_axis,
                    num_microbatches, pp_schedule="gpipe"):
    """Emit one fused transformer_stack op over stacked [L, ...]
    weights."""
    from ..layer_helper import LayerHelper
    from ..ops.transformer_ops import _LEAVES

    specs = _stack_param_specs(hid, num_layers, ffn_mult)
    helper = LayerHelper("transformer_stack")
    ins = {"X": [x.name]}
    for name in _LEAVES:
        shape, init = specs[name]
        p = helper.create_parameter(
            ParamAttr(name=f"stack.{name}", initializer=init), shape,
            "float32")
        ins[name] = [p.name]
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("transformer_stack", ins, {"Out": [out.name]},
                     {"num_heads": num_heads, "causal": True,
                      "pp_axis": pp_axis or "", "tp_axis": "",
                      "num_microbatches": num_microbatches,
                      "pp_schedule": pp_schedule})
    return out


def _backbone(tokens, vocab_size, hid, num_layers, num_heads, max_len,
              pp_axis=None, num_microbatches=4, stacked=None,
              pp_schedule="gpipe"):
    """Embedding + blocks + final layer norm -> hidden states [B,T,H].
    stacked=None resolves to `pp_axis is not None`, as in the
    reference."""
    T = int(tokens.shape[1])
    x = layers.embedding(input=tokens, size=[vocab_size, hid],
                         param_attr=ParamAttr(name="tok_emb"))
    pos = layers.create_parameter([max_len, hid], name="pos_emb")
    pos_t = layers.slice(pos, axes=[0], starts=[0], ends=[T])
    x = x + pos_t
    if stacked is None:
        stacked = pp_axis is not None
    if stacked:
        x = _stacked_blocks(x, hid, num_layers, num_heads, 4, pp_axis,
                            num_microbatches, pp_schedule)
    else:
        for i in range(num_layers):
            x = transformer_block(x, hid, num_heads, i)
    return layers.layer_norm(x, begin_norm_axis=2, name="ln_f")


def _head_logits(x, vocab_size):
    """The lm-head projection: one definition, so the logits path and
    the fused loss share the same `lm_head.w`."""
    return layers.fc(input=x, size=vocab_size, num_flatten_dims=2,
                     param_attr=ParamAttr(name="lm_head.w"), bias_attr=False)


def transformer_lm(tokens, vocab_size, hid=256, num_layers=4, num_heads=4,
                   max_len=512, pp_axis=None, num_microbatches=4,
                   stacked=None, pp_schedule="gpipe"):
    """tokens [B, T] or [B, T, 1] int64. Returns logits [B, T, vocab]:
    the reference's `transformer_lm` without mesh axes. stacked=True
    (implied by pp_axis) runs the blocks as one transformer_stack op."""
    x = _backbone(tokens, vocab_size, hid, num_layers, num_heads, max_len,
                  pp_axis, num_microbatches, stacked, pp_schedule)
    return _head_logits(x, vocab_size)


def transformer_lm_cost(tokens, next_tokens, vocab_size, hid=256,
                        num_layers=4, num_heads=4, max_len=512,
                        pp_axis=None, num_microbatches=4, stacked=None,
                        pp_schedule="gpipe"):
    """Causal LM loss (mean token cross-entropy, all positions) through
    the fused lm-head cross-entropy (layers.fused_lm_head_xent), which
    never materializes the [B, T, V] logits: the reference's
    `transformer_lm_cost` without mesh axes and with fused_head=None
    (which resolves to the fused head without tensor parallelism).
    tokens / next_tokens [B, T, 1] int64."""
    x = _backbone(tokens, vocab_size, hid, num_layers, num_heads, max_len,
                  pp_axis, num_microbatches, stacked, pp_schedule)
    loss = layers.fused_lm_head_xent(x, next_tokens, vocab_size,
                                     param_attr=ParamAttr(name="lm_head.w"))
    return layers.mean(loss)


def transformer_lm_generate(prompt, prompt_len, vocab_size, hid=256,
                            num_layers=4, num_heads=4, max_len=512,
                            max_new=32, eos_id=-1, temperature=0.0,
                            adopt_pos_emb=True, scope=None):
    """KV-cached autoregressive generation from the SAME parameters the
    stacked transformer_lm trains (stack.* / tok_emb / pos_emb /
    lm_head.w / ln_f.*): build the training program, train, then build
    this in a program sharing the scope and decode.

    prompt [B, Tp] int64 (right-padded), prompt_len [B]. Returns
    (ids [B, max_new] int64, lens [B]); generation stops per row at
    eos_id (-1 = never).

    adopt_pos_emb / scope: when adopt_pos_emb is True and a trained
    `pos_emb` exists in `scope` (default: the global scope), its length
    overrides a disagreeing `max_len` (with a warning), since a
    mismatched value would declare a conflicting shape against the
    shared parameter. adopt_pos_emb=False pins max_len."""
    from ..initializer import ConstantInitializer
    from ..layer_helper import LayerHelper
    from ..ops.transformer_ops import _LEAVES

    if adopt_pos_emb:
        # the decode lowering still checks the table's length >= prompt
        # + max_new when it runs
        if scope is None:
            from .. import executor as executor_mod
            scope = executor_mod.global_scope()
        trained_pos = scope.get("pos_emb")
        if trained_pos is not None:
            trained_len = int(trained_pos.shape[0])
            if max_len != trained_len:
                import warnings
                warnings.warn(
                    f"transformer_lm_generate: max_len={max_len} does "
                    "not match the trained pos_emb length "
                    f"{trained_len}; using {trained_len} (pass "
                    "adopt_pos_emb=False to pin max_len)", stacklevel=2)
                max_len = trained_len

    specs = _stack_param_specs(hid, num_layers)
    helper = LayerHelper("transformer_decode")
    ins = {"Tokens": [prompt.name], "PromptLen": [prompt_len.name]}
    for name in _LEAVES:
        shape, init = specs[name]
        p = helper.create_parameter(
            ParamAttr(name=f"stack.{name}", initializer=init), shape,
            "float32")
        ins[name] = [p.name]
    emb = helper.create_parameter(ParamAttr(name="tok_emb"),
                                  [vocab_size, hid], "float32")
    pos = helper.create_parameter(ParamAttr(name="pos_emb"),
                                  [max_len, hid], "float32")
    # the stacked trainer's final layer_norm names its parameters
    # ln_f.w_0 (scale) / ln_f.w_1 (shift)
    lnfg = helper.create_parameter(
        ParamAttr(name="ln_f.w_0", initializer=ConstantInitializer(1.0)),
        [hid], "float32")
    lnfb = helper.create_parameter(
        ParamAttr(name="ln_f.w_1", initializer=ConstantInitializer(0.0)),
        [hid], "float32")
    head = helper.create_parameter(ParamAttr(name="lm_head.w"),
                                   [hid, vocab_size], "float32")
    ins.update({"Emb": [emb.name], "Pos": [pos.name],
                "LnFG": [lnfg.name], "LnFB": [lnfb.name],
                "HeadW": [head.name]})
    ids = helper.create_tmp_variable("int64")
    lens = helper.create_tmp_variable("int64")
    helper.append_op("transformer_decode", ins,
                     {"Ids": [ids.name], "Lens": [lens.name]},
                     {"num_heads": num_heads, "max_new": int(max_new),
                      "eos_id": int(eos_id),
                      "temperature": float(temperature)})
    return ids, lens
