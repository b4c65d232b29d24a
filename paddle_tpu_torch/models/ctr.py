"""CTR models: wide&deep and DeepFM over high-dimensional sparse ids
(the port's copy of `paddle_tpu/models/ctr.py`, the north-star config
"CTR DeepFM / wide&deep (high-dim sparse)" of BASELINE.json).

The reference's CTR story is sparse embedding lookups whose gradients
are SelectedRows (lookup_table's sparse gradient path), pushed to the
optimizers' sparse-apply paths. The port keeps that: the tables are
is_sparse embeddings (selected_rows.py, the `sparse_grad` flag), and
`ep_axis` sets the reference's EP sharding hint on them (ParamAttr
.sharding); one card has no mesh, so the hint only keeps the tables on
the SelectedRows path under `sparse_grad=auto`.

Inputs are field-slot id tensors [B, num_fields] into one shared hashed
vocab (the usual CTR layout), plus optional dense features [B, D].
"""

from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr

__all__ = ["wide_deep", "deepfm", "ctr_cost"]


def _emb(ids, vocab_size, dim, name, ep_axis=None, is_sparse=True):
    attr = ParamAttr(name=name)
    if ep_axis is not None:
        attr.sharding = (ep_axis, None)
    return layers.embedding(input=ids, size=[vocab_size, dim],
                            is_sparse=is_sparse, param_attr=attr)


def wide_deep(sparse_ids, vocab_size, num_fields, emb_dim=16,
              hidden=(64, 32), dense_input=None, ep_axis=None,
              is_sparse=True):
    """Wide & Deep logits [B, 1]: linear over sparse ids + MLP over
    their embeddings (+ dense features in both parts when given)."""
    wide_emb = _emb(sparse_ids, vocab_size, 1, "wide_emb",
                    ep_axis, is_sparse)                      # [B, F, 1]
    wide = layers.reduce_sum(wide_emb, dim=1)                # [B, 1]
    if dense_input is not None:
        wide = wide + layers.fc(input=dense_input, size=1,
                                param_attr=ParamAttr(name="wide_dense.w"),
                                bias_attr=ParamAttr(name="wide_dense.b"))

    deep = layers.reshape(
        _emb(sparse_ids, vocab_size, emb_dim, "deep_emb", ep_axis,
             is_sparse),
        [-1, num_fields * emb_dim])                          # [B, F*k]
    if dense_input is not None:
        deep = layers.concat([deep, dense_input], axis=1)
    for i, h in enumerate(hidden):
        deep = layers.fc(input=deep, size=h, act="relu",
                         param_attr=ParamAttr(name=f"deep_fc{i}.w"),
                         bias_attr=ParamAttr(name=f"deep_fc{i}.b"))
    deep = layers.fc(input=deep, size=1,
                     param_attr=ParamAttr(name="deep_out.w"),
                     bias_attr=ParamAttr(name="deep_out.b"))
    return wide + deep


def deepfm(sparse_ids, vocab_size, num_fields, emb_dim=16,
           hidden=(64, 32), dense_input=None, ep_axis=None,
           is_sparse=True):
    """DeepFM logits [B, 1]: first-order + FM second-order pairwise
    interactions + deep MLP, sharing one embedding table."""
    first = layers.reduce_sum(
        _emb(sparse_ids, vocab_size, 1, "fm_first_emb", ep_axis,
             is_sparse), dim=1)                              # [B, 1]

    v = _emb(sparse_ids, vocab_size, emb_dim, "fm_emb", ep_axis,
             is_sparse)                                      # [B, F, k]
    sum_v = layers.reduce_sum(v, dim=1)                      # [B, k]
    sum_sq = layers.square(sum_v)
    sq_sum = layers.reduce_sum(layers.square(v), dim=1)      # [B, k]
    second = 0.5 * layers.reduce_sum(sum_sq - sq_sum, dim=1,
                                     keep_dim=True)          # [B, 1]

    deep = layers.reshape(v, [-1, num_fields * emb_dim])
    if dense_input is not None:
        deep = layers.concat([deep, dense_input], axis=1)
    for i, h in enumerate(hidden):
        deep = layers.fc(input=deep, size=h, act="relu",
                         param_attr=ParamAttr(name=f"dfm_fc{i}.w"),
                         bias_attr=ParamAttr(name=f"dfm_fc{i}.b"))
    deep = layers.fc(input=deep, size=1,
                     param_attr=ParamAttr(name="dfm_out.w"),
                     bias_attr=ParamAttr(name="dfm_out.b"))
    return first + second + deep


def ctr_cost(logits, label):
    """Mean log-loss on click labels [B, 1] float 0/1."""
    loss = layers.sigmoid_cross_entropy_with_logits(logits, label)
    return layers.mean(loss)
