"""OCR recognition model (CRNN-style): conv feature extractor ->
sequence over width -> lookahead row_conv context -> CTC.

The port's copy of `paddle_tpu/models/ocr.py`, building the same
program text. The reference's OCR capability is the sum of its parts
rather than one book chapter: warpctc + ctc ops (operators/warpctc_op.cc,
ctc_align_op.h), row_conv (operators/row_conv_op.cc, the DeepSpeech2
streaming context layer) and the CTC evaluators, composed the way the
era's CRNN/DeepSpeech configs did, end to end on padded sequences.
"""

from __future__ import annotations

from .. import layers
from ..framework import seq_len_name

__all__ = ["crnn_ctc", "crnn_ctc_cost"]


def crnn_ctc(images, num_classes, image_lens=None, hidden=96,
             future_context=2):
    """images [B, 1, H, W] (H fixed, W padded) -> logits [B, W', C+1]
    with a @SEQLEN companion derived from image_lens (valid widths).

    Returns the padded per-timestep logits (blank = class 0); W' = W/4
    after two stride-2 pools.
    """
    x = layers.conv2d(images, 16, 3, padding=1, act="relu")
    x = layers.pool2d(x, pool_size=2, pool_stride=2)
    x = layers.conv2d(x, 32, 3, padding=1, act="relu")
    x = layers.pool2d(x, pool_size=2, pool_stride=2)
    # [B, C, H/4, W/4] -> width-major sequence [B, W/4, C*H/4]
    B_, C, H, W = x.shape
    x = layers.transpose(x, [0, 3, 1, 2])
    seq = layers.reshape(x, [-1, W, C * H])

    # sequence lengths: valid widths shrink with the two stride-2 pools
    block = seq.block
    if image_lens is not None:
        lens = layers.cast(
            layers.scale(layers.cast(image_lens, "float32"), 0.25),
            "int32")
    else:
        # batch dim is dynamic (-1) for data layers: materialise one
        # length per batch row in-graph, not a build-time-guessed size
        lens_var = block.create_var(name=seq.name + "@full_lens")
        block.append_op("fill_constant_batch_size_like",
                        {"Input": [seq.name]}, {"Out": [lens_var.name]},
                        {"shape": [-1], "value": float(W), "dtype": "int32",
                         "input_dim_idx": 0, "output_dim_idx": 0})
        lens = lens_var
    sl = block.create_var(name=seq_len_name(seq.name), shape=(-1,),
                          dtype="int32")
    layers.assign(lens, output=sl)
    seq.lod_level = 1
    seq.seq_len_var = sl.name

    h = layers.fc(seq, hidden, num_flatten_dims=2, act="relu")
    h.lod_level, h.seq_len_var = 1, seq.seq_len_var
    h = layers.row_conv(h, future_context_size=future_context, act="relu")
    logits = layers.fc(h, num_classes + 1, num_flatten_dims=2)
    logits.lod_level, logits.seq_len_var = 1, seq.seq_len_var
    return logits


def crnn_ctc_cost(images, label, num_classes, image_lens=None, **kw):
    """Mean CTC loss over the batch; `label` is a padded id sequence
    (lod_level=1). Returns (cost, logits) — logits feed
    ctc_greedy_decoder / evaluator.EditDistance at eval time."""
    logits = crnn_ctc(images, num_classes, image_lens=image_lens, **kw)
    loss = layers.warpctc(logits, label, blank=0)
    return layers.mean(loss), logits
