"""Miscellaneous op lowerings (the port of the part of
`paddle_tpu/ops/misc_ops.py` the control-flow, recurrent_group and OCR
programs run): `fill_constant_batch_size_like` (a recurrent_group
memory's zero boot, the OCR model's full-width lengths), `is_empty` and
`lod_reset` (a new lengths vector for a padded sequence).
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import register_op, torch_dtype


@register_op("fill_constant_batch_size_like", differentiable=False)
def _fill_constant_bsl(ctx, ins, attrs):
    """A constant fill whose `output_dim_idx` dim copies the input's
    `input_dim_idx` dim (fill_constant_batch_size_like_op.cc)."""
    x = ins["Input"][0]
    shape = [int(s) for s in attrs["shape"]]
    shape[attrs.get("output_dim_idx", 0)] = int(
        x.shape[attrs.get("input_dim_idx", 0)])
    return {"Out": [torch.full(shape, attrs.get("value", 0.0),
                               dtype=torch_dtype(attrs.get("dtype",
                                                           "float32")),
                               device=ctx.device)]}


@register_op("is_empty", differentiable=False)
def _is_empty(ctx, ins, attrs):
    """[1] bool: whether X has no elements (is_empty_op.cc). Shapes are
    known on the host, so nothing is read from the card."""
    return {"Out": [torch.full((1,), ins["X"][0].numel() == 0,
                               dtype=torch.bool, device=ctx.device)]}


@register_op("lod_reset")
def _lod_reset(ctx, ins, attrs):
    """lod_reset_op.cc for the padded + @SEQLEN encoding: the values pass
    through and `SeqLenOut` is the new lengths vector, Y's lengths
    (`TargetLen`) or the `target_lod` offsets turned into int32
    lengths."""
    x = ins["X"][0]
    if ins.get("TargetLen"):
        new_len = ins["TargetLen"][0]
    else:
        target_lod = attrs.get("target_lod")
        if target_lod is None:
            raise ValueError("lod_reset needs TargetLen input or target_lod")
        lengths = np.diff(np.asarray(target_lod, dtype=np.int64))
        new_len = torch.from_numpy(lengths.astype(np.int32)).to(ctx.device)
    return {"Out": [x], "SeqLenOut": [new_len]}
