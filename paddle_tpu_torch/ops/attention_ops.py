"""Fused scaled-dot-product attention op (the port of
`paddle_tpu/ops/attention_ops.py::_sdpa`).

The reference elects its Pallas flash kernels on the TPU only
(`_elect_blocks`: the flash flag, T >= 1024 and a VMEM block pick) and
otherwise runs plain attention. The port has one route: the flash
function over the packed [B, T, n*D] planes (`flash_attention_plane`,
viewed head-major by strides with no copy), whose wrappers launch K1 and
the K2-K4 backward on the card (the bf16 K1 and K3 + K4 under amp, where
the op's compute role casts q, k and v to bf16) and run their plain
versions on the CPU.
"""

from __future__ import annotations

from .flash_attention import flash_attention_plane
from .registry import register_op


@register_op("scaled_dot_product_attention")
def _sdpa(ctx, ins, attrs):
    """Q/K/V [B, T, H]; attrs: num_heads, causal, scale (optional),
    seq_axis (ring attention over a mesh axis in the reference; on one
    card the same function is plain single-device attention, as the
    reference computes it with no mesh attached). Optional SeqLen [B]
    masks padded keys. Out [B, Tq, H]."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    n = attrs.get("num_heads", 1)
    if q.shape[2] % n:
        raise ValueError(f"scaled_dot_product_attention: hidden size "
                         f"{q.shape[2]} is not divisible by num_heads={n}")
    kv_len = ins["SeqLen"][0] if ins.get("SeqLen") else None
    out = flash_attention_plane(q, k, v, n, causal=attrs.get("causal", False),
                                scale=attrs.get("scale", None), kv_len=kv_len)
    return {"Out": [out]}
