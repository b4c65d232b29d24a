"""Carry LM weights across to the port: numpy -> f32 device tensors.

`lm_weights_from_numpy(weights, spec, device)` takes the reference's
`{name: np.ndarray}` in the `LMSpec` layout (stacked `stack.<Leaf>`
planes with head-major `Wqkv` columns, `tok_emb`, `pos_emb`, `ln_f.*`,
`lm_head.w`) — what `init_lm_weights` makes and LM artifacts carry —
validates names and shapes against the spec, and returns float32
tensors on the device. Extra names are refused: a weights dict for
another model should not load silently.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device

__all__ = ["lm_weights_from_numpy"]


def lm_weights_from_numpy(weights, spec, device=None):
    """{name: array} in `spec`'s layout -> {name: f32 tensor on device}.
    `device=None` means the CUDA card (raises when there is none)."""
    dev = resolve_device(device)
    spec.validate_weights(weights)
    extra = sorted(set(weights) - set(spec.weight_specs()))
    if extra:
        raise ValueError(f"LM weights carry names the spec does not know: "
                         f"{extra}")
    return {name: torch.from_numpy(np.ascontiguousarray(
                np.asarray(arr, dtype=np.float32))).to(dev)
            for name, arr in weights.items()}
