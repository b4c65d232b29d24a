"""Carry weights and training state across to the port and back.

`lm_weights_from_numpy(weights, spec, device)` takes the reference's
`{name: np.ndarray}` in the `LMSpec` layout (stacked `stack.<Leaf>`
planes with head-major `Wqkv` columns, `tok_emb`, `pos_emb`, `ln_f.*`,
`lm_head.w`) — what `init_lm_weights` makes and LM artifacts carry —
validates names and shapes against the spec, and returns float32
tensors on the device. Extra names are refused: a weights dict for
another model should not load silently.

`scope_from_numpy({name: ndarray}, device)` builds the port's `Scope`
from numpy arrays — a JAX `Scope` after the JAX package's `startup` run,
read out as numpy — keeping each array's dtype; `scope_to_numpy(scope)`
is its inverse. The parity tests carry one initialisation into both
packages this way, because the two packages' random streams differ.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device

__all__ = ["lm_weights_from_numpy", "scope_from_numpy", "scope_to_numpy"]


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


def scope_from_numpy(arrays, device=None):
    """{name: array} -> the port's `Scope` holding each array as a tensor
    of the same dtype on `device` (None: the CUDA card, raising when
    there is none)."""
    from .executor import Scope
    dev = resolve_device(device)
    scope = Scope()
    for name, arr in arrays.items():
        # a copy: the source (a JAX array's numpy view) may be read-only
        scope.set(name, torch.from_numpy(np.array(arr)).to(dev))
    return scope


def scope_to_numpy(scope):
    """The port's `Scope` -> {name: ndarray} of every tensor it holds
    (the executor's generator state is left out)."""
    return {name: val.detach().cpu().numpy()
            for name, val in scope.vars.items()
            if isinstance(val, torch.Tensor)}
