"""Device resolution for the port's entry points.

Every entry point takes `device=None` and runs on the CUDA card unless
the caller names the CPU explicitly (`device="cpu"`, as the tests do).
There is no silent CPU fallback: with no card and no explicit CPU, the
entry point raises.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "use_full_f32"]


def use_full_f32():
    """Pin float32 matmuls and convolutions to full float32, bf16
    matmuls to f32 reductions, and cuDNN to deterministic algorithms
    chosen without a search. The JAX engine computes in f32 end to end
    and accumulates bf16 products in f32; on the card PyTorch would run
    cuDNN convolutions (and, if a caller flipped it, cuBLAS matmuls) in
    TF32, which keeps about three decimal digits, and lets cuBLAS
    reduce a bf16 matmul's split-K partials in bf16. cuDNN's
    weight-gradient algorithms may sum with atomics, and its benchmark
    mode times algorithms at a new shape's first call: XLA on the TPU is
    deterministic, a preempted and resumed training run must equal the
    uninterrupted one bitwise, and a CUDA-graph capture must not search
    for algorithms. The switches are set explicitly, not left to their
    defaults."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def resolve_device(device=None):
    """`torch.device` for an entry point. None means the CUDA card;
    raises RuntimeError naming the missing card when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA card and none is visible "
                "(torch.cuda.is_available() is False); pass device='cpu' "
                "to run the plain PyTorch path on the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA card is "
                           "visible")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
