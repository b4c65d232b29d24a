"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for an NVIDIA
H100 (Hopper, sm_90a).

It stands beside the JAX package, which stays the reference it is held
against, and imports nothing of it. Entry points run on the CUDA card
unless the caller passes `device="cpu"`; every TPU kernel on a ported
path is a hand-written Hopper kernel under `csrc/`, built with nvcc at
first use. This slice ports LM serving:

    from paddle_tpu_torch.serving import (GenerationConfig,
                                          GenerationEngine, LMSpec,
                                          init_lm_weights)
    engine = GenerationEngine(spec, init_lm_weights(spec), config)
    ids, reason = engine.generate(prompt)

    python -m paddle_tpu_torch serve --generate --artifact lm.pdmodel
"""

__all__ = ["flags", "io", "monitor", "ops", "serving", "weights"]
