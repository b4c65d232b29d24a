"""LM serving on the CUDA card: the continuous-batching engine and its
HTTP front end (the port of `paddle_tpu.serving`'s LM half)."""

from .errors import (DeadlineExceededError, EngineClosedError,
                     ServerOverloadedError, ServingError)
from .lm import (GenerationConfig, GenerationEngine, GenerationStream,
                 LMSpec, init_lm_weights, price_kv_cache)

__all__ = ["GenerationConfig", "GenerationEngine", "GenerationStream",
           "LMSpec", "init_lm_weights", "price_kv_cache", "ServingError",
           "ServerOverloadedError", "DeadlineExceededError",
           "EngineClosedError"]
