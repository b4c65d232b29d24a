"""Serving on the CUDA card: the one-shot micro-batching engine
(engine.py), the continuous-batching LM engine (lm.py) and their HTTP
front end (the port of `paddle_tpu.serving`)."""

from .engine import EngineConfig, InferenceEngine, PendingResult
from .errors import (DeadlineExceededError, EngineClosedError,
                     ServerOverloadedError, ServingError)
from .lm import (GenerationConfig, GenerationEngine, GenerationStream,
                 LMSpec, init_lm_weights, price_kv_cache)

__all__ = ["EngineConfig", "InferenceEngine", "PendingResult",
           "GenerationConfig", "GenerationEngine", "GenerationStream",
           "LMSpec", "init_lm_weights", "price_kv_cache", "ServingError",
           "ServerOverloadedError", "DeadlineExceededError",
           "EngineClosedError"]
