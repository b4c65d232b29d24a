"""Serving on the CUDA card: the one-shot micro-batching engine
(engine.py), the continuous-batching LM engine (lm.py), their HTTP front
end (http.py), and the fleet over replicas of them: the router,
supervisor and registrar (fleet.py) and the autoscaler (autoscale.py)
(the port of `paddle_tpu.serving`)."""

from .autoscale import (AutoscaleConfig, AutoscaleController,
                        AutoscalePolicy)
from .batching import (bucket_ladder, pad_to_bucket, round_up_to_bucket,
                       split_rows)
from .engine import EngineConfig, InferenceEngine, PendingResult
from .errors import (DeadlineExceededError, EngineClosedError,
                     ServerOverloadedError, ServingError)
from .fleet import (FleetRegistrar, FleetRouter, ReplicaSupervisor,
                    RouterConfig)
from .http import make_server, resolve_trace_id
from .lm import (GenerationConfig, GenerationEngine, GenerationStream,
                 LMSpec, init_lm_weights, price_kv_cache)

__all__ = ["InferenceEngine", "EngineConfig", "PendingResult",
           "ServingError", "ServerOverloadedError",
           "DeadlineExceededError", "EngineClosedError",
           "bucket_ladder", "round_up_to_bucket", "pad_to_bucket",
           "split_rows", "make_server", "resolve_trace_id",
           "FleetRouter", "RouterConfig", "ReplicaSupervisor",
           "FleetRegistrar", "GenerationEngine", "GenerationConfig",
           "GenerationStream", "LMSpec", "init_lm_weights",
           "price_kv_cache", "AutoscaleConfig", "AutoscalePolicy",
           "AutoscaleController"]
