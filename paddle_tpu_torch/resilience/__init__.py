"""Resilience layer: retry policies, anomaly policies, fault injection.

The port's device-free copy of `paddle_tpu/resilience/`, the policy
machinery the supervised `Trainer` and the checkpoint IO use:

  RetryPolicy / retrying / call_with_retry
      bounded exponential-backoff retry with a retryable-exception
      predicate (retry.py): checkpoint IO and the supervised step loop.
      On the card, `torch.OutOfMemoryError` is transient (XLA's
      RESOURCE_EXHAUSTED) and a sticky CUDA error never is.
  AnomalyPolicy
      raise | skip_batch (consecutive-skip budget) | rollback for NaN
      guard trips and loss spikes (policy.py).
  FaultInjector / SimulatedCrash
      deterministic, seeded failure schedules via PADDLE_TPU_FAULTS /
      the `faults` flag, the reference's grammar unchanged (faults.py).
  RollbackRequested / PreemptionShutdown
      the supervised Trainer's control-flow signals.

Recovery activity is observable (with telemetry on): resilience.retries,
.rollbacks, .skipped_batches, .preemption_saves, .anomalies,
.loss_spikes, .ckpt_fallback_loads, .faults_injected in the monitor
registry.
"""

from __future__ import annotations

from .retry import RetryPolicy, call_with_retry, is_transient, retrying
from .policy import AnomalyPolicy
from .faults import (FaultInjector, FaultSpecError, PartitionFault,
                     SimulatedCrash)
from . import faults

__all__ = ["RetryPolicy", "retrying", "call_with_retry", "is_transient",
           "AnomalyPolicy", "FaultInjector", "FaultSpecError",
           "SimulatedCrash", "PartitionFault", "RollbackRequested",
           "PreemptionShutdown", "faults"]


class RollbackRequested(Exception):
    """Internal supervisor signal: restore the last good checkpoint and
    resume from its recorded position. Carries the triggering exception
    (`cause`); re-raised verbatim when no checkpoint is available or the
    restore budget is exhausted."""

    def __init__(self, cause=None, reason=""):
        super().__init__(reason or str(cause))
        self.cause = cause
        self.reason = reason


class PreemptionShutdown(Exception):
    """Raised by Trainer.train after a preemption request (SIGTERM /
    SIGINT / request_preemption()) was honored: the checkpoint — if a
    checkpoint_dir is configured — is already on disk when this
    propagates. Catch it, exit 0, and let the scheduler restart the job;
    the Trainer resumes from the saved step."""
