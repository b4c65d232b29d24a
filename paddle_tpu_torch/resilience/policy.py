"""Anomaly policy: what a supervised training loop does about a bad step.

The port's copy of `paddle_tpu/resilience/policy.py`. A "bad step" is
a tripped NaN guard (FloatingPointError out of the executor's
PADDLE_TPU_CHECK_NAN_INF scan) or a detected loss spike. Retrying is
pointless — the same batch reproduces the same NaN — so the choices are
the reference's failure-budget ones (a failed task is requeued until
its failure count exceeds the budget, then the pass errors):

  raise        — propagate (the pre-supervisor behavior; default)
  skip_batch   — drop the batch and continue, up to
                 `max_consecutive_skips` in a row; the budget exceeded
                 escalates to rollback (or raises when no checkpoint
                 exists). Requires the NaN guard's all-or-nothing
                 commit so the pre-step state survives the failed step
                 — the Trainer enables `check_nan_inf` automatically.
  rollback     — restore the last good checkpoint and continue from its
                 recorded position with fresh parameters/RNG.

Loss-spike detection (`loss_spike_factor`) flags a step whose loss
exceeds `factor ×` the running mean of the last `loss_window` finite
losses. A spike is detected *after* the step ran, so under `skip_batch`
it is recorded (`resilience.loss_spikes`) but the update stands;
`rollback` is the action that actually undoes it.
"""

from __future__ import annotations

import collections

__all__ = ["AnomalyPolicy"]


class AnomalyPolicy:
    RAISE = "raise"
    SKIP_BATCH = "skip_batch"
    ROLLBACK = "rollback"
    _ACTIONS = (RAISE, SKIP_BATCH, ROLLBACK)

    def __init__(self, action=RAISE, max_consecutive_skips=3,
                 loss_spike_factor=None, loss_window=16,
                 min_history=4):
        if action not in self._ACTIONS:
            raise ValueError(f"AnomalyPolicy action must be one of "
                             f"{self._ACTIONS}, got {action!r}")
        self.action = action
        self.max_consecutive_skips = int(max_consecutive_skips)
        self.loss_spike_factor = (float(loss_spike_factor)
                                  if loss_spike_factor else None)
        self.min_history = int(min_history)
        self._recent = collections.deque(maxlen=int(loss_window))
        self._consecutive_skips = 0

    # -- loss-spike detection ------------------------------------------------
    def observe_loss(self, loss) -> bool:
        """Record a finished step's loss; True when it is a spike.

        Spike losses are NOT folded into the running mean (one spike
        must not desensitize the detector to the next). Detection only
        engages once `min_history` finite losses accumulated and only
        for positive running means — spike-ratio tests are meaningless
        around zero or for negative (log-likelihood) losses.
        """
        loss = float(loss)
        spike = False
        if (self.loss_spike_factor is not None
                and len(self._recent) >= self.min_history):
            mean = sum(self._recent) / len(self._recent)
            if mean > 0:
                spike = loss > self.loss_spike_factor * mean
        if not spike:
            self._recent.append(loss)
        return spike

    # -- skip budget ---------------------------------------------------------
    def next_action(self) -> str:
        """Consulted once per anomalous step. Tracks the consecutive-
        skip budget: under `skip_batch`, exceeding it escalates to
        ROLLBACK (the trainer raises instead when it has no checkpoint
        to roll back to)."""
        if self.action == self.RAISE:
            return self.RAISE
        if self.action == self.SKIP_BATCH:
            self._consecutive_skips += 1
            if self._consecutive_skips > self.max_consecutive_skips:
                # budget blown: the flight recorder marks the escalation
                # so a post-mortem bundle shows WHY a skip policy rolled
                # back (free when telemetry is off)
                from .. import monitor
                monitor.blackbox.note_event(
                    "anomaly_escalation",
                    consecutive_skips=self._consecutive_skips,
                    budget=self.max_consecutive_skips,
                    escalated_to=self.ROLLBACK)
                return self.ROLLBACK
            return self.SKIP_BATCH
        return self.ROLLBACK

    def note_clean_step(self):
        """A step completed without anomaly: the skip budget is
        *consecutive*, so it resets."""
        self._consecutive_skips = 0

    def note_rollback(self):
        """The trainer restored a checkpoint: the skipped steps (and
        the losses observed since the checkpoint) were undone with it,
        so the skip budget and the spike-detection window reset —
        otherwise a post-restore replay inherits a stale overflowing
        counter and escalates every anomaly straight to rollback."""
        self._consecutive_skips = 0
        self._recent.clear()

    def __repr__(self):
        return (f"AnomalyPolicy(action={self.action!r}, "
                f"max_consecutive_skips={self.max_consecutive_skips}, "
                f"loss_spike_factor={self.loss_spike_factor})")
