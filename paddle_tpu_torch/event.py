"""Training events (the port's copy of `paddle_tpu/event.py`).

Handed to the user's `event_handler` by `trainer.Trainer.train/test` at
pass and iteration boundaries, carrying the fetched metric values.
"""

from __future__ import annotations

__all__ = ["BeginPass", "EndPass", "BeginIteration", "EndIteration",
           "IterationSkipped", "TestResult"]


class WithMetric:
    def __init__(self, metrics=None, metric_names=None):
        self.metrics = list(metrics or [])
        self.metric_names = list(metric_names or [])


class BeginPass:
    def __init__(self, pass_id):
        self.pass_id = pass_id


class EndPass(WithMetric):
    def __init__(self, pass_id, metrics=None, metric_names=None):
        super().__init__(metrics, metric_names)
        self.pass_id = pass_id


class BeginIteration:
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration(WithMetric):
    def __init__(self, pass_id, batch_id, cost, metrics=None,
                 metric_names=None, health=None, feed=None):
        super().__init__(metrics, metric_names)
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost
        # model-health snapshot for this step (Trainer(health_metrics=
        # True), monitor/health.py); None otherwise
        self.health = health
        # input-pipeline snapshot (feed.* family: stalls, queue depth,
        # wait/staging times, bytes/sec) when telemetry is enabled —
        # a starving feed explains itself at the event boundary
        self.feed = feed


class IterationSkipped:
    """The anomaly policy dropped this batch (no update ran, no
    EndIteration follows its BeginIteration): fired so Begin/End-pairing
    handlers can account for the gap instead of silently drifting."""

    def __init__(self, pass_id, batch_id, reason=""):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.reason = reason


class TestResult(WithMetric):
    def __init__(self, metrics=None, metric_names=None, cost=None):
        super().__init__(metrics, metric_names)
        self.cost = cost
