"""v2 SGD trainer (the port's copy of `paddle_tpu/v2/trainer.py`;
reference python/paddle/v2/trainer.py:37): the classic `SGD(cost,
parameters, update_equation).train(reader, event_handler)` UX,
delegating to the framework Trainer instead of the SWIG
GradientMachine + per-parameter updaters. It runs where `init` chose
unless it is given a place."""

from __future__ import annotations

from .. import monitor
from .. import trainer as core_trainer
from . import _place
from . import layer as v2_layer

__all__ = ["SGD"]


class SGD:
    def __init__(self, cost, parameters=None, update_equation=None,
                 extra_layers=None, is_local=True, place=None,
                 checkpoint_dir=None, preemption_checkpoint=False,
                 anomaly_policy=None, retry_policy=None,
                 health_metrics=False, feed_workers=None,
                 feed_prefetch_depth=None):
        """checkpoint_dir / preemption_checkpoint / anomaly_policy /
        retry_policy: fault-tolerance knobs forwarded to the framework
        Trainer (see trainer.Trainer and resilience/) — v2 jobs get the
        same supervised loop, preemption-safe shutdown included.
        health_metrics: in-graph model-health telemetry + live MFU
        accounting (monitor/health.py), forwarded likewise.
        feed_workers / feed_prefetch_depth: input-pipeline knobs
        (reader/pipeline.py staging workers + device prefetch depth;
        None = the feed_workers / feed_prefetch_depth flags),
        forwarded likewise."""
        self._parameters = parameters
        self._cost = cost
        extra = list(extra_layers or [])
        self._trainer = core_trainer.Trainer(
            cost=cost, optimizer=update_equation,
            place=place or _place.default_place(),
            scope=parameters.scope if parameters is not None else None,
            extra_fetch=extra, checkpoint_dir=checkpoint_dir,
            preemption_checkpoint=preemption_checkpoint,
            anomaly_policy=anomaly_policy, retry_policy=retry_policy,
            health_metrics=health_metrics, feed_workers=feed_workers,
            feed_prefetch_depth=feed_prefetch_depth)

    @property
    def parameters(self):
        return self._parameters

    def request_preemption(self):
        """Graceful-stop request (see trainer.Trainer.request_preemption)."""
        self._trainer.request_preemption()

    def train(self, reader, num_passes=1, event_handler=None,
              feeding=None):
        # per-step/pass telemetry comes from the delegate loop
        # (trainer.steps, trainer.step_time_s, ...); this counter keeps
        # the v2 entry point distinguishable in the registry
        monitor.counter_inc("v2.train_calls")
        feed_order = v2_layer.default_feed_order(feeding)
        with monitor.span("v2/SGD.train"):
            self._trainer.train(reader=reader, num_passes=num_passes,
                                feed_order=feed_order,
                                event_handler=event_handler)

    def test(self, reader, feeding=None):
        monitor.counter_inc("v2.test_calls")
        feed_order = v2_layer.default_feed_order(feeding)
        with monitor.span("v2/SGD.test"):
            return self._trainer.test(reader=reader,
                                      feed_order=feed_order)

    def save_parameter_to_tar(self, f):
        if self._parameters is not None:
            self._parameters.to_tar(f)
