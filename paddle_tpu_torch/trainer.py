"""Trainer: the v2 SGD event-loop training UX, fault-tolerant.

The port's copy of `paddle_tpu/trainer.py`: reader in, events out, over
the port's Executor on the card (`CUDAPlace(0)` unless the caller
passes `CPUPlace()`):

    trainer = Trainer(cost=avg_cost, optimizer=pt.AdamOptimizer(
                          pt.learning_rate_decay.exponential_decay(
                              1e-4, 1000, 0.5)),
                      checkpoint_dir="ckpt")
    trainer.train(reader=pt.reader.batch(examples, 8), num_passes=2,
                  feed_order=["tok", "nxt"], event_handler=handler)
    result = trainer.test(reader=..., feed_order=["tok", "nxt"])
    trainer.save_params(dirname) / save_inference_model(...)

Each pass iterates a `DeviceFeeder` (reader/pipeline.py): convert
workers and a side-stream copy of batch n+1 under step n.

Checkpoint/resume: with `checkpoint_dir`, the trainer checkpoints at
every EndPass (io.save_checkpoint: persistables + the generator state +
global step + the next (pass, batch) position), and a new
`Trainer(..., checkpoint_dir=d)` resumes from it; a mid-pass checkpoint
resumes at the exact step boundary (the resumed pass's consumed batches
are drawn and dropped, so the reader must be deterministic, as
reader.batch over a fixed dataset is). A checkpoint the JAX package
wrote resumes here and the other way round.

Fault tolerance (resilience/), the supervised loop:

  * transient errors (OS errors, `torch.OutOfMemoryError`, injected
    transients) retry with exponential backoff per `retry_policy`;
    exhausted retries restore the last good checkpoint and resume at
    its recorded global_step (up to `max_restores`). A step that failed
    after an op had written the scope's state in place (the executor
    marks the scope `state_invalidated`) is never retried — a retry
    would apply half an update twice — it is restored from the
    checkpoint, or raises when there is none.
  * a tripped NaN guard or a loss spike consults `anomaly_policy`
    (resilience.AnomalyPolicy): raise | skip_batch under a
    consecutive-skip budget | rollback to the last checkpoint. A
    non-raise policy turns the `check_nan_inf` flag on while training,
    so a tripped step commits none of its state and a skipped batch
    leaves every persistable at its pre-step value.
  * `preemption_checkpoint=True` installs SIGTERM/SIGINT handlers while
    training: a signal requests a checkpoint at the next step boundary,
    then `train` raises resilience.PreemptionShutdown.
    `request_preemption()` is the signal-free spelling.

Recovery events flow into the monitor registry (with telemetry on):
resilience.retries, .step_retries, .rollbacks, .skipped_batches,
.preemption_saves, .anomalies, .loss_spikes; per step
trainer.step_time_s, .steps, .samples, .samples_per_sec, per pass
trainer.pass_time_s, .passes.

Model health (`health_metrics=True`, monitor/health.py): each step also
fetches the global gradient and parameter norms and the per-parameter
update ratios, exported as `health.*` gauges, attached to EndIteration
(`.health`), carried into every blackbox bundle and into the anomaly
reports; with telemetry on, the step's FLOP tally over its wall time
sets `perf.mfu|device=<card>`.

Not ported yet: `parallelism=` (the SPMD transpiler, A11) raises
NotImplementedError.
"""

from __future__ import annotations

import contextlib
import itertools
import time

import numpy as np

from . import event as events
from . import executor as executor_mod
from . import framework, io, monitor, resilience
from .data_feeder import DataFeeder
from .executor import Executor, Scope
from .framework import CUDAPlace
from .resilience import faults as faults_mod

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, cost, optimizer=None, place=None, extra_fetch=None,
                 main_program=None, startup_program=None, scope=None,
                 checkpoint_dir=None, parallelism=None, retry_policy=None,
                 anomaly_policy=None, preemption_checkpoint=False,
                 max_restores=2, health_metrics=False,
                 feed_workers=None, feed_prefetch_depth=None):
        """cost: loss Variable of an already-built main program (the
        optimizer is applied here unless its ops are already present).
        extra_fetch: metric Variables fetched and reported in events
        (e.g. layers.accuracy output).
        retry_policy: resilience.RetryPolicy for transient step
        failures (None = the default policy: 3 attempts, exponential
        backoff; pass RetryPolicy(max_attempts=1) to retry nothing).
        anomaly_policy: resilience.AnomalyPolicy consulted on NaN-guard
        trips / loss spikes (None = raise, the pre-supervisor behavior).
        preemption_checkpoint: install SIGTERM/SIGINT handlers during
        train() that checkpoint at the next step boundary and raise
        PreemptionShutdown.
        max_restores: checkpoint-restore budget per train() call for
        rollbacks and unrecoverable-failure recovery.
        place: CUDAPlace(0) when None (raises without a card);
        CPUPlace() runs the plain PyTorch path on the CPU.
        health_metrics: compute model-health telemetry each step (global
        grad norm, parameter norm, per-parameter update ratios, loss
        EMA; monitor/health.py): extra eager reductions beside the step,
        exported as health.* gauges, attached to EndIteration (.health),
        included in blackbox bundles and anomaly reports; with telemetry
        on it also drives the perf.mfu / perf.flops_per_sec gauges.
        parallelism: not ported yet (A11); a true value raises
        NotImplementedError.
        feed_workers / feed_prefetch_depth: input-pipeline knobs
        forwarded to the DeviceFeeder (reader/pipeline.py): convert
        worker threads (0 = synchronous, the same batches) and
        device-side prefetch queue depth. None = the feed_workers /
        feed_prefetch_depth flags."""
        if parallelism:
            raise NotImplementedError(
                "Trainer(parallelism=...): the SPMD transpiler is not "
                "ported yet; the port trains on one card (ROADMAP A11)")
        self.cost = cost
        self.main_program = main_program or framework.default_main_program()
        self.startup_program = (startup_program
                                or framework.default_startup_program())
        if optimizer is not None and not self._has_optimize_ops():
            optimizer.minimize(cost)
        self.place = place or CUDAPlace(0)
        self.exe = Executor(self.place)
        self.scope = scope or Scope()
        self.extra_fetch = list(extra_fetch or [])
        self.metric_names = [v.name for v in self.extra_fetch]
        self.checkpoint_dir = checkpoint_dir
        self.retry_policy = (resilience.RetryPolicy()
                             if retry_policy is None else retry_policy)
        self.anomaly_policy = anomaly_policy
        self.preemption_checkpoint = bool(preemption_checkpoint)
        self.max_restores = int(max_restores)
        self.feed_workers = feed_workers
        self.feed_prefetch_depth = feed_prefetch_depth
        self._active_pipeline = None   # feed context for anomaly reports
        # batches consumed: skipped batches advance it too — it is the
        # DATA position a checkpoint resumes at, not an update count
        self.global_step = 0
        self._start_pass = 0
        self._start_batch = 0         # mid-pass resume position
        self._preempt_requested = False
        self._last_rollback_pos = None  # (pass, batch) that rolled back
        self._test_prog = None        # pruned clone cached per version
        self._test_prog_version = None
        self.health = None
        if health_metrics:
            self.health = monitor.health.HealthMonitor(self.main_program)
            # every blackbox bundle gets the active monitor's section
            monitor.health.activate(self.health)
        self._flops_cache = {}   # (uid, version, feed sig) -> static FLOPs

        self._run_startup_preserving_existing()
        if checkpoint_dir and io.checkpoint_exists(checkpoint_dir,
                                                   check_integrity=False):
            self.global_step, meta = io.load_checkpoint(
                self.exe, checkpoint_dir, self.main_program,
                scope=self.scope, return_meta=True)
            extra = meta.get("extra", {})
            self._start_pass = int(extra.get("pass_id", 0))
            self._start_batch = int(extra.get("batch_id", 0))

    def _run_startup_preserving_existing(self):
        """Initialise ONLY parameters the scope does not already hold:
        a caller-provided scope (fine-tuning, weights carried from the
        JAX package) keeps its preset values."""
        sblock = self.startup_program.global_block()
        missing = [n for n, v in sblock.vars.items()
                   if v.persistable and not self.scope.has(n)]
        if not missing:
            return
        if len(missing) == len([n for n, v in sblock.vars.items()
                                if v.persistable]):
            self.exe.run(self.startup_program, scope=self.scope)
            return
        tmp = Scope()
        self.exe.run(self.startup_program, scope=tmp)
        for n in missing:
            if tmp.has(n):
                self.scope.set(n, tmp.get(n))

    def _has_optimize_ops(self):
        from .ops.registry import has_op, get_op
        return any(has_op(op.type) and get_op(op.type).is_optimizer
                   for op in self.main_program.global_block().ops)

    # -- core loops ---------------------------------------------------------
    def _feeder(self, feed_order):
        block = self.main_program.global_block()
        feed_vars = [block.var(n) for n in feed_order]
        return DataFeeder(feed_vars, self.place)

    def train(self, reader, num_passes, feed_order, event_handler=None,
              test_reader=None):
        """Supervised pass/iteration loop: for each pass, iterate
        minibatches from `reader`, run the train step under the failure
        supervisor, and fire events. `reader` yields per-example
        tuples aligned with `feed_order` (use pt.reader.batch to batch a
        dataset)."""
        event_handler = event_handler or (lambda e: None)
        # rollback needs a checkpoint to roll back TO — if the policy
        # may ask for one before the first EndPass save, pin the initial
        # state now (params are untouched; pure IO side effect)
        if (self.checkpoint_dir and self.anomaly_policy is not None
                and self.anomaly_policy.action != "raise"
                and not io.checkpoint_exists(self.checkpoint_dir,
                                             check_integrity=False)):
            self._save_checkpoint(self._start_pass, self._start_batch)
        restores = 0
        with self._preemption_signals(), self._nan_guard_scope():
            while True:
                try:
                    return self._run_passes(reader, num_passes, feed_order,
                                            event_handler, test_reader)
                except resilience.RollbackRequested as rb:
                    # post-mortem bundle BEFORE the restore overwrites
                    # the state being diagnosed (no-op unless
                    # blackbox_dir is configured)
                    monitor.blackbox.maybe_dump(
                        "rollback", error=rb.cause,
                        extra={"rollback_reason": rb.reason,
                               "global_step": self.global_step})
                    if (not self._can_restore()
                            or restores >= self.max_restores):
                        raise rb.cause if rb.cause is not None else rb
                    restores += 1
                    self._restore_from_checkpoint()
                    monitor.blackbox.note_event(
                        "checkpoint_restored",
                        global_step=self.global_step,
                        pass_id=self._start_pass,
                        batch_id=self._start_batch)
                    if self.anomaly_policy is not None:
                        # the restore undid the skipped steps and the
                        # observed losses: stale budgets must not make
                        # the replay escalate every anomaly
                        self.anomaly_policy.note_rollback()
                    monitor.counter_inc("resilience.rollbacks")

    @contextlib.contextmanager
    def _nan_guard_scope(self):
        """skip/rollback anomaly handling needs the NaN guard to
        actually trip AND the pre-step state to survive the failed step
        (with check_nan_inf on, the executor commits a step's state all
        or nothing). Scoped to train(): other programs in the process
        keep their in-place updates once training returns."""
        from . import flags as flags_mod
        if (self.anomaly_policy is None
                or self.anomaly_policy.action == "raise"
                or flags_mod.get("check_nan_inf")):
            yield
            return
        flags_mod.set_flag("check_nan_inf", True)
        try:
            yield
        finally:
            flags_mod.set_flag("check_nan_inf", False)

    def _run_passes(self, reader, num_passes, feed_order, event_handler,
                    test_reader):
        feeder = self._feeder(feed_order)
        fetch = [self.cost] + self.extra_fetch
        # health fetches ride the same run (monitor/health.py)
        hm = (self.health if self.health is not None
              and self.health.enabled else None)
        health_fetch = hm.fetch_names() if hm else []
        fetch = fetch + health_fetch
        nh = len(health_fetch)
        mon = monitor.enabled()
        try:
            self._run_pass_loop(reader, num_passes, feeder, fetch, nh,
                                hm, mon, event_handler, test_reader,
                                feed_order)
        finally:
            # only the anomaly handler inside the pass loop reads it;
            # keeping the feeder past train() would pin the reader
            # closure, the program and the executor
            self._active_pipeline = None

    def _run_pass_loop(self, reader, num_passes, feeder, fetch, nh, hm,
                       mon, event_handler, test_reader, feed_order):
        from .reader import DeviceFeeder
        while self._start_pass < num_passes:
            pass_id = self._start_pass
            start_batch = self._start_batch
            event_handler(events.BeginPass(pass_id))
            pass_metrics = _MetricMean(len(self.extra_fetch))
            t_pass = time.perf_counter()
            # staged async device feed: N convert workers fill an
            # ordered staging buffer while the device stage copies
            # batch n+1 to the card under step n (reader/pipeline.py).
            # feed_workers=0 selects the synchronous path. On a mid-pass
            # resume the already-consumed batches are dropped on the
            # HOST side, before the workers pay conversion and the copy
            # for them (they are counted in the restored global_step).
            src = (reader if not start_batch else
                   lambda: itertools.islice(reader(), start_batch, None))
            pipeline = DeviceFeeder(src, self.main_program, self.exe,
                                    feeder=feeder,
                                    workers=self.feed_workers,
                                    prefetch_depth=self.feed_prefetch_depth)
            self._active_pipeline = pipeline
            with monitor.span(f"trainer/pass_{pass_id}"):
                for batch_id, feed in enumerate(pipeline, start=start_batch):
                    self._check_preemption(pass_id, batch_id)
                    event_handler(events.BeginIteration(pass_id, batch_id))
                    t_step = time.perf_counter() if mon else None
                    with monitor.span(
                            "trainer/step",
                            attrs={"pass": pass_id, "batch": batch_id,
                                   "step": self.global_step}):
                        out = self._supervised_step(feed, fetch, pass_id,
                                                    batch_id)
                    if out is None:   # anomaly policy skipped the batch
                        self.global_step += 1
                        event_handler(events.IterationSkipped(
                            pass_id, batch_id, reason="anomaly policy"))
                        continue
                    health_vals = out[len(out) - nh:] if nh else []
                    out = out[:len(out) - nh] if nh else out
                    cost = float(np.ravel(out[0])[0])
                    health = (hm.observe(self.global_step, cost,
                                         health_vals) if hm else None)
                    metrics = [np.asarray(m) for m in out[1:]]
                    bs = int(feed[feed_order[0]].shape[0])
                    pass_metrics.update(metrics, bs)
                    self.global_step += 1
                    self._observe_loss(cost, pass_id, batch_id)
                    if mon:
                        dt = time.perf_counter() - t_step
                        monitor.histogram_observe("trainer.step_time_s", dt)
                        monitor.counter_inc("trainer.steps")
                        monitor.counter_inc("trainer.samples", bs)
                        if dt > 0:
                            monitor.gauge_set("trainer.samples_per_sec",
                                              bs / dt)
                            if hm:
                                # live MFU: the program's static FLOP
                                # tally over the measured step time
                                flops = self._program_flops(feed)
                                if flops:
                                    monitor.introspect.note_step_flops(
                                        flops, dt)
                    event_handler(events.EndIteration(
                        pass_id, batch_id, cost, metrics,
                        self.metric_names, health=health,
                        feed=(pipeline.counters() if mon else None)))
            self._start_pass = pass_id + 1
            self._start_batch = 0
            if mon:
                monitor.histogram_observe("trainer.pass_time_s",
                                          time.perf_counter() - t_pass)
                monitor.counter_inc("trainer.passes")
                # a starving pipeline notes itself at every pass boundary
                if pipeline.counters()["stalls"]:
                    monitor.blackbox.note_event(
                        "feed_stalled", pass_id=pass_id,
                        global_step=self.global_step,
                        context=pipeline.explain())
            end = events.EndPass(pass_id, pass_metrics.eval(),
                                 self.metric_names)
            if test_reader is not None:
                end.test_result = self.test(test_reader, feed_order)
            event_handler(end)
            if self.checkpoint_dir:
                self._save_checkpoint(pass_id + 1, 0)

    def _program_flops(self, feed):
        """Static per-step FLOP tally of the main program
        (monitor.introspect.program_flops), cached per (program, feed
        signature). Never raises: MFU accounting is telemetry."""
        key = (self.main_program.uid, self.main_program.version,
               executor_mod._feed_signature(feed))
        flops = self._flops_cache.get(key)
        if flops is None:
            try:
                flops = monitor.introspect.program_flops(
                    self.main_program, feed=feed,
                    fetch_list=[self.cost.name], scope=self.scope,
                    executor=self.exe)
            except Exception:   # noqa: BLE001 — accounting only
                flops = 0
            self._flops_cache[key] = flops
        return flops

    # -- failure supervision ------------------------------------------------
    def _supervised_step(self, feed, fetch, pass_id, batch_id):
        """One executor step under the failure supervisor. Returns the
        fetch list, or None when the anomaly policy skipped the batch.
        Raises RollbackRequested to the train() loop for rollbacks."""
        def run_once():
            # fault-injection site: fires BEFORE the device step so a
            # retry re-runs an un-consumed step (faults.py)
            faults_mod.fire("step", index=self.global_step)
            with executor_mod.error_context(
                    f"global step {self.global_step} "
                    f"(pass {pass_id}, batch {batch_id})"):
                return self.exe.run(self.main_program, feed=feed,
                                    fetch_list=fetch, scope=self.scope)

        try:
            # a step that failed after writing state in place is never
            # retried: the retry would apply half an update twice
            return resilience.call_with_retry(
                run_once, policy=self.retry_policy,
                counter="resilience.step_retries",
                may_retry=lambda: not self._state_invalidated())
        except FloatingPointError as e:
            # NaN guard trip (or injected NaN): never retried — the
            # same batch reproduces the same NaN
            extra = {"global_step": self.global_step,
                     "pass_id": pass_id, "batch_id": batch_id}
            if self.health is not None and self.health.enabled:
                # what led up to it: the grad-norm trend, hottest param
                extra["health_context"] = self.health.explain()
                monitor.blackbox.note_event(
                    "anomaly_health_context",
                    context=extra["health_context"],
                    global_step=self.global_step)
            if self._active_pipeline is not None:
                # the feed's side of the story: "feed stalled 12x"
                extra["feed_context"] = self._active_pipeline.explain()
            monitor.blackbox.maybe_dump("anomaly", error=e, extra=extra)
            if self._anomaly_action(e, pass_id, batch_id) == "skip":
                monitor.counter_inc("resilience.skipped_batches")
                return None
            raise resilience.RollbackRequested(
                cause=e, reason="anomaly policy requested rollback")
        except Exception as e:
            if self._can_restore() and (self.retry_policy.is_retryable(e)
                                        or self._state_invalidated()):
                # transient but persistent (retries exhausted), OR a
                # failure after an op wrote the scope's state in place:
                # either way the state cannot be used as it is —
                # restore the last good checkpoint
                raise resilience.RollbackRequested(
                    cause=e, reason="retries exhausted")
            raise

    def _state_invalidated(self):
        """True when a failed run had already written the scope's state
        in place (the executor's record, `Scope.state_invalidated`): the
        state holds part of an update, so no retry may run through it;
        a checkpoint restore replaces exactly that state (and clears
        the mark)."""
        return bool(getattr(self.scope, "state_invalidated", False))

    def _anomaly_action(self, exc, pass_id, batch_id):
        """Classify a bad step through the anomaly policy: "skip",
        "rollback", or raises (action "raise", or no rollback target).

        A batch that rolled the run back once and STILL anomalies on
        replay is deterministically bad data: rolling back again would
        loop until max_restores burns out, so the repeat downgrades to
        a skip — the "continue with a fresh data position" half of the
        rollback contract."""
        pol = self.anomaly_policy
        if pol is None:
            raise exc
        monitor.counter_inc("resilience.anomalies")
        action = pol.next_action()
        if action == pol.RAISE:
            raise exc
        if action == pol.SKIP_BATCH:
            return "skip"
        if self._last_rollback_pos == (pass_id, batch_id):
            return "skip"
        if not self._can_restore():
            raise RuntimeError(
                "anomaly policy requested rollback (action="
                f"{pol.action!r}) but no checkpoint is available — pass "
                "checkpoint_dir to Trainer") from exc
        self._last_rollback_pos = (pass_id, batch_id)
        return "rollback"

    def _observe_loss(self, cost, pass_id, batch_id):
        """Post-step loss-spike detection. A spike is found AFTER the
        update ran: skip_batch can only record it (resilience.
        loss_spikes — NOT skipped_batches: the update stands); rollback
        actually undoes it."""
        pol = self.anomaly_policy
        if pol is None:
            return
        if not pol.observe_loss(cost):
            pol.note_clean_step()
            return
        monitor.counter_inc("resilience.loss_spikes")
        msg = (f"loss spike at global step {self.global_step - 1}: "
               f"{cost:.6g} exceeds {pol.loss_spike_factor}x the running "
               "mean")
        if self.health is not None and self.health.enabled:
            # the health monitor explains the spike instead of the bare
            # loss number: "grad_norm jumped 40.0x at step N; ..."
            msg += f" [{self.health.explain()}]"
        err = FloatingPointError(msg)
        if self._anomaly_action(err, pass_id, batch_id) != "skip":
            raise resilience.RollbackRequested(
                cause=err, reason="loss spike rollback")

    def _can_restore(self):
        # digest-free probe: consulted on every failure decision;
        # load_checkpoint verifies digests (with .old fallback) for real
        return bool(self.checkpoint_dir
                    and io.checkpoint_exists(self.checkpoint_dir,
                                             check_integrity=False))

    def _restore_from_checkpoint(self):
        """Reload params/optimizer state/generator and the recorded
        (global_step, pass, batch) position from the last good
        checkpoint."""
        self.global_step, meta = io.load_checkpoint(
            self.exe, self.checkpoint_dir, self.main_program,
            scope=self.scope, return_meta=True)
        extra = meta.get("extra", {})
        self._start_pass = int(extra.get("pass_id", 0))
        self._start_batch = int(extra.get("batch_id", 0))

    def _save_checkpoint(self, next_pass, next_batch):
        io.save_checkpoint(self.exe, self.checkpoint_dir,
                           self.main_program, scope=self.scope,
                           global_step=self.global_step,
                           extra_meta={"pass_id": int(next_pass),
                                       "batch_id": int(next_batch)},
                           retry_policy=self.retry_policy)

    # -- preemption ---------------------------------------------------------
    def request_preemption(self):
        """Ask for a graceful stop: the train loop checkpoints at the
        next step boundary and raises PreemptionShutdown. Safe from any
        thread / signal handler (it only sets a flag)."""
        self._preempt_requested = True

    def _check_preemption(self, pass_id, batch_id):
        if not self._preempt_requested:
            return
        self._preempt_requested = False
        # keep the in-memory resume position in sync with the checkpoint
        # so train() on THIS trainer object also resumes exactly here
        self._start_pass = pass_id
        self._start_batch = batch_id
        if self.checkpoint_dir:
            # one checkpoint at a step boundary, then exit
            self._save_checkpoint(pass_id, batch_id)
            monitor.counter_inc("resilience.preemption_saves")
        monitor.blackbox.maybe_dump(
            "preemption",
            extra={"global_step": self.global_step, "pass_id": pass_id,
                   "batch_id": batch_id,
                   "checkpoint_saved": bool(self.checkpoint_dir)})
        raise resilience.PreemptionShutdown(
            f"preempted at global step {self.global_step} (pass "
            f"{pass_id}, batch {batch_id})"
            + (": checkpoint saved" if self.checkpoint_dir
               else ": no checkpoint_dir, nothing saved"))

    @contextlib.contextmanager
    def _preemption_signals(self):
        """SIGTERM/SIGINT -> request_preemption() while training (only
        from the main thread — signal.signal is main-thread-only);
        previous handlers are restored on exit."""
        if not self.preemption_checkpoint:
            yield
            return
        import signal
        import threading
        if threading.current_thread() is not threading.main_thread():
            yield
            return
        prev = {}
        handler = lambda signum, frame: self.request_preemption()  # noqa: E731
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev[sig] = signal.signal(sig, handler)
        try:
            yield
        finally:
            for sig, h in prev.items():
                signal.signal(sig, h)

    def test(self, reader, feed_order):
        """One evaluation sweep on the inference-mode clone of the
        program. The clone is PRUNED to the fetch targets: a plain
        clone(for_test=True) keeps the backward/optimizer/lr-decay ops,
        and the executor would RUN them — a test sweep must never update
        parameters or advance schedule counters. Cached per program
        version."""
        if (self._test_prog is None
                or self._test_prog_version != self.main_program.version):
            fetch_names = [self.cost.name] + self.metric_names
            self._test_prog = io._prune_for_inference(
                self.main_program, list(feed_order), fetch_names)
            self._test_prog_version = self.main_program.version
        test_prog = self._test_prog
        feeder = self._feeder(feed_order)
        fetch = [self.cost.name] + [v.name for v in self.extra_fetch]
        agg = _MetricMean(len(fetch))
        for batch in reader():
            out = self.exe.run(test_prog, feed=feeder.feed(batch),
                               fetch_list=fetch, scope=self.scope)
            agg.update([np.asarray(o) for o in out], _batch_size(batch))
        vals = agg.eval()
        return events.TestResult(metrics=vals[1:],
                                 metric_names=self.metric_names,
                                 cost=vals[0] if vals else None)

    # -- persistence --------------------------------------------------------
    def save_params(self, dirname):
        return io.save_persistables(self.exe, dirname, self.main_program,
                                    scope=self.scope)

    def save_inference_model(self, dirname, feed_names, target_vars):
        return io.save_inference_model(dirname, feed_names, target_vars,
                                       self.exe, self.main_program,
                                       scope=self.scope)


def _batch_size(batch):
    try:
        return len(batch)
    except TypeError:
        return 1


class _MetricMean:
    """Example-weighted running mean of fetched metric values."""

    def __init__(self, n):
        self.sums = [0.0] * n
        self.count = 0

    def update(self, vals, weight):
        for i, v in enumerate(vals[:len(self.sums)]):
            self.sums[i] += float(np.ravel(v)[0]) * weight
        self.count += weight

    def eval(self):
        if not self.count:
            return [0.0] * len(self.sums)
        return [s / self.count for s in self.sums]
