"""Online inference engine: dynamic micro-batching over one device call.

The port of `paddle_tpu/serving/engine.py`'s one-shot engine:

  * `submit()` enqueues a request and returns a `PendingResult`; a
    background batcher thread collects requests until `max_batch_size`
    rows are waiting or `batch_timeout_ms` has passed since the first,
    pads the concatenated feeds up to a **bucket-ladder** rung
    (batching.py), runs ONE call of the model, and splits the rows back
    per request.
  * the ladder bounds the distinct dispatch shapes, so `warmup()` runs
    every rung once before traffic. On the card each rung is a CUDA
    graph (serving/graphs.py) of one `Executor.run` on static device
    feeds, the counterpart of the reference's executable per bucket:
    `warmup()` captures them largest first (a rung first dispatched
    before it is captured then), and every dispatch replays its rung's
    graph under the engine's dispatch lock.
  * **admission control**: a bounded queue — `submit` on a full queue
    raises `ServerOverloadedError` (nothing enqueued). Per-request
    deadlines are enforced while queued and again immediately before
    dispatch; expired requests are shed with `DeadlineExceededError`
    and never reach the device.
  * `shutdown(drain=True)` completes every in-flight request before
    returning; `drain=False` fails queued requests with
    `EngineClosedError`. Either way `submit` afterwards raises.

The backend is a live (program, scope) pair run by the port's Executor,
on the card unless the caller passes a CPU executor:

    InferenceEngine.from_program(program, feeds, targets, executor)

or an artifact that embeds its program (`paddle_tpu.io.
export_inference_artifact(..., embed_program=True)`), whose program
and arrays it reads into a fresh scope and serves the same way:

    InferenceEngine.from_artifact(path, config=None, device=None)

The artifact's StableHLO module and AOT rungs are JAX executables and
are never read; a plain artifact (no embedded program) is refused with
a named error. Observability lands in the `monitor` registry (when the
`metrics` flag is on), in the engine's always-on `stats()` dict (the
/healthz payload, and /debug/vars's `engine` section) and, with the
`profile_sample_n` flag, in the sampled device times of
monitor/deviceprof.py (`stats()["deviceprof"]`).
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np

from .. import monitor
from . import batching
from .graphs import StepGraphs
from .errors import (DeadlineExceededError, EngineClosedError,
                     ServerOverloadedError)

__all__ = ["EngineConfig", "PendingResult", "InferenceEngine"]


def _finish(span, error=None):
    """Close a maybe-None span (span recording off => None everywhere)."""
    if span is not None:
        span.finish(error=error)


class EngineConfig:
    """Batcher knobs. Unset values fall back to the `serving_*` runtime
    flags (flags.py), so deployments tune via PADDLE_TPU_SERVING_* env.

      max_batch_size    — admission bound AND largest ladder rung.
      batch_timeout_ms  — how long the batcher holds an incomplete batch
                          open for more requests (0 = dispatch whatever
                          is queued immediately).
      queue_limit       — bounded-queue capacity in *requests*; submit
                          beyond it is rejected.
      buckets           — explicit ladder (iterable), else powers of 2.
      default_deadline_ms — applied when submit() passes deadline=None;
                          None/0 = no deadline.
    """

    def __init__(self, max_batch_size=None, batch_timeout_ms=None,
                 queue_limit=None, buckets=None, default_deadline_ms=None):
        from .. import flags
        if buckets is not None and max_batch_size is None:
            max_batch_size = max(int(b) for b in buckets)
        self.max_batch_size = int(max_batch_size
                                  if max_batch_size is not None
                                  else flags.get("serving_max_batch_size"))
        self.batch_timeout_ms = float(
            batch_timeout_ms if batch_timeout_ms is not None
            else flags.get("serving_batch_timeout_ms"))
        self.queue_limit = int(queue_limit if queue_limit is not None
                               else flags.get("serving_queue_limit"))
        if self.queue_limit < 1:
            raise ValueError("queue_limit must be >= 1")
        if self.batch_timeout_ms < 0:
            raise ValueError("batch_timeout_ms must be >= 0")
        self.default_deadline_ms = default_deadline_ms
        self.buckets = batching.bucket_ladder(self.max_batch_size, buckets)


class PendingResult:
    """Write-once future for one submitted request.

    `trace_id` is always set (generated at submit, or adopted from the
    caller / the inbound `x-trace-id` header); `_span`/`_queue_span`
    hold the request-lifecycle spans when recording is on (None
    otherwise)."""

    __slots__ = ("arrays", "rows", "deadline_at", "deadline_s",
                 "enqueued_at", "trace_id", "_span", "_queue_span",
                 "_event", "_outputs", "_error")

    def __init__(self, arrays, rows, deadline_s):
        self.arrays = arrays
        self.rows = rows
        self.deadline_s = deadline_s
        now = time.monotonic()
        self.enqueued_at = now
        # deadline 0 (or negative) means an exhausted budget — already
        # expired — NOT "no deadline"; only None disables the deadline
        self.deadline_at = (now + deadline_s) if deadline_s is not None \
            else None
        self.trace_id = None
        self._span = None
        self._queue_span = None
        self._event = threading.Event()
        self._outputs = None
        self._error = None

    def _fulfill(self, outputs):
        self._outputs = outputs
        _finish(self._span)
        self._event.set()

    def _fail(self, error):
        self._error = error
        _finish(self._queue_span, error=error)
        _finish(self._span, error=error)
        self._event.set()

    def expired(self, now=None):
        return (self.deadline_at is not None
                and (now if now is not None else time.monotonic())
                > self.deadline_at)

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        """Block for the outputs (list, one array per fetch). Raises the
        engine-assigned error for shed/rejected/failed requests."""
        if not self._event.wait(timeout):
            raise TimeoutError("result not ready within "
                               f"{timeout}s (request still in flight)")
        if self._error is not None:
            raise self._error
        return self._outputs


class InferenceEngine:
    """Thread-safe micro-batching front end over one infer callable.

    `infer_fn(*positional_arrays) -> sequence of outputs` where every
    array's axis 0 is the batch dim. `feed_names` fixes the positional
    order (dict submissions are reordered to it); `input_specs`
    ([{"name", "dtype", "shape"}] with -1 batch dims) enables feed
    validation, dtype coercion, and `warmup()`. `from_program` on the
    card gives the engine a graph runner: its `infer_fn` takes and
    returns tensors on the card, and each padded feed signature is a
    CUDA graph of it on static inputs.
    """

    def __init__(self, infer_fn, feed_names, fetch_names,
                 input_specs=None, config=None, start=True, ready=True):
        self._infer_fn = infer_fn
        self._graphs = None           # from_program's, on the card
        self._dispatch_lock = threading.Lock()
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.input_specs = ({s["name"]: s for s in input_specs}
                            if input_specs else None)
        self.config = config or EngineConfig()
        # readiness is distinct from liveness: the serve CLI constructs
        # with ready=False and warmup() flips it
        self._ready = bool(ready)
        self._cond = threading.Condition()
        self._queue = collections.deque()
        self._stopping = False
        self._closed = False
        self._shapes = set()          # distinct dispatch signatures
        self._warmed = ()
        self._warmup_s = {}           # rung -> warmup seconds
        self._quant = None            # quant summary of the model
        self._stats = collections.Counter()
        # sampled device profiling (flag profile_sample_n=N): None when
        # disabled — the off path constructs nothing and costs one
        # attribute test a batch
        self._profiler = monitor.deviceprof.sampler_from_flags()
        self._thread = None
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="paddle-tpu-torch-batcher",
                                            daemon=True)
            self._thread.start()
        return self

    def shutdown(self, drain=True, timeout=None):
        """Stop the batcher. drain=True completes every queued request
        first; drain=False fails them with EngineClosedError. Idempotent;
        submit() afterwards raises EngineClosedError."""
        with self._cond:
            self._stopping = True
            abandoned = []
            if not drain:
                abandoned = list(self._queue)
                self._queue.clear()
            self._cond.notify_all()
        for req in abandoned:
            self._count("abandoned")
            req._fail(EngineClosedError(
                "engine shut down without draining the queue"))
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("batcher did not stop within "
                                   f"{timeout}s")
        self._closed = True
        self._gauge_depth()
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=exc == (None, None, None))

    # -- submission ---------------------------------------------------------

    def submit(self, feeds, deadline=None, trace_id=None):
        """Enqueue one request; returns a PendingResult.

        `feeds`: dict name -> array, or positional sequence in
        `feed_names` order; axis 0 is the batch dim (1 <= rows <=
        max_batch_size). `deadline`: seconds from now this request is
        worth computing; once it lapses the request is shed, never run
        (0 or negative = shed on arrival; None = no deadline).
        `trace_id`: adopt the caller's trace; None generates one.
        """
        trace_id = trace_id or monitor.new_trace_id()
        root = monitor.start_span("serving/request", trace_id=trace_id)
        admit = monitor.start_span("serving/admit", parent=root)
        try:
            arrays, rows = self._normalize(feeds)
            if deadline is None and self.config.default_deadline_ms:
                deadline = self.config.default_deadline_ms / 1e3
            req = PendingResult(arrays, rows, deadline)
            req.trace_id = trace_id
            req._span = root
            if root is not None:
                root.set_attr("rows", rows)
            with self._cond:
                if self._stopping or self._closed:
                    raise EngineClosedError("engine is shut down")
                depth = len(self._queue)
                if depth >= self.config.queue_limit:
                    self._stats["rejected"] += 1
                    monitor.counter_inc("serving.rejected")
                    raise ServerOverloadedError(depth,
                                                self.config.queue_limit)
                req._queue_span = monitor.start_span(
                    "serving/queue_wait", parent=root,
                    attrs={"depth_at_enqueue": depth})
                self._queue.append(req)
                self._stats["submitted"] += 1
                self._cond.notify_all()
        except BaseException as e:
            # admission failed (bad feeds / overload / closed): the
            # request never enqueued, so its spans close here
            _finish(admit, error=e)
            _finish(root, error=e)
            raise
        _finish(admit)
        monitor.counter_inc("serving.requests")
        self._gauge_depth()
        return req

    def infer(self, feeds, deadline=None, timeout=None, trace_id=None):
        """submit() and wait — the one-call convenience."""
        return self.submit(feeds, deadline=deadline,
                           trace_id=trace_id).result(timeout)

    def warmup(self):
        """Run every ladder rung once with zero-filled feeds, largest
        first, so no request pays a first-call cost (kernel builds,
        allocator growth; on the card the rung's CUDA-graph capture,
        which raises with the rung's signature if it fails). Needs
        input_specs (from_program derives them). Returns the rung
        list."""
        if not self.input_specs:
            raise RuntimeError("warmup() needs input_specs describing "
                               "the feed shapes/dtypes")
        for bucket in sorted(self.config.buckets, reverse=True):
            arrays = [self._zero_feed(name, bucket)
                      for name in self.feed_names]
            t0 = time.perf_counter()
            self._dispatch(arrays)
            dt = time.perf_counter() - t0
            with self._cond:
                self._warmup_s[int(bucket)] = round(dt, 6)
            monitor.histogram_observe(f"serving.warmup_s|rung={bucket}",
                                      dt)
        self._warmed = tuple(self.config.buckets)
        self._ready = True
        return list(self._warmed)

    @property
    def ready(self):
        """Readiness (warmup done / explicitly marked), independent of
        liveness: the /healthz readiness probe keys off this."""
        return self._ready

    def set_ready(self, flag=True):
        self._ready = bool(flag)
        return self._ready

    # -- introspection ------------------------------------------------------

    def stats(self):
        """Always-on engine counters (independent of the metrics flag):
        the /healthz payload."""
        with self._cond:
            depth = len(self._queue)
            snap = dict(self._stats)
            shapes = len(self._shapes)
            warmup_s = dict(self._warmup_s)
        # not under the dispatch lock, which a dispatch holds throughout
        graphs = (sorted(key[0][0][0] for key in self._graphs.keys())
                  if self._graphs is not None else [])
        out = {"queue_depth": depth, "queue_limit": self.config.queue_limit,
               "max_batch_size": self.config.max_batch_size,
               "batch_timeout_ms": self.config.batch_timeout_ms,
               "buckets": list(self.config.buckets),
               "warmed_buckets": list(self._warmed),
               "warmup_s": {str(b): s
                            for b, s in sorted(warmup_s.items())},
               "quant": self._quant,
               "distinct_dispatch_shapes": shapes,
               "aot_buckets": graphs,
               "aot_status": ("cuda_graph" if self._graphs is not None
                              else "none"),
               "closed": self._closed,
               "ready": self._ready,
               **{k: snap.get(k, 0) for k in
                  ("submitted", "completed", "batches", "rejected",
                   "shed", "errors", "abandoned")}}
        if self._profiler is not None:
            # optional section: absent when sampling is off
            out["deviceprof"] = self._profiler.section()
        return out

    # -- internals ----------------------------------------------------------

    def _zero_feed(self, name, bucket):
        spec = self.input_specs[name]
        shape = tuple(bucket if d == -1 else int(d)
                      for d in spec["shape"])
        return np.zeros(shape, dtype=np.dtype(spec["dtype"]))

    def _normalize(self, feeds):
        if isinstance(feeds, dict):
            extra = set(feeds) - set(self.feed_names)
            missing = set(self.feed_names) - set(feeds)
            if extra or missing:
                raise ValueError(
                    f"feeds must be exactly {self.feed_names}; "
                    f"missing={sorted(missing)} unknown={sorted(extra)}")
            arrays = [np.asarray(feeds[n]) for n in self.feed_names]
        else:
            arrays = [np.asarray(a) for a in feeds]
            if len(arrays) != len(self.feed_names):
                raise ValueError(f"expected {len(self.feed_names)} "
                                 f"positional feeds ({self.feed_names}), "
                                 f"got {len(arrays)}")
        rows = None
        for name, arr in zip(self.feed_names, arrays):
            if arr.ndim < 1:
                raise ValueError(f"feed {name!r} must have a batch dim")
            if rows is None:
                rows = arr.shape[0]
            elif arr.shape[0] != rows:
                raise ValueError(
                    f"feed {name!r} has {arr.shape[0]} rows; other feeds "
                    f"in this request have {rows}")
        if rows < 1:
            raise ValueError("a request needs at least one row")
        if rows > self.config.max_batch_size:
            raise ValueError(
                f"request of {rows} rows exceeds max_batch_size "
                f"{self.config.max_batch_size} — split it client-side")
        if self.input_specs:
            arrays = [self._check_spec(n, a)
                      for n, a in zip(self.feed_names, arrays)]
        return arrays, rows

    def _check_spec(self, name, arr):
        spec = self.input_specs[name]
        want = spec["shape"]
        if arr.ndim != len(want) or any(
                w != -1 and arr.shape[i] != w
                for i, w in enumerate(want)):
            raise ValueError(
                f"feed {name!r} shape {tuple(arr.shape)} does not match "
                f"the model's spec {want} (-1 = batch dim)")
        dtype = np.dtype(spec["dtype"])
        if arr.dtype != dtype:
            arr = arr.astype(dtype)
        return arr

    def _count(self, key, n=1):
        with self._cond:
            self._stats[key] += n

    def _gauge_depth(self):
        if monitor.enabled():
            with self._cond:
                depth = len(self._queue)
            monitor.gauge_set("serving.queue_depth", depth)

    def _shed(self, req, now):
        self._count("shed")
        monitor.counter_inc("serving.deadline_shed")
        req._fail(DeadlineExceededError(now - req.enqueued_at,
                                        req.deadline_s))

    def _loop(self):
        while True:
            batch = self._collect()
            if batch is None:
                return
            if batch:
                try:
                    self._run_batch(batch)
                except Exception as e:   # noqa: BLE001 — last resort:
                    # an escape here would kill the batcher thread and
                    # hang every future request; fail the batch instead
                    self._count("errors")
                    monitor.counter_inc("serving.errors")
                    monitor.blackbox.maybe_dump(
                        "serving_batch_failure", error=e,
                        extra={"trace_ids": [r.trace_id for r in batch]})
                    for req in batch:
                        if not req.done():
                            req._fail(e)
            self._gauge_depth()

    def _collect(self):
        """Form one batch: wait for a first request, then hold the batch
        open (up to batch_timeout_ms) while more rows fit. Expired
        requests are shed instead of collected. Returns None when the
        engine is stopping and the queue is drained."""
        timeout_s = self.config.batch_timeout_ms / 1e3
        shed, batch, rows = [], [], 0
        with self._cond:
            while not self._queue:
                if self._stopping:
                    return None
                self._cond.wait()
            close_at = time.monotonic() + timeout_s
            while True:
                now = time.monotonic()
                while (self._queue
                       and rows + self._queue[0].rows
                       <= self.config.max_batch_size):
                    req = self._queue.popleft()
                    if req.expired(now):
                        shed.append(req)
                        continue
                    _finish(req._queue_span)
                    batch.append(req)
                    rows += req.rows
                if (rows >= self.config.max_batch_size or self._stopping
                        or self._queue):   # full / draining / head too big
                    break
                remaining = close_at - now
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
        now = time.monotonic()
        for req in shed:
            self._shed(req, now)
        return batch

    def _run_batch(self, batch):
        # the last deadline gate: time passed while the batch was held
        # open, so re-check before spending device time
        now = time.monotonic()
        live = []
        for req in batch:
            if req.expired(now):
                self._shed(req, now)
            else:
                live.append(req)
        if not live:
            return
        self._count("batches")
        monitor.counter_inc("serving.batches")
        # the batch's spans are SHARED by every co-batched request; each
        # carries every member's trace id in `trace_ids`
        trace_ids = [r.trace_id for r in live]
        batch_span = monitor.start_span(
            "serving/batch",
            attrs={"requests": len(live), "trace_ids": trace_ids})
        t0 = time.perf_counter()
        dispatch_span = None
        try:
            # formation (concat/pad) stays INSIDE the guard: mismatched
            # trailing dims must fail the batch, not kill the batcher
            rows = sum(r.rows for r in live)
            bucket = batching.round_up_to_bucket(rows,
                                                 self.config.buckets)
            with monitor.span("serving/batch/pad", parent=batch_span,
                              attrs={"rows": rows, "bucket": bucket,
                                     "trace_ids": trace_ids}):
                padded, slices = batching.pad_to_bucket(
                    [r.arrays for r in live], bucket)
            monitor.histogram_observe("serving.batch_size", rows)
            monitor.histogram_observe("serving.padding_waste",
                                      (bucket - rows) / bucket)
            dispatch_span = monitor.start_span(
                "serving/batch/dispatch", parent=batch_span,
                attrs={"rows": rows, "bucket": bucket,
                       "trace_ids": trace_ids})
            outputs = self._profiled_dispatch(padded, bucket, trace_ids)
            _finish(dispatch_span)
            with monitor.span("serving/batch/split", parent=batch_span,
                              attrs={"trace_ids": trace_ids}):
                per_request = batching.split_rows(outputs, slices)
        except Exception as e:   # noqa: BLE001 — batch fails, engine lives
            self._count("errors")
            monitor.counter_inc("serving.errors")
            _finish(dispatch_span, error=e)
            _finish(batch_span, error=e)
            monitor.blackbox.maybe_dump(
                "serving_batch_failure", error=e,
                extra={"trace_ids": trace_ids, "engine": self.stats()})
            for req in live:
                req._fail(e)
            return
        _finish(batch_span)
        monitor.histogram_observe("serving.batch_latency_s",
                                  time.perf_counter() - t0)
        done = time.monotonic()
        for req, outs in zip(live, per_request):
            self._count("completed")
            monitor.histogram_observe("serving.request_latency_s",
                                      done - req.enqueued_at)
            if req._span is not None and dispatch_span is not None:
                # link each request's tree to the shared dispatch span
                req._span.set_attr("batch_span_id",
                                   dispatch_span.span_id)
                req._span.set_attr("cobatched", len(live))
            req._fulfill(outs)

    def _profiled_dispatch(self, padded, bucket, trace_ids):
        """Route an elected 1-in-N batch through the sampling profiler
        (its device time into serving.device_time|rung=, a rate-limited
        full capture, stamped with the batch's trace ids); everything
        else goes straight to _dispatch."""
        prof = self._profiler
        if prof is not None and prof.tick():
            return prof.sample(self._dispatch, padded, rung=bucket,
                               trace_ids=trace_ids)
        return self._dispatch(padded)

    def _dispatch(self, padded):
        """One call of the model (on the card: the replay of its rung's
        graph); tracks the distinct dispatch signatures so 'dispatch
        shapes == warmed buckets' is observable, and sets
        `serving.compiled_shapes` to the captured graphs (the distinct
        signatures on the CPU)."""
        sig = tuple(a.shape for a in padded)
        with self._cond:
            if sig not in self._shapes:
                self._shapes.add(sig)
                n = len(self._shapes)
            else:
                n = None
        with self._dispatch_lock:
            if self._graphs is not None:
                key = tuple((a.shape, a.dtype.str) for a in padded)
                outputs = self._graphs.run(key, self._infer_fn, *padded)
                n = len(self._graphs) if n is not None else None
            else:
                outputs = self._infer_fn(*padded)
        if n is not None:
            monitor.gauge_set("serving.compiled_shapes", n)
        return [np.asarray(o) for o in outputs]

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_artifact(cls, path, config=None, start=True, device=None):
        """Serve a version-3 artifact written by the JAX package's
        `export_inference_artifact(..., embed_program=True)`: its
        embedded program and npz arrays go into a fresh `Scope` on
        `device` (None: the card) and are served by `from_program`, so
        on the card each rung is a CUDA graph. A fixed-batch export
        (`symbolic_batch` False) clamps the ladder to the one baked
        rung and admits requests of that size only, as the reference
        does. The StableHLO module and AOT rungs
        are not read (`stats()["aot_status"]` is "cuda_graph" on the
        card, "none" on the CPU). A plain artifact raises the reference's
        named ValueError."""
        import torch

        from .. import io as io_mod
        from .. import quant as quant_mod
        from ..executor import Executor, Scope

        meta, program, arrays = io_mod.read_embedded_program(path)
        exe = Executor(device)
        scope = Scope()
        for name, arr in arrays.items():
            scope.set(name, torch.from_numpy(np.array(arr)).to(exe.device))
        if quant_mod.has_quant_ops(program):
            quant_mod.ensure_loadable(program, scope)
            quant_mod.place_int8_weights(program, scope)
        specs = meta.get("input_specs")
        if meta.get("symbolic_batch") is False and specs:
            # the export admits exactly the baked batch: one rung
            baked = int(specs[0]["shape"][0]) if specs[0]["shape"] else 1
            base = config or EngineConfig()
            config = EngineConfig(max_batch_size=baked, buckets=(baked,),
                                  batch_timeout_ms=base.batch_timeout_ms,
                                  queue_limit=base.queue_limit,
                                  default_deadline_ms=
                                  base.default_deadline_ms)
        engine = cls.from_program(program, meta["feed_names"],
                                  meta["fetch_names"], executor=exe,
                                  scope=scope, config=config, start=False)
        if specs:
            # the export's own specs: a fixed-batch artifact admits
            # requests of the baked size only, as in the reference
            engine.input_specs = {s["name"]: s for s in specs}
        if meta.get("quant"):
            engine._quant = quant_mod.record_artifact_loaded(meta["quant"])
        return engine.start() if start else engine

    @classmethod
    def from_program(cls, program, feed_names, target_vars, executor=None,
                     scope=None, config=None, start=True):
        """Serve a live (program, scope) pair through the Executor (the
        weights stay in the scope). `executor=None` runs on the card."""
        from .. import framework
        from ..executor import Executor, global_scope
        from ..io import _prune_for_inference

        fetch_names = [v.name if isinstance(v, framework.Variable) else v
                       for v in target_vars]
        pruned = _prune_for_inference(program, list(feed_names),
                                      fetch_names)
        exe = (executor if isinstance(executor, Executor)
               else Executor())
        scope = scope or global_scope()
        block = pruned.global_block()
        sorted_names = sorted(feed_names)
        input_specs = []
        for name in sorted_names:
            var = block.var(name)
            dims = [(-1 if (s is None or s < 0) else int(s))
                    for s in (var.shape or (1,))]
            input_specs.append({"name": name, "dtype": var.dtype,
                                "shape": dims})

        card = exe.device.type == "cuda"

        def infer_fn(*feeds):
            # numpy in and out on the CPU; on the card, captured per
            # rung: its static device tensors in, device tensors out
            return exe.run(pruned, feed=dict(zip(sorted_names, feeds)),
                           fetch_list=fetch_names, scope=scope,
                           return_numpy=not card)

        engine = cls(infer_fn, sorted_names, fetch_names,
                     input_specs=input_specs, config=config, start=False)
        if card:
            engine._graphs = StepGraphs(exe.device)
        return engine.start() if start else engine
