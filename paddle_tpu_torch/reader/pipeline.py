"""Device input pipeline: overlap host feed with the step on the card.

The port's copy of `paddle_tpu/reader/pipeline.py` (ROADMAP A10): a
three-stage host pipeline between a batch reader and `Executor.run`:

  source thread   -> enumerates batch_reader() and tags each batch
                     with a sequence number
  N worker threads-> convert + cast (DataFeeder + numpy) into a bounded
                     ORDERED staging buffer (out-of-order completion,
                     in-order delivery)
  device thread   -> copies each batch to the card, `prefetch_depth`
                     batches ahead of the consumer (2 = double
                     buffering)

The device stage (the reference's `jax.device_put`) copies each array
into pinned host memory and from there to the card with a
non-blocking copy on a side CUDA stream, and records an event after the
batch's copies. The consumer, on the compute stream, waits on that
event before the step reads the batch, so batch n+1's copy rides under
step n. Each batch tensor is allocated on the side stream and read on
the compute stream, so it is `record_stream`ed to the compute stream:
otherwise the caching allocator could hand its memory to a later
batch's copy while the step still reads it. The executor takes a
device tensor of the feed var's dtype as it is, with no second copy.
On the CPU (the tests) a batch is `torch.from_numpy` of the converted
array, no copy.

`workers=0` is the synchronous path: no threads, no queues — convert
and copy inline per batch, the same batches in the same order with the
same casts as the threaded path. Because the staging buffer is ordered,
every worker count yields the SAME batch sequence: `feed_workers` is a
throughput knob, never a semantics knob.

Everything is counted in `stats()` / `counters()` / `explain()` and, with
telemetry on, the `feed.*` metric family (queue depth, staging / copy /
wait-for-data histograms, bytes shipped, stall counter), which the
Trainer's EndIteration events carry.
"""

from __future__ import annotations

import collections
import queue
import threading
import time

import numpy as np
import torch

__all__ = ["DeviceFeeder", "feed_stats",
           "THREAD_PREFIX"]

# every pipeline thread name starts with this, so tests can assert zero
# survivors by prefix
THREAD_PREFIX = "paddle-tpu-feed"


class _WorkerError:
    def __init__(self, exc):
        self.exc = exc


_END = object()


class _OrderedStage:
    """Bounded reorder buffer between the convert workers and the
    device stage: workers insert (seq, item) in completion order, the
    device stage drains in strict sequence order — N workers never
    change the batch sequence the consumer sees. Backpressure: an
    insert more than `capacity` ahead of the drain cursor blocks until
    the window advances (or the pipeline stops)."""

    def __init__(self, capacity, stop):
        self._cond = threading.Condition()
        self._items = {}
        self._next = 0
        self._capacity = max(1, int(capacity))
        self._stop = stop

    def put(self, seq, item):
        with self._cond:
            while not self._stop.is_set():
                if seq < self._next + self._capacity:
                    self._items[seq] = item
                    self._cond.notify_all()
                    return True
                self._cond.wait(0.1)
        return False

    def get(self):
        """Next item in sequence order; None when the pipeline stopped."""
        with self._cond:
            while not self._stop.is_set():
                item = self._items.pop(self._next, None)
                if item is not None:
                    self._next += 1
                    self._cond.notify_all()
                    return item
                self._cond.wait(0.1)
        return None

    def size(self):
        with self._cond:
            return len(self._items)

    def wake(self):
        with self._cond:
            self._cond.notify_all()


class _FeedStats:
    """Always-on (cheap) pipeline bookkeeping behind `stats()` /
    `explain()`; mirrors into the monitor registry's `feed.*` family
    when telemetry is enabled. Thread-safe: the worker, device and
    consumer threads all record concurrently."""

    _SAMPLE = 512     # recent-sample window for the p50s

    def __init__(self, workers, prefetch_depth):
        self._lock = threading.Lock()
        self.workers = workers
        self.prefetch_depth = prefetch_depth
        self.batches = 0
        self.stalls = 0
        self.bytes = 0
        self.wait_total_s = 0.0
        self.staging_total_s = 0.0
        self.device_put_total_s = 0.0
        self._t0 = None               # first-delivery wall clock
        self._t_last = None           # last-delivery wall clock
        self._waits = collections.deque(maxlen=self._SAMPLE)
        self._stagings = collections.deque(maxlen=self._SAMPLE)
        self._puts = collections.deque(maxlen=self._SAMPLE)
        self._depths = collections.deque(maxlen=self._SAMPLE)

    def note_staging(self, dt):
        with self._lock:
            self.staging_total_s += dt
            self._stagings.append(dt)
        from ..monitor import registry as _reg
        _reg.histogram_observe("feed.staging_time_s", dt)

    def note_device_put(self, dt, nbytes):
        from ..monitor import registry as _reg
        with self._lock:
            self.device_put_total_s += dt
            self._puts.append(dt)
            self.bytes += nbytes
        _reg.histogram_observe("feed.device_put_time_s", dt)
        _reg.counter_inc("feed.bytes", nbytes)

    def note_wait(self, dt, stalled, depth, device_depth):
        from ..monitor import registry as _reg
        with self._lock:
            now = time.perf_counter()
            if self._t0 is None:
                self._t0 = now
            self._t_last = now
            self.batches += 1
            self.wait_total_s += dt
            self._waits.append(dt)
            self._depths.append(depth)
            if stalled:
                self.stalls += 1
            bps = self._rate_locked()
        _reg.histogram_observe("feed.wait_time_s", dt)
        _reg.counter_inc("feed.batches")
        _reg.gauge_set("feed.queue_depth", depth)
        _reg.gauge_set("feed.device_queue_depth", device_depth)
        if stalled:
            _reg.counter_inc("feed.stalls")
        if bps is not None:
            _reg.gauge_set("feed.bytes_per_sec", bps)

    def _rate_locked(self):
        """Achieved bytes/sec over the FIRST..LAST delivery window —
        frozen once iteration ends (a /debug/vars poll minutes later
        must not show a decaying rate), and undefined (None) before the
        second delivery (bytes already include prefetched batches, so
        dividing by the microseconds after first delivery would report
        fantasy bandwidth)."""
        if self.batches < 2:
            return None
        elapsed = self._t_last - self._t0
        return self.bytes / elapsed if elapsed > 0 else None

    @staticmethod
    def _p50(samples):
        if not samples:
            return None
        xs = sorted(samples)
        return xs[len(xs) // 2]

    def counters(self):
        """Scalar-only snapshot: what the per-step EndIteration hook
        attaches. No deque copies, no sorting — the recording threads
        hold the same lock, so the hot path must not pay percentile
        math every step (the p50s live in snapshot(), computed on
        demand)."""
        with self._lock:
            bps = self._rate_locked()
            return {
                "workers": self.workers,
                "prefetch_depth": self.prefetch_depth,
                "batches": self.batches,
                "stalls": self.stalls,
                "bytes": self.bytes,
                "bytes_per_sec": (round(bps, 1) if bps is not None
                                  else None),
                "wait_total_s": round(self.wait_total_s, 6),
                "staging_total_s": round(self.staging_total_s, 6),
                "device_put_total_s": round(self.device_put_total_s, 6),
            }

    def snapshot(self):
        # copy the sample windows under the lock, sort OUTSIDE it: the
        # convert/device threads record under the same lock
        with self._lock:
            waits = list(self._waits)
            stagings = list(self._stagings)
            puts = list(self._puts)
            depths = list(self._depths)
        out = self.counters()
        out.update({
            "queue_depth_p50": self._p50(depths),
            "wait_p50_s": self._p50(waits),
            "staging_p50_s": self._p50(stagings),
            "device_put_p50_s": self._p50(puts),
        })
        return out


class _Staged:
    """A batch on the card: its tensors and the side-stream event
    recorded after their copies."""

    __slots__ = ("feed", "event")

    def __init__(self, feed, event):
        self.feed = feed
        self.event = event


class DeviceFeeder:
    """Iterate device-resident feed dicts through the staged pipeline.

    batch_reader: zero-arg callable yielding either ready feed dicts
      ({name: array}) or minibatches (list of per-example tuples, which
      require `feeder=DataFeeder(...)` to convert).
    program/executor: the feed vars' dtypes and the executor's device,
      which every batch is copied to.
    workers: convert/cast worker threads (default: the `feed_workers`
      flag). 0 = synchronous inline feed — no threads, bit-identical
      batches/order to the threaded path.
    prefetch_depth: device-side queue depth (default: the
      `feed_prefetch_depth` flag); 2 = classic double buffering.
"""

    def __init__(self, batch_reader, program, executor, feeder=None,
                 workers=None, prefetch_depth=None):
        from .. import flags
        self.batch_reader = batch_reader
        self.program = program
        self.executor = executor
        self.feeder = feeder
        if prefetch_depth is None:
            prefetch_depth = flags.get("feed_prefetch_depth")
        self.prefetch_depth = int(prefetch_depth)
        if self.prefetch_depth < 1:
            # Queue(0) would mean UNBOUNDED prefetch — a device-memory
            # leak, the opposite of what "no buffering" suggests
            raise ValueError("DeviceFeeder prefetch_depth must be >= 1")
        self.workers = int(workers if workers is not None
                           else flags.get("feed_workers"))
        if self.workers < 0:
            raise ValueError("DeviceFeeder workers must be >= 0")
        self.device = executor.device
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        self._stats = _FeedStats(self.workers, self.prefetch_depth)

    # -- stage bodies -------------------------------------------------------
    def _convert(self, batch):
        """Host stage: minibatch -> {name: numpy array in the feed
        var's dtype}. Runs in the convert workers (or inline when
        workers=0); shares the ONE feed-dtype policy with the executor
        (host_cast_feed) so the paths cannot drift."""
        from ..executor import host_cast_feed
        feed = self.feeder.feed(batch) if self.feeder is not None else batch
        if not isinstance(feed, dict):
            raise TypeError(
                "DeviceFeeder needs feed dicts; pass feeder=DataFeeder(...) "
                "to convert minibatch tuples")
        return {name: host_cast_feed(self.program, name, np.asarray(arr))
                for name, arr in feed.items()}

    def _device_put(self, host_feed):
        """Device stage: on the card, pinned host copy, then a
        non-blocking copy on the side stream and an event after the
        batch; on the CPU the arrays as tensors, no copy."""
        if self._stream is None:
            return {name: torch.from_numpy(arr)
                    for name, arr in host_feed.items()}
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            feed = {name: torch.from_numpy(arr).pin_memory().to(
                        self.device, non_blocking=True)
                    for name, arr in host_feed.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Staged(feed, event)

    def _hand_over(self, item):
        """The consumer's side of the device stage: the compute stream
        waits for the batch's copies, and each tensor is recorded on the
        compute stream so the caching allocator keeps its memory until
        the step that reads it is done."""
        if not isinstance(item, _Staged):
            return item
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(item.event)
        for t in item.feed.values():
            t.record_stream(compute)
        return item.feed

    # -- observability ------------------------------------------------------
    def stats(self):
        """Cumulative `feed.*` snapshot of this pipeline (plain dict —
        p50s included)."""
        return self._stats.snapshot()

    def counters(self):
        """Scalar-only stats (no percentile math): the per-step
        spelling trainer EndIteration events carry as `.feed`."""
        return self._stats.counters()

    def explain(self):
        """One-line feed context for anomaly reports: a starving
        pipeline says so the way grad-norm anomalies do."""
        s = self._stats.snapshot()
        if not s["batches"]:
            return "feed: no batches delivered yet"
        if not s["stalls"]:
            return (f"feed healthy: 0 stalls over {s['batches']} batches "
                    f"(p50 wait {1e3 * (s['wait_p50_s'] or 0):.2f} ms)")
        return (f"feed stalled {s['stalls']}x over {s['batches']} batches "
                f"(p50 wait {1e3 * (s['wait_p50_s'] or 0):.2f} ms, "
                f"p50 staging {1e3 * (s['staging_p50_s'] or 0):.2f} ms, "
                f"{(s['bytes_per_sec'] or 0) / 1e6:.1f} MB/s shipped)")

    # -- iteration ----------------------------------------------------------
    def __iter__(self):
        """Generator over device-resident feed dicts. Abandoning the
        iterator early (break, GeneratorExit, exception, infinite
        reader) stops every pipeline thread promptly and releases the
        queued device batches — without this, daemon threads would pin
        prefetch_depth+ batches in device memory forever. A reader or
        conversion exception is re-raised exactly once, in batch order,
        after the batches that preceded it."""
        activate(self)
        from ..monitor import registry as _reg
        _reg.gauge_set("feed.workers", self.workers)
        if self.workers == 0:
            return self._iter_sync()
        return self._iter_async()

    def _iter_sync(self):
        """Synchronous fallback: convert + copy to the card inline. No
        threads means no overlap — and no divergence: the trajectory-
        identity contract (same batches, same order, same casts as the
        async path and the pre-pipeline feed) is pinned by test."""
        for batch in self.batch_reader():
            t0 = time.perf_counter()
            host = self._convert(batch)
            t1 = time.perf_counter()
            self._stats.note_staging(t1 - t0)
            nbytes = sum(int(a.nbytes) for a in host.values())
            dev = self._device_put(host)
            self._stats.note_device_put(time.perf_counter() - t1, nbytes)
            self._stats.note_wait(0.0, False, 0, 0)
            yield self._hand_over(dev)

    def _iter_async(self):
        stop = threading.Event()
        work_q = queue.Queue(maxsize=max(2, 2 * self.workers))
        stage = _OrderedStage(max(self.prefetch_depth, self.workers),
                              stop)
        dev_q = queue.Queue(maxsize=self.prefetch_depth)

        def q_put(q, item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def source():
            seq = 0
            try:
                for batch in self.batch_reader():
                    if stop.is_set() or not q_put(work_q, (seq, batch)):
                        return
                    seq += 1
            except BaseException as e:  # surfaced on the consumer side
                stage.put(seq, _WorkerError(e))
                return
            # the end marker rides the ordered stage at seq N: it can
            # only be delivered after every real batch before it
            stage.put(seq, _END)

        def worker():
            while not stop.is_set():
                try:
                    seq, batch = work_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                try:
                    t0 = time.perf_counter()
                    item = self._convert(batch)
                    self._stats.note_staging(time.perf_counter() - t0)
                except BaseException as e:
                    item = _WorkerError(e)
                if not stage.put(seq, item):
                    return

        def device_stage():
            while not stop.is_set():
                item = stage.get()
                if item is None:
                    return
                if item is _END or isinstance(item, _WorkerError):
                    q_put(dev_q, item)
                    return
                nbytes = sum(int(a.nbytes) for a in item.values())
                t0 = time.perf_counter()
                try:
                    dev = self._device_put(item)
                except BaseException as e:
                    q_put(dev_q, _WorkerError(e))
                    return
                self._stats.note_device_put(time.perf_counter() - t0,
                                            nbytes)
                if not q_put(dev_q, dev):
                    return

        threads = [threading.Thread(target=source, daemon=True,
                                    name=f"{THREAD_PREFIX}-source")]
        threads += [threading.Thread(target=worker, daemon=True,
                                     name=f"{THREAD_PREFIX}-worker-{i}")
                    for i in range(self.workers)]
        dev_thread = threading.Thread(target=device_stage, daemon=True,
                                      name=f"{THREAD_PREFIX}-device")
        threads.append(dev_thread)
        for t in threads:
            t.start()
        try:
            first = True
            while True:
                t0 = time.perf_counter()
                stalled = False
                try:
                    item = dev_q.get_nowait()
                except queue.Empty:
                    stalled = True
                    item = None
                    while item is None:
                        try:
                            item = dev_q.get(timeout=0.1)
                        except queue.Empty:
                            if not dev_thread.is_alive() and dev_q.empty():
                                raise RuntimeError(
                                    "feed pipeline device stage died "
                                    "without a result or an error")
                if item is _END:
                    return
                if isinstance(item, _WorkerError):
                    raise item.exc
                self._stats.note_wait(time.perf_counter() - t0,
                                      stalled and not first,
                                      stage.size(), dev_q.qsize())
                first = False
                yield self._hand_over(item)
        finally:
            stop.set()
            stage.wake()
            while True:         # unblock a device stage stuck in put()
                try:
                    dev_q.get_nowait()
                except queue.Empty:
                    break
            for t in threads:
                t.join(timeout=5.0)


# the latest activated pipeline's stats (one training feed per process
# is the operational case; its last stats persist after iteration
# ends). Only the _FeedStats object is retained: keeping the feeder
# itself would pin its reader closure, program and executor for the
# process's lifetime.
_active = None


def activate(feeder):
    global _active
    _active = feeder._stats
    return feeder


def feed_stats():
    """Latest active pipeline's stats dict; None when no pipeline has
    run."""
    if _active is None:
        return None
    return _active.snapshot()
