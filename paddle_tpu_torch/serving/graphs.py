"""Serving rungs captured as CUDA graphs.

The port's counterpart of the reference's compiled dispatch steps: the
LM engine's `jax.jit` of its prefill, decode and page-copy functions
(`paddle_tpu/serving/lm.py:658-667`) with the baked AOT rungs it can
load per rung key (`paddle_tpu/io.py::load_lm_aot_rungs`, :1296), and
the one-shot engine's executable per bucket rung. PyTorch dispatches
each of a step's kernels from the host (~500 for a GPT-2-small decode
step); a CUDA graph records them once and replays them in one launch.

`StepGraphs` holds one engine's rungs, keyed by the engine's rung key.
A rung is one fixed-shape dispatch `fn(*device_inputs) -> outputs` and
holds:
  * static device input buffers at the rung's shapes and dtypes, and
    pinned host staging for them;
  * the `torch.cuda.CUDAGraph` of one call of `fn` on those buffers;
  * the static output tensors the graph writes, and pinned host
    buffers they are copied into.

`run(key, fn, *host_arrays)` captures the rung at its first call (as
jit compiles at first call; the engines' warmups reach every rung
first, largest first), then copies the arrays into the staging and on
to the static inputs, replays the graph, copies the outputs back, waits
for the stream and returns numpy arrays. What `fn` writes in place
(the LM engine's KV planes, allocated before any capture) the replay
writes in place too.

Rules the engines keep: every graph of an engine allocates from one
memory pool, so their transients share memory; that is safe because
every capture and every replay runs under the engine's dispatch lock
and the outputs are copied out before the next replay. A rung is
warmed by one eager call on the capture's side stream before it is
captured (builds the kernels, loads the libraries), and a capture that
fails raises with the rung key: there is no eager fallback.

Captures are guarded against the rest of the process. They run one at
a time in the process, in CUDA's thread-local capture mode, so another
thread's CUDA calls (another engine's replays) neither fail nor break
them; and with Python's automatic garbage collection off: a dropped
engine is a reference cycle, and the collector, run mid-capture in the
capturing thread, would destroy its graphs there, which CUDA refuses
during a capture and which invalidates it.

The kernel wrappers count their launches in Python
(ops/launch_counts.py), which runs once at capture and never at replay.
So the counts the capturing thread made during the capture are taken
back and recorded as the rung's deltas, and every replay adds them: the
counters count the kernels that ran on the card.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time

import numpy as np
import torch

from .. import monitor
from ..ops.launch_counts import count, tallied

__all__ = ["StepGraphs"]


_capturing = threading.Lock()      # one capture at a time in the process


@contextlib.contextmanager
def _alone():
    """The process's one capture, with automatic garbage collection
    off (see the module docstring)."""
    with _capturing:
        collecting = gc.isenabled()
        gc.disable()
        try:
            yield
        finally:
            if collecting:
                gc.enable()


def _torch_dtype(a):
    return torch.from_numpy(np.empty(0, a.dtype)).dtype


class _Rung:
    __slots__ = ("graph", "inputs", "staged", "outputs", "fetched",
                 "deltas")


class StepGraphs:
    """One engine's captured rungs on `device` (a CUDA device). The
    caller holds its dispatch lock around every `run`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.Stream(self.device)
        self._rungs = {}
        # the captured keys, replaced (never mutated) at each capture:
        # stats() reads it from other threads without the dispatch lock
        self._keys = ()

    def keys(self):
        """The captured rung keys, in capture order."""
        return list(self._keys)

    def __len__(self):
        return len(self._keys)

    def run(self, key, fn, *host):
        """`fn(*host)` on the card through the rung's graph (captured
        now if `key` has none); returns the outputs as numpy arrays."""
        host = [np.asarray(a) for a in host]
        rung = self._rungs.get(key)
        if rung is None:
            t0 = time.perf_counter()
            rung = self._rungs[key] = self._capture(key, fn, host)
            self._keys = self._keys + (key,)
            # a capture is the port's counterpart of the reference's
            # compile of a rung: the executor.compile_last_s table
            if monitor.enabled():
                monitor.introspect.note_compile(
                    f"cuda_graph:{key}", time.perf_counter() - t0)
        return self._replay(key, rung, host)

    def _capture(self, key, fn, host):
        dev = self.device
        rung = _Rung()
        rung.inputs = [torch.empty(a.shape, dtype=_torch_dtype(a),
                                   device=dev) for a in host]
        rung.staged = [(t, t.numpy()) for t in (
            torch.empty(a.shape, dtype=_torch_dtype(a), pin_memory=True)
            for a in host)]
        for (t, view), a, x in zip(rung.staged, host, rung.inputs):
            np.copyto(view, a)
            x.copy_(t)
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        tally = {}
        try:
            with torch.cuda.stream(stream):
                fn(*rung.inputs)                   # the warm-up call
            torch.cuda.current_stream(dev).wait_stream(stream)
            with _alone(), tallied() as tally, torch.cuda.graph(
                    graph, pool=self.pool, stream=stream,
                    capture_error_mode="thread_local"):
                out = fn(*rung.inputs)
        except Exception as e:
            raise RuntimeError(f"warming or capturing the serving rung "
                               f"{key!r} as a CUDA graph failed: "
                               f"{e}") from e
        finally:
            # the warm-up's launches ran; the capture's did not
            for (w, a), n in tally.items():
                count(w, a, -n)
        outs = (() if out is None else tuple(out)
                if isinstance(out, (tuple, list)) else (out,))
        if not all(isinstance(o, torch.Tensor) for o in outs):
            raise TypeError(f"serving rung {key!r} returned "
                            f"{[type(o).__name__ for o in outs]}; a "
                            "captured rung returns tensors")
        rung.graph = graph
        rung.outputs = outs
        # numpy has no bfloat16: a bf16 output comes back as float32,
        # exactly, as the Executor fetches it
        rung.fetched = [torch.empty(
            o.shape, dtype=torch.float32 if o.dtype == torch.bfloat16
            else o.dtype, pin_memory=True) for o in outs]
        rung.deltas = [(w, a, n) for (w, a), n in tally.items() if n]
        return rung

    def _replay(self, key, rung, host):
        for (t, view), a, x in zip(rung.staged, host, rung.inputs):
            if a.shape != view.shape:
                raise ValueError(f"serving rung {key!r} was captured for "
                                 f"input shape {view.shape}, got "
                                 f"{a.shape}")
            np.copyto(view, a)
            x.copy_(t, non_blocking=True)
        rung.graph.replay()
        for o, f in zip(rung.outputs, rung.fetched):
            f.copy_(o, non_blocking=True)
        # the staging is reused by the next call: wait for the copies
        torch.cuda.current_stream(self.device).synchronize()
        for w, a, n in rung.deltas:
            count(w, a, n)
        return [f.numpy().copy() for f in rung.fetched]
