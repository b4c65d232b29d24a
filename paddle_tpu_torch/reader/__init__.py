"""Reader decorators (the port's device-free copy of
`paddle_tpu/reader/__init__.py`).

A reader is a zero-arg callable returning a generator of samples — the
same composable-decorator design as the reference (batch, shuffle,
buffered, map_readers, compose, chain, firstn, cache, xmap_readers).
`DeviceFeeder` (pipeline.py) is the stage that converts the batches and
copies them to the card ahead of the step.
"""

from __future__ import annotations

import itertools
import queue
import random
import threading

__all__ = ["batch", "shuffle", "buffered", "map_readers", "compose",
           "chain", "firstn", "cache", "xmap_readers",
           "DeviceFeeder", "feed_stats"]

from .pipeline import DeviceFeeder, feed_stats  # noqa: E402,F401


def batch(reader, batch_size, drop_last=True):
    def batch_reader():
        b = []
        for sample in reader():
            b.append(sample)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batch_reader


def shuffle(reader, buf_size, seed=None):
    rng = random.Random(seed)

    def shuffle_reader():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        rng.shuffle(buf)
        yield from buf
    return shuffle_reader


def buffered(reader, size):
    """Prefetch via a background thread (decorator.py buffered)."""
    end = object()

    def buffered_reader():
        q = queue.Queue(maxsize=size)

        def worker():
            try:
                for sample in reader():
                    q.put(sample)
            finally:
                q.put(end)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            sample = q.get()
            if sample is end:
                break
            yield sample
    return buffered_reader


def map_readers(func, *readers):
    def reader():
        for args in zip(*[r() for r in readers]):
            yield func(*args)
    return reader


def compose(*readers, check_alignment=True):
    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        for outputs in zip(*[r() for r in readers]):
            yield sum((make_tuple(o) for o in outputs), ())
    return reader


def chain(*readers):
    def reader():
        for r in readers:
            yield from r()
    return reader


def firstn(reader, n):
    def reader_n():
        return itertools.islice(reader(), n)
    return reader_n


def cache(reader):
    done = []

    def cached():
        if done:
            yield from done[0]
            return
        items = []
        for s in reader():
            items.append(s)
            yield s
        done.append(items)
    return cached


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map via threads (decorator.py xmap_readers)."""
    end = object()

    def xreader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)

        def feed():
            for s in reader():
                in_q.put(s)
            for _ in range(process_num):
                in_q.put(end)

        def work():
            while True:
                s = in_q.get()
                if s is end:
                    out_q.put(end)
                    break
                out_q.put(mapper(s))

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()
        finished = 0
        while finished < process_num:
            s = out_q.get()
            if s is end:
                finished += 1
            else:
                yield s
    return xreader
