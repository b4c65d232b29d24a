"""RecordIO record files (the port's copy of `paddle_tpu/recordio.py`;
native C++ reader/writer via ctypes).

The data-path twin of the reference's recordio libraries (consumed by
the Go master's chunk partitioner, go/master/service.go:106). Records
are opaque bytes; `Writer`/`reader` handle framing + CRC in C++
(native/recordio.cpp, built with g++ into build/paddle_tpu_torch/ at
first use), and `reader`/`range_reader` plug into the reader decorator
chain. The file format is the JAX package's: a file either package
wrote reads in the other, and the same files give the same chunk table
and shard partition.
"""

from __future__ import annotations

import ctypes

from .native import build as _build

__all__ = ["Writer", "reader", "range_reader", "count", "write_records",
           "chunk_files", "shard_chunks", "sharded_reader"]

def _get_lib():
    return _build.load()      # built on first use, cached for the process


class Writer:
    def __init__(self, path):
        self._lib = _get_lib()
        self._h = self._lib.ptrio_open_write(path.encode())
        if not self._h:
            raise IOError(f"recordio: cannot open {path!r} for writing")

    def write(self, record: bytes):
        if self._lib.ptrio_write(self._h, record, len(record)) != 0:
            raise IOError("recordio: write failed")

    def close(self):
        if self._h:
            self._lib.ptrio_close_write(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_records(path, records):
    with Writer(path) as w:
        for r in records:
            w.write(r if isinstance(r, bytes) else bytes(r))
    return path


def count(path) -> int:
    n = _get_lib().ptrio_count(path.encode())
    if n < 0:
        raise IOError(f"recordio: cannot read {path!r} (rc={n})")
    return n


class _Reader:
    def __init__(self, path):
        self._lib = _get_lib()
        self._h = self._lib.ptrio_open_read(path.encode())
        if not self._h:
            raise IOError(f"recordio: cannot open {path!r}")
        self._cap = 1 << 16
        self._buf = ctypes.create_string_buffer(self._cap)

    def skip(self, n):
        return self._lib.ptrio_skip(self._h, n)

    def next(self):
        rc = self._lib.ptrio_next(self._h, self._buf, self._cap)
        if rc == -1:
            return None
        if rc == -2:
            raise IOError("recordio: corrupt record (CRC mismatch)")
        if rc < 0:  # -(needed)-3: grow and retry
            self._cap = -rc - 3
            self._buf = ctypes.create_string_buffer(self._cap)
            return self.next()
        # string_at copies the record alone (`.raw` would copy the
        # whole buffer first: 64 KiB a record)
        return ctypes.string_at(self._buf, rc)

    def close(self):
        if self._h:
            self._lib.ptrio_close_read(self._h)
            self._h = None


def reader(path):
    """Creator yielding every record in the file (pt.reader-compatible)."""

    def gen():
        r = _Reader(path)
        try:
            while True:
                rec = r.next()
                if rec is None:
                    return
                yield rec
        finally:
            r.close()
    return gen


def range_reader(path, start, count):
    """Creator for a (path, start, count) slice — the unit the elastic
    master schedules as one task."""

    def gen():
        r = _Reader(path)
        try:
            r.skip(start)
            for _ in range(count):
                rec = r.next()
                if rec is None:
                    return
                yield rec
        finally:
            r.close()
    return gen


# ---------------------------------------------------------------------------
# sharded partitioning: deterministic per-host / per-worker chunk sets
# (the Go master's chunk partitioner, go/master/service.go:106, as a
# library — elastic.partition_recordio schedules the SAME chunk table
# through the task queue; this path hands each shard its slice
# directly, no master required)
# ---------------------------------------------------------------------------

def chunk_files(paths, records_per_chunk=64):
    """Chunk recordio files into an ordered [{path, start, count}]
    table — the shape the elastic master schedules as tasks and
    `shard_chunks` partitions. Deterministic: same files, same chunk
    size => same table."""
    if records_per_chunk < 1:
        raise ValueError("records_per_chunk must be >= 1")
    chunks = []
    for path in paths:
        n = count(path)
        for start in range(0, n, records_per_chunk):
            chunks.append({"path": path, "start": start,
                           "count": min(records_per_chunk, n - start)})
    return chunks


def shard_chunks(chunks, num_shards, shard_id):
    """Deterministic round-robin shard assignment over an ordered chunk
    table: chunk i belongs to shard i % num_shards. Shards are disjoint
    and exhaustive by construction; the interleaving spreads a remainder
    (M % N != 0) and any per-file skew evenly instead of handing one
    shard a contiguous hot tail."""
    num_shards = int(num_shards)
    shard_id = int(shard_id)
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    if not 0 <= shard_id < num_shards:
        raise ValueError(
            f"shard_id must be in [0, {num_shards}), got {shard_id}")
    return [c for i, c in enumerate(chunks) if i % num_shards == shard_id]


def sharded_reader(paths, num_shards, shard_id, records_per_chunk=64):
    """Creator over this shard's disjoint chunk set — the per-host /
    per-worker data path of the input pipeline (reader/pipeline.py):
    host h of H reads sharded_reader(files, H, h), and N pipeline
    workers can split further with (H*N, h*N+w). Composes with the
    elastic data path: the chunk table is the one the master would
    schedule, minus the queue."""

    # the chunk table is deterministic and immutable for fixed paths:
    # compute it ONCE here, not per gen() call — chunk_files count()s
    # every file, and a reader creator is re-invoked every pass
    chunks = shard_chunks(chunk_files(paths, records_per_chunk),
                          num_shards, shard_id)

    def gen():
        for c in chunks:
            yield from range_reader(c["path"], c["start"], c["count"])()
    return gen
