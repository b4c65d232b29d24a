"""recordio in the port (`paddle_tpu_torch/recordio.py` over
`native/recordio.cpp`, built with g++ at first use) against the JAX
package's, on the CPU with the real library: the recordio half of
tests/test_elastic_recordio.py and the shard cases of
tests/test_feed_pipeline.py run on the port, files written by either
package read in the other, equal `chunk_files` / `shard_chunks` tables,
and the build's rules (hashed name under build/paddle_tpu_torch/,
builds at once do not collide, a failed build raises).
"""

import os
import struct
import threading

import numpy as np
import pytest

from paddle_tpu import recordio as jrio
from paddle_tpu_torch import recordio as prio
from paddle_tpu_torch.native import build as native_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_recordio_roundtrip(tmp_path):
    path = str(tmp_path / "data.rio")
    recs = [b"hello", b"", b"x" * 100000, np.arange(5).tobytes()]
    prio.write_records(path, recs)
    assert prio.count(path) == 4
    assert list(prio.reader(path)()) == recs


def test_recordio_range_reader(tmp_path):
    path = str(tmp_path / "data.rio")
    prio.write_records(path, [f"r{i}".encode() for i in range(10)])
    assert list(prio.range_reader(path, 3, 4)()) == [b"r3", b"r4", b"r5",
                                                     b"r6"]
    assert list(prio.range_reader(path, 8, 5)()) == [b"r8", b"r9"]


def test_recordio_detects_corruption(tmp_path):
    path = str(tmp_path / "data.rio")
    prio.write_records(path, [b"abcdefgh" * 4])
    with open(path, "r+b") as f:
        f.seek(16)
        b = f.read(1)
        f.seek(16)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(IOError, match="CRC"):
        list(prio.reader(path)())


def test_recordio_truncated_tail_is_corruption_not_eof(tmp_path):
    path = str(tmp_path / "trunc.rio")
    prio.write_records(path, [b"aaaa", b"bbbb"])
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 2)
    with pytest.raises(IOError):
        list(prio.reader(path)())
    with pytest.raises(IOError):
        prio.count(path)


def test_recordio_hostile_length_field_rejected(tmp_path):
    path = str(tmp_path / "evil.rio")
    with open(path, "wb") as f:
        f.write(b"PTR1")
        f.write(struct.pack("<II", 0xFFFFFF00, 0))
        f.write(b"\x00" * 64)
    with pytest.raises(IOError):
        list(prio.reader(path)())
    with pytest.raises(IOError):
        prio.count(path)


def test_recordio_not_a_record_file(tmp_path):
    path = str(tmp_path / "plain.txt")
    with open(path, "wb") as f:
        f.write(b"hello")
    with pytest.raises(IOError, match="cannot open"):
        list(prio.reader(path)())
    with pytest.raises(IOError, match="cannot read"):
        prio.count(path)


@pytest.mark.parametrize("writer,reader", [(jrio, prio), (prio, jrio)],
                         ids=["jax_to_port", "port_to_jax"])
def test_files_cross_packages(tmp_path, writer, reader):
    path = str(tmp_path / "x.rio")
    rng = np.random.RandomState(0)
    recs = [rng.bytes(int(n)) for n in rng.randint(0, 3000, 40)] + [b""]
    writer.write_records(path, recs)
    assert reader.count(path) == len(recs)
    assert list(reader.reader(path)()) == recs
    assert list(reader.range_reader(path, 7, 9)()) == recs[7:16]
    other = str(tmp_path / "y.rio")
    reader.write_records(other, recs)
    with open(path, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()


def _files(tmp_path, sizes):
    paths = []
    for i, n in enumerate(sizes):
        p = str(tmp_path / f"f{i}.rio")
        prio.write_records(p, [f"{i}:{j}".encode() for j in range(n)])
        paths.append(p)
    return paths


@pytest.mark.parametrize("per_chunk", [1, 3, 4, 64])
def test_chunk_and_shard_tables_equal_the_reference(tmp_path, per_chunk):
    paths = _files(tmp_path, (10, 7, 1, 0, 13))
    chunks = prio.chunk_files(paths, per_chunk)
    assert chunks == jrio.chunk_files(paths, per_chunk)
    for n in (1, 2, 3, 7, 10):
        for s in range(n):
            assert prio.shard_chunks(chunks, n, s) == \
                jrio.shard_chunks(chunks, n, s)
            assert list(prio.sharded_reader(paths, n, s, per_chunk)()) == \
                list(jrio.sharded_reader(paths, n, s, per_chunk)())


def test_shard_chunks_disjoint_exhaustive_deterministic():
    chunks = [{"path": "f", "start": 10 * i, "count": 10} for i in range(7)]
    for num_shards in (1, 2, 3, 7, 10):
        shards = [prio.shard_chunks(chunks, num_shards, s)
                  for s in range(num_shards)]
        flat = [c for sh in shards for c in sh]
        assert sorted(flat, key=lambda c: c["start"]) == chunks
        sizes = [len(sh) for sh in shards]
        assert max(sizes) - min(sizes) <= 1, (num_shards, sizes)


def test_shard_chunks_validates_args():
    for n, s in ((0, 0), (2, 2), (2, -1)):
        with pytest.raises(ValueError):
            prio.shard_chunks([], n, s)
    with pytest.raises(ValueError):
        prio.chunk_files([], 0)


def test_sharded_reader_covers_every_record(tmp_path):
    paths = _files(tmp_path, (10, 7, 1))
    full = [r for p in paths for r in prio.reader(p)()]
    for num_shards in (1, 3, 4):
        union = [r for s in range(num_shards)
                 for r in prio.sharded_reader(paths, num_shards, s, 3)()]
        assert sorted(union) == sorted(full) and len(union) == len(full)


# -- the build ----------------------------------------------------------------

def test_the_library_is_built_under_build_not_the_package():
    path = native_build.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "build",
                                                 "paddle_tpu_torch")
    assert os.path.exists(native_build.build())
    assert not [f for f in os.listdir(os.path.dirname(native_build.__file__))
                if f.endswith(".so")]


def test_the_name_carries_the_source_and_flags(monkeypatch):
    before = native_build.library_path()
    monkeypatch.setattr(native_build, "GXX_FLAGS",
                        native_build.GXX_FLAGS + ("-DPTR_X",))
    assert native_build.library_path() != before


def test_builds_at_once_do_not_collide(tmp_path, monkeypatch):
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path))
    out, errors = [], []

    def one():
        try:
            out.append(native_build.build())
        except Exception as e:          # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, daemon=True) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive(), "a build hung"
    assert not errors, errors
    assert len(set(out)) == 1 and os.listdir(tmp_path) == [
        os.path.basename(out[0])]


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_build, "GXX_FLAGS",
                        native_build.GXX_FLAGS + ("-fno-such-option",))
    with pytest.raises(RuntimeError, match="native build failed"):
        native_build.build()
