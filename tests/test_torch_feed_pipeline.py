"""The port's input pipeline (reader/pipeline.py, reader decorators,
DataFeeder) on the CPU.

The DeviceFeeder's batch order across worker counts 0, 1 and 4 (a
jittering converter makes multi-worker completion out of order), the
same training trajectory for every worker count, a reader error and a
conversion error raised once in batch order with every pipeline thread
stopped, early exit, the flags, the counters; and DataFeeder's dtype
semantics and its sequence (LoD) feeds against the JAX package's. On the CPU a batch is
`torch.from_numpy` of the converted array; the side-stream copy to the
card is held by tests/test_torch_trainer_cuda.py.
"""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu_torch import flags, monitor
from paddle_tpu_torch.reader import DeviceFeeder
from paddle_tpu_torch.reader.pipeline import THREAD_PREFIX


@pytest.fixture(autouse=True)
def clean_flags():
    flags.reset()
    yield
    flags.reset()
    monitor.reset()
    monitor.set_enabled(False)


def _linreg():
    pt.framework.reset_default_programs()
    x = pt.layers.data("x", [8])
    y = pt.layers.data("y", [1])
    pred = pt.layers.fc(input=x, size=1, param_attr=pt.ParamAttr(name="w"),
                        bias_attr=False)
    cost = pt.layers.mean(pt.layers.square_error_cost(pred, y))
    pt.SGDOptimizer(learning_rate=0.1).minimize(cost)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    return pt.default_main_program(), exe, scope, cost


def _indexed_batches(n, bs=4):
    """Batches whose content encodes their index."""
    def reader():
        for i in range(n):
            x = np.full((bs, 8), float(i), np.float32)
            yield {"x": x, "y": x[:, :1].copy()}
    return reader


def _pipeline_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(THREAD_PREFIX) and t.is_alive()]


def _assert_threads_stop(timeout=5.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if not _pipeline_threads():
            return
        time.sleep(0.05)
    raise AssertionError("pipeline threads survived: "
                         f"{[t.name for t in _pipeline_threads()]}")


class _JitterFeeder:
    """Conversion whose cost varies per batch: multi-worker completion
    is out of order, so the ordered stage has to reorder."""

    def __init__(self, seed=0):
        self._rng = np.random.RandomState(seed)

    def feed(self, batch):
        time.sleep(float(self._rng.uniform(0.0, 0.01)))
        return batch


@pytest.mark.parametrize("workers", [0, 1, 4])
def test_batch_order_for_every_worker_count(workers):
    main, exe, _, _ = _linreg()
    n = 12
    feeder = DeviceFeeder(_indexed_batches(n), main, exe,
                          feeder=_JitterFeeder(), workers=workers,
                          prefetch_depth=2)
    seen = []
    for feed in feeder:
        assert isinstance(feed["x"], torch.Tensor)
        assert feed["x"].device.type == "cpu"
        seen.append(float(feed["x"][0, 0]))
    assert seen == [float(i) for i in range(n)]
    assert feeder.counters()["batches"] == n
    _assert_threads_stop()


def _train_losses(workers):
    main, exe, scope, cost = _linreg()

    def reader():
        rng = np.random.RandomState(5)
        w = rng.randn(8, 1).astype(np.float32)
        for _ in range(15):
            x = rng.randn(4, 8).astype(np.float32)
            yield {"x": x, "y": x @ w}

    losses = []
    for feed in DeviceFeeder(reader, main, exe, workers=workers,
                             prefetch_depth=2):
        loss, = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        losses.append(float(np.ravel(loss)[0]))
    assert len(losses) == 15
    return losses


def test_every_worker_count_gives_the_same_trajectory():
    sync = _train_losses(workers=0)
    assert sync == _train_losses(workers=1)
    assert sync == _train_losses(workers=4)
    _assert_threads_stop()


def test_sync_path_spawns_no_threads():
    main, exe, _, _ = _linreg()
    before = set(threading.enumerate())
    for _ in DeviceFeeder(_indexed_batches(3), main, exe, workers=0):
        assert not (set(threading.enumerate()) - before)


def test_flags_drive_defaults():
    flags.set_flag("feed_workers", 3)
    flags.set_flag("feed_prefetch_depth", 4)
    main, exe, _, _ = _linreg()
    f = DeviceFeeder(_indexed_batches(1), main, exe)
    assert (f.workers, f.prefetch_depth) == (3, 4)
    assert DeviceFeeder(_indexed_batches(1), main, exe,
                        prefetch_depth=2).prefetch_depth == 2
    with pytest.raises(ValueError):
        DeviceFeeder(_indexed_batches(1), main, exe, prefetch_depth=0)
    with pytest.raises(ValueError):
        DeviceFeeder(_indexed_batches(1), main, exe, workers=-1)


def test_early_exit_stops_all_workers():
    main, exe, _, _ = _linreg()

    def infinite():
        i = 0
        while True:
            x = np.full((4, 8), float(i), np.float32)
            i += 1
            yield {"x": x, "y": x[:, :1].copy()}

    it = iter(DeviceFeeder(infinite, main, exe, workers=3,
                           prefetch_depth=2))
    for i, _ in enumerate(it):
        if i == 2:
            break
    it.close()
    _assert_threads_stop()


@pytest.mark.parametrize("workers", [0, 3])
def test_reader_error_raised_once_and_threads_stop(workers):
    main, exe, _, _ = _linreg()

    def bad_reader():
        for i in range(4):
            x = np.full((2, 8), float(i), np.float32)
            yield {"x": x, "y": x[:, :1].copy()}
        raise RuntimeError("disk on fire")

    it = iter(DeviceFeeder(bad_reader, main, exe, workers=workers,
                           prefetch_depth=2))
    got = []
    with pytest.raises(RuntimeError, match="disk on fire"):
        for feed in it:
            got.append(float(feed["x"][0, 0]))
    assert got == [0.0, 1.0, 2.0, 3.0]
    _assert_threads_stop()
    assert list(it) == []


@pytest.mark.parametrize("workers", [0, 3])
def test_conversion_error_raised_once_and_threads_stop(workers):
    main, exe, _, _ = _linreg()

    class ExplodingFeeder:
        def feed(self, batch):
            if float(np.asarray(batch["x"])[0, 0]) == 2.0:
                raise ValueError("decode exploded")
            return batch

    it = iter(DeviceFeeder(_indexed_batches(6), main, exe,
                           feeder=ExplodingFeeder(), workers=workers,
                           prefetch_depth=2))
    got = []
    with pytest.raises(ValueError, match="decode exploded"):
        for feed in it:
            got.append(float(feed["x"][0, 0]))
    assert got == [0.0, 1.0]
    _assert_threads_stop()
    assert list(it) == []


def test_counters_stats_and_explain():
    monitor.set_enabled(True)
    monitor.reset()
    main, exe, _, _ = _linreg()
    f = DeviceFeeder(_indexed_batches(5), main, exe, workers=2)
    assert f.explain() == "feed: no batches delivered yet"
    for _ in f:
        pass
    c = f.counters()
    assert c["batches"] == 5 and c["workers"] == 2
    assert c["bytes"] == 5 * 4 * 9 * 4
    assert "0 stalls" in f.explain() or "stalled" in f.explain()
    snap = monitor.snapshot()
    assert snap["counters"]["feed.batches"] == 5
    assert snap["counters"]["feed.bytes"] == c["bytes"]
    assert "feed.wait_time_s" in snap["histograms"]


def test_trainer_trajectory_identity_across_worker_counts():
    rng = np.random.RandomState(2)
    x = rng.randn(24, 8).astype(np.float32)
    y = (x @ rng.randn(8, 1)).astype(np.float32)
    reader = pt.reader.batch(lambda: zip(x, y), 4)

    def run(workers):
        _, _, _, cost = _linreg()
        t = pt.Trainer(cost, place=pt.CPUPlace(), feed_workers=workers)
        log = []
        t.train(reader, 2, ["x", "y"], lambda ev: log.append(
            float(ev.cost)) if type(ev).__name__ == "EndIteration" else None)
        return log, t.scope.get("w").numpy().copy()

    ref_log, ref_w = run(0)
    for workers in (1, 4):
        log, w = run(workers)
        assert log == ref_log
        assert np.array_equal(w, ref_w)
    _assert_threads_stop()


def test_end_iteration_carries_feed_counters():
    monitor.set_enabled(True)
    _, _, _, cost = _linreg()
    t = pt.Trainer(cost, place=pt.CPUPlace())
    feeds = []
    t.train(_batches_of_tuples(3), 1, ["x", "y"],
            lambda ev: feeds.append(ev.feed)
            if type(ev).__name__ == "EndIteration" else None)
    assert [f["batches"] for f in feeds] == [1, 2, 3]


def _batches_of_tuples(n):
    def reader():
        for i in range(n):
            yield [(np.full(8, float(i), np.float32),
                    np.array([float(i)], np.float32))] * 4
    return reader


# ---------------------------------------------------------------------------
# reader decorators and DataFeeder
# ---------------------------------------------------------------------------

def test_reader_decorators_match_jax_package():
    src = lambda: iter(range(10))  # noqa: E731
    for name, args in (("batch", (3,)), ("firstn", (4,)),
                       ("shuffle", (4, 7)), ("buffered", (2,)),
                       ("cache", ())):
        got = list(getattr(pt.reader, name)(src, *args)())
        want = list(getattr(jpt.reader, name)(src, *args)())
        assert got == want, name
    sq = lambda v: v * v  # noqa: E731
    assert sorted(pt.reader.xmap_readers(sq, src, 3, 4)()) == \
        sorted(jpt.reader.xmap_readers(sq, src, 3, 4)())
    assert list(pt.reader.compose(src, src)()) == \
        list(jpt.reader.compose(src, src)())
    assert list(pt.reader.chain(src, src)()) == \
        list(jpt.reader.chain(src, src)())


def _feed_vars(P):
    P.framework.reset_default_programs()
    P.layers.data("x", [3])
    P.layers.data("lab", [1], dtype="int64")
    P.layers.data("img", [4])
    P.layers.data("h", [2], dtype="bfloat16")
    blk = P.default_main_program().global_block()
    return [blk.var(n) for n in ("x", "lab", "img", "h")]


def test_datafeeder_dtype_semantics_match_jax_package():
    """One conversion straight into the var's dtype: python floats and
    uint8 to float32, int labels to int64 with the rank fixed to the
    declared [-1, 1], a bfloat16 var fed float32. The JAX package (with
    jax's x64 on, as its tests run) gives the same arrays."""
    rows = [([0.1, 0.2, 0.3], 1, np.arange(4, dtype=np.uint8), [1.5, 2.0]),
            ([1e-8, 2.5, -3.75], 0, np.arange(4, 8, dtype=np.uint8),
             [0.25, -1.0])]
    got = pt.DataFeeder(_feed_vars(pt)).feed(rows)
    want = jpt.DataFeeder(_feed_vars(jpt)).feed(rows)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name])
    assert got["x"].dtype == np.float32 and got["h"].dtype == np.float32
    assert got["lab"].dtype == np.int64 and got["lab"].shape == (2, 1)


def test_datafeeder_refuses_sequence_feeds():
    """Sequence feeds are ported up to the reference's two LoD levels; a
    deeper one is refused when fed, in both packages, with the same
    error."""
    rows = [([[[[1]]]],)]
    for P in (pt, jpt):
        P.framework.reset_default_programs()
        var = P.default_main_program().global_block().create_var(
            name="seq", shape=[-1, -1, -1, -1, 1], dtype="int64",
            lod_level=3, is_data=True)
        feeder = P.DataFeeder([var])
        with pytest.raises(NotImplementedError, match="lod_level=3"):
            feeder.feed(rows)


def _sequence_rows(lod_level, ragged):
    """Rows of (ids, features, label): ids a sequence of int ids (lod 1)
    or of sub-sequences (lod 2); features [n, 3] float rows; ragged
    lengths or all rows full (the bucket's edge, 16)."""
    rng = np.random.RandomState(lod_level * 10 + ragged)
    rows = []
    for i in range(5):
        n = int(rng.randint(1, 20)) if ragged else 16
        if lod_level == 1:
            ids = rng.randint(0, 50, n).tolist()
        else:
            ids = [rng.randint(0, 50, int(rng.randint(1, 9)) if ragged
                               else 16).tolist()
                   for _ in range(int(rng.randint(1, 5)) if ragged else 4)]
        feats = rng.randn(n, 3).astype(np.float64).tolist()
        rows.append((ids, feats, i % 2))
    return rows


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "full"])
@pytest.mark.parametrize("lod_level", [1, 2])
def test_datafeeder_sequence_feeds_match_jax_package(lod_level, ragged):
    """The port's DataFeeder on sequence vars gives the JAX package's
    arrays: the padded values, their dtypes (int64 ids, float32
    features), the bucketed pad length, `@SEQLEN` (int32) and, for
    lod_level 2, `@SEQLEN@SUB`."""
    rows = _sequence_rows(lod_level, ragged)
    out = {}
    for P in (pt, jpt):
        P.framework.reset_default_programs()
        ids = P.layers.data("ids", [1], dtype="int64", lod_level=lod_level)
        feats = P.layers.data("feats", [3], lod_level=1)
        lab = P.layers.data("lab", [1], dtype="int64")
        out[P] = P.DataFeeder([ids, feats, lab]).feed(rows)
    got, want = out[pt], out[jpt]
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name])
    assert got["ids@SEQLEN"].dtype == np.int32
    assert got["ids"].dtype == np.int64 and got["feats"].dtype == np.float32
    T = max(len(r[1]) for r in rows)
    assert got["feats"].shape == (5, pt.data_feeder.bucket_length(T), 3)
    if lod_level == 2:
        assert got["ids@SEQLEN@SUB"].shape == got["ids"].shape[:2]
        assert "ids@SEQLEN@SUB" in want
