"""Slice test of the host data path the port adds: a dataset loader's
examples written to recordio (pickled per-example tuples, the CLI's
convention), read back by `sharded_reader`, batched and trained by the
`Trainer`, in each package from its own files, on the CPU.

  * seq2seq-attention (the chip smoke's phase 42 (b) program, at emb /
    hid 16 and a 64-word vocabulary) from `wmt16.train`, and the book's
    recommender (phase 42 (c)) from `movielens.train`, 3 steps of B 8 in
    both packages from the JAX package's initial weights: every loss
    within 1e-5 (both f32: the recurrences and Adam round differently,
    ~1e-7 a step).
  * Inside the port, the recordio route against the loader fed
    straight to the Trainer: every feed (token ids and the @SEQLEN
    lengths) and every loss bitwise equal.
"""

import pickle

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu.models  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.weights import scope_from_numpy

V, W, B, STEPS, FILES = 64, 16, 8, 3, 4
LOSS_ATOL = 1e-5
SIZES = {"max_uid": 6041, "max_gender": 2, "max_age": 7, "max_job": 21,
         "max_movie": 3953, "max_category": 18, "max_title": 5000}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_DATASET_SYNTHETIC", raising=False)
    for P in (jpt, pt):
        P.flags.reset()
        P.framework.reset_default_programs()


def _seq2seq(P):
    src, tgt, nxt = [P.layers.data(n, [1], dtype="int64", lod_level=1)
                     for n in ("src", "tgt", "nxt")]
    cost = P.models.seq2seq.seq2seq_attention_cost(src, tgt, nxt, V, V, W,
                                                   W)
    P.AdamOptimizer(1e-3).minimize(cost)
    return cost, ["src", "tgt", "nxt"], lambda: P.dataset.wmt16.train(V, V)


def _recommender(P):
    ids = {n: P.layers.data(n, [1], dtype="int64")
           for n in ("uid", "gender", "age", "job", "movie")}
    cats = P.layers.data("cats", [1], dtype="int64", lod_level=1)
    titles = P.layers.data("titles", [1], dtype="int64", lod_level=1)
    rating = P.layers.data("rating", [1])
    R = P.models.recommender
    usr = R.user_net(ids["uid"], ids["gender"], ids["age"], ids["job"],
                     SIZES)
    mov = R.movie_net(ids["movie"], cats, titles, SIZES)
    cost = R.recommender_cost(usr, mov, rating)
    P.AdamOptimizer(1e-2).minimize(cost)
    order = ["uid", "gender", "age", "job", "movie", "cats", "titles",
             "rating"]
    return cost, order, lambda: P.dataset.movielens.train()


def write_shards(P, examples, root):
    """`examples` pickled into FILES recordio files, in order."""
    paths, per = [], -(-len(examples) // FILES)
    for k in range(FILES):
        path = str(root / f"{P.__name__}-{k}.rec")
        P.recordio.write_records(path, [pickle.dumps(e) for e in
                                        examples[k * per:(k + 1) * per]])
        paths.append(path)
    return paths


def recordio_reader(P, paths):
    return P.reader.batch(P.reader.map_readers(
        pickle.loads, P.recordio.sharded_reader(paths, 1, 0)), B)


def _trainer(P, build, init=None):
    P.framework.reset_default_programs()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        cost, order, source = build(P)
    if P is jpt:
        return jpt.Trainer(cost, place=jpt.CPUPlace(), main_program=main,
                           startup_program=startup), order, source
    return pt.Trainer(cost, place=pt.CPUPlace(), main_program=main,
                      startup_program=startup,
                      scope=scope_from_numpy(init, "cpu")), order, source


def _run(trainer, order, reader):
    losses, feeds = [], []
    run = trainer.exe.run

    def recording(program, feed=None, **kw):
        if program is trainer.main_program:
            feeds.append({k: np.array(v) for k, v in feed.items()})
        return run(program, feed=feed, **kw)

    trainer.exe.run = recording

    def handler(ev):
        if type(ev).__name__ == "EndIteration":
            losses.append(float(ev.cost))
    trainer.train(reader, 1, order, handler)
    return losses, feeds


@pytest.mark.parametrize("build", [_seq2seq, _recommender],
                         ids=["seq2seq_wmt16", "recommender_movielens"])
def test_trained_from_recordio_as_the_reference(build, tmp_path):
    jt, order, jsource = _trainer(jpt, build)
    init = {k: np.array(jt.scope.get(k)) for k in jt.scope.keys()
            if not k.startswith("__")}
    jexamples = list(jpt.reader.firstn(jsource(), B * STEPS)())
    jpaths = write_shards(jpt, jexamples, tmp_path)
    jloss, _ = _run(jt, order, recordio_reader(jpt, jpaths))

    pt_, _, psource = _trainer(pt, build, init)
    pexamples = list(pt.reader.firstn(psource(), B * STEPS)())
    assert pickle.dumps(pexamples) == pickle.dumps(jexamples)
    ppaths = write_shards(pt, pexamples, tmp_path)
    for a, b in zip(jpaths, ppaths):
        assert open(a, "rb").read() == open(b, "rb").read()
    ploss, pfeeds = _run(pt_, order, recordio_reader(pt, ppaths))
    assert len(ploss) == len(jloss) == STEPS
    np.testing.assert_allclose(ploss, jloss, rtol=0, atol=LOSS_ATOL)
    assert all(np.isfinite(ploss))

    # the same steps fed straight from the loader: the same bits
    direct_t, _, _ = _trainer(pt, build, init)
    dloss, dfeeds = _run(direct_t, order, pt.reader.batch(
        pt.reader.firstn(psource(), B * STEPS), B))
    assert dloss == ploss
    assert len(dfeeds) == len(pfeeds) == STEPS
    for d, p in zip(dfeeds, pfeeds):
        assert sorted(d) == sorted(p)
        assert any(k.endswith("@SEQLEN") for k in p)
        for k in d:
            assert d[k].dtype == p[k].dtype and np.array_equal(d[k], p[k]), k
