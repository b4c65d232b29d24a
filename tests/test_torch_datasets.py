"""The eleven dataset loaders the port adds (`paddle_tpu_torch/dataset/`:
uci_housing, imikolov, imdb, sentiment, movielens, conll05, wmt14,
wmt16, mq2007, flowers, voc2012) against the JAX package's, on the CPU.

  * Synthetic mode (the default): the first samples of every split, and
    every dict and table a loader returns, bit-equal to the reference's:
    the same Python and numpy types, dtypes, shapes and bytes. A
    creator's generator is drawn at creation, so a second call of its
    reader continues the stream, in both.
  * Real mode: tests/fixtures/datasets/make_fixtures.py writes its
    archives into tmp_path; both packages parse them, every sample and
    dict equal (flowers and voc2012 decode images with PIL, imported
    there only).
  * All 13 loaders reach `v2.dataset`, and no loader imports PIL at
    import time.
"""

import importlib.util
import math
import os
import re

import numpy as np
import pytest

import paddle_tpu.dataset as jds
import paddle_tpu_torch.dataset as pds

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIRST = 32
NEW = ("uci_housing", "imikolov", "imdb", "sentiment", "movielens",
       "conll05", "wmt14", "wmt16", "mq2007", "flowers", "voc2012")


def same(a, b, where="sample"):
    """Deep equality with types: numpy arrays by dtype, shape and bytes,
    floats by value (NaN equal to NaN, the sign of 0 kept)."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, float):
        assert (a == b and math.copysign(1, a) == math.copysign(1, b)) or (
            math.isnan(a) and math.isnan(b)), (where, a, b)
    else:
        assert a == b, (where, a, b)


def _take(reader, n):
    out = []
    for sample in reader():
        out.append(sample)
        if len(out) == n:
            break
    return out


# (loader, label, f(dataset package) -> a reader creator, or a value)
SYNTHETIC = [
    ("uci_housing", "train", lambda d: d.uci_housing.train()),
    ("uci_housing", "test", lambda d: d.uci_housing.test()),
    ("imikolov", "build_dict", lambda d: d.imikolov.build_dict()),
    ("imikolov", "train", lambda d: d.imikolov.train(
        d.imikolov.build_dict(), 5)),
    ("imikolov", "test", lambda d: d.imikolov.test(
        d.imikolov.build_dict(), 3)),
    ("imdb", "word_dict", lambda d: d.imdb.word_dict()),
    ("imdb", "train", lambda d: d.imdb.train(d.imdb.word_dict())),
    ("imdb", "test", lambda d: d.imdb.test(d.imdb.word_dict())),
    ("sentiment", "get_word_dict", lambda d: d.sentiment.get_word_dict()),
    ("sentiment", "train", lambda d: d.sentiment.train()),
    ("sentiment", "test", lambda d: d.sentiment.test()),
    ("movielens", "tables", lambda d: [
        d.movielens.max_user_id(), d.movielens.max_movie_id(),
        d.movielens.max_job_id(), d.movielens.age_table(),
        d.movielens.movie_categories(),
        d.movielens.get_movie_title_dict()]),
    ("movielens", "train", lambda d: d.movielens.train()),
    ("movielens", "test", lambda d: d.movielens.test()),
    ("conll05", "get_dict", lambda d: d.conll05.get_dict()),
    ("conll05", "get_embedding", lambda d: d.conll05.get_embedding()),
    ("conll05", "train", lambda d: d.conll05.train()),
    ("conll05", "test", lambda d: d.conll05.test()),
    ("wmt14", "get_dict", lambda d: d.wmt14.get_dict()),
    ("wmt14", "train", lambda d: d.wmt14.train()),
    ("wmt14", "test", lambda d: d.wmt14.test()),
    ("wmt14", "gen", lambda d: d.wmt14.gen()),
    ("wmt16", "get_dict", lambda d: [d.wmt16.get_dict("en"),
                                     d.wmt16.get_dict("de", 300, True)]),
    ("wmt16", "train", lambda d: d.wmt16.train(30000, 30000)),
    ("wmt16", "test", lambda d: d.wmt16.test()),
    ("wmt16", "validation", lambda d: d.wmt16.validation(500, 400, "de")),
    ("mq2007", "train_pointwise", lambda d: d.mq2007.train_pointwise()),
    ("mq2007", "test_pointwise", lambda d: d.mq2007.test_pointwise()),
    ("mq2007", "train_pairwise", lambda d: d.mq2007.train_pairwise()),
    ("mq2007", "test_pairwise", lambda d: d.mq2007.test_pairwise()),
    ("mq2007", "train_listwise", lambda d: d.mq2007.train_listwise()),
    ("mq2007", "test_listwise", lambda d: d.mq2007.test_listwise()),
    ("flowers", "train", lambda d: d.flowers.train()),
    ("flowers", "test", lambda d: d.flowers.test()),
    ("flowers", "valid", lambda d: d.flowers.valid()),
    ("voc2012", "train", lambda d: d.voc2012.train()),
    ("voc2012", "test", lambda d: d.voc2012.test()),
    ("voc2012", "valid", lambda d: d.voc2012.valid()),
]


@pytest.fixture
def synthetic(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_DATASET_SYNTHETIC", raising=False)


@pytest.mark.parametrize("loader,label,make", SYNTHETIC,
                         ids=[f"{m}.{s}" for m, s, _ in SYNTHETIC])
def test_synthetic_samples_bit_equal_the_reference(synthetic, loader, label,
                                                   make):
    j, p = make(jds), make(pds)
    if not callable(j):
        same(p, j, label)
        return
    n = 4 if loader == "flowers" else FIRST
    same(_take(p, n), _take(j, n), label)
    # the stream goes on: a second call continues where the first stopped
    same(_take(p, 3), _take(j, 3), label + " (second call)")


def test_the_stream_continues_across_calls(synthetic):
    r = pds.wmt16.train(30000, 30000)
    first, second = _take(r, 5), _take(r, 5)
    assert first != second
    fresh = _take(pds.wmt16.train(30000, 30000), 10)
    same(first + second, fresh)


def test_thirteen_loaders_reach_v2():
    import paddle_tpu_torch.v2 as v2
    assert v2.dataset is pds
    assert pds.__all__ == jds.__all__ and len(pds.__all__) == 14
    for name in NEW:
        mod = getattr(pds, name)
        assert mod.__name__ == f"paddle_tpu_torch.dataset.{name}"


def test_no_pil_at_import():
    """PIL and scipy.io are imported inside the real-mode functions only:
    no module-level import of either in any loader."""
    import ast
    root = os.path.join(REPO, "paddle_tpu_torch", "dataset")
    for name in os.listdir(root):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(root, name)).read())
        for node in tree.body:
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            assert not [m for m in mods if m.split(".")[0] == "PIL"
                        or m.startswith("scipy")], (name, mods)
    lazy = [n for n in ("flowers.py", "voc2012.py")
            if "from PIL import Image" in open(os.path.join(root, n)).read()]
    assert lazy == ["flowers.py", "voc2012.py"]


# -- real mode ----------------------------------------------------------------

_CACHES = (("uci_housing", "_cache"), ("movielens", "_meta"),
           ("sentiment", "_dict_cache"), ("wmt14", "_dict_cache"),
           ("wmt16", "_dict_cache"))


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    """make_fixtures.py's archives, written into a temporary directory."""
    root = tmp_path_factory.mktemp("datasets")
    spec = importlib.util.spec_from_file_location(
        "_make_fixtures", os.path.join(HERE, "fixtures", "datasets",
                                       "make_fixtures.py"))
    mk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mk)
    mk.HERE = str(root)
    for name in NEW:
        getattr(mk, name)()
    return str(root)


@pytest.fixture
def real_mode(monkeypatch, fixture_dir):
    monkeypatch.setenv("PADDLE_TPU_DATASET_SYNTHETIC", "0")
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", fixture_dir)
    for d in (jds, pds):
        monkeypatch.setattr(d.common, "DATA_HOME", fixture_dir)

    def clear():
        for d in (jds, pds):
            for mod, attr in _CACHES:
                getattr(getattr(d, mod), attr).clear()
    clear()
    yield
    clear()


_IMDB_TRAIN = re.compile(r"aclImdb/train/.*\.txt$")
REAL = [
    ("uci_housing", lambda d: [list(d.uci_housing.train()()),
                               list(d.uci_housing.test()())]),
    ("imikolov", lambda d: [d.imikolov.build_dict(2), list(
        d.imikolov.train(d.imikolov.build_dict(2), 3)()), list(
        d.imikolov.test(d.imikolov.build_dict(2), 3)())]),
    ("imdb", lambda d: [
        d.imdb.build_dict(_IMDB_TRAIN, 1), d.imdb.word_dict(),
        list(d.imdb.train(d.imdb.build_dict(_IMDB_TRAIN, 1))()),
        list(d.imdb.test(d.imdb.word_dict())())]),
    ("sentiment", lambda d: [d.sentiment.get_word_dict(),
                             list(d.sentiment.train()()),
                             list(d.sentiment.test()())]),
    ("movielens", lambda d: [list(d.movielens.train()()),
                             list(d.movielens.test()()),
                             d.movielens.movie_categories(),
                             d.movielens.get_movie_title_dict()]),
    ("conll05", lambda d: [d.conll05.get_dict(), d.conll05.get_embedding(),
                           list(d.conll05.test()()),
                           list(d.conll05.train()())]),
    ("wmt14", lambda d: [d.wmt14.get_dict(10), list(d.wmt14.train(10)()),
                         list(d.wmt14.test(10)()), list(d.wmt14.gen(10)())]),
    ("wmt16", lambda d: [d.wmt16.get_dict("en", 12),
                         d.wmt16.get_dict("de", 12, True),
                         list(d.wmt16.train(12, 12, "en")()),
                         list(d.wmt16.train(12, 10, "de")()),
                         list(d.wmt16.validation(12, 12)()),
                         list(d.wmt16.test(12, 12)())]),
    ("mq2007", lambda d: [d.mq2007.parse_letor_line(
        "2 qid:10 1:0.5 3:0.25 46:1.0 #docid = GX1")] + [
        list(getattr(d.mq2007, f"{s}_{k}")()()) for s in ("train", "test")
        for k in ("pointwise", "pairwise", "listwise")]),
    ("voc2012", lambda d: [list(d.voc2012.train()()),
                           list(d.voc2012.valid()()),
                           list(d.voc2012.test()())]),
    ("flowers", lambda d: [list(d.flowers.train()()),
                           list(d.flowers.test()()),
                           list(d.flowers.valid()())]),
]


@pytest.mark.parametrize("loader,parse", REAL, ids=[m for m, _ in REAL])
def test_real_mode_parses_equal_the_reference(real_mode, loader, parse):
    j = parse(jds)
    for d in (jds, pds):
        for mod, attr in _CACHES:
            getattr(getattr(d, mod), attr).clear()
    p = parse(pds)
    same(p, j, loader)
    assert any(isinstance(x, list) and x for x in p), "nothing parsed"


def test_real_mode_missing_file_guidance(real_mode, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", "/nonexistent_dir")
    with pytest.raises(IOError, match="synthetic mode"):
        list(pds.wmt16.train(12, 12)())
