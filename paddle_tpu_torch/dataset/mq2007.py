"""MQ2007 learning-to-rank (reference dataset/mq2007.py): pointwise /
pairwise / listwise readers over (query, doc features[46], relevance).

Real mode parses the published LETOR text format
(reference mq2007.py:83-107 QueryList.parse): each line
``rel qid:<q> 1:<v> ... 46:<v> #docid = ...``, grouped by qid, read
from MQ2007/Fold1/{train,test}.txt inside the archive layout."""

import numpy as np

from . import common

FEATURES = 46


def _queries(split, n_queries):
    rng = common.synthetic_rng("mq2007", split)
    w = common.synthetic_rng("mq2007", "w").randn(FEATURES)
    out = []
    for q in range(n_queries):
        docs = []
        for _ in range(int(rng.randint(4, 12))):
            x = rng.randn(FEATURES).astype(np.float32)
            rel = int(np.clip((x @ w) / 4 + 1 + 0.3 * rng.randn(), 0, 2))
            docs.append((x, rel))
        out.append(docs)
    return out


def parse_letor_line(line, fill_missing=-1.0):
    """One LETOR line -> (qid, features[46], relevance). Mirrors
    reference mq2007.py:88-107: token 0 is the relevance degree, token
    1 is qid:<id>, the rest are <index>:<value> pairs up to the #docid
    comment; missing feature indices fill with -1."""
    body = line.split("#")[0].strip()
    parts = body.split()
    rel = int(parts[0])
    qid = int(parts[1].split(":")[1])
    feats = np.full(FEATURES, fill_missing, np.float32)
    for p in parts[2:]:
        idx, val = p.split(":")
        feats[int(idx) - 1] = float(val)
    return qid, feats, rel


def _load_letor(path):
    """Grouped-by-qid document lists, file order preserved."""
    queries, order = {}, []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            qid, feats, rel = parse_letor_line(line)
            if qid not in queries:
                queries[qid] = []
                order.append(qid)
            queries[qid].append((feats, rel))
    return [queries[q] for q in order]


def _data(split):
    if common.synthetic_mode():
        return _queries(split, 128)
    path = common.real_file(
        "MQ2007", f"MQ2007/Fold1/{'train' if split == 'train' else 'test'}.txt")
    return _load_letor(path)


def _pointwise(split):
    data = _data(split)

    def reader():
        for docs in data:
            for x, rel in docs:
                yield x, float(rel)
    return reader


def _pairwise(split):
    data = _data(split)

    def reader():
        for docs in data:
            for i, (xi, ri) in enumerate(docs):
                for xj, rj in docs[i + 1:]:
                    if ri != rj:
                        hi, lo = (xi, xj) if ri > rj else (xj, xi)
                        yield hi, lo
    return reader


def _listwise(split):
    data = _data(split)

    def reader():
        for docs in data:
            xs = np.stack([d[0] for d in docs])
            rels = np.asarray([d[1] for d in docs], np.float32)
            yield xs, rels
    return reader


def train_pointwise():
    return _pointwise("train")


def test_pointwise():
    return _pointwise("test")


def train_pairwise():
    return _pairwise("train")


def test_pairwise():
    return _pairwise("test")


def train_listwise():
    return _listwise("train")


def test_listwise():
    return _listwise("test")
