"""IMDB sentiment (reference dataset/imdb.py): word_dict() then
train(word_idx)/test(word_idx) yielding ([word ids], 0/1 label — 0 is
POSITIVE, matching reader_creator's load order, imdb.py:74-89).
Real mode streams the aclImdb tarball sequentially (tarfile.next, like
the reference's tokenize at imdb.py:35-52) matching
aclImdb/{train,test}/{pos,neg}/*.txt; word_dict builds the
frequency-sorted dict with cutoff 150 (imdb.py:128-135).
Synthetic (default — no egress): two token distributions."""

import re
import string
import tarfile

from . import common

VOCAB = 2000
ACLIMDB_TAR = "aclImdb_v1.tar.gz"


def word_dict():
    if common.synthetic_mode():
        return common.make_word_dict(VOCAB)
    return build_dict(
        re.compile(r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$"),
        150)


def _synthetic(split, word_idx, n):
    rng = common.synthetic_rng("imdb", split)
    V = max(word_idx.values()) + 1
    half = V // 2

    def reader():
        for _ in range(n):
            label = int(rng.randint(0, 2))
            length = int(rng.randint(8, 64))
            lo, hi = (3, half) if label else (half, V)
            ids = rng.randint(lo, hi, size=length).tolist()
            yield ids, label
    return reader


def tokenize(pattern):
    """Sequential walk of the tarball (random access via extractfile
    per member would O(n^2) the read — the reference's own warning),
    yielding lowercase punctuation-stripped token lists."""
    path = common.real_file("imdb", ACLIMDB_TAR)
    table = str.maketrans("", "", string.punctuation)
    with tarfile.open(path) as tarf:
        tf = tarf.next()
        while tf is not None:
            if bool(pattern.match(tf.name)):
                data = tarf.extractfile(tf).read().decode("utf-8",
                                                          "ignore")
                yield data.rstrip("\n\r").translate(table).lower().split()
            tf = tarf.next()


def build_dict(pattern, cutoff):
    word_freq = {}
    for doc in tokenize(pattern):
        for word in doc:
            word_freq[word] = word_freq.get(word, 0) + 1
    word_freq = [x for x in word_freq.items() if x[1] > cutoff]
    dictionary = sorted(word_freq, key=lambda x: (-x[1], x[0]))
    words, _ = list(zip(*dictionary)) if dictionary else ((), ())
    word_idx = dict(zip(words, range(len(words))))
    word_idx["<unk>"] = len(words)
    return word_idx


def _real(pos_re, neg_re, word_idx):
    def reader():
        unk = word_idx["<unk>"]
        for pattern, label in ((pos_re, 0), (neg_re, 1)):
            for doc in tokenize(pattern):
                yield [word_idx.get(w, unk) for w in doc], label
    return reader


def train(word_idx):
    if common.synthetic_mode():
        return _synthetic("train", word_idx, 2048)
    return _real(re.compile(r"aclImdb/train/pos/.*\.txt$"),
                 re.compile(r"aclImdb/train/neg/.*\.txt$"), word_idx)


def test(word_idx):
    if common.synthetic_mode():
        return _synthetic("test", word_idx, 256)
    return _real(re.compile(r"aclImdb/test/pos/.*\.txt$"),
                 re.compile(r"aclImdb/test/neg/.*\.txt$"), word_idx)
