"""Movie-review sentiment (reference dataset/sentiment.py, which reads
the NLTK movie_reviews corpus): train()/test() yield (word_ids, 0/1),
files interleaved neg/pos (sentiment.py:73-85) with 1600/400
train/test split of the 2000 documents.

Real mode parses the corpus zip itself (movie_reviews.zip, the same
archive nltk downloads): members movie_reviews/{neg,pos}/cv*.txt. The
corpus ships pre-tokenized (one token per whitespace break), so
whitespace splitting reproduces nltk's token stream for it; the word
dict is frequency-sorted descending like the reference's
get_word_dict."""

import itertools
import zipfile
from collections import defaultdict

from . import common

VOCAB = 1500
NUM_TRAINING_INSTANCES = 1600
ZIP_NAME = "movie_reviews.zip"


def _corpus_file_names(zf):
    neg = sorted(n for n in zf.namelist()
                 if "/neg/" in n and n.endswith(".txt"))
    pos = sorted(n for n in zf.namelist()
                 if "/pos/" in n and n.endswith(".txt"))
    # cross-read neg/pos (reference sort_files, sentiment.py:73-85)
    return list(itertools.chain.from_iterable(zip(neg, pos)))


def _tokens(zf, name):
    return zf.read(name).decode("utf-8", "ignore").lower().split()


_dict_cache = {}


def get_word_dict():
    if common.synthetic_mode():
        return common.make_word_dict(VOCAB)
    fn = common.real_file("sentiment", ZIP_NAME)
    if fn not in _dict_cache:       # one corpus scan per process, not
        freq = defaultdict(int)      # one per epoch
        with zipfile.ZipFile(fn) as zf:
            for name in _corpus_file_names(zf):
                for w in _tokens(zf, name):
                    freq[w] += 1
        ranked = sorted(freq.items(), key=lambda x: -x[1])
        _dict_cache[fn] = {w: i for i, (w, _) in enumerate(ranked)}
    return _dict_cache[fn]


def _synthetic(split, n):
    rng = common.synthetic_rng("sentiment", split)
    half = VOCAB // 2

    def reader():
        for _ in range(n):
            label = int(rng.randint(0, 2))
            length = int(rng.randint(5, 50))
            lo, hi = (3, half) if label else (half, VOCAB)
            yield rng.randint(lo, hi, size=length).tolist(), label
    return reader


def _real(lo, hi):
    def reader():
        word_ids = get_word_dict()
        fn = common.real_file("sentiment", ZIP_NAME)
        with zipfile.ZipFile(fn) as zf:
            for name in _corpus_file_names(zf)[lo:hi]:
                label = 0 if "/neg/" in name else 1
                yield [word_ids[w] for w in _tokens(zf, name)], label
    return reader


def train():
    if common.synthetic_mode():
        return _synthetic("train", 1600)
    return _real(0, NUM_TRAINING_INSTANCES)


def test():
    if common.synthetic_mode():
        return _synthetic("test", 400)
    return _real(NUM_TRAINING_INSTANCES, None)
