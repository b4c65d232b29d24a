"""PTB-style n-gram LM data (reference dataset/imikolov.py):
build_dict() then train(word_idx, n)/test(word_idx, n) yielding n-gram
id tuples (the word2vec book-chapter input). Real mode reads
./simple-examples/data/ptb.{train,valid}.txt from the tarball with
<s>/<e> sentence markers and min-frequency dict building
(imikolov.py:36-75); synthetic (default): markov-ish id chains."""

import tarfile

from . import common

VOCAB = 1000
TAR = "simple-examples.tgz"
TRAIN_MEMBER = "./simple-examples/data/ptb.train.txt"
TEST_MEMBER = "./simple-examples/data/ptb.valid.txt"


def _word_count(f, word_freq=None):
    if word_freq is None:
        word_freq = {}
    for line in f:
        for w in line.strip().split():
            word_freq[w] = word_freq.get(w, 0) + 1
        word_freq["<s>"] = word_freq.get("<s>", 0) + 1
        word_freq["<e>"] = word_freq.get("<e>", 0) + 1
    return word_freq


def build_dict(min_word_freq=50):
    if common.synthetic_mode():
        return common.make_word_dict(VOCAB)
    path = common.real_file("imikolov", TAR)
    with tarfile.open(path) as f:
        # reference imikolov.py:56-62 accumulates counts over BOTH the
        # train and valid files (word_count(testf, word_count(trainf)))
        word_freq = None
        for member in (TRAIN_MEMBER, TEST_MEMBER):
            lines = (l.decode("utf-8", "ignore")
                     for l in f.extractfile(member))
            word_freq = _word_count(lines, word_freq)
    word_freq.pop("<unk>", None)
    word_freq = [x for x in word_freq.items() if x[1] > min_word_freq]
    dictionary = sorted(word_freq, key=lambda x: (-x[1], x[0]))
    words, _ = list(zip(*dictionary)) if dictionary else ((), ())
    word_idx = dict(zip(words, range(len(words))))
    word_idx["<unk>"] = len(words)
    return word_idx


def _synthetic(split, word_idx, n, count):
    rng = common.synthetic_rng("imikolov", split)
    V = max(word_idx.values()) + 1

    def reader():
        for _ in range(count):
            # markov-ish chain: next id correlated with previous
            ids = [int(rng.randint(3, V))]
            for _ in range(n - 1):
                ids.append(int((ids[-1] * 31 + rng.randint(0, 7)) % V))
            yield tuple(ids)
    return reader


def _real(member, word_idx, n):
    def reader():
        path = common.real_file("imikolov", TAR)
        unk = word_idx["<unk>"]
        with tarfile.open(path) as f:
            for line in f.extractfile(member):
                l = (["<s>"]
                     + line.decode("utf-8", "ignore").strip().split()
                     + ["<e>"])
                if len(l) >= n:
                    ids = [word_idx.get(w, unk) for w in l]
                    for i in range(n, len(ids) + 1):
                        yield tuple(ids[i - n:i])
    return reader


def train(word_idx, n):
    if common.synthetic_mode():
        return _synthetic("train", word_idx, n, 4096)
    return _real(TRAIN_MEMBER, word_idx, n)


def test(word_idx, n):
    if common.synthetic_mode():
        return _synthetic("test", word_idx, n, 512)
    return _real(TEST_MEMBER, word_idx, n)
