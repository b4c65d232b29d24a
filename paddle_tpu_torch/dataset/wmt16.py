"""WMT-16 en<->de with BPE (reference dataset/wmt16.py). Same triple
format as wmt14; get_dict(lang) per language.

Real mode parses the published wmt16.tar.gz layout (reference
wmt16.py:59-139): tab-separated en\\tde parallel text under
wmt16/{train,val,test}; the vocabularies are BUILT from the train
member by frequency (descending), prefixed with <s>/<e>/<unk>. Unlike
the reference (which caches <lang>_<size>.dict files next to the
tarball), the built dict is memoized in-process keyed by the tarball
path: a file cache would pollute a read-only / fixture data dir and a
stale one would silently serve an old vocabulary."""

import tarfile
from collections import defaultdict

from . import common

DICT_SIZE = 10000
TAR_NAME = "wmt16.tar.gz"
START_MARK, END_MARK, UNK_MARK = "<s>", "<e>", "<unk>"

_dict_cache = {}


def _build_dict(tar_file, dict_size, lang):
    word_dict = defaultdict(int)
    with tarfile.open(tar_file) as f:
        for line in f.extractfile("wmt16/train"):
            parts = line.decode().strip().split("\t")
            if len(parts) != 2:
                continue
            sen = parts[0] if lang == "en" else parts[1]
            for w in sen.split():
                word_dict[w] += 1
    words = [START_MARK, END_MARK, UNK_MARK]
    for word, _ in sorted(word_dict.items(), key=lambda x: x[1],
                          reverse=True):
        if len(words) == dict_size:
            break
        words.append(word)
    return {w: i for i, w in enumerate(words)}


def _load_dict(tar_file, dict_size, lang, reverse=False):
    key = (tar_file, dict_size, lang)
    if key not in _dict_cache:
        _dict_cache[key] = _build_dict(tar_file, dict_size, lang)
    word_dict = _dict_cache[key]
    if reverse:
        return {i: w for w, i in word_dict.items()}
    return word_dict


def get_dict(lang="en", dict_size=DICT_SIZE, reverse=False):
    if common.synthetic_mode():
        # same marker layout real dicts get: <s>=0, <e>=1, <unk>=2
        d = common.make_word_dict(dict_size, lang[:1],
                                  markers=(START_MARK, END_MARK,
                                           UNK_MARK))
        return {v: k for k, v in d.items()} if reverse else d
    return _load_dict(common.real_file("wmt16", TAR_NAME), dict_size,
                      lang, reverse)


def _synthetic(split, dict_size, n):
    rng = common.synthetic_rng("wmt16", split)

    def reader():
        for _ in range(n):
            length = int(rng.randint(3, 16))
            src = rng.randint(3, dict_size, size=length).tolist()
            trg = [(w * 11 + 5) % dict_size for w in src]
            trg = [t if t > 2 else t + 3 for t in trg]  # ids 0-2 = markers
            yield src, [0] + trg, trg + [1]             # <s>=0, <e>=1
    return reader


def reader_creator(tar_file, file_name, src_dict_size, trg_dict_size,
                   src_lang):
    def reader():
        src_dict = _load_dict(tar_file, src_dict_size, src_lang)
        trg_dict = _load_dict(tar_file, trg_dict_size,
                              "de" if src_lang == "en" else "en")
        start_id = src_dict[START_MARK]
        end_id = src_dict[END_MARK]
        unk_id = src_dict[UNK_MARK]
        src_col = 0 if src_lang == "en" else 1
        trg_col = 1 - src_col
        with tarfile.open(tar_file) as f:
            for line in f.extractfile(file_name):
                parts = line.decode().strip().split("\t")
                if len(parts) != 2:
                    continue
                src_ids = ([start_id]
                           + [src_dict.get(w, unk_id)
                              for w in parts[src_col].split()]
                           + [end_id])
                trg_ids = [trg_dict.get(w, unk_id)
                           for w in parts[trg_col].split()]
                yield (src_ids, [start_id] + trg_ids,
                       trg_ids + [end_id])
    return reader


def _split(split, src_dict_size, trg_dict_size, src_lang, n):
    if common.synthetic_mode():
        return _synthetic(split, min(src_dict_size, trg_dict_size), n)
    return reader_creator(common.real_file("wmt16", TAR_NAME),
                          f"wmt16/{split}", src_dict_size,
                          trg_dict_size, src_lang)


def train(src_dict_size=DICT_SIZE, trg_dict_size=DICT_SIZE,
          src_lang="en"):
    return _split("train", src_dict_size, trg_dict_size, src_lang, 4096)


def test(src_dict_size=DICT_SIZE, trg_dict_size=DICT_SIZE,
         src_lang="en"):
    return _split("test", src_dict_size, trg_dict_size, src_lang, 256)


def validation(src_dict_size=DICT_SIZE, trg_dict_size=DICT_SIZE,
               src_lang="en"):
    return _split("val", src_dict_size, trg_dict_size, src_lang, 256)
