"""WMT-14 fr->en (reference dataset/wmt14.py): the machine_translation
book chapter input — (src_ids, trg_ids, trg_next_ids) with <s>/<e>
bracketing. Synthetic: target = deterministic per-token mapping of
source, so a seq2seq model can genuinely learn the mapping.

Real mode parses the published wmt14.tgz layout (reference
wmt14.py:53-112): src.dict / trg.dict members (one token per line,
first dict_size lines) and tab-separated parallel text under
train/train, test/test, gen/gen; sequences longer than 80 tokens are
skipped, exactly as the reference does."""

import tarfile

from . import common

DICT_SIZE = 30000
# marker ids follow the REAL dict layout (<s>=0, <e>=1, <unk>=2 — the
# first three lines of src.dict/trg.dict); synthetic mode uses the
# same convention so consumers (e.g. beam stop conditions on END) are
# mode-independent
START, END, UNK = 0, 1, 2
START_MARK, END_MARK, UNK_MARK = "<s>", "<e>", "<unk>"
UNK_IDX = 2          # the reference's UNK_IDX (wmt14.py:51)
TAR_NAME = "wmt14.tgz"


def _read_to_dict(tar_file, dict_size):
    def to_dict(fd, size):
        out = {}
        for i, line in enumerate(fd):
            if i >= size:
                break
            out[line.decode().strip()] = i
        return out

    with tarfile.open(tar_file) as f:
        src_name = [m.name for m in f if m.name.endswith("src.dict")]
        trg_name = [m.name for m in f if m.name.endswith("trg.dict")]
        assert len(src_name) == 1 and len(trg_name) == 1
        return (to_dict(f.extractfile(src_name[0]), dict_size),
                to_dict(f.extractfile(trg_name[0]), dict_size))


_MARKERS = (START_MARK, END_MARK, UNK_MARK)   # real-dict layout: 0/1/2


def get_dict(dict_size=DICT_SIZE, reverse=False):
    if common.synthetic_mode():
        src = common.make_word_dict(dict_size, "s", markers=_MARKERS)
        trg = common.make_word_dict(dict_size, "t", markers=_MARKERS)
    else:
        src, trg = _read_to_dict(common.real_file("wmt14", TAR_NAME),
                                 dict_size)
    if reverse:
        src = {v: k for k, v in src.items()}
        trg = {v: k for k, v in trg.items()}
    return src, trg


def _synthetic(split, dict_size, n):
    rng = common.synthetic_rng("wmt14", split)

    def reader():
        for _ in range(n):
            length = int(rng.randint(3, 12))
            src = rng.randint(3, dict_size, size=length).tolist()
            trg = [(w * 7 + 3) % dict_size for w in src]
            trg = [t if t > 2 else t + 3 for t in trg]  # ids 0-2 = markers
            yield src, [START] + trg, trg + [END]
    return reader


_dict_cache = {}


def _cached_dicts(tar_file, dict_size):
    key = (tar_file, dict_size)
    if key not in _dict_cache:      # one tar scan per process, not one
        _dict_cache[key] = _read_to_dict(tar_file, dict_size)  # per epoch
    return _dict_cache[key]


def reader_creator(tar_file, file_name, dict_size):
    def reader():
        src_dict, trg_dict = _cached_dicts(tar_file, dict_size)
        with tarfile.open(tar_file) as f:
            names = [m.name for m in f if m.name.endswith(file_name)]
            for name in names:
                for line in f.extractfile(name):
                    parts = line.decode().strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src_words = parts[0].split()
                    src_ids = [src_dict.get(w, UNK_IDX) for w in
                               [START_MARK] + src_words + [END_MARK]]
                    trg_words = parts[1].split()
                    trg_ids = [trg_dict.get(w, UNK_IDX)
                               for w in trg_words]
                    if len(src_ids) > 80 or len(trg_ids) > 80:
                        continue
                    trg_ids_next = trg_ids + [trg_dict[END_MARK]]
                    trg_ids = [trg_dict[START_MARK]] + trg_ids
                    yield src_ids, trg_ids, trg_ids_next
    return reader


def train(dict_size=DICT_SIZE):
    if common.synthetic_mode():
        return _synthetic("train", dict_size, 4096)
    return reader_creator(common.real_file("wmt14", TAR_NAME),
                          "train/train", dict_size)


def test(dict_size=DICT_SIZE):
    if common.synthetic_mode():
        return _synthetic("test", dict_size, 256)
    return reader_creator(common.real_file("wmt14", TAR_NAME),
                          "test/test", dict_size)


def gen(dict_size=DICT_SIZE):
    if common.synthetic_mode():
        return _synthetic("gen", dict_size, 64)
    return reader_creator(common.real_file("wmt14", TAR_NAME),
                          "gen/gen", dict_size)
