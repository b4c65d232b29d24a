"""CoNLL-2005 SRL (reference dataset/conll05.py): the
label_semantic_roles book chapter input — (word_ids, ctx_n2, ctx_n1,
ctx_0, ctx_p1, ctx_p2, verb_ids, mark, label_ids) aligned sequences.

Real mode parses the published conll05st-tests.tar.gz layout — paired
words.gz / props.gz streams inside the tarball, bracketed proposition
columns converted to BIO tags (reference conll05.py:51-121) — plus the
plain-text word/verb/target dict files."""

import gzip
import itertools
import tarfile

from . import common

WORD_VOCAB = 5000
LABEL_COUNT = 59  # BIO over the SRL tag set
PRED_VOCAB = 3000
UNK_IDX = 0

DATA_TAR = "conll05st-tests.tar.gz"
WORDS_NAME = "conll05st-release/test.wsj/words/test.wsj.words.gz"
PROPS_NAME = "conll05st-release/test.wsj/props/test.wsj.props.gz"


def load_dict(filename):
    d = {}
    with open(filename) as f:
        for i, line in enumerate(f):
            d[line.strip()] = i
    return d


def get_dict():
    if common.synthetic_mode():
        word_dict = common.make_word_dict(WORD_VOCAB)
        verb_dict = common.make_word_dict(PRED_VOCAB, prefix="v")
        label_dict = {f"L{i}": i for i in range(LABEL_COUNT)}
        return word_dict, verb_dict, label_dict
    return (load_dict(common.real_file("conll05st", "wordDict.txt")),
            load_dict(common.real_file("conll05st", "verbDict.txt")),
            load_dict(common.real_file("conll05st", "targetDict.txt")))


def get_embedding():
    if common.synthetic_mode():
        rng = common.synthetic_rng("conll05", "emb")
        return rng.randn(WORD_VOCAB, 32).astype("float32")
    # the reference returns the downloaded file's PATH (conll05.py:198)
    return common.real_file("conll05st", "emb")


def corpus_reader(data_path, words_name=WORDS_NAME,
                  props_name=PROPS_NAME):
    """Yield (sentence tokens, predicate, BIO labels) triples from the
    paired words/props gzip streams (reference conll05.py:51-121): a
    blank line ends a sentence; each proposition column becomes one
    training sample; bracketed spans '(TAG*'/'*)'/'*' turn into
    B-/I-/O tags."""

    def reader():
        with tarfile.open(data_path) as tf:
            wf = tf.extractfile(words_name)
            pf = tf.extractfile(props_name)
            with gzip.GzipFile(fileobj=wf) as words_file, \
                    gzip.GzipFile(fileobj=pf) as props_file:
                sentences, labels, one_seg = [], [], []
                for word, label in itertools.zip_longest(words_file,
                                                         props_file):
                    word = (word or b"").decode().strip()
                    label = (label or b"").decode().strip().split()
                    if len(label) == 0:      # end of sentence
                        for i in range(len(one_seg[0]) if one_seg
                                       else 0):
                            labels.append([x[i] for x in one_seg])
                        if len(labels) >= 1:
                            verb_list = [x for x in labels[0]
                                         if x != "-"]
                            for i, lbl in enumerate(labels[1:]):
                                cur_tag, in_bracket = "O", False
                                lbl_seq = []
                                for l in lbl:
                                    if l == "*" and not in_bracket:
                                        lbl_seq.append("O")
                                    elif l == "*" and in_bracket:
                                        lbl_seq.append("I-" + cur_tag)
                                    elif l == "*)":
                                        lbl_seq.append("I-" + cur_tag)
                                        in_bracket = False
                                    elif "(" in l and ")" in l:
                                        cur_tag = l[1:l.find("*")]
                                        lbl_seq.append("B-" + cur_tag)
                                        in_bracket = False
                                    elif "(" in l and ")" not in l:
                                        cur_tag = l[1:l.find("*")]
                                        lbl_seq.append("B-" + cur_tag)
                                        in_bracket = True
                                    else:
                                        raise RuntimeError(
                                            f"Unexpected label: {l}")
                                yield sentences, verb_list[i], lbl_seq
                        sentences, labels, one_seg = [], [], []
                    else:
                        sentences.append(word)
                        one_seg.append(label)

    return reader


def reader_creator(corpus_rdr, word_dict, predicate_dict, label_dict):
    """Predicate-context featurisation (reference conll05.py:126-176)."""

    def reader():
        for sentence, predicate, labels in corpus_rdr():
            sen_len = len(sentence)
            verb_index = labels.index("B-V")
            mark = [0] * len(labels)

            def ctx(offset, fallback):
                i = verb_index + offset
                if 0 <= i < len(labels):
                    mark[i] = 1
                    return sentence[i]
                return fallback

            ctx_n2 = ctx(-2, "bos") if verb_index > 1 else "bos"
            ctx_n1 = ctx(-1, "bos") if verb_index > 0 else "bos"
            ctx_0 = ctx(0, "bos")
            ctx_p1 = ctx(1, "eos") if verb_index < len(labels) - 1 \
                else "eos"
            ctx_p2 = ctx(2, "eos") if verb_index < len(labels) - 2 \
                else "eos"

            word_idx = [word_dict.get(w, UNK_IDX) for w in sentence]
            ctxs = [[word_dict.get(c, UNK_IDX)] * sen_len
                    for c in (ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2)]
            pred_idx = [predicate_dict.get(predicate)] * sen_len
            label_idx = [label_dict.get(w) for w in labels]
            yield (word_idx, *ctxs, pred_idx, mark, label_idx)

    return reader


def _synthetic(split, n):
    rng = common.synthetic_rng("conll05", split)

    def reader():
        for _ in range(n):
            length = int(rng.randint(5, 40))
            words = rng.randint(3, WORD_VOCAB, size=length).tolist()
            ctx = [rng.randint(3, WORD_VOCAB, size=length).tolist()
                   for _ in range(5)]
            verb = [int(rng.randint(3, PRED_VOCAB))] * length
            mark = [0] * length
            mark[int(rng.randint(0, length))] = 1
            labels = rng.randint(0, LABEL_COUNT, size=length).tolist()
            yield (words, *ctx, verb, mark, labels)
    return reader


def test():
    if common.synthetic_mode():
        return _synthetic("test", 512)
    word_dict, verb_dict, label_dict = get_dict()
    rdr = corpus_reader(common.real_file("conll05st", DATA_TAR))
    return reader_creator(rdr, word_dict, verb_dict, label_dict)


def train():
    # the real CoNLL-05 training set is not freely distributable; the
    # reference trains on the public test split too (conll05.py:201)
    if common.synthetic_mode():
        return _synthetic("train", 2048)
    return test()
