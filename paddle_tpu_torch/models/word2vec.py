"""N-gram word2vec (reference: book test_word2vec.py) and the recommender
embedding trick of sharing one table across context slots."""

from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr

__all__ = ["ngram_lm"]


def ngram_lm(words, dict_size, emb_dim=32, hidden_size=256):
    """words: list of 4 int64 id vars (first, second, third, fourth);
    returns softmax over the dict predicting the next word. All context
    embeddings share one table, as in the reference."""
    embs = []
    for w in words:
        emb = layers.embedding(
            input=w, size=[dict_size, emb_dim],
            param_attr=ParamAttr(name="shared_w"))
        embs.append(emb)
    concat = layers.concat(input=embs, axis=1)
    hidden = layers.fc(input=concat, size=hidden_size, act="sigmoid")
    return layers.fc(input=hidden, size=dict_size, act="softmax")
