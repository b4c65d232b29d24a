"""UCI housing (reference dataset/uci_housing.py): (features[13] f32,
price[1] f32). Real mode parses the whitespace-separated 14-column
file and normalises features by (x - avg) / (max - min) over the whole
file, 80/20 train/test split — the exact load_data recipe
(uci_housing.py:60-76). Synthetic (default): linear ground truth +
noise so fit_a_line converges exactly as on the real data."""

import numpy as np

from . import common

DATA_FILE = "housing.data"
FEATURE_NUM = 14
_cache = {}


def _synthetic(split, n):
    rng = common.synthetic_rng("uci_housing", split)
    w = common.synthetic_rng("uci_housing", "w").randn(13, 1)

    def reader():
        for _ in range(n):
            x = rng.randn(13).astype("float32")
            y = (x @ w)[0] + 0.1 * rng.randn()
            yield x, np.asarray([y], dtype="float32")
    return reader


def _load_real(ratio=0.8):
    if "train" in _cache:
        return
    path = common.real_file("uci_housing", DATA_FILE)
    data = np.fromfile(path, sep=" ")
    data = data.reshape(data.shape[0] // FEATURE_NUM, FEATURE_NUM)
    maximums = data.max(axis=0)
    minimums = data.min(axis=0)
    avgs = data.sum(axis=0) / data.shape[0]
    for i in range(FEATURE_NUM - 1):
        data[:, i] = (data[:, i] - avgs[i]) / (maximums[i] - minimums[i])
    offset = int(data.shape[0] * ratio)
    _cache["train"] = data[:offset]
    _cache["test"] = data[offset:]


def _real(split):
    def reader():
        _load_real()
        for d in _cache[split]:
            yield d[:-1].astype("float32"), d[-1:].astype("float32")
    return reader


def train():
    if common.synthetic_mode():
        return _synthetic("train", 404)
    return _real("train")


def test():
    if common.synthetic_mode():
        return _synthetic("test", 102)
    return _real("test")
