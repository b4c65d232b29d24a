"""Dataset cache plumbing (the port's copy of
`paddle_tpu/dataset/common.py`; reference python/paddle/v2/dataset/
common.py: DATA_HOME, md5 check). The port downloads nothing: a real
file is placed under DATA_HOME by hand, and `download` is not copied.

Every loader in this package has a deterministic SYNTHETIC mode
producing structurally-faithful data (same tuple shapes, dtypes, vocab
objects as the real loaders), on by default and switchable with
PADDLE_TPU_DATASET_SYNTHETIC=0 once real files are present in
DATA_HOME. Tests run hermetically on synthetic data, mirroring the
reference's own fixture-generator strategy
(gserver/tests/sequenceGen.py etc., SURVEY.md §4).
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))


def data_home():
    """Resolve the data root at CALL time: the env var wins over the
    import-time snapshot, so pointing PADDLE_TPU_DATA_HOME at fixture
    files works even after the package is imported."""
    env = os.environ.get("PADDLE_TPU_DATA_HOME")
    return os.path.expanduser(env) if env else DATA_HOME


def synthetic_mode() -> bool:
    return os.environ.get("PADDLE_TPU_DATASET_SYNTHETIC", "1") != "0"


def md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def real_file(module_name, filename):
    """Path of an already-present real data file (what `download` would
    have fetched); raises with guidance when absent. Real-mode loaders
    resolve their inputs through this so a PADDLE_TPU_DATA_HOME pointed
    at fixture files exercises the same parsers hermetically."""
    path = os.path.join(data_home(), module_name, filename)
    if not os.path.exists(path):
        raise IOError(
            f"real-mode dataset file missing: {path}. Download it there "
            "(no egress in this environment) or use synthetic mode "
            "(PADDLE_TPU_DATASET_SYNTHETIC=1, the default)")
    return path


def synthetic_rng(name, split):
    """Deterministic per-(dataset, split) generator."""
    seed = int(hashlib.md5(f"{name}:{split}".encode()).hexdigest()[:8], 16)
    return np.random.RandomState(seed)


def make_word_dict(vocab_size, prefix="w",
                   markers=("<unk>", "<s>", "<e>")):
    """word -> id dict shaped like the reference's build_dict outputs.
    `markers` sets the first ids in order — the wmt loaders pass
    ("<s>", "<e>", "<unk>") to mirror their real dict files' layout."""
    d = {m: i for i, m in enumerate(markers)}
    for i in range(len(markers), vocab_size):
        d[f"{prefix}{i}"] = i
    return d
