"""CIFAR-10/100 (reference dataset/cifar.py): readers yield
(image[3072] float32 in [0,1], label int). Real mode walks the python
pickle batches inside the official tarballs exactly like the reference
(cifar.py:46-64: members matched by sub_name, `data` uint8 rows /255,
`labels` or `fine_labels`); synthetic mode (default — no egress) emits
class-centered blobs."""

import pickle
import tarfile

from . import common

CIFAR10_TAR = "cifar-10-python.tar.gz"
CIFAR100_TAR = "cifar-100-python.tar.gz"


def _synthetic(split, classes, n):
    rng = common.synthetic_rng(f"cifar{classes}", split)
    centers = common.synthetic_rng(f"cifar{classes}", "centers").rand(
        classes, 3072)

    def reader():
        for _ in range(n):
            y = int(rng.randint(0, classes))
            x = (0.7 * centers[y] + 0.3 * rng.rand(3072)).clip(0, 1)
            yield x.astype("float32"), y
    return reader


def _real(tar_name, sub_name):
    def reader():
        path = common.real_file("cifar", tar_name)
        with tarfile.open(path, mode="r") as f:
            names = [m.name for m in f if sub_name in m.name]
            for name in sorted(names):
                batch = pickle.load(f.extractfile(name),
                                    encoding="latin1")
                data = batch["data"]
                labels = batch.get("labels", batch.get("fine_labels"))
                assert labels is not None, name
                for row, label in zip(data, labels):
                    yield (row / 255.0).astype("float32"), int(label)
    return reader


def train10():
    if common.synthetic_mode():
        return _synthetic("train", 10, 4096)
    return _real(CIFAR10_TAR, "data_batch")


def test10():
    if common.synthetic_mode():
        return _synthetic("test", 10, 512)
    return _real(CIFAR10_TAR, "test_batch")


def train100():
    if common.synthetic_mode():
        return _synthetic("train", 100, 4096)
    return _real(CIFAR100_TAR, "train")


def test100():
    if common.synthetic_mode():
        return _synthetic("test", 100, 512)
    return _real(CIFAR100_TAR, "test")
