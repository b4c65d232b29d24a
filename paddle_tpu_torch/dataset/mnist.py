"""MNIST (reference python/paddle/v2/dataset/mnist.py): train()/test()
yield (image[784] float32 in [-1,1], label int). Synthetic mode (the
default here — no egress) emits class-separable gaussian digit blobs so
tiny models actually converge; real mode parses the gzip idx files
exactly like the reference (mnist.py:38-70 — zcat pipe there, gzip
module here; same 16/8-byte header skip, same /255*2-1 scaling).
"""

import gzip

import numpy as np

from . import common

TRAIN_SIZE, TEST_SIZE = 8192, 1024

TRAIN_IMAGES = "train-images-idx3-ubyte.gz"
TRAIN_LABELS = "train-labels-idx1-ubyte.gz"
TEST_IMAGES = "t10k-images-idx3-ubyte.gz"
TEST_LABELS = "t10k-labels-idx1-ubyte.gz"


def _synthetic(split, n):
    rng = common.synthetic_rng("mnist", split)
    centers = common.synthetic_rng("mnist", "centers").randn(10, 784) * 0.5

    def reader():
        for _ in range(n):
            y = int(rng.randint(0, 10))
            x = (centers[y] + 0.3 * rng.randn(784)).clip(-1, 1)
            yield x.astype("float32"), y
    return reader


def _parse_idx(image_gz, label_gz):
    """idx3 (images) + idx1 (labels): big-endian headers — magic,
    count[, rows, cols] — then raw ubyte payload."""
    with gzip.open(image_gz, "rb") as f:
        magic = int.from_bytes(f.read(4), "big")
        if magic != 2051:
            raise IOError(f"{image_gz}: bad idx3 magic {magic}")
        count = int.from_bytes(f.read(4), "big")
        rows = int.from_bytes(f.read(4), "big")
        cols = int.from_bytes(f.read(4), "big")
        images = np.frombuffer(f.read(count * rows * cols),
                               np.uint8).reshape(count, rows * cols)
    with gzip.open(label_gz, "rb") as f:
        magic = int.from_bytes(f.read(4), "big")
        if magic != 2049:
            raise IOError(f"{label_gz}: bad idx1 magic {magic}")
        lcount = int.from_bytes(f.read(4), "big")
        labels = np.frombuffer(f.read(lcount), np.uint8)
    if count != lcount:
        raise IOError(f"mnist: {count} images but {lcount} labels")
    return images, labels


def _real(image_name, label_name):
    def reader():
        images, labels = _parse_idx(common.real_file("mnist", image_name),
                                    common.real_file("mnist", label_name))
        scaled = images.astype("float32") / 255.0 * 2.0 - 1.0
        for i in range(images.shape[0]):
            yield scaled[i], int(labels[i])
    return reader


def train():
    if common.synthetic_mode():
        return _synthetic("train", TRAIN_SIZE)
    return _real(TRAIN_IMAGES, TRAIN_LABELS)


def test():
    if common.synthetic_mode():
        return _synthetic("test", TEST_SIZE)
    return _real(TEST_IMAGES, TEST_LABELS)
