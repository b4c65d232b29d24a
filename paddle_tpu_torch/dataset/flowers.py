"""Oxford-102 flowers (reference dataset/flowers.py): readers yield
(image[3*224*224] float32, label int).

Real mode parses the published archive trio (reference
flowers.py:73-130): 102flowers.tgz holding jpg/image_%05d.jpg,
imagelabels.mat ('labels', 1-based) and setid.mat whose
trnid/valid/tstid vectors pick each split's image indices; images
decode via PIL, center-crop-resize to 224, CHW float32 — the
reference's simple_transform without the train-time random crop
(deterministic loaders here)."""

import io
import tarfile

import numpy as np

from . import common

CLASSES = 102

FLOWERS_TAR = "102flowers.tgz"
LABELS_MAT = "imagelabels.mat"
SETID_MAT = "setid.mat"
# reference flowers.py train/test/valid use tstid/trnid/valid
# respectively (the big 'test' split trains, flowers.py:163-205)
SPLIT_KEY = {"train": "tstid", "test": "trnid", "valid": "valid"}


def _synthetic(split, n, seed_extra=""):
    rng = common.synthetic_rng("flowers" + seed_extra, split)

    def reader():
        for _ in range(n):
            y = int(rng.randint(0, CLASSES))
            base = (y / CLASSES)
            x = (base + 0.2 * rng.rand(3 * 224 * 224)).clip(0, 1)
            yield x.astype(np.float32), y
    return reader


def default_mapper(sample):
    """Decode + center-crop-resize to 3x224x224 float32 (the
    deterministic core of reference flowers.py default_mapper)."""
    from PIL import Image
    img_bytes, label = sample
    img = Image.open(io.BytesIO(img_bytes)).convert("RGB")
    w, h = img.size
    s = min(w, h)
    img = img.crop(((w - s) // 2, (h - s) // 2,
                    (w + s) // 2, (h + s) // 2)).resize((224, 224))
    arr = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
    return arr.flatten(), int(label) - 1


def reader_creator(data_file, label_file, setid_file, dataset_name,
                   mapper=None):
    import scipy.io as scio
    labels = scio.loadmat(label_file)["labels"][0]
    indexes = scio.loadmat(setid_file)[dataset_name][0]
    mapper = mapper or default_mapper

    def reader():
        # one SEQUENTIAL pass over the gzip tar collecting this split's
        # members (random access in a .tgz re-decompresses from the
        # start on every backward seek — O(n^2) for the real 330 MB
        # archive); memory is bounded by the split's compressed jpgs,
        # the same budget as the reference's batch-pickle staging
        wanted = {"jpg/image_%05d.jpg" % i: int(i) for i in indexes}
        blobs = {}
        with tarfile.open(data_file) as f:
            m = f.next()
            while m is not None:
                if m.name in wanted:
                    blobs[m.name] = f.extractfile(m).read()
                m = f.next()
        for i in indexes:
            name = "jpg/image_%05d.jpg" % i
            yield mapper((blobs[name], labels[i - 1]))
    return reader


def _split(split, n, mapper=None):
    if common.synthetic_mode():
        return _synthetic(split, n)
    return reader_creator(common.real_file("flowers", FLOWERS_TAR),
                          common.real_file("flowers", LABELS_MAT),
                          common.real_file("flowers", SETID_MAT),
                          SPLIT_KEY[split], mapper)


def train(mapper=None, buffered_size=1024, use_xmap=False):
    return _split("train", 256, mapper)


def test(mapper=None, buffered_size=1024, use_xmap=False):
    return _split("test", 64, mapper)


def valid(mapper=None, buffered_size=1024, use_xmap=False):
    return _split("valid", 64, mapper)
