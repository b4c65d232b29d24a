"""PASCAL VOC2012 segmentation (reference dataset/voc2012.py): readers
yield (image, segmentation label) pairs.

Real mode parses the published VOCtrainval tarball layout (reference
voc2012.py:33-66): the split list under
VOCdevkit/VOC2012/ImageSets/Segmentation/{train,val,trainval}.txt names
each sample; images decode from JPEGImages/<name>.jpg (HWC uint8) and
labels from SegmentationClass/<name>.png (palette png -> HW class
indices), via PIL exactly as the reference."""

import io
import tarfile

import numpy as np

from . import common

H = W = 128  # synthetic resolution (real VOC is variable-size)
CLASSES = 21

VOC_TAR = "VOCtrainval_11-May-2012.tar"
SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"


def _synthetic(split, n):
    rng = common.synthetic_rng("voc2012", split)

    def reader():
        # same layout the real decode yields: HWC uint8 image, HW
        # uint8 class-index label (PIL palette png)
        for _ in range(n):
            img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
            seg = np.zeros((H, W), np.uint8)
            # a couple of rectangular "objects"
            for _ in range(int(rng.randint(1, 4))):
                c = int(rng.randint(1, CLASSES))
                x0, y0 = rng.randint(0, H // 2, size=2)
                seg[y0:y0 + H // 4, x0:x0 + W // 4] = c
            yield img, seg
    return reader


def reader_creator(filename, sub_name):
    from PIL import Image

    def reader():
        with tarfile.open(filename) as tarobject:
            name2mem = {m.name: m for m in tarobject.getmembers()}
            sets = tarobject.extractfile(
                name2mem[SET_FILE.format(sub_name)])
            for line in sets:
                line = line.decode().strip()
                data = tarobject.extractfile(
                    name2mem[DATA_FILE.format(line)]).read()
                label = tarobject.extractfile(
                    name2mem[LABEL_FILE.format(line)]).read()
                data = np.array(Image.open(io.BytesIO(data)))
                label = np.array(Image.open(io.BytesIO(label)))
                yield data, label
    return reader


def _split(split, sub_name, n):
    if common.synthetic_mode():
        return _synthetic(split, n)
    return reader_creator(common.real_file("VOC2012", VOC_TAR), sub_name)


def train():
    return _split("train", "trainval", 128)


def test():
    return _split("test", "train", 32)


def valid():
    return _split("valid", "val", 32)
