"""GoogLeNet v1 (reference: benchmark/paddle/image/googlenet.py — the
inception(name, input, ...) config at :108-195, a primary GPU benchmark
model, benchmark/README.md:50).

The port's copy of `paddle_tpu/models/googlenet.py`. Inception module =
four parallel towers (1x1 / 1x1->3x3 / 1x1->5x5 / pool->1x1)
concatenated on channels. The two auxiliary classifier heads of the
paper are omitted (the reference benchmark config omits them too).
"""

from __future__ import annotations

from .. import layers

__all__ = ["googlenet", "smallnet_mnist_cifar"]


def _inception(x, c1, c3r, c3, c5r, c5, proj):
    t1 = layers.conv2d(x, c1, 1, act="relu")
    t3 = layers.conv2d(x, c3r, 1, act="relu")
    t3 = layers.conv2d(t3, c3, 3, padding=1, act="relu")
    t5 = layers.conv2d(x, c5r, 1, act="relu")
    t5 = layers.conv2d(t5, c5, 5, padding=2, act="relu")
    tp = layers.pool2d(x, pool_size=3, pool_stride=1, pool_padding=1,
                       pool_type="max")
    tp = layers.conv2d(tp, proj, 1, act="relu")
    return layers.concat([t1, t3, t5, tp], axis=1)


def googlenet(input, class_dim=1000, is_test=False):
    """input [N, 3, 224, 224] -> softmax probs [N, class_dim]."""
    x = layers.conv2d(input, 64, 7, stride=2, padding=3, act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    x = layers.conv2d(x, 64, 1, act="relu")
    x = layers.conv2d(x, 192, 3, padding=1, act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")

    x = _inception(x, 64, 96, 128, 16, 32, 32)      # 3a -> 256
    x = _inception(x, 128, 128, 192, 32, 96, 64)    # 3b -> 480
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    x = _inception(x, 192, 96, 208, 16, 48, 64)     # 4a
    x = _inception(x, 160, 112, 224, 24, 64, 64)    # 4b
    x = _inception(x, 128, 128, 256, 24, 64, 64)    # 4c
    x = _inception(x, 112, 144, 288, 32, 64, 64)    # 4d
    x = _inception(x, 256, 160, 320, 32, 128, 128)  # 4e -> 832
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    x = _inception(x, 256, 160, 320, 32, 128, 128)  # 5a
    x = _inception(x, 384, 192, 384, 48, 128, 128)  # 5b -> 1024

    x = layers.pool2d(x, pool_size=7, pool_stride=7, pool_type="avg")
    x = layers.dropout(x, dropout_prob=0.4, is_test=is_test)
    return layers.fc(x, class_dim, act="softmax")


def smallnet_mnist_cifar(input, class_dim=10):
    """SmallNet / CIFAR-quick (benchmark/paddle/image/
    smallnet_mnist_cifar.py): 3 conv-pool stages + fc.
    input [N, 3, 32, 32]."""
    x = layers.conv2d(input, 32, 5, padding=2, act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    x = layers.conv2d(x, 32, 5, padding=2, act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="avg")
    x = layers.conv2d(x, 64, 3, padding=1, act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="avg")
    x = layers.fc(x, 64, act="relu")
    return layers.fc(x, class_dim, act="softmax")
