"""AlexNet (the port's copy of `paddle_tpu/models/alexnet.py`; reference:
benchmark/paddle/image/alexnet.py, the primary GPU benchmark model of
the reference tree, benchmark/README.md:37)."""

from __future__ import annotations

from .. import layers

__all__ = ["alexnet"]


def alexnet(input, class_dim=1000, is_test=False):
    x = layers.conv2d(input=input, num_filters=64, filter_size=11, stride=4,
                      padding=2, act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_type="max")
    x = layers.lrn(x, n=5, alpha=1e-4, beta=0.75)
    x = layers.conv2d(input=x, num_filters=192, filter_size=5, padding=2,
                      act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_type="max")
    x = layers.lrn(x, n=5, alpha=1e-4, beta=0.75)
    x = layers.conv2d(input=x, num_filters=384, filter_size=3, padding=1,
                      act="relu")
    x = layers.conv2d(input=x, num_filters=256, filter_size=3, padding=1,
                      act="relu")
    x = layers.conv2d(input=x, num_filters=256, filter_size=3, padding=1,
                      act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_type="max")
    x = layers.fc(input=x, size=4096, act="relu")
    x = layers.dropout(x, dropout_prob=0.5, is_test=is_test)
    x = layers.fc(input=x, size=4096, act="relu")
    x = layers.dropout(x, dropout_prob=0.5, is_test=is_test)
    return layers.fc(input=x, size=class_dim, act="softmax")
