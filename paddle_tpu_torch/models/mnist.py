"""MNIST nets (the port's copy of `paddle_tpu/models/mnist.py`;
reference: tests/book/test_recognize_digits_{mlp,conv}.py)."""

from __future__ import annotations

from .. import layers, nets

__all__ = ["mlp", "conv_net"]


def mlp(img, class_dim=10):
    h1 = layers.fc(input=img, size=128, act="relu")
    h2 = layers.fc(input=h1, size=64, act="relu")
    return layers.fc(input=h2, size=class_dim, act="softmax")


def conv_net(img, class_dim=10, is_test=False):
    """conv-pool x2 + fc softmax (the book's simple_img_conv_pool pair)."""
    c1 = nets.simple_img_conv_pool(input=img, filter_size=5, num_filters=20,
                                   pool_size=2, pool_stride=2, act="relu")
    c2 = nets.simple_img_conv_pool(input=c1, filter_size=5, num_filters=50,
                                   pool_size=2, pool_stride=2, act="relu")
    return layers.fc(input=c2, size=class_dim, act="softmax")
