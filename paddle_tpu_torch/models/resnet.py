"""ResNet for ImageNet (50/101/152) and CIFAR (depth 6n+2).

The port's copy of `paddle_tpu/models/resnet.py` (reference parity:
benchmark/paddle/image/resnet.py and the book image_classification
resnet): the same layer calls, so the Program is the JAX front end's.
Each conv is an NCHW cuDNN convolution; batch_norm, relu and the
residual add run as their own eager ops.
"""

from __future__ import annotations

from .. import layers

__all__ = ["resnet_imagenet", "resnet_cifar10", "resnet50", "resnet101",
           "resnet152"]

_IMAGENET_BLOCKS = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


def conv_bn_layer(input, num_filters, filter_size, stride=1, padding=None,
                  act="relu"):
    if padding is None:
        padding = (filter_size - 1) // 2
    conv = layers.conv2d(input=input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act=None, bias_attr=False)
    return layers.batch_norm(input=conv, act=act)


def _shortcut(input, ch_out, stride):
    ch_in = int(input.shape[1])
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, padding=0, act=None)
    return input


def bottleneck_block(input, num_filters, stride):
    conv0 = conv_bn_layer(input, num_filters, 1, padding=0)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, padding=0, act=None)
    short = _shortcut(input, num_filters * 4, stride)
    return layers.relu(conv2 + short)


def basic_block(input, num_filters, stride):
    conv0 = conv_bn_layer(input, num_filters, 3, stride=stride)
    conv1 = conv_bn_layer(conv0, num_filters, 3, act=None)
    short = _shortcut(input, num_filters, stride)
    return layers.relu(conv1 + short)


def resnet_imagenet(input, class_dim=1000, depth=50):
    """Bottleneck ResNet over 3x224x224 NCHW input; returns softmax probs."""
    counts = _IMAGENET_BLOCKS[depth]
    conv = conv_bn_layer(input, 64, 7, stride=2)
    pool = layers.pool2d(conv, pool_size=3, pool_type="max", pool_stride=2,
                         pool_padding=1)
    x = pool
    for stage, n in enumerate(counts):
        num_filters = 64 * (2 ** stage)
        for i in range(n):
            stride = 2 if i == 0 and stage > 0 else 1
            x = bottleneck_block(x, num_filters, stride)
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    return layers.fc(input=pool, size=class_dim, act="softmax")


def resnet50(input, class_dim=1000):
    return resnet_imagenet(input, class_dim, depth=50)


def resnet101(input, class_dim=1000):
    return resnet_imagenet(input, class_dim, depth=101)


def resnet152(input, class_dim=1000):
    return resnet_imagenet(input, class_dim, depth=152)


def resnet_cifar10(input, class_dim=10, depth=32):
    """Basic-block ResNet over 3x32x32 (depth = 6n+2, reference book
    test_image_classification_train.py resnet_cifar10)."""
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    x = conv_bn_layer(input, 16, 3)
    for stage in range(3):
        num_filters = 16 * (2 ** stage)
        for i in range(n):
            stride = 2 if i == 0 and stage > 0 else 1
            x = basic_block(x, num_filters, stride)
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    return layers.fc(input=pool, size=class_dim, act="softmax")
