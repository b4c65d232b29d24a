"""VGG-11/13/16/19 (the port's copy of `paddle_tpu/models/vgg.py`;
reference: benchmark/paddle/image/vgg.py and the book
image_classification vgg16_bn_drop)."""

from __future__ import annotations

from .. import layers

__all__ = ["vgg", "vgg16", "vgg19", "vgg16_bn_drop"]

_CFG = {
    11: [1, 1, 2, 2, 2],
    13: [2, 2, 2, 2, 2],
    16: [2, 2, 3, 3, 3],
    19: [2, 2, 4, 4, 4],
}


def _conv_block(x, num_filters, groups, with_bn=False, drop=0.0,
                is_test=False):
    for _ in range(groups):
        x = layers.conv2d(input=x, num_filters=num_filters, filter_size=3,
                          padding=1, act=None if with_bn else "relu")
        if with_bn:
            x = layers.batch_norm(input=x, act="relu", is_test=is_test)
        if drop:
            x = layers.dropout(x, dropout_prob=drop, is_test=is_test)
    return layers.pool2d(x, pool_size=2, pool_type="max", pool_stride=2)


def vgg(input, class_dim=1000, depth=16, with_bn=False, is_test=False):
    x = input
    for stage, groups in enumerate(_CFG[depth]):
        x = _conv_block(x, 64 * (2 ** min(stage, 3)), groups,
                        with_bn=with_bn, is_test=is_test)
    x = layers.fc(input=x, size=4096, act="relu")
    x = layers.dropout(x, dropout_prob=0.5, is_test=is_test)
    x = layers.fc(input=x, size=4096, act="relu")
    x = layers.dropout(x, dropout_prob=0.5, is_test=is_test)
    return layers.fc(input=x, size=class_dim, act="softmax")


def vgg16(input, class_dim=1000, is_test=False):
    return vgg(input, class_dim, depth=16, is_test=is_test)


def vgg19(input, class_dim=1000, is_test=False):
    return vgg(input, class_dim, depth=19, is_test=is_test)


def vgg16_bn_drop(input, class_dim=10, is_test=False):
    """The book's CIFAR VGG: conv blocks with BN + dropout (rate 0 on each
    block's last conv, as in the reference config), two 512 fcs."""
    from .. import nets
    x = input
    first_drops = [0.3, 0.4, 0.4, 0.4, 0.4]
    for stage, groups in enumerate(_CFG[16]):
        drop_rates = [first_drops[stage]] * (groups - 1) + [0.0]
        x = nets.img_conv_group(
            x, conv_num_filter=[64 * (2 ** min(stage, 3))] * groups,
            pool_size=2, pool_stride=2, conv_act="relu",
            conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=drop_rates)
    x = layers.dropout(x, dropout_prob=0.5, is_test=is_test)
    x = layers.fc(input=x, size=512, act=None)
    x = layers.batch_norm(input=x, act="relu", is_test=is_test)
    x = layers.dropout(x, dropout_prob=0.5, is_test=is_test)
    x = layers.fc(input=x, size=512, act=None)
    return layers.fc(input=x, size=class_dim, act="softmax")
