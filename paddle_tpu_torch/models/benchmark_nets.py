"""The reference's image benchmark networks — the port of
``paddle_tpu/models/benchmark_nets.py``: AlexNet (227 px), the CIFAR
'quick' SmallNet (32 px) and GoogLeNet v1's main tower (224 px, the aux
classifiers off, as the benchmark runs it), in Fluid layers."""

from __future__ import annotations

from ..fluid import layers

__all__ = ["alexnet", "smallnet_cifar", "googlenet_v1"]


def alexnet(img, class_num: int = 1000, groups: int = 1):
    """Five convolutions (11x11 stride 4, 5x5, three 3x3), LRN after the
    first two, three 3x3 stride-2 max pools, two dropped fc 4096 and a
    softmax."""
    net = layers.conv2d(input=img, num_filters=96, filter_size=11,
                        stride=4, padding=1, act="relu")
    net = layers.lrn(net, n=5, alpha=1e-4, beta=0.75)
    net = layers.pool2d(input=net, pool_size=3, pool_stride=2)
    net = layers.conv2d(input=net, num_filters=256, filter_size=5,
                        padding=2, groups=groups, act="relu")
    net = layers.lrn(net, n=5, alpha=1e-4, beta=0.75)
    net = layers.pool2d(input=net, pool_size=3, pool_stride=2)
    net = layers.conv2d(input=net, num_filters=384, filter_size=3,
                        padding=1, act="relu")
    net = layers.conv2d(input=net, num_filters=384, filter_size=3,
                        padding=1, groups=groups, act="relu")
    net = layers.conv2d(input=net, num_filters=256, filter_size=3,
                        padding=1, groups=groups, act="relu")
    net = layers.pool2d(input=net, pool_size=3, pool_stride=2)
    net = layers.dropout(layers.fc(input=net, size=4096, act="relu"), 0.5)
    net = layers.dropout(layers.fc(input=net, size=4096, act="relu"), 0.5)
    return layers.fc(input=net, size=class_num, act="softmax")


def smallnet_cifar(img, class_num: int = 10):
    """Three 5x5 / 5x5 / 3x3 convolutions, each followed by a 3x3
    stride-2 pool (max, then average), fc 64 and a softmax."""
    net = layers.conv2d(input=img, num_filters=32, filter_size=5,
                        padding=2, act="relu")
    net = layers.pool2d(input=net, pool_size=3, pool_stride=2,
                        pool_padding=1)
    net = layers.conv2d(input=net, num_filters=32, filter_size=5,
                        padding=2, act="relu")
    net = layers.pool2d(input=net, pool_size=3, pool_stride=2,
                        pool_padding=1, pool_type="avg")
    net = layers.conv2d(input=net, num_filters=64, filter_size=3,
                        padding=1, act="relu")
    net = layers.pool2d(input=net, pool_size=3, pool_stride=2,
                        pool_padding=1, pool_type="avg")
    net = layers.fc(input=net, size=64, act="relu")
    return layers.fc(input=net, size=class_num, act="softmax")


def _inception(x, c1, c3r, c3, c5r, c5, proj):
    """An inception block: 1x1, 1x1 -> 3x3, 1x1 -> 5x5 and 3x3 max pool
    -> 1x1 towers, joined along the channels."""
    t1 = layers.conv2d(input=x, num_filters=c1, filter_size=1, act="relu")
    t3 = layers.conv2d(input=x, num_filters=c3r, filter_size=1, act="relu")
    t3 = layers.conv2d(input=t3, num_filters=c3, filter_size=3, padding=1,
                       act="relu")
    t5 = layers.conv2d(input=x, num_filters=c5r, filter_size=1, act="relu")
    t5 = layers.conv2d(input=t5, num_filters=c5, filter_size=5, padding=2,
                       act="relu")
    tp = layers.pool2d(input=x, pool_size=3, pool_stride=1, pool_padding=1)
    tp = layers.conv2d(input=tp, num_filters=proj, filter_size=1,
                       act="relu")
    return layers.concat(input=[t1, t3, t5, tp], axis=1)


def googlenet_v1(img, class_num: int = 1000):
    """GoogLeNet v1's main tower: the stem, inception 3a-3b, 4a-4e and
    5a-5b between 3x3 stride-2 max pools padded by 1 (224 -> 56, 28, 14,
    7), a 7x7 average pool, dropout 0.4 and a softmax."""
    net = layers.conv2d(input=img, num_filters=64, filter_size=7, stride=2,
                        padding=3, act="relu")
    net = layers.pool2d(input=net, pool_size=3, pool_stride=2,
                        pool_padding=1)
    net = layers.conv2d(input=net, num_filters=64, filter_size=1,
                        act="relu")
    net = layers.conv2d(input=net, num_filters=192, filter_size=3,
                        padding=1, act="relu")
    net = layers.pool2d(input=net, pool_size=3, pool_stride=2,
                        pool_padding=1)
    net = _inception(net, 64, 96, 128, 16, 32, 32)       # 3a -> 256
    net = _inception(net, 128, 128, 192, 32, 96, 64)     # 3b -> 480
    net = layers.pool2d(input=net, pool_size=3, pool_stride=2,
                        pool_padding=1)
    net = _inception(net, 192, 96, 208, 16, 48, 64)      # 4a -> 512
    net = _inception(net, 160, 112, 224, 24, 64, 64)     # 4b
    net = _inception(net, 128, 128, 256, 24, 64, 64)     # 4c
    net = _inception(net, 112, 144, 288, 32, 64, 64)     # 4d -> 528
    net = _inception(net, 256, 160, 320, 32, 128, 128)   # 4e -> 832
    net = layers.pool2d(input=net, pool_size=3, pool_stride=2,
                        pool_padding=1)
    net = _inception(net, 256, 160, 320, 32, 128, 128)   # 5a
    net = _inception(net, 384, 192, 384, 48, 128, 128)   # 5b -> 1024
    net = layers.pool2d(input=net, pool_size=7, pool_stride=1,
                        pool_type="avg")
    net = layers.dropout(net, 0.4)
    return layers.fc(input=net, size=class_num, act="softmax")
