"""CIFAR and ImageNet image classification, the book's third chapter —
the port of ``paddle_tpu/models/image_classification.py``: the
chapter's ``vgg16_bn_drop`` and ``resnet_cifar10``, and the bottleneck
``resnet_imagenet`` (depth 50, 101 or 152) of the reference's ResNet-50
benchmark."""

from __future__ import annotations

from ..fluid import layers, nets

__all__ = ["conv_bn_layer", "shortcut", "vgg16_bn_drop", "resnet_cifar10",
           "resnet_imagenet"]


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu"):
    """A convolution without bias, then a batch norm with the
    activation: the unit of both ResNets."""
    tmp = layers.conv2d(input=input, filter_size=filter_size,
                        num_filters=ch_out, stride=stride,
                        padding=padding, act=None, bias_attr=False)
    return layers.batch_norm(input=tmp, act=act)


def shortcut(input, ch_in, ch_out, stride):
    """The residual branch: a 1x1 ``conv_bn_layer`` where the channel
    count changes, else the input itself."""
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None)
    return input


def vgg16_bn_drop(input, class_num: int = 10):
    """VGG-16 with a batch norm after every convolution and dropout
    between them, then fc 512 -> batch norm -> fc 512 -> softmax."""
    def conv_block(ipt, num_filter, groups, dropouts):
        return nets.img_conv_group(
            input=ipt, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type="max")

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = layers.dropout(x=conv5, dropout_prob=0.5)
    fc1 = layers.fc(input=drop, size=512, act=None)
    bn = layers.batch_norm(input=fc1, act="relu")
    drop2 = layers.dropout(x=bn, dropout_prob=0.5)
    fc2 = layers.fc(input=drop2, size=512, act=None)
    return layers.fc(input=fc2, size=class_num, act="softmax")


def resnet_cifar10(input, depth: int = 32, class_num: int = 10):
    """The chapter's CIFAR ResNet: a 16-channel ``conv_bn_layer``, three
    stacks of (depth - 2) / 6 basic blocks at 16, 32 and 64 channels, an
    8x8 average pool and a softmax."""
    assert (depth - 2) % 6 == 0

    def basicblock(input, ch_in, ch_out, stride):
        tmp = conv_bn_layer(input, ch_out, 3, stride, 1)
        tmp = conv_bn_layer(tmp, ch_out, 3, 1, 1, act=None)
        short = shortcut(input, ch_in, ch_out, stride)
        return layers.elementwise_add(tmp, short, act="relu")

    def layer_warp(block_func, input, ch_in, ch_out, count, stride):
        tmp = block_func(input, ch_in, ch_out, stride)
        for _ in range(count - 1):
            tmp = block_func(tmp, ch_out, ch_out, 1)
        return tmp

    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, ch_out=16, filter_size=3, stride=1,
                          padding=1)
    res1 = layer_warp(basicblock, conv1, 16, 16, n, 1)
    res2 = layer_warp(basicblock, res1, 16, 32, n, 2)
    res3 = layer_warp(basicblock, res2, 32, 64, n, 2)
    pool = layers.pool2d(input=res3, pool_size=8, pool_type="avg",
                         pool_stride=1)
    return layers.fc(input=pool, size=class_num, act="softmax")


def resnet_imagenet(input, class_num: int = 1000, depth: int = 50):
    """The bottleneck ResNet of the reference's ImageNet benchmark: a 7x7
    stride-2 ``conv_bn_layer`` and a 3x3 max pool, four stacks of
    bottleneck blocks (3-4-6-3 at depth 50, 3-4-23-3 at 101, 3-8-36-3 at
    152), a global average pool and a softmax."""
    cfg = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]

    def bottleneck(input, ch_in, ch_out, stride):
        tmp = conv_bn_layer(input, ch_out, 1, stride, 0)
        tmp = conv_bn_layer(tmp, ch_out, 3, 1, 1)
        tmp = conv_bn_layer(tmp, ch_out * 4, 1, 1, 0, act=None)
        short = shortcut(input, ch_in, ch_out * 4, stride)
        return layers.elementwise_add(tmp, short, act="relu")

    def layer_warp(input, ch_in, ch_out, count, stride):
        tmp = bottleneck(input, ch_in, ch_out, stride)
        for _ in range(count - 1):
            tmp = bottleneck(tmp, ch_out * 4, ch_out, 1)
        return tmp

    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                          padding=3)
    pool1 = layers.pool2d(input=conv1, pool_size=3, pool_stride=2,
                          pool_padding=1, pool_type="max")
    res1 = layer_warp(pool1, 64, 64, cfg[0], 1)
    res2 = layer_warp(res1, 256, 128, cfg[1], 2)
    res3 = layer_warp(res2, 512, 256, cfg[2], 2)
    res4 = layer_warp(res3, 1024, 512, cfg[3], 2)
    pool2 = layers.pool2d(input=res4, pool_type="avg", global_pooling=True)
    return layers.fc(input=pool2, size=class_num, act="softmax")
