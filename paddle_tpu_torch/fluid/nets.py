"""Composite network helpers — the port of ``paddle_tpu/fluid/nets.py``,
cut to the image helpers: ``simple_img_conv_pool`` and
``img_conv_group``.  ``sequence_conv_pool``, ``glu`` and
``scaled_dot_product_attention`` are absent."""

from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act=None, param_attr=None,
                         pool_type="max", **kw):
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", **kw):
    """Convolutions, each optionally followed by a batch norm (which then
    takes the activation) and a dropout, then one pool."""
    tmp = input
    if not isinstance(conv_padding, list):
        conv_padding = [conv_padding] * len(conv_num_filter)
    if not isinstance(conv_with_batchnorm, list):
        conv_with_batchnorm = [conv_with_batchnorm] * len(conv_num_filter)
    if not isinstance(conv_batchnorm_drop_rate, list):
        conv_batchnorm_drop_rate = ([conv_batchnorm_drop_rate]
                                    * len(conv_num_filter))
    for i, nf in enumerate(conv_num_filter):
        local_act = conv_act if not conv_with_batchnorm[i] else None
        tmp = layers.conv2d(input=tmp, num_filters=nf,
                            filter_size=conv_filter_size,
                            padding=conv_padding[i], param_attr=param_attr,
                            act=local_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i] > 0:
                tmp = layers.dropout(x=tmp,
                                     dropout_prob=conv_batchnorm_drop_rate[i])
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)
