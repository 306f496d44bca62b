"""MNIST digit recognition, the book's second chapter — the port of
``paddle_tpu/models/recognize_digits.py``: the conv-pool network and the
multilayer perceptron."""

from __future__ import annotations

from ..fluid import layers, nets


def conv_net(img, label):
    """Two conv-pool stages (20 and 50 filters of 5x5, 2x2 max pool),
    then a 10-way softmax."""
    conv_pool_1 = nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv_pool_2 = nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    prediction = layers.fc(input=conv_pool_2, size=10, act="softmax")
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=prediction, label=label)
    return prediction, avg_cost, acc


def mlp(img, label):
    hidden = layers.fc(input=img, size=128, act="relu")
    hidden = layers.fc(input=hidden, size=64, act="relu")
    prediction = layers.fc(input=hidden, size=10, act="softmax")
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=prediction, label=label)
    return prediction, avg_cost, acc
