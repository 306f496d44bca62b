"""Linear regression, the book's first chapter — the port of
``paddle_tpu/models/fit_a_line.py``."""

from __future__ import annotations

from ..fluid import layers, optimizer


def build(feature_dim: int = 13, lr: float = 0.01):
    """Returns (feeds, loss, pred) with SGD already applied: the
    reference chapter's program."""
    x = layers.data(name="x", shape=[feature_dim], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    y_predict = layers.fc(input=x, size=1, act=None)
    cost = layers.square_error_cost(input=y_predict, label=y)
    avg_cost = layers.mean(cost)
    optimizer.SGD(learning_rate=lr).minimize(avg_cost)
    return [x, y], avg_cost, y_predict
