"""Sentiment classification — the port of ``paddle_tpu/models/sentiment.py``
(book ch.06), cut to ``stacked_lstm_net``.  ``convolution_net`` needs
``sequence_conv`` and is not ported."""

from __future__ import annotations

from ..fluid import layers

__all__ = ["stacked_lstm_net"]


def stacked_lstm_net(data, label, input_dim, class_dim=2, emb_dim=128,
                     hid_dim=512, stacked_num=3):
    """The chapter's stacked LSTM, alternating forward and reverse."""
    if stacked_num % 2 != 1:
        raise ValueError("stacked_num must be odd")
    emb = layers.embedding(input=data, size=[input_dim, emb_dim])
    fc1 = layers.fc(input=emb, size=hid_dim)
    lstm1, _ = layers.dynamic_lstm(input=fc1, size=hid_dim)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(input=inputs, size=hid_dim)
        lstm, _ = layers.dynamic_lstm(input=fc, size=hid_dim,
                                      is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]
    fc_last = layers.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = layers.sequence_pool(input=inputs[1], pool_type="max")
    prediction = layers.fc(input=[fc_last, lstm_last], size=class_dim,
                           act="softmax")
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=prediction, label=label)
    return avg_cost, acc, prediction
