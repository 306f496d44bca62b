"""word2vec N-gram language model — the port of
``paddle_tpu/models/word2vec.py``, book ch.04
(fluid/tests/book/test_word2vec.py): four context words -> next word."""

from __future__ import annotations

from ..fluid import layers


def ngram_model(words, dict_size: int, embed_size: int = 32,
                hidden_size: int = 256):
    """`words` is a list of 5 int data vars: 4 context + 1 target.
    Returns (avg_cost, predict_word)."""
    # all four context positions share ONE table, like the reference
    # chapter (book/test_word2vec.py:33-56 passes param_attr='shared_w' to
    # every embedding; LayerHelper dedupes by name)
    embeds = [
        layers.embedding(input=w, size=[dict_size, embed_size],
                         param_attr="shared_w")
        for w in words[:4]
    ]
    concat = layers.concat(input=embeds, axis=1)
    hidden = layers.fc(input=concat, size=hidden_size, act="sigmoid")
    predict = layers.fc(input=hidden, size=dict_size, act="softmax")
    cost = layers.cross_entropy(input=predict, label=words[4])
    return layers.mean(cost), predict
