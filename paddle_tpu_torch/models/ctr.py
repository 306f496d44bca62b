"""CTR prediction — wide&deep with sparse embeddings; the port of
``paddle_tpu/models/ctr.py``.

BASELINE.json config #5: "CTR DeepFM / wide&deep with sparse embeddings".
`embedding(is_sparse=True)` produces SelectedRows row gradients inside
the captured step, and sgd / adagrad apply them as row scatters: no
[V, D] dense gradient.

Criteo-style schema: 13 dense numeric features + 26 categorical slots,
binary click label.  Deep part: slot embeddings concat → MLP; wide part:
per-slot 1-d embeddings (a sparse linear model) + dense linear.
"""

from __future__ import annotations

from ..fluid import layers

__all__ = ["wide_and_deep", "DENSE_DIM", "NUM_SLOTS"]

DENSE_DIM = 13
NUM_SLOTS = 26


def wide_and_deep(sparse_ids, dense_input, label, slot_vocab: int,
                  embed_dim: int = 16, hidden_sizes=(400, 400, 400),
                  is_sparse: bool = True):
    """Build the wide&deep CTR graph.

    sparse_ids: list of NUM_SLOTS int64 data vars [batch, 1];
    dense_input: float32 [batch, DENSE_DIM]; label: float32 [batch, 1].
    Returns (avg_cost, prob).
    """
    # deep: per-slot embeddings (the huge sparse tables)
    embeds = [
        layers.embedding(input=ids, size=[slot_vocab, embed_dim],
                         is_sparse=is_sparse,
                         param_attr=f"deep_emb_{i}")
        for i, ids in enumerate(sparse_ids)
    ]
    deep = layers.concat(input=embeds + [dense_input], axis=1)
    for i, h in enumerate(hidden_sizes):
        deep = layers.fc(input=deep, size=h, act="relu")
    deep_logit = layers.fc(input=deep, size=1)

    # wide: sparse linear (1-d embeddings double as per-id weights) + dense
    wide_parts = [
        layers.embedding(input=ids, size=[slot_vocab, 1],
                         is_sparse=is_sparse,
                         param_attr=f"wide_emb_{i}")
        for i, ids in enumerate(sparse_ids)
    ]
    wide_logit = layers.fc(input=layers.concat(input=wide_parts, axis=1),
                           size=1, bias_attr=False)
    dense_logit = layers.fc(input=dense_input, size=1, bias_attr=False)

    logit = layers.elementwise_add(
        layers.elementwise_add(deep_logit, wide_logit), dense_logit)
    cost = layers.sigmoid_cross_entropy_with_logits(x=logit, label=label)
    avg_cost = layers.mean(cost)
    prob = layers.sigmoid(logit)
    return avg_cost, prob
