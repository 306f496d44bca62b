"""Semantic role labeling — the port of
``paddle_tpu/models/label_semantic_roles.py``, book ch.07
(fluid/tests/book/test_label_semantic_roles.py): the CoNLL-05 SRL model.
Eight input features (word + 5 context windows + predicate + mark) are
embedded, mixed through fc layers, run through a `depth`-deep stack of
alternating-direction dynamic LSTMs ("db_lstm"), and scored with a
linear-chain CRF; decoding is Viterbi (crf_decoding).  The functions
are the reference's line for line, so both packages' programs serialize
to the same bytes; each ``dynamic_lstm`` is one launch of the port's
LSTM kernel (``kernels/lstm.py``) a step.
"""

from __future__ import annotations

from ..fluid import ParamAttr, layers

__all__ = ["db_lstm", "srl_model", "SRLDims"]


class SRLDims:
    def __init__(self, word_dict_len=44068, label_dict_len=106,
                 pred_len=3162, mark_dict_len=2, word_dim=32, mark_dim=5,
                 hidden_dim=512, depth=8):
        self.word_dict_len = word_dict_len
        self.label_dict_len = label_dict_len
        self.pred_len = pred_len
        self.mark_dict_len = mark_dict_len
        self.word_dim = word_dim
        self.mark_dim = mark_dim
        self.hidden_dim = hidden_dim
        self.depth = depth


def db_lstm(word, predicate, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, mark,
            dims: SRLDims, is_sparse: bool = True,
            embedding_name: str = "emb"):
    """The chapter's deep bidirectional LSTM feature scorer (db_lstm in
    test_label_semantic_roles.py:48) — returns per-step label scores."""
    predicate_emb = layers.embedding(
        input=predicate, size=[dims.pred_len, dims.word_dim],
        is_sparse=is_sparse, param_attr="vemb")
    mark_emb = layers.embedding(
        input=mark, size=[dims.mark_dict_len, dims.mark_dim],
        is_sparse=is_sparse)

    word_input = [word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2]
    # the six word-window features share one (frozen in the reference's
    # pretrained setup) embedding table
    emb_layers = [
        layers.embedding(input=x,
                         size=[dims.word_dict_len, dims.word_dim],
                         param_attr=ParamAttr(name=embedding_name,
                                              trainable=False))
        for x in word_input
    ]
    emb_layers += [predicate_emb, mark_emb]

    hidden_0 = layers.sums(input=[
        layers.fc(input=emb, size=dims.hidden_dim) for emb in emb_layers])
    lstm_0, _ = layers.dynamic_lstm(
        input=hidden_0, size=dims.hidden_dim,
        candidate_activation="relu", gate_activation="sigmoid",
        cell_activation="sigmoid")

    input_tmp = [hidden_0, lstm_0]
    for i in range(1, dims.depth):
        mix_hidden = layers.sums(input=[
            layers.fc(input=input_tmp[0], size=dims.hidden_dim),
            layers.fc(input=input_tmp[1], size=dims.hidden_dim),
        ])
        lstm, _ = layers.dynamic_lstm(
            input=mix_hidden, size=dims.hidden_dim,
            candidate_activation="relu", gate_activation="sigmoid",
            cell_activation="sigmoid", is_reverse=(i % 2) == 1)
        input_tmp = [mix_hidden, lstm]

    feature_out = layers.sums(input=[
        layers.fc(input=input_tmp[0], size=dims.label_dict_len),
        layers.fc(input=input_tmp[1], size=dims.label_dict_len),
    ])
    return feature_out


def srl_model(dims: SRLDims = None, is_sparse: bool = True,
              mix_hidden_lr: float = 1e-3):
    """Build the training graph; returns (avg_cost, feature_out,
    crf_decode, target, feed_vars)."""
    dims = dims or SRLDims()
    feature_names = ("word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
                     "ctx_p1_data", "ctx_p2_data", "verb_data", "mark_data")
    feats = {n: layers.data(name=n, shape=[1], dtype="int64", lod_level=1)
             for n in feature_names}
    feature_out = db_lstm(
        word=feats["word_data"], predicate=feats["verb_data"],
        ctx_n2=feats["ctx_n2_data"], ctx_n1=feats["ctx_n1_data"],
        ctx_0=feats["ctx_0_data"], ctx_p1=feats["ctx_p1_data"],
        ctx_p2=feats["ctx_p2_data"], mark=feats["mark_data"],
        dims=dims, is_sparse=is_sparse)
    target = layers.data(name="target", shape=[1], dtype="int64",
                         lod_level=1)
    crf_cost = layers.linear_chain_crf(
        input=feature_out, label=target,
        param_attr=ParamAttr(name="crfw", learning_rate=mix_hidden_lr))
    avg_cost = layers.mean(crf_cost)
    crf_decode = layers.crf_decoding(input=feature_out,
                                     param_attr=ParamAttr(name="crfw"))
    feed_vars = [feats[n] for n in feature_names] + [target]
    return avg_cost, feature_out, crf_decode, target, feed_vars
