"""Machine translation — the port of
``paddle_tpu/models/machine_translation.py`` (book ch.08): an LSTM
encoder, a DynamicRNN decoder for training, and a While-loop beam-search
decoder for inference, plus the attention variants (Bahdanau attention,
the shape of the reference's seqToseq demo).  The programs are the JAX
package's byte for byte.

Every parameter is named, so the training and decoding programs share
them.  The decode loop carries tensor arrays through a While (topk ->
beam_search -> array_write each step) on the dense [batch, beam] grid:
ancestry is a parent-pointer array and the decoder state is reordered
with batch_gather.  Attention in the decode loop is dense:
sequence_pad bridges the encoder's sequence output to [B, S, H] and a
mask, and the scores are batched matmuls masked additively.  On the
card the training step is one captured graph; the decode loop's trip
count is data-dependent, so the host drives it (``fluid/executor.py``).
"""

from __future__ import annotations

from ..fluid import ParamAttr, layers

__all__ = ["encoder", "decoder_train", "decoder_decode", "train_model",
           "decode_model", "attention_train_model",
           "attention_decode_model"]


def encoder(src_word, dict_size, word_dim=16, hidden_dim=32,
            emb_name="src_emb", return_sequence=False):
    """Uni-directional LSTM encoder.  Returns the last hidden state
    [B, H], or (hidden sequence, last state) with return_sequence."""
    src_embedding = layers.embedding(
        input=src_word, size=[dict_size, word_dim],
        param_attr=ParamAttr(name=emb_name))
    fc1 = layers.fc(input=src_embedding, size=hidden_dim * 4, act="tanh",
                    param_attr=ParamAttr(name="enc_fc.w"),
                    bias_attr=ParamAttr(name="enc_fc.b"))
    lstm_hidden, _ = layers.dynamic_lstm(
        input=fc1, size=hidden_dim * 4,
        param_attr=ParamAttr(name="enc_lstm.w"),
        bias_attr=ParamAttr(name="enc_lstm.b"))
    last = layers.sequence_last_step(input=lstm_hidden)
    if return_sequence:
        return lstm_hidden, last
    return last


def _decoder_step(word_emb, context, state, dict_size, decoder_size,
                  axis):
    """Shared train/decode step tail: merged -> state' -> vocab softmax.
    ``axis`` is the feature axis of the concat ([B,*] train, [B,W,*]
    decode)."""
    merged = layers.concat([word_emb, context, state], axis=axis)
    new_state = layers.fc(input=merged, size=decoder_size, act="tanh",
                          num_flatten_dims=axis,
                          param_attr=ParamAttr(name="dec_fc.w"),
                          bias_attr=ParamAttr(name="dec_fc.b"))
    score = layers.fc(input=new_state, size=dict_size, act="softmax",
                      num_flatten_dims=axis,
                      param_attr=ParamAttr(name="dec_out.w"),
                      bias_attr=ParamAttr(name="dec_out.b"))
    return new_state, score


def decoder_train(context, trg_word, dict_size, word_dim=16, decoder_size=32,
                  emb_name="trg_emb"):
    """Teacher-forced DynamicRNN decoder; returns per-step vocab softmax."""
    trg_embedding = layers.embedding(
        input=trg_word, size=[dict_size, word_dim],
        param_attr=ParamAttr(name=emb_name))
    rnn = layers.DynamicRNN()
    with rnn.block():
        current_word = rnn.step_input(trg_embedding)
        pre_state = rnn.memory(init=context)
        current_state, current_score = _decoder_step(
            current_word, context, pre_state, dict_size, decoder_size,
            axis=1)
        rnn.update_memory(pre_state, current_state)
        rnn.output(current_score)
    return rnn()


def train_model(src_word, trg_word, trg_next_word, dict_size, word_dim=16,
                hidden_dim=32):
    """Full training graph: encoder + decoder + length-masked CE loss."""
    context = encoder(src_word, dict_size, word_dim, hidden_dim)
    rnn_out = decoder_train(context, trg_word, dict_size, word_dim,
                            decoder_size=hidden_dim)
    cost = layers.cross_entropy(input=rnn_out, label=trg_next_word)
    # per-sequence sum (masked by lengths), then batch mean — padding
    # contributes nothing, the analog of LoD's pad-free loss
    seq_cost = layers.sequence_pool(input=cost, pool_type="sum")
    avg_cost = layers.mean(seq_cost)
    return avg_cost, rnn_out


def _beam_decode_loop(step_fn, context, dict_size, word_dim, decoder_size,
                      beam_size, topk_size, max_length, start_id, end_id,
                      emb_name):
    """The While-loop beam-search skeleton.  ``step_fn(pre_ids_emb,
    pre_state) -> (new_state_pre_gather, score)`` supplies the model
    body ([B, W, *] dense grid)."""
    W = beam_size
    counter = layers.zeros(shape=[1], dtype="int64")
    counter.stop_gradient = True
    array_len = layers.fill_constant(shape=[1], dtype="int64",
                                     value=max_length)
    array_len.stop_gradient = True
    cap = max_length + 1

    # [B, W, H] decoder state, each beam starting from the encoder context
    state0 = layers.expand(
        layers.reshape(context, [-1, 1, decoder_size]), [1, W, 1])
    state_array = layers.array_write(state0, i=counter, capacity=cap)

    # [B, W] beams: all start tokens; only beam 0 live (others at -1e9)
    init_ids = layers.fill_constant_batch_size_like(
        context, shape=[-1, W], dtype="int64", value=float(start_id))
    init_ids.stop_gradient = True
    live0 = layers.fill_constant_batch_size_like(
        context, shape=[-1, 1], dtype="float32", value=0.0)
    dead = layers.fill_constant_batch_size_like(
        context, shape=[-1, W - 1], dtype="float32", value=-1e9)
    init_scores = layers.concat([live0, dead], axis=1)
    init_parents = layers.fill_constant_batch_size_like(
        context, shape=[-1, W], dtype="int32", value=0.0)
    init_parents.stop_gradient = True

    ids_array = layers.array_write(init_ids, i=counter, capacity=cap)
    scores_array = layers.array_write(init_scores, i=counter, capacity=cap)
    parents_array = layers.array_write(init_parents, i=counter, capacity=cap)

    cond = layers.less_than(x=counter, y=array_len)
    while_op = layers.While(cond=cond)
    with while_op.block():
        pre_ids = layers.array_read(array=ids_array, i=counter)
        pre_scores = layers.array_read(array=scores_array, i=counter)
        pre_state = layers.array_read(array=state_array, i=counter)

        pre_ids_emb = layers.embedding(
            input=pre_ids, size=[dict_size, word_dim],
            param_attr=ParamAttr(name=emb_name))

        current_state, current_score = step_fn(pre_ids_emb, pre_state)
        topk_scores, topk_indices = layers.topk(current_score, k=topk_size)
        selected_ids, selected_scores, parent_idx = layers.beam_search(
            pre_ids, pre_scores, topk_indices, topk_scores, W,
            end_id=end_id)
        new_state = layers.batch_gather(current_state, parent_idx)

        layers.increment(x=counter, value=1, in_place=True)
        layers.array_write(new_state, array=state_array, i=counter)
        layers.array_write(selected_ids, array=ids_array, i=counter)
        layers.array_write(selected_scores, array=scores_array, i=counter)
        layers.array_write(parent_idx, array=parents_array, i=counter)

        layers.less_than(x=counter, y=array_len, cond=cond)

    translation_ids, translation_scores = layers.beam_search_decode(
        ids=ids_array, scores=scores_array, parents=parents_array,
        end_id=end_id)
    return translation_ids, translation_scores


def decoder_decode(context, dict_size, word_dim=16, decoder_size=32,
                   beam_size=2, topk_size=50, max_length=8, start_id=0,
                   end_id=1, emb_name="trg_emb"):
    """Beam-search decoding loop (reference decoder_decode) on the dense
    [batch, beam] grid; returns (translation_ids [B, W, T],
    translation_scores [B, W]).  Parameters are shared with
    decoder_train by name."""
    def step(pre_ids_emb, pre_state):
        ctx3 = layers.expand(
            layers.reshape(context, [-1, 1, decoder_size]),
            [1, beam_size, 1])
        return _decoder_step(pre_ids_emb, ctx3, pre_state, dict_size,
                             decoder_size, axis=2)

    return _beam_decode_loop(step, context, dict_size, word_dim,
                             decoder_size, beam_size, topk_size,
                             max_length, start_id, end_id, emb_name)


def decode_model(src_word, dict_size, word_dim=16, hidden_dim=32,
                 beam_size=2, topk_size=50, max_length=8, start_id=0,
                 end_id=1):
    context = encoder(src_word, dict_size, word_dim, hidden_dim)
    return decoder_decode(context, dict_size, word_dim,
                          decoder_size=hidden_dim, beam_size=beam_size,
                          topk_size=topk_size, max_length=max_length,
                          start_id=start_id, end_id=end_id)


# ---------------------------------------------------------------------------
# attention variants (reference demo/seqToseq attention + networks.py
# simple_attention: a_j = v . tanh(W s_{t-1} + U h_j))
# ---------------------------------------------------------------------------

def _attention_context_train(enc_seq, enc_proj, state, att_size):
    """Bahdanau attention inside the DynamicRNN block (LoD sequence ops,
    one query per example — the same lowering as v2 simple_attention)."""
    transformed = layers.fc(input=state, size=att_size, bias_attr=False,
                            param_attr=ParamAttr(name="att_w.w"))
    expanded = layers.sequence_expand(transformed, enc_proj)
    combined = layers.tanh(layers.elementwise_add(expanded, enc_proj))
    e = layers.fc(input=combined, size=1, bias_attr=False,
                  param_attr=ParamAttr(name="att_v.w"))
    weight = layers.sequence_softmax(e)
    scaled = layers.elementwise_mul(enc_seq, weight)
    return layers.sequence_pool(input=scaled, pool_type="sum")


def attention_train_model(src_word, trg_word, trg_next_word, dict_size,
                          word_dim=16, hidden_dim=32):
    """Training graph with per-step attention over the full encoder
    sequence instead of a single context vector."""
    enc_seq, enc_last = encoder(src_word, dict_size, word_dim, hidden_dim,
                                return_sequence=True)
    # U h_j, precomputed once outside the loop (reference convention)
    enc_proj = layers.fc(input=enc_seq, size=hidden_dim, bias_attr=False,
                         param_attr=ParamAttr(name="att_u.w"))
    trg_embedding = layers.embedding(
        input=trg_word, size=[dict_size, word_dim],
        param_attr=ParamAttr(name="trg_emb"))
    rnn = layers.DynamicRNN()
    with rnn.block():
        current_word = rnn.step_input(trg_embedding)
        enc_s = rnn.static_input(enc_seq)
        enc_p = rnn.static_input(enc_proj)
        pre_state = rnn.memory(init=enc_last)
        context = _attention_context_train(enc_s, enc_p, pre_state,
                                           hidden_dim)
        current_state, current_score = _decoder_step(
            current_word, context, pre_state, dict_size, hidden_dim,
            axis=1)
        rnn.update_memory(pre_state, current_state)
        rnn.output(current_score)
    rnn_out = rnn()
    cost = layers.cross_entropy(input=rnn_out, label=trg_next_word)
    seq_cost = layers.sequence_pool(input=cost, pool_type="sum")
    avg_cost = layers.mean(seq_cost)
    return avg_cost, rnn_out


def attention_decode_model(src_word, dict_size, word_dim=16, hidden_dim=32,
                           beam_size=2, topk_size=50, max_length=8,
                           start_id=0, end_id=1):
    """Beam search with dense attention in the loop: the encoder LoD
    output is bridged to [B, S, H] + mask once (sequence_pad); each step
    scores all beams against all source positions with batched matmuls
    and an additive -1e9 pad mask.  Shares every parameter with
    attention_train_model by name."""
    enc_seq, enc_last = encoder(src_word, dict_size, word_dim, hidden_dim,
                                return_sequence=True)
    enc_pad, enc_mask = layers.sequence_pad(enc_seq)       # [B,S,H],[B,S]
    enc_proj = layers.fc(input=enc_pad, size=hidden_dim, bias_attr=False,
                         num_flatten_dims=2,
                         param_attr=ParamAttr(name="att_u.w"))
    # additive mask: 0 on live positions, -1e9 on padding
    neg = layers.scale(layers.elementwise_add(
        enc_mask, layers.fill_constant(shape=[1], dtype="float32",
                                       value=-1.0)), scale=1e9)
    neg3 = layers.unsqueeze(neg, axes=[1])                 # [B,1,S]
    p4 = layers.unsqueeze(enc_proj, axes=[1])              # [B,1,S,A]

    def step(pre_ids_emb, pre_state):
        transformed = layers.fc(input=pre_state, size=hidden_dim,
                                bias_attr=False, num_flatten_dims=2,
                                param_attr=ParamAttr(name="att_w.w"))
        t4 = layers.unsqueeze(transformed, axes=[2])       # [B,W,1,A]
        combined = layers.tanh(layers.elementwise_add(t4, p4))
        e = layers.fc(input=combined, size=1, bias_attr=False,
                      num_flatten_dims=3,
                      param_attr=ParamAttr(name="att_v.w"))
        e = layers.squeeze(e, axes=[3])                    # [B,W,S]
        alpha = layers.softmax(layers.elementwise_add(e, neg3))
        context = layers.matmul(alpha, enc_pad)            # [B,W,H]
        return _decoder_step(pre_ids_emb, context, pre_state, dict_size,
                             hidden_dim, axis=2)

    return _beam_decode_loop(step, enc_last, dict_size, word_dim,
                             hidden_dim, beam_size, topk_size, max_length,
                             start_id, end_id, "trg_emb")
