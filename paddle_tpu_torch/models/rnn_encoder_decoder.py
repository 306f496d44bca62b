"""RNN encoder-decoder — the port of
``paddle_tpu/models/rnn_encoder_decoder.py`` (book ch.08 variant): a
bidirectional LSTM encoder (two ``dynamic_lstm``, one reversed) and an
LSTM-step decoder built from fc / sigmoid / tanh inside a DynamicRNN.
The programs are the JAX package's byte for byte."""

from __future__ import annotations

from ..fluid import layers

__all__ = ["bi_lstm_encoder", "lstm_step", "lstm_decoder_without_attention",
           "seq_to_seq_net"]


def bi_lstm_encoder(input_seq, hidden_size, use_peepholes=False):
    """Forward + backward LSTM; returns (forward_last, backward_first)."""
    fwd_proj = layers.fc(input=input_seq, size=hidden_size * 4,
                         bias_attr=True)
    forward, _ = layers.dynamic_lstm(input=fwd_proj, size=hidden_size * 4,
                                     use_peepholes=use_peepholes)
    bwd_proj = layers.fc(input=input_seq, size=hidden_size * 4,
                         bias_attr=True)
    backward, _ = layers.dynamic_lstm(input=bwd_proj, size=hidden_size * 4,
                                      is_reverse=True,
                                      use_peepholes=use_peepholes)
    return (layers.sequence_last_step(input=forward),
            layers.sequence_first_step(input=backward))


def lstm_step(x_t, hidden_t_prev, cell_t_prev, size):
    """LSTM cell from primitives (the chapter's hand-rolled lstm_step)."""
    def linear(inputs):
        return layers.fc(input=inputs, size=size, bias_attr=True)

    forget_gate = layers.sigmoid(x=linear([hidden_t_prev, x_t]))
    input_gate = layers.sigmoid(x=linear([hidden_t_prev, x_t]))
    output_gate = layers.sigmoid(x=linear([hidden_t_prev, x_t]))
    cell_tilde = layers.tanh(x=linear([hidden_t_prev, x_t]))

    cell_t = layers.sums(input=[
        layers.elementwise_mul(x=forget_gate, y=cell_t_prev),
        layers.elementwise_mul(x=input_gate, y=cell_tilde)])
    hidden_t = layers.elementwise_mul(x=output_gate,
                                      y=layers.tanh(x=cell_t))
    return hidden_t, cell_t


def lstm_decoder_without_attention(target_embedding, decoder_boot, context,
                                   decoder_size, target_dict_dim):
    """DynamicRNN decoder seeded by the encoder's final states."""
    rnn = layers.DynamicRNN()
    cell_init = layers.fill_constant_batch_size_like(
        input=decoder_boot, value=0.0, shape=[-1, decoder_size],
        dtype="float32")
    cell_init.stop_gradient = False

    with rnn.block():
        current_word = rnn.step_input(target_embedding)
        context_in = rnn.static_input(context)
        hidden_mem = rnn.memory(init=decoder_boot, need_reorder=True)
        cell_mem = rnn.memory(init=cell_init)
        decoder_inputs = layers.concat(input=[context_in, current_word],
                                       axis=1)
        h, c = lstm_step(decoder_inputs, hidden_mem, cell_mem, decoder_size)
        rnn.update_memory(hidden_mem, h)
        rnn.update_memory(cell_mem, c)
        out = layers.fc(input=h, size=target_dict_dim, bias_attr=True,
                        act="softmax")
        rnn.output(out)
    return rnn()


def seq_to_seq_net(src_word, trg_word, label, source_dict_dim,
                   target_dict_dim, embedding_dim=16, encoder_size=32,
                   decoder_size=32):
    """The chapter's full net; returns (avg_cost, prediction_seq)."""
    src_embedding = layers.embedding(input=src_word,
                                     size=[source_dict_dim, embedding_dim])
    src_forward_last, src_backward_first = bi_lstm_encoder(
        src_embedding, encoder_size)
    encoded_vector = layers.concat(
        input=[src_forward_last, src_backward_first], axis=1)
    decoder_boot = layers.fc(input=src_backward_first, size=decoder_size,
                             act="tanh")

    trg_embedding = layers.embedding(input=trg_word,
                                     size=[target_dict_dim, embedding_dim])
    prediction = lstm_decoder_without_attention(
        trg_embedding, decoder_boot, encoded_vector, decoder_size,
        target_dict_dim)
    cost = layers.cross_entropy(input=prediction, label=label)
    seq_cost = layers.sequence_pool(input=cost, pool_type="sum")
    avg_cost = layers.mean(seq_cost)
    return avg_cost, prediction
