"""Sequence layers — the port of ``paddle_tpu/fluid/layers/sequence.py``,
cut to ``sequence_conv``, ``sequence_pool`` and its first / last step
forms, ``sequence_expand``, ``sequence_pad``, the linear-chain CRF
(``linear_chain_crf``, ``crf_decoding``), CTC (``warpctc``,
``edit_distance``, ``ctc_align``, ``ctc_greedy_decoder``) and
``lambda_rank_cost``."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["sequence_conv", "sequence_pool", "sequence_first_step",
           "sequence_last_step", "sequence_expand", "sequence_pad",
           "linear_chain_crf", "crf_decoding", "warpctc", "edit_distance",
           "ctc_align", "ctc_greedy_decoder", "lambda_rank_cost"]


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None, main_program=None, startup_program=None):
    """Context-window projection (``ops/sequence_ops.sequence_conv``):
    a [filter_size * D, num_filters] filter over windows centred on each
    step, then the bias and the activation."""
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name,
                         main_program=main_program,
                         startup_program=startup_program)
    dtype = input.dtype
    feat = input.shape[-1]
    w = helper.create_parameter(helper.param_attr,
                                shape=[filter_size * feat, num_filters],
                                dtype=dtype)
    out = helper.create_tmp_variable(dtype, lod_level=1)
    helper.append_op("sequence_conv", {"X": input, "Filter": w},
                     {"Out": out},
                     {"context_length": filter_size,
                      "context_start": -((filter_size - 1) // 2),
                      "context_stride": filter_stride})
    out = helper.append_bias_op(out, dim_start=2,
                                bias_shape=[num_filters])
    return helper.append_activation(out)


def sequence_pool(input, pool_type, name=None):
    helper = LayerHelper("sequence_pool", name=name)
    out = helper.create_tmp_variable(input.dtype)
    max_index = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op("sequence_pool", {"X": input},
                     {"Out": out, "MaxIndex": max_index},
                     {"pooltype": pool_type})
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_expand(x, y, name=None):
    """Each row of ``x`` broadcast across the steps of ``y``'s sequence
    in that row."""
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_tmp_variable(x.dtype, lod_level=1)
    helper.append_op("sequence_expand", {"X": x, "Y": y}, {"Out": out})
    return out


def sequence_pad(x, name=None):
    """A sequence batch as (dense [B, T, ...], mask [B, T]): the bridge
    to dense ops over padded data."""
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_tmp_variable(x.dtype)
    mask = helper.create_tmp_variable(x.dtype, stop_gradient=True)
    helper.append_op("sequence_pad", {"X": x}, {"Out": out, "Mask": mask})
    return out, mask


def linear_chain_crf(input, label, param_attr=None):
    """CRF negative log-likelihood per sequence (reference layers/nn.py
    linear_chain_crf:791); its sum or mean is the training loss.  The
    transition parameter is [num_tags + 2, num_tags]: row 0 start, row 1
    stop, the rest transitions."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    num_tags = input.shape[-1]
    transition = helper.create_parameter(helper.param_attr,
                                         shape=[num_tags + 2, num_tags],
                                         dtype=input.dtype,
                                         suffix="transition")
    nll = helper.create_tmp_variable(input.dtype)
    helper.append_op("linear_chain_crf",
                     {"Emission": input, "Transition": transition,
                      "Label": label},
                     {"LogLikelihood": nll})
    return nll


def crf_decoding(input, param_attr=None, label=None):
    """Viterbi decode (reference layers/nn.py crf_decoding).
    ``param_attr`` names the transition parameter of the
    ``linear_chain_crf`` it decodes: creating it again by that name
    shares it, as in the reference."""
    helper = LayerHelper("crf_decoding", param_attr=param_attr)
    num_tags = input.shape[-1]
    transition = helper.create_parameter(helper.param_attr,
                                         shape=[num_tags + 2, num_tags],
                                         dtype=input.dtype,
                                         suffix="transition")
    path = helper.create_tmp_variable("int32", lod_level=1,
                                      stop_gradient=True)
    inputs = {"Emission": input, "Transition": transition}
    if label is not None:
        inputs["Label"] = label
    helper.append_op("crf_decoding", inputs, {"ViterbiPath": path})
    return path


def warpctc(input, label, blank=0, norm_by_times=False, name=None):
    """CTC loss (reference layers/nn.py warpctc, ``ops/ctc_ops.warpctc``)
    of a sequence of raw logits [b, T, classes] against blank-free label
    sequences -> [b, 1]."""
    helper = LayerHelper("warpctc", name=name)
    loss = helper.create_tmp_variable(input.dtype)
    helper.append_op("warpctc", {"Logits": input, "Label": label},
                     {"Loss": loss},
                     {"blank": int(blank),
                      "norm_by_times": bool(norm_by_times)})
    return loss


def edit_distance(input, label, normalized=False, name=None):
    """Levenshtein distance of each hypothesis from its reference
    (edit_distance_op.cc) -> [b, 1] float32."""
    helper = LayerHelper("edit_distance", name=name)
    out = helper.create_tmp_variable("float32", stop_gradient=True)
    helper.append_op("edit_distance", {"Hyps": input, "Refs": label},
                     {"Out": out}, {"normalized": bool(normalized)})
    return out


def ctc_align(input, blank=0, name=None):
    """A greedy CTC path with repeats merged and blanks dropped."""
    helper = LayerHelper("ctc_align", name=name)
    out = helper.create_tmp_variable("int32", lod_level=1,
                                     stop_gradient=True)
    helper.append_op("ctc_align", {"Input": input}, {"Output": out},
                     {"blank": int(blank)})
    return out


def ctc_greedy_decoder(input, blank=0, name=None):
    """The greedy CTC decode: the argmax class of each step, then
    ``ctc_align``."""
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    ids = helper.create_tmp_variable("int32", lod_level=1,
                                     stop_gradient=True)
    helper.append_op("argmax", {"X": input}, {"Out": ids}, {"axis": -1})
    return ctc_align(ids, blank=blank, name=name)


def lambda_rank_cost(score, label, ndcg_num=5, name=None):
    """LambdaRank cost per query sequence -> [B, 1]."""
    helper = LayerHelper("lambda_rank_cost", name=name)
    out = helper.create_tmp_variable("float32")
    helper.append_op("lambda_rank_cost", {"Score": score, "Label": label},
                     {"Out": out}, {"ndcg_num": int(ndcg_num)})
    return out
