"""Neural-net layers — the port of ``paddle_tpu/fluid/layers/nn.py``, cut
to what ``models/transformer.transformer()`` (fused or unfused
attention), the paged and dense serving steps and beam search, the LSTM
text classifiers, the book's chapters (``models/fit_a_line``,
``models/recognize_digits``, ``models/image_classification``,
``models/word2vec``, ``models/recommender``), the reference's image
benchmarks (``models/benchmark_nets``), CTR wide&deep
(``models/ctr``) and the seq2seq models (``models/machine_translation``,
``models/rnn_encoder_decoder``: ``squeeze``, ``unsqueeze``, ``expand``)
build, and the general tensor layers (``one_hot``, ``split``,
``gather``, ``multiplex``, the reductions), the speech and detection
layers (``conv2d_transpose``, ``conv3d``, ``pool3d``, ``l2_normalize``,
``nce``, ``im2sequence``, ``prior_box``, ``bipartite_match``,
``multiclass_nms``, ``ssd_loss``, ``detection_output``), and the
layers of the loss and miscellaneous ops (``smooth_l1``, ``roi_pool``,
``spp``, ``unpool``, ``max_pool2d_with_index``, ``bilinear_interp``,
the ranking losses, ``auc``, ``hsigmoid``, ``selective_fc``, ``pad``,
``crop``, ``lod_reset``, ``row_conv`` and the rest; the reference's
all but ``dynamic_lstmp``, ``switch_moe`` and the quantized layers).
Each layer appends ops to the current block through
``LayerHelper`` exactly as the reference does, so both packages build
byte-identical programs."""

from __future__ import annotations

import math

from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["fc", "embedding", "dropout", "cross_entropy", "accuracy",
           "softmax_with_cross_entropy", "square_error_cost",
           "sigmoid_cross_entropy_with_logits", "cos_sim", "conv2d",
           "pool2d", "batch_norm", "layer_norm", "lrn", "reduce_sum",
           "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
           "one_hot", "split", "gather", "multiplex",
           "reshape", "transpose", "squeeze", "unsqueeze", "expand",
           "matmul", "topk", "beam_search", "beam_search_decode",
           "batch_gather", "fused_attention", "fused_vocab_cross_entropy",
           "decode_attention", "ragged_decode_attention",
           "conv2d_transpose", "conv3d", "pool3d", "l2_normalize", "nce",
           "im2sequence", "prior_box", "bipartite_match", "multiclass_nms",
           "ssd_loss", "detection_output", "smooth_l1", "auc", "hsigmoid",
           "sampling_id", "bilinear_interp", "prelu", "maxout",
           "selective_fc", "scale_sub_region", "rotate",
           "cross_entropy_over_beam", "cross_entropy_with_selfnorm", "pad",
           "crop", "lod_reset", "label_smooth", "rank_loss",
           "margin_rank_loss", "log_loss", "conv_shift", "row_conv",
           "roi_pool", "spp", "unpool", "max_pool2d_with_index"]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None, main_program=None, startup_program=None,
       use_mkldnn=False):
    """Fully connected: one ``mul`` per input (each with its own weight),
    a ``sum`` of the partial products, then the bias and the
    activation.  A sequence input [b, t, f...] keeps its time axis: its
    weight covers the feature dims and the bias broadcasts on the last
    axis.  ``use_mkldnn`` (a CPU-library switch, which the reference
    ignores too) is accepted and ignored."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name,
                         main_program=main_program,
                         startup_program=startup_program)
    dtype = helper.input_dtype()
    mul_results = []
    for input_var in helper.multiple_input():
        seq = 1 if input_var.lod_level > 0 else 0
        # a padded sequence's desc shape [b, f...] omits its time axis
        flat = input_var.shape[1:] if seq else \
            input_var.shape[num_flatten_dims:]
        in_features = math.prod(flat)
        w = helper.create_parameter(helper.param_attr,
                                    shape=[in_features, size], dtype=dtype)
        tmp = helper.create_tmp_variable(dtype,
                                         lod_level=input_var.lod_level)
        helper.append_op("mul", {"X": input_var, "Y": w}, {"Out": tmp},
                         {"x_num_col_dims": num_flatten_dims + seq,
                          "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_tmp_variable(dtype)
        helper.append_op("sum", {"X": mul_results}, {"Out": pre_bias})
    # shape inference has given pre_bias the sequence level of its value
    seq = 1 if pre_bias.lod_level else 0
    pre_act = helper.append_bias_op(pre_bias,
                                    dim_start=num_flatten_dims + seq,
                                    bias_shape=[size])
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32", name=None,
              main_program=None, startup_program=None):
    """Embedding lookup.  ``is_sparse=True`` gives the table a
    SelectedRows gradient (the looked-up rows and their output
    gradients, no dense [vocab, dim] tensor), as the reference's
    lookup_table_op does: sgd and adagrad apply it as a row scatter,
    momentum and adam as lazy row updates, the other optimizers
    densify it."""
    helper = LayerHelper("embedding", param_attr=param_attr, name=name,
                         main_program=main_program,
                         startup_program=startup_program)
    w = helper.create_parameter(helper.param_attr, shape=list(size),
                                dtype=dtype)
    out = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    attrs = {"is_sparse": bool(is_sparse)}
    if padding_idx is not None:
        attrs["padding_idx"] = int(padding_idx)
    helper.append_op("lookup_table", {"W": w, "Ids": input}, {"Out": out},
                     attrs)
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
    helper.append_op("dropout", {"X": x}, {"Out": out},
                     {"dropout_prob": float(dropout_prob),
                      "is_test": is_test})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = helper.create_tmp_variable(logits.dtype)
    loss = helper.create_tmp_variable(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     {"Logits": logits, "Label": label},
                     {"Softmax": softmax, "Loss": loss},
                     {"soft_label": soft_label})
    return loss


def cross_entropy(input, label, soft_label=False, name=None):
    helper = LayerHelper("cross_entropy", name=name)
    out = helper.create_tmp_variable(input.dtype,
                                     lod_level=input.lod_level)
    helper.append_op("cross_entropy", {"X": input, "Label": label},
                     {"Out": out}, {"soft_label": soft_label})
    return out


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    """Elementwise binary cross-entropy on logits (reference
    sigmoid_cross_entropy_with_logits_op.cc, the CTR nets' loss)."""
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     {"X": x, "Label": label}, {"Out": out})
    return out


def square_error_cost(input, label, name=None):
    helper = LayerHelper("square_error_cost", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("square_error_cost", {"X": input, "Y": label},
                     {"Out": out})
    return out


def cos_sim(X, Y, name=None):
    """Row-wise cosine similarity (reference cos_sim_op.cc); the norms
    are gradient-free outputs."""
    helper = LayerHelper("cos_sim", name=name)
    out = helper.create_tmp_variable(X.dtype)
    xnorm = helper.create_tmp_variable(X.dtype, stop_gradient=True)
    ynorm = helper.create_tmp_variable(X.dtype, stop_gradient=True)
    helper.append_op("cos_sim", {"X": X, "Y": Y},
                     {"Out": out, "XNorm": xnorm, "YNorm": ynorm})
    return out


def _pair(x):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x, x]


def _append_channel_bias(helper, pre_bias):
    """A [C] bias added along axis 1 (NCHW channels), if the layer has
    one."""
    bias_attr = helper.bias_attr
    if bias_attr is None:
        return pre_bias
    channels = pre_bias.shape[1]
    b = helper.create_parameter(bias_attr, shape=[channels],
                                dtype=pre_bias.dtype, is_bias=True)
    out = helper.create_tmp_variable(pre_bias.dtype)
    helper.append_op("elementwise_add", {"X": pre_bias, "Y": b},
                     {"Out": out}, {"axis": 1})
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, groups=1,
           dilation=1, param_attr=None, bias_attr=None, act=None,
           use_cudnn=True, name=None, main_program=None,
           startup_program=None):
    """2-D convolution, NCHW, filter [num_filters, C / groups, kh, kw]
    drawn from Normal(0, sqrt(2 / (kh * kw * C))), then a channel bias
    and the activation."""
    helper = LayerHelper("conv2d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name,
                         main_program=main_program,
                         startup_program=startup_program)
    dtype = input.dtype
    fsize = _pair(filter_size)
    num_channels = input.shape[1]
    std = (2.0 / (fsize[0] * fsize[1] * num_channels)) ** 0.5
    w = helper.create_parameter(
        helper.param_attr,
        shape=[num_filters, num_channels // groups] + list(fsize),
        dtype=dtype, default_initializer=NormalInitializer(0.0, std))
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op("conv2d", {"Input": input, "Filter": w},
                     {"Output": pre_bias},
                     {"strides": _pair(stride), "paddings": _pair(padding),
                      "dilations": _pair(dilation), "groups": groups})
    pre_act = _append_channel_bias(helper, pre_bias)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, main_program=None,
           startup_program=None):
    helper = LayerHelper("pool2d", name=name, main_program=main_program,
                         startup_program=startup_program)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("pool2d", {"X": input}, {"Out": out},
                     {"pooling_type": pool_type,
                      "ksize": _pair(pool_size),
                      "strides": _pair(pool_stride),
                      "paddings": _pair(pool_padding),
                      "global_pooling": global_pooling,
                      "ceil_mode": ceil_mode})
    return out


def accuracy(input, label, k=1, correct=None, total=None, **kw):
    """Top-k accuracy: a ``top_k`` op, then ``accuracy``."""
    helper = LayerHelper("accuracy")
    topk_out = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    topk_indices = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op("top_k", {"X": input},
                     {"Out": topk_out, "Indices": topk_indices}, {"k": k})
    acc_out = helper.create_tmp_variable("float32", stop_gradient=True)
    correct = correct or helper.create_tmp_variable("int32",
                                                    stop_gradient=True)
    total = total or helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op("accuracy",
                     {"Out": topk_out, "Indices": topk_indices,
                      "Label": label},
                     {"Accuracy": acc_out, "Correct": correct,
                      "Total": total})
    return acc_out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None,
               main_program=None, startup_program=None):
    """Batch normalization (``ops/nn_ops.batch_norm``): the parameters
    ``.scale`` (init 1) and ``.offset`` (init 0), and the moving mean and
    variance as persistable global vars (init 0 and 1, named
    ``moving_mean_name`` / ``moving_variance_name`` if given) that the op
    updates in the program, then the activation."""
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name,
                         main_program=main_program,
                         startup_program=startup_program)
    dtype = input.dtype
    channels = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    pshape = [channels]
    scale = helper.create_parameter(
        helper.param_attr, shape=pshape, dtype=dtype,
        default_initializer=ConstantInitializer(1.0), suffix="scale")
    bias = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                   shape=pshape, dtype=dtype, is_bias=True,
                                   suffix="offset")
    mean = helper.create_global_variable(
        shape=pshape, dtype=dtype, persistable=True, name=moving_mean_name)
    helper.set_variable_initializer(mean, ConstantInitializer(0.0))
    variance = helper.create_global_variable(
        shape=pshape, dtype=dtype, persistable=True,
        name=moving_variance_name)
    helper.set_variable_initializer(variance, ConstantInitializer(1.0))
    saved_mean = helper.create_tmp_variable(dtype, stop_gradient=True)
    saved_var = helper.create_tmp_variable(dtype, stop_gradient=True)
    out = helper.create_tmp_variable(dtype)
    helper.append_op(
        "batch_norm",
        {"X": input, "Scale": scale, "Bias": bias, "Mean": mean,
         "Variance": variance},
        {"Y": out, "MeanOut": mean, "VarianceOut": variance,
         "SavedMean": saved_mean, "SavedVariance": saved_var},
        {"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
         "data_layout": data_layout})
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    norm_shape = [math.prod(input.shape[begin_norm_axis:])]
    inputs = {"X": input}
    if scale:
        inputs["Scale"] = helper.create_parameter(
            helper.param_attr, shape=norm_shape, dtype=dtype,
            default_initializer=ConstantInitializer(1.0), suffix="scale")
    if shift:
        inputs["Bias"] = helper.create_parameter(
            helper.bias_attr or ParamAttr(), shape=norm_shape,
            dtype=dtype, is_bias=True)
    out = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    mean = helper.create_tmp_variable(dtype, stop_gradient=True)
    var = helper.create_tmp_variable(dtype, stop_gradient=True)
    helper.append_op("layer_norm", inputs,
                     {"Y": out, "Mean": mean, "Variance": var},
                     {"epsilon": epsilon, "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def lrn(input, n=5, k=2.0, alpha=1e-4, beta=0.75, name=None):
    """Local response normalization across channels (``ops/misc_ops.lrn``);
    its ``MidOut`` is a second, gradient-free output."""
    helper = LayerHelper("lrn", name=name)
    out = helper.create_tmp_variable(input.dtype)
    mid = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    helper.append_op("lrn", {"X": input}, {"Out": out, "MidOut": mid},
                     {"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def _make_reduce(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(input.dtype)
        attrs = {"keep_dim": keep_dim, "reduce_all": dim is None}
        if dim is not None:
            attrs["dim"] = dim if isinstance(dim, (list, tuple)) else [dim]
        helper.append_op(op_type, {"X": input}, {"Out": out}, attrs)
        return out

    layer.__name__ = op_type
    return layer


reduce_sum = _make_reduce("reduce_sum")
reduce_mean = _make_reduce("reduce_mean")
reduce_max = _make_reduce("reduce_max")
reduce_min = _make_reduce("reduce_min")
reduce_prod = _make_reduce("reduce_prod")


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = helper.create_tmp_variable("float32")
    helper.append_op("one_hot", {"X": input}, {"Out": out}, {"depth": depth})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    """``input`` cut along ``dim`` into ``num_or_sections`` equal parts,
    or parts of the listed sizes."""
    helper = LayerHelper("split", name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        attrs = {"num": num, "axis": dim}
    else:
        num = len(num_or_sections)
        attrs = {"sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_tmp_variable(input.dtype) for _ in range(num)]
    helper.append_op("split", {"X": input}, {"Out": outs}, attrs)
    return outs


def gather(input, index, name=None):
    """reference gather_op.cc — rows of input by index."""
    helper = LayerHelper("gather", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("gather", {"X": input, "Index": index}, {"Out": out})
    return out


def multiplex(inputs, index, name=None):
    """reference multiplex_op.cc — per-row select among candidate tensors."""
    helper = LayerHelper("multiplex", name=name)
    out = helper.create_tmp_variable(inputs[0].dtype)
    helper.append_op("multiplex", {"Ids": index, "X": inputs}, {"Out": out})
    return out


def reshape(x, shape, act=None, name=None):
    helper = LayerHelper("reshape", name=name, act=act)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("reshape", {"X": x}, {"Out": out},
                     {"shape": list(shape)})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("transpose", {"X": x}, {"Out": out},
                     {"axis": list(perm)})
    return out


def squeeze(input, axes, name=None):
    """Drop the size-1 dims at ``axes``."""
    helper = LayerHelper("squeeze", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("squeeze", {"X": input}, {"Out": out},
                     {"axes": list(axes)})
    return out


def unsqueeze(input, axes, name=None):
    """Insert size-1 dims at ``axes``."""
    helper = LayerHelper("unsqueeze", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("unsqueeze", {"X": input}, {"Out": out},
                     {"axes": list(axes)})
    return out


def expand(x, expand_times, name=None):
    """Tile each dim ``expand_times[i]`` times."""
    helper = LayerHelper("expand", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("expand", {"X": x}, {"Out": out},
                     {"expand_times": list(expand_times)})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("matmul", {"X": x, "Y": y}, {"Out": out},
                     {"transpose_X": transpose_x, "transpose_Y": transpose_y,
                      "alpha": float(alpha)})
    return out


def topk(input, k=1):
    helper = LayerHelper("top_k")
    vals = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    idx = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op("top_k", {"X": input}, {"Out": vals, "Indices": idx},
                     {"k": k})
    return vals, idx


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=False, name=None):
    """One beam-search step on a dense [batch, beam] grid
    (``ops/beam_ops.beam_search``).  Returns (selected_ids,
    selected_scores, parent_idx); parent_idx carries the ancestry the
    reference's LoD encodes."""
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_tmp_variable(pre_ids.dtype)
    sel_scores = helper.create_tmp_variable("float32")
    parent = helper.create_tmp_variable("int32")
    sel_ids.stop_gradient = parent.stop_gradient = True
    helper.append_op(
        "beam_search",
        {"pre_ids": pre_ids, "pre_scores": pre_scores, "ids": ids,
         "scores": scores},
        {"selected_ids": sel_ids, "selected_scores": sel_scores,
         "parent_idx": parent},
        {"beam_size": beam_size, "end_id": end_id, "level": level,
         "is_accumulated": is_accumulated})
    return sel_ids, sel_scores, parent


def beam_search_decode(ids, scores, parents, end_id, name=None):
    """Backtrace the beam arrays into ranked hypotheses
    (``ops/beam_ops.beam_search_decode``): SentenceIds a level-2
    NestedSeqArray, SentenceScores [B, W]."""
    helper = LayerHelper("beam_search_decode", name=name)
    sent_ids = helper.create_tmp_variable(ids.dtype)
    sent_scores = helper.create_tmp_variable("float32")
    sent_ids.stop_gradient = sent_scores.stop_gradient = True
    helper.append_op(
        "beam_search_decode",
        {"Ids": ids, "Scores": scores, "Parents": parents},
        {"SentenceIds": sent_ids, "SentenceScores": sent_scores},
        {"end_id": end_id})
    return sent_ids, sent_scores


def batch_gather(x, index, name=None):
    """out[b, j] = x[b, index[b, j]]: the dense beam's cache reorder."""
    helper = LayerHelper("batch_gather", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("batch_gather", {"X": x, "Index": index}, {"Out": out})
    return out


def fused_attention(q, k, v, bias=None, causal=False, sm_scale=None,
                    seq_parallel=False, sp_impl="ring", impl=None,
                    dropout_rate=0.0, is_test=False, layout="bhld",
                    name=None):
    """Fused scaled-dot-product attention (``kernels.flash_attention``):
    ``layout='bhld'`` takes [b, h, l, d], ``'blhd'`` [b, l, h, d].
    ``dropout_rate`` drops attention probabilities inside the kernel
    (hash mask, train mode only).  The attrs are the reference's, so the
    program serializes alike; sequence parallelism (``seq_parallel``)
    and the ``impl`` switch are not ported."""
    if seq_parallel:
        raise NotImplementedError("fused_attention(seq_parallel=...): ring "
                                  "and Ulysses attention need a mesh, not "
                                  "ported to paddle_tpu_torch")
    if impl is not None:
        raise NotImplementedError(f"fused_attention(impl={impl!r}) is not "
                                  f"ported to paddle_tpu_torch")
    if sp_impl not in ("ring", "ulysses"):
        raise ValueError(
            f"fused_attention: sp_impl must be 'ring' or 'ulysses', "
            f"got {sp_impl!r}")
    helper = LayerHelper("fused_attention", name=name)
    out = helper.create_tmp_variable(q.dtype)
    inputs = {"Q": q, "K": k, "V": v}
    if bias is not None:
        inputs["Bias"] = bias
    attrs = {"causal": bool(causal), "seq_parallel": False,
             "sp_impl": str(sp_impl),
             "dropout_rate": float(dropout_rate), "is_test": bool(is_test),
             "layout": str(layout)}
    if sm_scale is not None:
        attrs["sm_scale"] = float(sm_scale)
    helper.append_op("fused_attention", inputs, {"Out": out}, attrs)
    return out


def fused_vocab_cross_entropy(input, label, vocab_size, chunk=8192,
                              param_attr=None, name=None):
    """Streaming projection + softmax + cross-entropy against a [D, V]
    vocab matrix: the math of ``fc(bias_attr=False)`` +
    ``softmax_with_cross_entropy`` without the [N, V] logits held whole.
    Share the projection with an inference head by passing the same
    ``param_attr`` name to an ``fc``."""
    helper = LayerHelper("fused_vocab_cross_entropy", param_attr=param_attr,
                         name=name)
    d = input.shape[-1]
    w = helper.create_parameter(helper.param_attr, shape=[d, vocab_size],
                                dtype=input.dtype)
    loss = helper.create_tmp_variable("float32")
    helper.append_op("fused_vocab_cross_entropy",
                     {"X": input, "W": w, "Label": label}, {"Loss": loss},
                     {"chunk": int(chunk)})
    return loss


def decode_attention(q, k_cache, v_cache, lengths, sm_scale=None,
                     name=None):
    """A decode step's attention over a preallocated KV cache with a
    per-lane length mask (``ops/cache_ops.decode_attention``), layout
    'blhd': q [B, Lq, H, D], caches [B, Lmax, H, D], lengths [B] int32
    live cache rows."""
    helper = LayerHelper("decode_attention", name=name)
    out = helper.create_tmp_variable(q.dtype, stop_gradient=True)
    attrs = {}
    if sm_scale is not None:
        attrs["sm_scale"] = float(sm_scale)
    helper.append_op("decode_attention",
                     {"Q": q, "KCache": k_cache, "VCache": v_cache,
                      "Lengths": lengths},
                     {"Out": out}, attrs)
    return out


def ragged_decode_attention(q, pool, page_table, lengths, q_base=None,
                            layer=0, n_layer=1, causal=True, sm_scale=None,
                            impl=None, scales=None, name=None):
    """Attention of per-lane query blocks against the paged KV pool,
    walking each lane's page list (``ops/cache_ops.ragged_decode_attention``;
    the CUDA kernel lives in ``kernels/flash_attention``).  q [B, C, H, D]
    (C=1 steady-state decode, C=chunk during chunked prefill), pool
    [H, R, page_size, D], page_table [B, P] int32 logical pages, lengths
    [B] int32 live positions, q_base [B] int32 global query start
    (required when causal).  ``scales`` ([1, R, page_size] fp32) rides
    along for int8 pools."""
    helper = LayerHelper("ragged_decode_attention", name=name)
    out = helper.create_tmp_variable(q.dtype, stop_gradient=True)
    attrs = {"layer": int(layer), "n_layer": int(n_layer),
             "causal": bool(causal)}
    if sm_scale is not None:
        attrs["sm_scale"] = float(sm_scale)
    if impl is not None:
        attrs["impl"] = impl
    inputs = {"Q": q, "Pool": pool, "PageTable": page_table,
              "Lengths": lengths}
    if q_base is not None:
        inputs["QBase"] = q_base
    if scales is not None:
        inputs["Scales"] = scales
    helper.append_op("ragged_decode_attention", inputs, {"Out": out}, attrs)
    return out


def _triple(x):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x, x, x]


def _single_out_layer(op_type, inputs, attrs=None, dtype=None, lod=0,
                      extra_outputs=None, stop_gradient=False, name=None):
    """One op whose output slot Out is a var of ``dtype`` (default: the
    first input's) at ``lod``; each slot of ``extra_outputs`` gets a
    gradient-free var of the first input's dtype."""
    helper = LayerHelper(op_type, name=name)
    first = next(iter(inputs.values()))
    first = first[0] if isinstance(first, list) else first
    out = helper.create_tmp_variable(dtype or first.dtype, lod_level=lod,
                                     stop_gradient=stop_gradient)
    outputs = {"Out": out}
    for slot in (extra_outputs or []):
        outputs[slot] = helper.create_tmp_variable(first.dtype,
                                                   stop_gradient=True)
    helper.append_op(op_type, inputs, outputs, attrs or {})
    return out


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, param_attr=None,
                     bias_attr=None, act=None, name=None):
    """Transposed 2-D convolution, NCHW, filter [C, num_filters, kh, kw]
    (conv_transpose_op.cc), then a channel bias and the activation."""
    helper = LayerHelper("conv2d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    w = helper.create_parameter(
        helper.param_attr,
        shape=[input.shape[1], num_filters] + _pair(filter_size),
        dtype=dtype)
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op("conv2d_transpose", {"Input": input, "Filter": w},
                     {"Output": pre_bias},
                     {"strides": _pair(stride), "paddings": _pair(padding),
                      "dilations": _pair(dilation)})
    pre_act = _append_channel_bias(helper, pre_bias)
    return helper.append_activation(pre_act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, groups=1,
           dilation=1, param_attr=None, bias_attr=None, act=None,
           name=None):
    """3-D convolution, NCDHW, filter [num_filters, C / groups, kd, kh,
    kw] drawn from Normal(0, sqrt(2 / (kd * kh * kw * C))), then a
    channel bias and the activation."""
    helper = LayerHelper("conv3d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    fsize = _triple(filter_size)
    num_channels = input.shape[1]
    std = (2.0 / (math.prod(fsize) * num_channels)) ** 0.5
    w = helper.create_parameter(
        helper.param_attr,
        shape=[num_filters, num_channels // groups] + fsize, dtype=dtype,
        default_initializer=NormalInitializer(0.0, float(std)))
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op("conv3d", {"Input": input, "Filter": w},
                     {"Output": pre_bias},
                     {"strides": _triple(stride),
                      "paddings": _triple(padding),
                      "dilations": _triple(dilation), "groups": groups})
    pre_act = _append_channel_bias(helper, pre_bias)
    return helper.append_activation(pre_act)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           name=None):
    """3-D pooling, NCDHW (``ops/nn_ops.pool3d``)."""
    helper = LayerHelper("pool3d", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("pool3d", {"X": input}, {"Out": out},
                     {"pooling_type": pool_type,
                      "ksize": _triple(pool_size),
                      "strides": _triple(pool_stride),
                      "paddings": _triple(pool_padding),
                      "global_pooling": global_pooling,
                      "ceil_mode": ceil_mode})
    return out


def l2_normalize(x, axis=-1, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("l2_normalize", {"X": x}, {"Out": out},
                     {"axis": axis, "epsilon": epsilon})
    return out


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None):
    """Noise-contrastive estimation (nce_op.cc): a [classes, dim] weight
    and a [classes] bias; the op draws its negatives from its seed.
    ``sample_weight`` is taken and not read, as in the reference."""
    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    w = helper.create_parameter(helper.param_attr,
                                shape=[num_total_classes, input.shape[1]],
                                dtype=input.dtype)
    b = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                shape=[num_total_classes], dtype=input.dtype,
                                is_bias=True)
    cost = helper.create_tmp_variable(input.dtype)
    helper.append_op("nce", {"Input": input, "Label": label,
                             "Weight": w, "Bias": b}, {"Cost": cost},
                     {"num_total_classes": num_total_classes,
                      "num_neg_samples": num_neg_samples or 10})
    return cost


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    helper = LayerHelper("im2sequence", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("im2sequence", {"X": input}, {"Out": out},
                     {"kernels": _pair(filter_size),
                      "strides": _pair(stride), "paddings": _pair(padding)})
    return out


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=None,
              variances=None, flip=False, clip=False, step_h=0.0,
              step_w=0.0, offset=0.5, name=None):
    """SSD's priors of a feature map (prior_box_op.cc) -> (boxes,
    variances), each [fh, fw, n_priors, 4]."""
    helper = LayerHelper("prior_box", name=name)
    boxes = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    var = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    helper.append_op("prior_box", {"Input": input, "Image": image},
                     {"Boxes": boxes, "Variances": var},
                     {"min_sizes": list(min_sizes),
                      "max_sizes": list(max_sizes or []),
                      "aspect_ratios": list(aspect_ratios or [1.0]),
                      "variances": list(variances
                                        or [0.1, 0.1, 0.2, 0.2]),
                      "flip": flip, "clip": clip, "step_h": step_h,
                      "step_w": step_w, "offset": offset})
    return boxes, var


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    """bipartite_match_op.cc -> (matched row of each column, its
    distance)."""
    helper = LayerHelper("bipartite_match", name=name)
    idx = helper.create_tmp_variable("int32", stop_gradient=True)
    dist = helper.create_tmp_variable("float32", stop_gradient=True)
    helper.append_op("bipartite_match", {"DistMat": dist_matrix},
                     {"ColToRowMatchIndices": idx,
                      "ColToRowMatchDist": dist},
                     {"match_type": match_type,
                      "dist_threshold": dist_threshold})
    return idx, dist


def multiclass_nms(bboxes, scores, score_threshold=0.01,
                   nms_threshold=0.45, nms_top_k=16, keep_top_k=16,
                   name=None):
    """Per-class NMS over [n, 4] boxes -> [keep_top_k, 6] rows."""
    return _single_out_layer("multiclass_nms",
                             {"BBoxes": bboxes, "Scores": scores},
                             {"score_threshold": score_threshold,
                              "nms_threshold": nms_threshold,
                              "nms_top_k": nms_top_k,
                              "keep_top_k": keep_top_k},
                             stop_gradient=True, name=name)


def ssd_loss(location, confidence, gt_box, gt_label, prior_box_var,
             overlap_threshold=0.5, neg_pos_ratio=3.0,
             background_label=0, name=None):
    """SSD's MultiBox training loss per image, [B, 1];
    ``prior_box_var`` is the (boxes, variances) pair ``prior_box``
    returns."""
    helper = LayerHelper("ssd_loss", name=name)
    pb, pv = prior_box_var
    out = helper.create_tmp_variable("float32")
    helper.append_op("ssd_loss",
                     {"Location": location, "Confidence": confidence,
                      "GTBox": gt_box, "GTLabel": gt_label,
                      "PriorBox": pb, "PriorVar": pv},
                     {"Out": out},
                     {"overlap_threshold": float(overlap_threshold),
                      "neg_pos_ratio": float(neg_pos_ratio),
                      "background_label": int(background_label)})
    return out


def detection_output(loc, conf, prior_box, prior_var,
                     background_id=0, nms_threshold=0.45, nms_top_k=400,
                     keep_top_k=200, confidence_threshold=0.01,
                     name=None):
    """SSD's inference head: the decoded boxes, softmaxed scores and
    per-class NMS -> [B, keep_top_k, 6] rows."""
    return _single_out_layer(
        "detection_output",
        {"Location": loc, "Confidence": conf, "PriorBox": prior_box,
         "PriorVar": prior_var},
        {"background_id": int(background_id),
         "nms_threshold": float(nms_threshold),
         "nms_top_k": int(nms_top_k), "keep_top_k": int(keep_top_k),
         "confidence_threshold": float(confidence_threshold)},
        stop_gradient=True, name=name)


def smooth_l1(x, y, sigma=1.0):
    """Smooth L1 loss summed over the last axis (smooth_l1_loss_op.cc)
    -> [B, 1]; the op's Diff is a second output."""
    helper = LayerHelper("smooth_l1")
    diff = helper.create_tmp_variable(x.dtype)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("smooth_l1_loss", {"X": x, "Y": y},
                     {"Diff": diff, "Out": out}, {"sigma": sigma})
    return out


def auc(input, label, curve="ROC", num_thresholds=200, topk=1):
    """Rank-based AUC of ``input``'s positive-class column against 0/1
    ``label``, after a ``top_k`` whose indices the op takes (and does
    not read), as the reference builds it."""
    helper = LayerHelper("auc")
    topk_out = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    topk_indices = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op("top_k", {"X": input},
                     {"Out": topk_out, "Indices": topk_indices}, {"k": topk})
    out = helper.create_tmp_variable("float32", stop_gradient=True)
    helper.append_op("auc", {"Out": input, "Indices": topk_indices,
                             "Label": label}, {"AUC": out},
                     {"curve": curve, "num_thresholds": num_thresholds})
    return out


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    """Hierarchical sigmoid cost over the default complete binary tree:
    a [num_classes - 1, feat] weight and, unless ``bias_attr`` is
    False, a [num_classes - 1] bias -> the per-row cost [B, 1]."""
    helper = LayerHelper("hsigmoid", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dtype = input.dtype
    feat = input.shape[-1]
    w = helper.create_parameter(helper.param_attr,
                                shape=[num_classes - 1, feat], dtype=dtype)
    inputs = {"X": input, "Label": label, "W": w}
    if bias_attr is not False:
        inputs["Bias"] = helper.create_parameter(
            helper.bias_attr or ParamAttr(), shape=[num_classes - 1],
            dtype=dtype, is_bias=True)
    out = helper.create_tmp_variable(dtype)
    helper.append_op("hsigmoid", inputs, {"Out": out},
                     {"num_classes": int(num_classes)})
    return out


def sampling_id(x, name=None):
    """One class id per row drawn from the row's probabilities."""
    helper = LayerHelper("sampling_id", name=name)
    out = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op("sampling_id", {"X": x}, {"Out": out}, {})
    return out


def bilinear_interp(input, out_h, out_w, name=None):
    """Bilinear upsampling of [B, C, H, W] to (out_h, out_w), corners
    aligned."""
    helper = LayerHelper("bilinear_interp", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("bilinear_interp", {"X": input}, {"Out": out},
                     {"out_h": int(out_h), "out_w": int(out_w)})
    return out


def prelu(x, mode="all", param_attr=None, name=None):
    """Parametric ReLU with a learned slope, initialized 0.25: one for
    ``mode`` 'all', one per channel ('channel', NCHW axis 1) or one per
    feature element ('element')."""
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    if mode == "all":
        shape = [1]
    elif mode == "channel":
        shape = [x.shape[1]]
    elif mode == "element":
        shape = list(x.shape[1:])
    else:
        raise ValueError(f"prelu: unknown mode {mode!r}")
    alpha = helper.create_parameter(
        helper.param_attr, shape=shape, dtype=x.dtype,
        default_initializer=ConstantInitializer(0.25))
    out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
    helper.append_op("prelu", {"X": x, "Alpha": alpha}, {"Out": out},
                     {"mode": mode})
    return out


def maxout(x, groups, name=None):
    """The max over each group of ``groups`` channels, NCHW."""
    return _single_out_layer("maxout", {"X": x},
                             {"groups": int(groups)}, name=name)


def selective_fc(input, size, select=None, act=None, param_attr=None,
                 bias_attr=None, name=None):
    """An fc computed only at ``select``'s columns ([B, k] ids, -1
    padded) -> [B, k]; without ``select``, ``fc``."""
    if select is None:
        return fc(input, size, act=act, param_attr=param_attr,
                  bias_attr=bias_attr, name=name)
    helper = LayerHelper("selective_fc", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    w = helper.create_parameter(helper.param_attr,
                                shape=[int(input.shape[-1]), size],
                                dtype=dtype)
    inputs = {"X": input, "W": w, "Select": select}
    if helper.bias_attr is not None:
        inputs["Bias"] = helper.create_parameter(
            helper.bias_attr, shape=[size], dtype=dtype, is_bias=True)
    out = helper.create_tmp_variable(dtype)
    helper.append_op("selective_fc", inputs, {"Out": out})
    return helper.append_activation(out)


def scale_sub_region(input, indices, value, name=None):
    """Each sample's CHW block ``indices`` [B, 6] (1-based, inclusive
    [c0, c1, h0, h1, w0, w1]) scaled by ``value``."""
    helper = LayerHelper("scale_sub_region", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("scale_sub_region",
                     {"X": input, "Indices": indices}, {"Out": out},
                     {"value": float(value)})
    return out


def rotate(x, name=None):
    """Each [H, W] map turned 90 degrees clockwise."""
    return _single_out_layer("rotate", {"X": x}, {}, name=name)


def cross_entropy_over_beam(beams, name=None):
    """The learning-to-search beam cost of (candidate_scores,
    selected_ids, gold) triples, one per beam expansion -> [B, 1]."""
    helper = LayerHelper("cross_entropy_over_beam", name=name)
    out = helper.create_tmp_variable("float32")
    helper.append_op("cross_entropy_over_beam",
                     {"Scores": [b[0] for b in beams],
                      "Ids": [b[1] for b in beams],
                      "Gold": [b[2] for b in beams]},
                     {"Out": out})
    return out


def cross_entropy_with_selfnorm(input, label, softmax_selfnorm_alpha=0.1,
                                name=None):
    """Self-normalized cross-entropy of unnormalized positive scores ->
    [B, 1]."""
    helper = LayerHelper("cross_entropy_with_selfnorm", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("cross_entropy_with_selfnorm",
                     {"X": input, "Label": label}, {"Out": out},
                     {"softmax_selfnorm_alpha": float(softmax_selfnorm_alpha)})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    """Constant padding, ``paddings`` = [before0, after0, ...]."""
    return _single_out_layer("pad", {"X": x},
                             {"paddings": list(paddings),
                              "pad_value": float(pad_value)}, name=name)


def crop(x, shape=None, offsets=None, y=None, name=None):
    """The ``shape`` block of ``x`` at ``offsets`` (or ``y``'s shape)."""
    inputs = {"X": x}
    attrs = {"offsets": list(offsets or [0] * len(x.shape))}
    if y is not None:
        inputs["Y"] = y
    else:
        attrs["shape"] = list(shape)
    return _single_out_layer("crop", inputs, attrs, name=name)


def lod_reset(x, y=None, target_lod=None, name=None):
    """The same data under new sequence lengths, ``y``'s or those of the
    offsets ``target_lod``.  As in the reference, the output var's shape
    is left undeclared where the op's inference fails (a dense ``y``:
    ROADMAP C8)."""
    inputs = {"X": x}
    attrs = {}
    if y is not None:
        inputs["Y"] = y
    else:
        attrs["target_lod"] = list(target_lod)
    return _single_out_layer("lod_reset", inputs, attrs, lod=1, name=name)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """(1 - epsilon) label + epsilon prior (uniform by default)."""
    inputs = {"X": label}
    if prior_dist is not None:
        inputs["PriorDist"] = prior_dist
    return _single_out_layer("label_smooth", inputs,
                             {"epsilon": float(epsilon)}, name=name)


def rank_loss(label, left, right, name=None):
    """RankNet's pairwise logistic loss of the scores ``left`` and
    ``right``."""
    return _single_out_layer("rank_loss",
                             {"Label": label, "Left": left,
                              "Right": right}, name=name)


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    """max(0, -label (left - right) + margin)."""
    return _single_out_layer("margin_rank_loss",
                             {"Label": label, "X1": left, "X2": right},
                             {"margin": float(margin)},
                             extra_outputs=["Activated"], name=name)


def log_loss(input, label, epsilon=1e-4, name=None):
    """The binary log loss of probabilities ``input``."""
    helper = LayerHelper("log_loss", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("log_loss", {"Predicted": input, "Labels": label},
                     {"Loss": out}, {"epsilon": float(epsilon)})
    return out


def conv_shift(x, y, name=None):
    """Per-row circular correlation of ``x`` with ``y``."""
    return _single_out_layer("conv_shift", {"X": x, "Y": y}, name=name)


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None):
    """DeepSpeech2's lookahead convolution over a sequence: a
    [future_context_size + 1, feat] filter."""
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act,
                         name=name)
    w = helper.create_parameter(helper.param_attr,
                                shape=[future_context_size + 1,
                                       input.shape[-1]],
                                dtype=input.dtype)
    out = helper.create_tmp_variable(input.dtype, lod_level=1)
    helper.append_op("row_conv", {"X": input, "Filter": w}, {"Out": out})
    return helper.append_activation(out)


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, name=None):
    """Max pool of each RoI ([R, 5] = image, x1, y1, x2, y2) to
    [pooled_height, pooled_width] bins -> [R, C, ph, pw]."""
    return _single_out_layer("roi_pool", {"X": input, "ROIs": rois},
                             {"pooled_height": pooled_height,
                              "pooled_width": pooled_width,
                              "spatial_scale": spatial_scale}, name=name)


def spp(input, pyramid_height=3, pool_type="max", name=None):
    """Spatial pyramid pooling, flattened -> [B, C * sum(4^l)]."""
    return _single_out_layer("spp", {"X": input},
                             {"pyramid_height": pyramid_height,
                              "pooling_type": pool_type}, name=name)


def unpool(x, indices, unpooled_size, name=None):
    """Pooled values written back at ``max_pool2d_with_index``'s
    indices."""
    return _single_out_layer("unpool", {"X": x, "Indices": indices},
                             {"unpooled_size": list(unpooled_size)},
                             name=name)


def max_pool2d_with_index(input, pool_size, pool_stride=None, name=None):
    """Max pool and the flat index of each window's maximum (the Mask
    ``unpool`` reads) -> (out, mask)."""
    helper = LayerHelper("max_pool2d_with_index", name=name)
    k = pool_size if isinstance(pool_size, (list, tuple)) \
        else [pool_size, pool_size]
    s = pool_stride if pool_stride is not None else list(k)
    s = s if isinstance(s, (list, tuple)) else [s, s]
    out = helper.create_tmp_variable(input.dtype)
    mask = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op("max_pool2d_with_index", {"X": input},
                     {"Out": out, "Mask": mask},
                     {"ksize": list(k), "strides": list(s)})
    return out, mask
