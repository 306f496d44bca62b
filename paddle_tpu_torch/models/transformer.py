"""Transformer (encoder-decoder NMT) — the port of
``paddle_tpu/models/transformer.py``: the Fluid training graph and the
dense and paged serving graphs.

Every builder appends Fluid ops through ``fluid.layers`` exactly as the
reference does, so both packages build byte-identical programs, and
``fluid.Executor`` runs them (on the card each step signature is one
captured CUDA graph).

Training.  ``transformer()`` and its builders (``multi_head_attention``,
``positionwise_feed_forward``, ``pre_post_process_layer``,
``encoder(_layer)``, ``decoder(_layer)``, ``prepare_embedding``,
``wrap_encoder``): with ``fused=True`` every attention is one
``fused_attention`` op in the ``blhd`` layout (the flash kernels on the
card); with ``fused=False``, the reference's default, the unfused
matmul + softmax composition over an additive bias (plain PyTorch ops:
the reference computes it outside any Pallas kernel).
``amp_dtype="bfloat16"`` is the reference's bf16 recipe: bf16
activations from one cast at each embedding, f32 master weights.

Serving.  The dense decode towers ``decode_prefill`` (encode once,
project every layer's cross K/V) and ``decode_step`` (the dense caches
of ``multi_head_attention``'s ``cache`` / ``static_kv`` branches,
threaded through the layer builders as ``cache`` / ``cross_kv``), which
``serving.decoder.TransformerGenerator`` runs; the paged branches
(``paged_cache``: project q/k/v, write K/V into the pool, attend
causally over the lane's pages; ``paged_static``: project q, attend
over cross pages written at prefill), threaded through as
``paged_cache(s)`` / ``paged_cross(es)``, and the three paged towers
``paged_prefill_chunk``, ``paged_decode_step`` and ``verify_step``,
which ``serving.paged_decoder`` assembles into its unified step and its
beam step.  Parameter names under ``param_prefix`` are the training
graph's, so one scope serves all of them.

Not ported: ``mp_shard`` and ``seq_parallel``.
"""

from __future__ import annotations

import numpy as np

from ..fluid import ParamAttr, layers, unique_name

__all__ = ["transformer", "multi_head_attention", "positionwise_feed_forward",
           "pre_post_process_layer", "encoder_layer", "encoder",
           "decoder_layer", "decoder", "prepare_embedding", "wrap_encoder",
           "make_attn_bias", "position_encoding_init", "decode_prefill",
           "decode_step", "paged_prefill_chunk", "paged_decode_step",
           "verify_step"]


# ---------------------------------------------------------------------------
# the Fluid training graph
# ---------------------------------------------------------------------------

def _nm(prefix, key):
    """Parameter name under an explicit prefix; None keeps auto-naming.
    ``transformer(param_prefix=...)`` names every parameter, and the
    serving towers re-create the same names, so one scope serves both."""
    return None if prefix is None else f"{prefix}.{key}"


def _attr(mp_shard, name=None):
    """ParamAttr of a named parameter, None for an auto-named one.  The
    reference's ``mp_shard`` (tensor-parallel sharding annotations)
    needs a mesh and is not ported."""
    if mp_shard:
        raise NotImplementedError("transformer(mp_shard=...): tensor "
                                  "parallelism is not ported to "
                                  "paddle_tpu_torch")
    return None if name is None else ParamAttr(name=name)


def multi_head_attention(queries, keys, values, attn_bias, d_key, d_value,
                         d_model, n_head=1, dropout_rate=0.0,
                         mp_shard=False, fused=False, seq_parallel=False,
                         causal=False, prefix=None, cache=None,
                         static_kv=None, paged_cache=None,
                         paged_static=None):
    """Project q/k/v, attend, merge heads, output projection.

    Training: with ``fused=True`` one ``fused_attention`` op on the
    head-interleaved [b, l, h, d] tensors (``layout='blhd'``: no
    split-heads transposes; the flash kernels on the card), where
    ``causal=True`` masks future keys inside the kernel and
    attention-probability dropout happens inside the kernel too.  With
    ``fused=False`` (the default, as in the reference) the unfused
    composition: split heads, ``scale``, ``matmul`` q.k^T, the bias add,
    ``softmax``, dropout, ``matmul`` with v, merge heads; causal masking
    then comes from the bias (``make_attn_bias(causal=True)``).

    Dense decode (``serving/decoder.py``):
      ``cache={"k","v","index","lengths"}`` — the current token's k/v are
      written into the persistable cache vars at ``index``
      (``cache_write``) and the query attends over the cache's first
      ``lengths`` rows (``decode_attention``);
      ``static_kv={"k","v","lengths"}`` — cross-attention against K/V
      projected once at prefill (``decode_prefill``).

    Paged serving (block-table page indirection over ONE pooled KV
    tensor; see serving/paged_decoder.py):
      ``paged_cache={"pool","table","pages","offsets","lengths","base",
      "layer","n_layer","scales"}`` — the chunk's K/V are scattered into
      the pool at per-token (page, offset) and the queries attend
      causally over the lane's page list (``paged_cache_write`` or, with
      ``scales``, ``quantized_paged_cache_write``, then
      ``ragged_decode_attention``: write-then-attend).
      ``paged_static={"pool","table","lengths","layer","n_layer",
      "scales"}`` — read-only cross-attention against pages written at
      prefill."""
    if seq_parallel:
        raise NotImplementedError("multi_head_attention(seq_parallel=...) "
                                  "is not ported to paddle_tpu_torch")
    q_attr = _attr(mp_shard, _nm(prefix, "q.w"))
    o_attr = _attr(mp_shard, _nm(prefix, "out.w"))
    q = layers.fc(input=queries, size=d_key * n_head, bias_attr=False,
                  num_flatten_dims=2, param_attr=q_attr)

    def interleave_heads(x, d_head):
        b, l = x.shape[0], x.shape[1]
        return layers.reshape(x, [-1 if b == -1 else b, l, n_head, d_head])

    def merge_heads_proj(ctx):
        b, l = ctx.shape[0], ctx.shape[1]
        return layers.fc(
            input=layers.reshape(
                ctx, [-1 if b == -1 else b, l, n_head * d_value]),
            size=d_model, bias_attr=False, num_flatten_dims=2,
            param_attr=o_attr)

    def project_kv():
        k = layers.fc(input=keys, size=d_key * n_head, bias_attr=False,
                      num_flatten_dims=2,
                      param_attr=_attr(mp_shard, _nm(prefix, "k.w")))
        v = layers.fc(input=values, size=d_value * n_head, bias_attr=False,
                      num_flatten_dims=2,
                      param_attr=_attr(mp_shard, _nm(prefix, "v.w")))
        return k, v

    if paged_cache is not None or paged_static is not None:
        if sum(x is not None
               for x in (cache, static_kv, paged_cache, paged_static)) > 1:
            raise ValueError("multi_head_attention: pick ONE of cache / "
                             "static_kv / paged_cache / paged_static")
        q = interleave_heads(q, d_key)          # [b, lq, h, dk]
        if paged_static is not None:
            ps = paged_static
            ctx = layers.ragged_decode_attention(
                q, ps["pool"], ps["table"], ps["lengths"],
                layer=ps["layer"], n_layer=ps["n_layer"], causal=False,
                sm_scale=float(d_key) ** -0.5, scales=ps.get("scales"))
        else:
            pc = paged_cache
            k, v = project_kv()
            kv_scales = pc.get("scales")
            if kv_scales is not None:       # int8 pool: quantize on write
                pool, kv_scales = layers.quantized_paged_cache_write(
                    pc["pool"], kv_scales, interleave_heads(k, d_key),
                    interleave_heads(v, d_value), pc["pages"],
                    pc["offsets"], layer=pc["layer"],
                    n_layer=pc["n_layer"])
            else:
                pool = layers.paged_cache_write(
                    pc["pool"], interleave_heads(k, d_key),
                    interleave_heads(v, d_value), pc["pages"],
                    pc["offsets"], layer=pc["layer"],
                    n_layer=pc["n_layer"])
            ctx = layers.ragged_decode_attention(
                q, pool, pc["table"], pc["lengths"], pc["base"],
                layer=pc["layer"], n_layer=pc["n_layer"], causal=True,
                sm_scale=float(d_key) ** -0.5, scales=kv_scales)
        return merge_heads_proj(ctx)

    if cache is not None or static_kv is not None:
        if cache is not None and static_kv is not None:
            raise ValueError("multi_head_attention: cache and static_kv "
                             "are mutually exclusive")
        q = interleave_heads(q, d_key)          # [b, lq, h, dk]
        if static_kv is not None:
            ctx = layers.decode_attention(
                q, static_kv["k"], static_kv["v"], static_kv["lengths"],
                sm_scale=float(d_key) ** -0.5)
        else:
            k, v = project_kv()
            kc = layers.cache_write(cache["k"], interleave_heads(k, d_key),
                                    cache["index"], axis=1)
            vc = layers.cache_write(cache["v"], interleave_heads(v, d_value),
                                    cache["index"], axis=1)
            ctx = layers.decode_attention(q, kc, vc, cache["lengths"],
                                          sm_scale=float(d_key) ** -0.5)
        return merge_heads_proj(ctx)

    k, v = project_kv()
    if fused:
        q = interleave_heads(q, d_key)
        k = interleave_heads(k, d_key)
        v = interleave_heads(v, d_value)
        ctx = layers.fused_attention(q, k, v, bias=attn_bias, causal=causal,
                                     sm_scale=float(d_key) ** -0.5,
                                     dropout_rate=dropout_rate,
                                     layout="blhd")
        return merge_heads_proj(ctx)

    def split_heads(x, d_head):
        return layers.transpose(interleave_heads(x, d_head), [0, 2, 1, 3])

    q = split_heads(q, d_key)                   # [b, h, lq, dk]
    k = split_heads(k, d_key)
    v = split_heads(v, d_value)
    if causal:
        raise NotImplementedError(
            "in-graph causal masking without a bias tensor requires the "
            "fused attention path (fused=True); pass a causal attn_bias "
            "from make_attn_bias otherwise")
    q = layers.scale(q, scale=float(d_key) ** -0.5)
    product = layers.matmul(q, k, transpose_y=True)   # [b, h, lq, lk]
    if attn_bias is not None:
        product = layers.elementwise_add(product, attn_bias)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx = layers.matmul(weights, v)                   # [b, h, lq, dv]
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    return merge_heads_proj(ctx)


def positionwise_feed_forward(x, d_inner_hid, d_hid, mp_shard=False,
                              prefix=None):
    hidden = layers.fc(input=x, size=d_inner_hid, num_flatten_dims=2,
                       act="relu",
                       param_attr=_attr(mp_shard, _nm(prefix, "fc1.w")),
                       bias_attr=_attr(False, _nm(prefix, "fc1.b")))
    return layers.fc(input=hidden, size=d_hid, num_flatten_dims=2,
                     param_attr=_attr(mp_shard, _nm(prefix, "fc2.w")),
                     bias_attr=_attr(False, _nm(prefix, "fc2.b")))


def pre_post_process_layer(prev_out, out, process_cmd, dropout_rate=0.0,
                           prefix=None):
    """The a/n/d chain: residual add, layer norm, dropout."""
    for j, cmd in enumerate(process_cmd):
        if cmd == "a":
            out = layers.elementwise_add(out, prev_out) \
                if prev_out is not None else out
        elif cmd == "n":
            out = layers.layer_norm(
                out, begin_norm_axis=len(out.shape) - 1,
                param_attr=_attr(False, _nm(prefix, f"ln{j}.w")),
                bias_attr=_attr(False, _nm(prefix, f"ln{j}.b")))
        elif cmd == "d" and dropout_rate:
            out = layers.dropout(out, dropout_prob=dropout_rate)
    return out


def encoder_layer(enc_input, attn_bias, n_head, d_key, d_value, d_model,
                  d_inner_hid, dropout_rate=0.0, mp_shard=False,
                  fused=False, seq_parallel=False, prefix=None,
                  paged_cache=None):
    attn_output = multi_head_attention(
        enc_input, enc_input, enc_input, attn_bias, d_key, d_value, d_model,
        n_head, dropout_rate, mp_shard, fused, seq_parallel,
        prefix=_nm(prefix, "self"), paged_cache=paged_cache)
    attn_output = pre_post_process_layer(enc_input, attn_output, "dan",
                                         dropout_rate,
                                         prefix=_nm(prefix, "post_self"))
    ffd_output = positionwise_feed_forward(attn_output, d_inner_hid, d_model,
                                           mp_shard,
                                           prefix=_nm(prefix, "ffn"))
    return pre_post_process_layer(attn_output, ffd_output, "dan",
                                  dropout_rate,
                                  prefix=_nm(prefix, "post_ffn"))


def encoder(enc_input, attn_bias, n_layer, n_head, d_key, d_value, d_model,
            d_inner_hid, dropout_rate=0.0, mp_shard=False, fused=False,
            seq_parallel=False, prefix=None, paged_caches=None):
    for i in range(n_layer):
        enc_input = encoder_layer(enc_input, attn_bias, n_head, d_key,
                                  d_value, d_model, d_inner_hid,
                                  dropout_rate, mp_shard, fused,
                                  seq_parallel, prefix=_nm(prefix, f"enc{i}"),
                                  paged_cache=None if paged_caches is None
                                  else paged_caches[i])
    return enc_input


def decoder_layer(dec_input, enc_output, slf_attn_bias, dec_enc_attn_bias,
                  n_head, d_key, d_value, d_model, d_inner_hid,
                  dropout_rate=0.0, mp_shard=False, fused=False,
                  seq_parallel=False, causal=False, prefix=None,
                  cache=None, cross_kv=None, paged_cache=None,
                  paged_cross=None):
    """One decoder layer.  Training re-attends over the whole target
    (``slf_attn_bias`` or ``causal``) and over the encoder output; dense
    decode passes ``cache`` (self-attention over the layer's KV cache)
    and ``cross_kv`` (the cross K/V from prefill and the source lengths);
    paged serving passes ``paged_cache`` (self-attention over the lane's
    self pages) and ``paged_cross`` (cross-attention over the cross pages
    written at prefill)."""
    slf_attn = multi_head_attention(dec_input, dec_input, dec_input,
                                    slf_attn_bias, d_key, d_value, d_model,
                                    n_head, dropout_rate, mp_shard, fused,
                                    seq_parallel, causal=causal,
                                    prefix=_nm(prefix, "self"), cache=cache,
                                    paged_cache=paged_cache)
    slf_attn = pre_post_process_layer(dec_input, slf_attn, "dan",
                                      dropout_rate,
                                      prefix=_nm(prefix, "post_self"))
    cross = multi_head_attention(slf_attn, enc_output, enc_output,
                                 dec_enc_attn_bias, d_key, d_value, d_model,
                                 n_head, dropout_rate, mp_shard, fused,
                                 seq_parallel, prefix=_nm(prefix, "cross"),
                                 static_kv=cross_kv,
                                 paged_static=paged_cross)
    cross = pre_post_process_layer(slf_attn, cross, "dan", dropout_rate,
                                   prefix=_nm(prefix, "post_cross"))
    ffd = positionwise_feed_forward(cross, d_inner_hid, d_model, mp_shard,
                                    prefix=_nm(prefix, "ffn"))
    return pre_post_process_layer(cross, ffd, "dan", dropout_rate,
                                  prefix=_nm(prefix, "post_ffn"))


def decoder(dec_input, enc_output, slf_attn_bias, dec_enc_attn_bias,
            n_layer, n_head, d_key, d_value, d_model, d_inner_hid,
            dropout_rate=0.0, mp_shard=False, fused=False,
            seq_parallel=False, causal=False, prefix=None,
            caches=None, cross_kvs=None, paged_caches=None,
            paged_crosses=None):
    for i in range(n_layer):
        dec_input = decoder_layer(dec_input, enc_output, slf_attn_bias,
                                  dec_enc_attn_bias, n_head, d_key, d_value,
                                  d_model, d_inner_hid, dropout_rate,
                                  mp_shard, fused, seq_parallel,
                                  causal=causal, prefix=_nm(prefix, f"dec{i}"),
                                  cache=None if caches is None else caches[i],
                                  cross_kv=None if cross_kvs is None
                                  else cross_kvs[i],
                                  paged_cache=None if paged_caches is None
                                  else paged_caches[i],
                                  paged_cross=None if paged_crosses is None
                                  else paged_crosses[i])
    return dec_input


def prepare_embedding(word_ids, pos_ids, vocab_size, max_length, d_model,
                      dropout_rate=0.0, emb_name=None, amp_dtype=None,
                      pos_name=None):
    """word_emb[ids] * sqrt(d_model) + pos_emb[pos], then dropout.  With
    ``amp_dtype`` the sum is cast once to that dtype: every op after it
    computes in the activation dtype over the f32 master weights."""
    word_emb = layers.embedding(
        input=word_ids, size=[vocab_size, d_model],
        param_attr=emb_name)
    word_emb = layers.scale(word_emb, scale=float(d_model) ** 0.5)
    pos_emb = layers.embedding(input=pos_ids, size=[max_length, d_model],
                               param_attr=pos_name)
    out = layers.elementwise_add(word_emb, pos_emb)
    if amp_dtype:
        out = layers.cast(out, amp_dtype)
    if dropout_rate:
        out = layers.dropout(out, dropout_prob=dropout_rate)
    return out


def wrap_encoder(src_word, src_pos, src_slf_attn_bias, src_vocab_size,
                 max_length, n_layer, n_head, d_key, d_value, d_model,
                 d_inner_hid, dropout_rate=0.0, mp_shard=False, fused=False,
                 seq_parallel=False, amp_dtype=None, prefix=None):
    emb = prepare_embedding(src_word, src_pos, src_vocab_size, max_length,
                            d_model, dropout_rate, amp_dtype=amp_dtype,
                            emb_name=_nm(prefix, "src_emb.w"),
                            pos_name=_nm(prefix, "src_pos_emb.w"))
    return encoder(emb, src_slf_attn_bias, n_layer, n_head, d_key, d_value,
                   d_model, d_inner_hid, dropout_rate, mp_shard, fused,
                   seq_parallel, prefix=prefix)


def transformer(src_vocab_size, trg_vocab_size, max_length, n_layer=6,
                n_head=8, d_key=64, d_value=64, d_model=512,
                d_inner_hid=2048, dropout_rate=0.1, src_seq_len=32,
                trg_seq_len=32, mp_shard=False, fused=False,
                seq_parallel=False, materialize_attn_bias=True,
                fused_vocab_loss=False, amp_dtype=None, param_prefix=None):
    """Build the full training graph; returns (avg_cost, predict, feeds).

    Data vars (dense, static sequence lengths): src_word/src_pos
    [b, slen], trg_word/trg_pos [b, tlen] int64, the *_attn_bias float32
    additive masks [b, h, lq, lk], lbl_word [b, tlen] int64 and
    lbl_weight [b, tlen] float32 (0 at padding).

    ``materialize_attn_bias=False`` (requires ``fused=True``) drops the
    three bias inputs: decoder self-attention is masked causally inside
    the kernel and the others run unmasked (sequences packed to full
    length; loss padding still honoured through lbl_weight).
    ``fused_vocab_loss`` streams the vocab projection into the loss, so
    the [b, t, V] logits of ``predict`` are never computed in training
    (the executor runs only the ops a fetch or a parameter needs).
    ``param_prefix`` names every parameter under the prefix: the names
    ``PagedTransformerGenerator.load_params`` reads."""
    src_word = layers.data("src_word", [src_seq_len], "int64")
    src_pos = layers.data("src_pos", [src_seq_len], "int64")
    trg_word = layers.data("trg_word", [trg_seq_len], "int64")
    trg_pos = layers.data("trg_pos", [trg_seq_len], "int64")
    if materialize_attn_bias:
        src_slf_attn_bias = layers.data(
            "src_slf_attn_bias", [n_head, src_seq_len, src_seq_len],
            "float32")
        trg_slf_attn_bias = layers.data(
            "trg_slf_attn_bias", [n_head, trg_seq_len, trg_seq_len],
            "float32")
        trg_src_attn_bias = layers.data(
            "trg_src_attn_bias", [n_head, trg_seq_len, src_seq_len],
            "float32")
    else:
        if not fused:
            raise ValueError("materialize_attn_bias=False requires "
                             "fused=True (in-kernel causal masking)")
        src_slf_attn_bias = trg_slf_attn_bias = trg_src_attn_bias = None
    lbl_word = layers.data("lbl_word", [trg_seq_len], "int64")
    lbl_weight = layers.data("lbl_weight", [trg_seq_len], "float32")

    enc_output = wrap_encoder(src_word, src_pos, src_slf_attn_bias,
                              src_vocab_size, max_length, n_layer, n_head,
                              d_key, d_value, d_model, d_inner_hid,
                              dropout_rate, mp_shard, fused, seq_parallel,
                              amp_dtype=amp_dtype, prefix=param_prefix)
    dec_emb = prepare_embedding(trg_word, trg_pos, trg_vocab_size,
                                max_length, d_model, dropout_rate,
                                amp_dtype=amp_dtype,
                                emb_name=_nm(param_prefix, "trg_emb.w"),
                                pos_name=_nm(param_prefix, "trg_pos_emb.w"))
    dec_output = decoder(dec_emb, enc_output, trg_slf_attn_bias,
                         trg_src_attn_bias, n_layer, n_head, d_key, d_value,
                         d_model, d_inner_hid, dropout_rate, mp_shard,
                         fused, seq_parallel,
                         causal=not materialize_attn_bias,
                         prefix=param_prefix)
    proj_attr = ParamAttr(name=(_nm(param_prefix, "vocab_proj.w")
                                or unique_name.generate("vocab_proj_w")))
    predict = layers.fc(input=dec_output, size=trg_vocab_size,
                        num_flatten_dims=2, bias_attr=False,
                        param_attr=proj_attr)
    if fused_vocab_loss:
        # shares the projection with the inference head through proj_attr
        cost = layers.fused_vocab_cross_entropy(
            dec_output, layers.reshape(lbl_word, [0, trg_seq_len, 1]),
            vocab_size=trg_vocab_size, param_attr=proj_attr)
    else:
        cost = layers.softmax_with_cross_entropy(
            logits=predict,
            label=layers.reshape(lbl_word, [0, trg_seq_len, 1]))
    weighted = layers.elementwise_mul(
        layers.reshape(cost, [0, trg_seq_len]), lbl_weight)
    sum_cost = layers.reduce_sum(weighted)
    token_count = layers.reduce_sum(lbl_weight)
    avg_cost = layers.elementwise_div(sum_cost, token_count)
    feeds = [src_word, src_pos, trg_word, trg_pos]
    if materialize_attn_bias:
        feeds += [src_slf_attn_bias, trg_slf_attn_bias, trg_src_attn_bias]
    feeds += [lbl_word, lbl_weight]
    return avg_cost, predict, feeds


def make_attn_bias(lengths, seq_len, n_head, causal=False):
    """Host-side additive bias [b, h, q, k]: 0 valid, -1e9 masked."""
    lengths = np.asarray(lengths)
    b = lengths.shape[0]
    valid = (np.arange(seq_len)[None, :] < lengths[:, None])
    bias = np.where(valid[:, None, None, :], 0.0, -1e9)
    bias = np.broadcast_to(bias, (b, n_head, seq_len, seq_len)).copy()
    if causal:
        future = np.triu(np.ones((seq_len, seq_len)), k=1) * -1e9
        bias = bias + future[None, None]
    return bias.astype(np.float32)


def position_encoding_init(n_position, d_model):
    """Sinusoid table (the reference transformer's position_encoding_init)."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_model)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d_model)
    table = np.zeros((n_position, d_model), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


# ---------------------------------------------------------------------------
# the dense decode towers (serving/decoder.py)
# ---------------------------------------------------------------------------

def decode_prefill(src_word, src_pos, src_slf_attn_bias, src_vocab_size,
                   max_length, n_layer, n_head, d_key, d_value, d_model,
                   d_inner_hid, param_prefix, dropout_rate=0.0):
    """The dense prefill tower: encode the source once (the unfused
    attention, as the reference builds it) and project every decoder
    layer's cross-attention K/V from the encoder output, under the
    training graph's parameter names.  Returns ``(enc_output,
    cross_kvs)``, ``cross_kvs`` a list of ``(k_i, v_i)`` vars, each [b,
    src_len, n_head, d]: the ``static_kv`` layout ``decode_step``
    reads."""
    if not param_prefix:
        raise ValueError("decode_prefill requires param_prefix (the "
                         "explicit-name sharing contract with the "
                         "training graph)")
    enc_output = wrap_encoder(src_word, src_pos, src_slf_attn_bias,
                              src_vocab_size, max_length, n_layer, n_head,
                              d_key, d_value, d_model, d_inner_hid,
                              dropout_rate, prefix=param_prefix)
    b, s = enc_output.shape[0], enc_output.shape[1]

    def heads(x, d_head):
        return layers.reshape(x, [-1 if b == -1 else b, s, n_head, d_head])

    cross_kvs = []
    for i in range(n_layer):
        pre = _nm(param_prefix, f"dec{i}.cross")
        k = layers.fc(input=enc_output, size=d_key * n_head,
                      bias_attr=False, num_flatten_dims=2,
                      param_attr=_attr(False, _nm(pre, "k.w")))
        v = layers.fc(input=enc_output, size=d_value * n_head,
                      bias_attr=False, num_flatten_dims=2,
                      param_attr=_attr(False, _nm(pre, "v.w")))
        cross_kvs.append((heads(k, d_key), heads(v, d_value)))
    return enc_output, cross_kvs


def decode_step(trg_word, trg_pos, cache_index, self_lengths, src_lengths,
                self_caches, cross_caches, trg_vocab_size, max_length,
                n_layer, n_head, d_key, d_value, d_model, d_inner_hid,
                param_prefix):
    """One dense incremental decode step.  Feeds: ``trg_word`` /
    ``trg_pos`` [b, 1], ``cache_index`` [b] int32 (each lane's write
    position), ``self_lengths`` [b] int32 (position + 1),
    ``src_lengths`` [b] int32.  ``self_caches``: per layer ``{"k",
    "v"}`` persistable vars [b, max_out_len, h, d], written in place by
    ``cache_write``; ``cross_caches``: per layer ``{"k", "v"}`` [b,
    src_len, h, d] from ``decode_prefill``.  Returns logits [b, 1,
    vocab]."""
    if not param_prefix:
        raise ValueError("decode_step requires param_prefix (the "
                         "explicit-name sharing contract with the "
                         "training graph)")
    emb = prepare_embedding(trg_word, trg_pos, trg_vocab_size, max_length,
                            d_model, 0.0,
                            emb_name=_nm(param_prefix, "trg_emb.w"),
                            pos_name=_nm(param_prefix, "trg_pos_emb.w"))
    # [b, 1] ids embed to [b, d]; the decoder works on [b, 1, d]
    emb = layers.reshape(emb, [-1, 1, d_model])
    caches = [{"k": c["k"], "v": c["v"], "index": cache_index,
               "lengths": self_lengths} for c in self_caches]
    cross = [{"k": c["k"], "v": c["v"], "lengths": src_lengths}
             for c in cross_caches]
    dec_output = decoder(emb, None, None, None, n_layer, n_head, d_key,
                         d_value, d_model, d_inner_hid, 0.0,
                         prefix=param_prefix, caches=caches,
                         cross_kvs=cross)
    return layers.fc(input=dec_output, size=trg_vocab_size,
                     num_flatten_dims=2, bias_attr=False,
                     param_attr=_attr(False, _nm(param_prefix,
                                                 "vocab_proj.w")))


# ---------------------------------------------------------------------------
# the paged serving towers (serving/paged_decoder.build_unified_program)
# ---------------------------------------------------------------------------

def paged_prefill_chunk(pf_word, pf_pos, pf_base, pf_len, enc_table,
                        enc_pages, cross_pages, w_offsets, pool,
                        src_vocab_size, max_length, n_layer, n_head, d_key,
                        d_value, d_model, d_inner_hid, param_prefix,
                        kv_scales=None, mp_shard=False):
    """One chunked-prefill tower step: encode up to C source tokens per
    lane CAUSALLY against the lane's paged encoder-KV prefix, and
    project + page-write the chunk's cross-attention K/V.  The causal
    encoder makes chunked prefill exact and a prefix's K/V a function of
    the prefix alone (what makes prefix sharing sound).

    Feeds: ``pf_word``/``pf_pos`` [b, C] int64 (chunk tokens at GLOBAL
    positions), ``pf_base`` [b] int32 (chunk start), ``pf_len`` [b]
    int32 (encoded length INCLUDING this chunk), ``enc_table`` [b, P]
    int32, ``enc_pages``/``cross_pages``/``w_offsets`` [b, C] int32
    per-token write targets (trash page 0 for dead tokens and lanes).
    ``kv_scales`` (int8 pools) is the [1, R, page_size] fp32 block-scale
    sidecar: K/V quantize on write and dequantize inside the ragged
    attention walk.  Returns the chunk's encoder output [b, C, d_model]."""
    if not param_prefix:
        raise ValueError("paged_prefill_chunk requires param_prefix")
    emb = prepare_embedding(pf_word, pf_pos, src_vocab_size, max_length,
                            d_model, 0.0,
                            emb_name=_nm(param_prefix, "src_emb.w"),
                            pos_name=_nm(param_prefix, "src_pos_emb.w"))
    paged = [{"pool": pool, "table": enc_table, "pages": enc_pages,
              "offsets": w_offsets, "lengths": pf_len, "base": pf_base,
              "layer": i, "n_layer": n_layer, "scales": kv_scales}
             for i in range(n_layer)]
    enc_chunk = encoder(emb, None, n_layer, n_head, d_key, d_value,
                        d_model, d_inner_hid, 0.0, mp_shard=mp_shard,
                        prefix=param_prefix, paged_caches=paged)
    b, c = enc_chunk.shape[0], enc_chunk.shape[1]

    def heads(x, d_head):
        return layers.reshape(x, [-1 if b == -1 else b, c, n_head, d_head])

    for i in range(n_layer):
        pre = _nm(param_prefix, f"dec{i}.cross")
        k = layers.fc(input=enc_chunk, size=d_key * n_head,
                      bias_attr=False, num_flatten_dims=2,
                      param_attr=_attr(mp_shard, _nm(pre, "k.w")))
        v = layers.fc(input=enc_chunk, size=d_value * n_head,
                      bias_attr=False, num_flatten_dims=2,
                      param_attr=_attr(mp_shard, _nm(pre, "v.w")))
        if kv_scales is not None:
            pool, kv_scales = layers.quantized_paged_cache_write(
                pool, kv_scales, heads(k, d_key), heads(v, d_value),
                cross_pages, w_offsets, layer=i, n_layer=n_layer)
        else:
            pool = layers.paged_cache_write(pool, heads(k, d_key),
                                            heads(v, d_value), cross_pages,
                                            w_offsets, layer=i,
                                            n_layer=n_layer)
    return enc_chunk


def paged_decode_step(trg_word, trg_pos, self_table, self_pages,
                      self_offsets, self_lengths, self_base, cross_table,
                      src_lengths, pool, trg_vocab_size, max_length,
                      n_layer, n_head, d_key, d_value, d_model, d_inner_hid,
                      param_prefix, kv_scales=None, mp_shard=False):
    """One paged incremental decode step: each lane's token K/V lands in
    its self pages (``self_pages``/``self_offsets`` [b, 1] int32) and
    attention walks ``self_table``/``cross_table`` [b, P] int32 under
    ``self_lengths``/``src_lengths``.  Returns logits [b, 1, vocab].  The
    1-token case of ``verify_step`` (the same op sequence)."""
    return verify_step(trg_word, trg_pos, self_table, self_pages,
                       self_offsets, self_lengths, self_base, cross_table,
                       src_lengths, pool, trg_vocab_size, max_length,
                       n_layer, n_head, d_key, d_value, d_model,
                       d_inner_hid, param_prefix, kv_scales=kv_scales,
                       n_tokens=1, mp_shard=mp_shard)


def verify_step(trg_word, trg_pos, self_table, self_pages, self_offsets,
                self_lengths, self_base, cross_table, src_lengths, pool,
                trg_vocab_size, max_length, n_layer, n_head, d_key,
                d_value, d_model, d_inner_hid, param_prefix,
                kv_scales=None, n_tokens=1, logit_mask=None,
                mp_shard=False):
    """Score ``n_tokens`` (K) positions per lane in one step.

    Feeds: ``trg_word``/``trg_pos`` [b, K] int64 (the lane's tokens at
    GLOBAL positions base..base+K-1), ``self_pages``/``self_offsets``
    [b, K] int32 per-token write targets (trash page 0 past the lane's
    live tokens), ``self_lengths`` [b] int32 (= base + live tokens),
    ``self_base`` [b] int32.  Each token's K/V scatters into the lane's
    self pages and the K queries attend CAUSALLY over the lane's page
    list (query j reads keys <= base + j), then over its cross pages.
    ``logit_mask``, an additive [b, K, vocab] float32 feed, is added to
    the logits (constrained generation with masks as data).  Returns
    logits [b, K, vocab]."""
    if not param_prefix:
        raise ValueError("verify_step requires param_prefix")
    emb = prepare_embedding(trg_word, trg_pos, trg_vocab_size, max_length,
                            d_model, 0.0,
                            emb_name=_nm(param_prefix, "trg_emb.w"),
                            pos_name=_nm(param_prefix, "trg_pos_emb.w"))
    emb = layers.reshape(emb, [-1, int(n_tokens), d_model])
    paged_caches = [{"pool": pool, "table": self_table,
                     "pages": self_pages, "offsets": self_offsets,
                     "lengths": self_lengths, "base": self_base,
                     "layer": i, "n_layer": n_layer, "scales": kv_scales}
                    for i in range(n_layer)]
    paged_crosses = [{"pool": pool, "table": cross_table,
                      "lengths": src_lengths, "layer": i,
                      "n_layer": n_layer, "scales": kv_scales}
                     for i in range(n_layer)]
    dec_output = decoder(emb, None, None, None, n_layer, n_head, d_key,
                         d_value, d_model, d_inner_hid, 0.0,
                         mp_shard=mp_shard, prefix=param_prefix,
                         paged_caches=paged_caches,
                         paged_crosses=paged_crosses)
    logits = layers.fc(input=dec_output, size=trg_vocab_size,
                       num_flatten_dims=2, bias_attr=False,
                       param_attr=_attr(False, _nm(param_prefix,
                                                   "vocab_proj.w")))
    if logit_mask is not None:
        logits = layers.elementwise_add(logits, logit_mask)
    return logits
