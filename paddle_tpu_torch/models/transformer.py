"""Transformer (encoder-decoder NMT) — the port of
``paddle_tpu/models/transformer.py``: the Fluid training graph and the
paged serving model.

Training.  ``transformer()`` and its builders (``multi_head_attention``
on the fused path, ``positionwise_feed_forward``,
``pre_post_process_layer``, ``encoder(_layer)``, ``decoder(_layer)``,
``prepare_embedding``, ``wrap_encoder``) append Fluid ops through
``fluid.layers`` exactly as the reference does, so both packages build
byte-identical programs; ``fluid.Executor`` runs them.  Every attention
is one ``fused_attention`` op in the ``blhd`` layout (the flash kernels
on the card).  ``amp_dtype="bfloat16"`` is the reference's bf16 recipe:
bf16 activations from one cast at each embedding, f32 master weights.
Not ported: the unfused matmul + softmax attention, ``mp_shard`` and
``seq_parallel``.

Serving.  The reference builds its serving graphs from Fluid ops too;
here they are ``nn.Module``s that run the same op sequence eagerly:

* ``embed_tokens`` — word embedding x sqrt(d_model) + position
  embedding (the builder ``prepare_embedding`` with dropout off);
* ``MultiHeadAttention`` in its two paged modes — ``paged_cache``
  (project q/k/v, write K/V into the pool, attend causally over the
  lane's pages: write-then-attend) and ``paged_static`` (project q,
  attend over cross pages written at prefill);
* ``FeedForward`` (``positionwise_feed_forward``: fc1 + relu, fc2);
* ``PostProcess`` — the "dan" chain: dropout (off in serving), residual
  add, ``layer_norm`` over the last axis with epsilon 1e-5;
* ``EncoderLayer`` / ``DecoderLayer``;
* ``PagedTransformer`` with ``paged_prefill_chunk``, ``verify_step``
  (K = 1, the plain decode step) and ``unified_step``: the chunked
  prefill tower and the decode step of every lane in one call, then the
  vocab projection and the argmax — what the reference's
  ``build_unified_program`` computes.

Weights keep Fluid's ``[in, out]`` layout, and every parameter's
``state_dict`` key is its Fluid name without the prefix
(``enc0.self.q.w``, ``dec1.cross.k.w``, ``enc0.post_ffn.ln2.w``,
``vocab_proj.w``), so weights carry across from a JAX scope by name.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..fluid import ParamAttr, layers, unique_name
from ..fluid.ops.cache_ops import (paged_cache_write,
                                   quantized_paged_cache_write)
from ..kernels.flash_attention import ragged_decode_attention

__all__ = ["transformer", "multi_head_attention", "positionwise_feed_forward",
           "pre_post_process_layer", "encoder_layer", "encoder",
           "decoder_layer", "decoder", "prepare_embedding", "wrap_encoder",
           "make_attn_bias", "PagedTransformer", "embed_tokens",
           "MultiHeadAttention", "FeedForward", "PostProcess",
           "EncoderLayer", "DecoderLayer", "Linear", "LayerNorm"]

LN_EPS = 1e-5


# ---------------------------------------------------------------------------
# the Fluid training graph
# ---------------------------------------------------------------------------

def _nm(prefix, key):
    """Parameter name under an explicit prefix; None keeps auto-naming.
    ``transformer(param_prefix=...)`` names every parameter, which is how
    a trained scope reaches ``PagedTransformerGenerator.load_params``."""
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
                         causal=False, prefix=None):
    """Project q/k/v, attend with one ``fused_attention`` op on the
    head-interleaved [b, l, h, d] tensors (``layout='blhd'``: no
    split-heads transposes), merge heads, output projection.
    ``causal=True`` masks future keys inside the kernel instead of
    through a materialised bias; attention-probability dropout happens
    inside the kernel too.  Only the fused path is ported."""
    if not fused:
        raise NotImplementedError("multi_head_attention(fused=False): the "
                                  "matmul + softmax composition is not "
                                  "ported to paddle_tpu_torch")
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

    k = layers.fc(input=keys, size=d_key * n_head, bias_attr=False,
                  num_flatten_dims=2,
                  param_attr=_attr(mp_shard, _nm(prefix, "k.w")))
    v = layers.fc(input=values, size=d_value * n_head, bias_attr=False,
                  num_flatten_dims=2,
                  param_attr=_attr(mp_shard, _nm(prefix, "v.w")))
    q = interleave_heads(q, d_key)      # [b, lq, h, dk]
    k = interleave_heads(k, d_key)
    v = interleave_heads(v, d_value)
    ctx = layers.fused_attention(q, k, v, bias=attn_bias, causal=causal,
                                 sm_scale=float(d_key) ** -0.5,
                                 dropout_rate=dropout_rate, layout="blhd")
    b, l = ctx.shape[0], ctx.shape[1]
    return layers.fc(
        input=layers.reshape(ctx, [-1 if b == -1 else b, l,
                                   n_head * d_value]),
        size=d_model, bias_attr=False, num_flatten_dims=2,
        param_attr=o_attr)


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
                  fused=False, seq_parallel=False, prefix=None):
    attn_output = multi_head_attention(
        enc_input, enc_input, enc_input, attn_bias, d_key, d_value, d_model,
        n_head, dropout_rate, mp_shard, fused, seq_parallel,
        prefix=_nm(prefix, "self"))
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
            seq_parallel=False, prefix=None):
    for i in range(n_layer):
        enc_input = encoder_layer(enc_input, attn_bias, n_head, d_key,
                                  d_value, d_model, d_inner_hid,
                                  dropout_rate, mp_shard, fused,
                                  seq_parallel, prefix=_nm(prefix, f"enc{i}"))
    return enc_input


def decoder_layer(dec_input, enc_output, slf_attn_bias, dec_enc_attn_bias,
                  n_head, d_key, d_value, d_model, d_inner_hid,
                  dropout_rate=0.0, mp_shard=False, fused=False,
                  seq_parallel=False, causal=False, prefix=None):
    """One decoder layer of the training graph: self-attention over the
    whole target (``slf_attn_bias`` or ``causal``), cross-attention over
    the encoder output, feed-forward."""
    slf_attn = multi_head_attention(dec_input, dec_input, dec_input,
                                    slf_attn_bias, d_key, d_value, d_model,
                                    n_head, dropout_rate, mp_shard, fused,
                                    seq_parallel, causal=causal,
                                    prefix=_nm(prefix, "self"))
    slf_attn = pre_post_process_layer(dec_input, slf_attn, "dan",
                                      dropout_rate,
                                      prefix=_nm(prefix, "post_self"))
    cross = multi_head_attention(slf_attn, enc_output, enc_output,
                                 dec_enc_attn_bias, d_key, d_value, d_model,
                                 n_head, dropout_rate, mp_shard, fused,
                                 seq_parallel, prefix=_nm(prefix, "cross"))
    cross = pre_post_process_layer(slf_attn, cross, "dan", dropout_rate,
                                   prefix=_nm(prefix, "post_cross"))
    ffd = positionwise_feed_forward(cross, d_inner_hid, d_model, mp_shard,
                                    prefix=_nm(prefix, "ffn"))
    return pre_post_process_layer(cross, ffd, "dan", dropout_rate,
                                  prefix=_nm(prefix, "post_ffn"))


def decoder(dec_input, enc_output, slf_attn_bias, dec_enc_attn_bias,
            n_layer, n_head, d_key, d_value, d_model, d_inner_hid,
            dropout_rate=0.0, mp_shard=False, fused=False,
            seq_parallel=False, causal=False, prefix=None):
    for i in range(n_layer):
        dec_input = decoder_layer(dec_input, enc_output, slf_attn_bias,
                                  dec_enc_attn_bias, n_head, d_key, d_value,
                                  d_model, d_inner_hid, dropout_rate,
                                  mp_shard, fused, seq_parallel,
                                  causal=causal, prefix=_nm(prefix, f"dec{i}"))
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


# ---------------------------------------------------------------------------
# the paged serving model
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    """Fluid ``fc`` with ``num_flatten_dims=2``: ``x @ w (+ b)``, weight
    ``[in, out]``."""

    def __init__(self, d_in: int, d_out: int, bias: bool = False):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out))
        self.b = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.w)
        return y if self.b is None else y + self.b


class LayerNorm(nn.Module):
    """Fluid ``layer_norm`` over the last axis (scale ``w``, shift ``b``)."""

    def __init__(self, d: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d))
        self.b = nn.Parameter(torch.empty(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.w, self.b, LN_EPS)


class Embedding(nn.Module):
    """Fluid ``embedding`` table ``w [rows, d]``."""

    def __init__(self, rows: int, d: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(rows, d))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.w[ids]


def embed_tokens(word: Embedding, pos: Embedding, word_ids: torch.Tensor,
                 pos_ids: torch.Tensor) -> torch.Tensor:
    """word_emb[ids] * sqrt(d_model) + pos_emb[pos] (the reference's
    ``prepare_embedding`` with dropout off)."""
    d_model = word.w.shape[1]
    return word(word_ids) * float(d_model) ** 0.5 + pos(pos_ids)


class MultiHeadAttention(nn.Module):
    """Paged multi-head attention.  ``paged_cache`` and ``paged_static``
    are dicts as in the reference: ``{"pool", "table", "pages",
    "offsets", "lengths", "base", "layer", "n_layer", "scales"}`` and
    ``{"pool", "table", "lengths", "layer", "n_layer", "scales"}``."""

    def __init__(self, d_model: int, n_head: int, d_key: int, d_value: int):
        super().__init__()
        self.n_head, self.d_key, self.d_value = n_head, d_key, d_value
        self.q = Linear(d_model, d_key * n_head)
        self.k = Linear(d_model, d_key * n_head)
        self.v = Linear(d_model, d_value * n_head)
        self.out = Linear(d_value * n_head, d_model)

    def heads(self, x: torch.Tensor, d_head: int) -> torch.Tensor:
        """[b, l, h * d] -> [b, l, h, d] (the reference's
        interleave_heads reshape)."""
        return x.reshape(x.shape[0], x.shape[1], self.n_head, d_head)

    def forward(self, x: torch.Tensor, paged_cache: Optional[Dict] = None,
                paged_static: Optional[Dict] = None) -> torch.Tensor:
        if (paged_cache is None) == (paged_static is None):
            raise ValueError("MultiHeadAttention: pass exactly one of "
                             "paged_cache / paged_static")
        q = self.heads(self.q(x), self.d_key)
        sm_scale = float(self.d_key) ** -0.5
        if paged_static is not None:
            ps = paged_static
            ctx = ragged_decode_attention(
                q, ps["pool"], ps["table"], ps["lengths"],
                layer=ps["layer"], n_layer=ps["n_layer"], causal=False,
                sm_scale=sm_scale, scales=ps.get("scales"))
        else:
            pc = paged_cache
            k = self.heads(self.k(x), self.d_key)
            v = self.heads(self.v(x), self.d_value)
            scales = pc.get("scales")
            if scales is not None:          # int8 pool: quantize on write
                quantized_paged_cache_write(
                    pc["pool"], scales, k, v, pc["pages"], pc["offsets"],
                    layer=pc["layer"], n_layer=pc["n_layer"])
            else:
                paged_cache_write(pc["pool"], k, v, pc["pages"],
                                  pc["offsets"], layer=pc["layer"],
                                  n_layer=pc["n_layer"])
            ctx = ragged_decode_attention(
                q, pc["pool"], pc["table"], pc["lengths"], pc["base"],
                layer=pc["layer"], n_layer=pc["n_layer"], causal=True,
                sm_scale=sm_scale, scales=scales)
        b, l = ctx.shape[0], ctx.shape[1]
        return self.out(ctx.reshape(b, l, self.n_head * self.d_value))


class FeedForward(nn.Module):
    """relu(x @ fc1.w + fc1.b) @ fc2.w + fc2.b."""

    def __init__(self, d_model: int, d_inner_hid: int):
        super().__init__()
        self.fc1 = Linear(d_model, d_inner_hid, bias=True)
        self.fc2 = Linear(d_inner_hid, d_model, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))


class PostProcess(nn.Module):
    """The "dan" chain: (dropout, off in serving), residual add, layer
    norm.  The norm is the chain's third command, hence ``ln2``."""

    def __init__(self, d_model: int):
        super().__init__()
        self.ln2 = LayerNorm(d_model)

    def forward(self, prev: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        return self.ln2(out + prev)


def _register(module: nn.Module, name: str, child: nn.Module) -> nn.Module:
    """Register ``child`` under a Fluid name that is not a valid or
    convenient attribute name (``self``, ``enc0``)."""
    module.add_module(name, child)
    return child


class EncoderLayer(nn.Module):
    def __init__(self, d_model, n_head, d_key, d_value, d_inner_hid):
        super().__init__()
        _register(self, "self", MultiHeadAttention(d_model, n_head, d_key,
                                                   d_value))
        self.post_self = PostProcess(d_model)
        self.ffn = FeedForward(d_model, d_inner_hid)
        self.post_ffn = PostProcess(d_model)

    @property
    def attn(self) -> MultiHeadAttention:
        """The self-attention, registered under its Fluid name ``self``."""
        return self._modules["self"]

    def forward(self, x: torch.Tensor, paged_cache: Dict) -> torch.Tensor:
        x = self.post_self(x, self.attn(x, paged_cache=paged_cache))
        return self.post_ffn(x, self.ffn(x))


class DecoderLayer(nn.Module):
    def __init__(self, d_model, n_head, d_key, d_value, d_inner_hid):
        super().__init__()
        _register(self, "self", MultiHeadAttention(d_model, n_head, d_key,
                                                   d_value))
        self.post_self = PostProcess(d_model)
        # cross.k/cross.v project the encoder output at prefill
        # (PagedTransformer.paged_prefill_chunk); decode reads the pages
        self.cross = MultiHeadAttention(d_model, n_head, d_key, d_value)
        self.post_cross = PostProcess(d_model)
        self.ffn = FeedForward(d_model, d_inner_hid)
        self.post_ffn = PostProcess(d_model)

    @property
    def attn(self) -> MultiHeadAttention:
        """The self-attention, registered under its Fluid name ``self``."""
        return self._modules["self"]

    def forward(self, x: torch.Tensor, paged_cache: Dict,
                paged_static: Dict) -> torch.Tensor:
        x = self.post_self(x, self.attn(x, paged_cache=paged_cache))
        x = self.post_cross(x, self.cross(x, paged_static=paged_static))
        return self.post_ffn(x, self.ffn(x))


class PagedTransformer(nn.Module):
    """The paged serving model: chunked causal prefill tower plus the
    paged decode step.  Parameter keys are the Fluid names without the
    ``param_prefix``."""

    def __init__(self, src_vocab_size, trg_vocab_size, n_layer, n_head,
                 d_key, d_value, d_model, d_inner_hid, max_length):
        super().__init__()
        self.n_layer = int(n_layer)
        self.d_key, self.d_value = d_key, d_value
        self.src_emb = Embedding(src_vocab_size, d_model)
        self.src_pos_emb = Embedding(max_length, d_model)
        self.trg_emb = Embedding(trg_vocab_size, d_model)
        self.trg_pos_emb = Embedding(max_length, d_model)
        self.enc = [_register(self, f"enc{i}", EncoderLayer(
            d_model, n_head, d_key, d_value, d_inner_hid))
            for i in range(n_layer)]
        self.dec = [_register(self, f"dec{i}", DecoderLayer(
            d_model, n_head, d_key, d_value, d_inner_hid))
            for i in range(n_layer)]
        self.vocab_proj = Linear(d_model, trg_vocab_size)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` (a CPU ``torch.Generator``):
        Xavier-uniform matrices and tables, unit norm scales, zero
        biases — the Fluid defaults' shapes of distribution.  Values are
        drawn on the CPU and copied, so one seed gives the same weights
        on every device."""
        for name, p in self.named_parameters():
            if p.dim() == 2:
                lim = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                val = torch.empty(p.shape).uniform_(-lim, lim,
                                                    generator=generator)
            elif name.endswith("ln2.w"):
                val = torch.ones(p.shape)
            else:
                val = torch.zeros(p.shape)
            p.copy_(val)

    def _paged(self, pool, scales, table, lengths, layer, pages=None,
               offsets=None, base=None) -> Dict:
        return {"pool": pool, "scales": scales, "table": table,
                "pages": pages, "offsets": offsets, "lengths": lengths,
                "base": base, "layer": layer, "n_layer": self.n_layer}

    def paged_prefill_chunk(self, f: Dict[str, torch.Tensor], pool,
                            scales=None) -> torch.Tensor:
        """One chunked-prefill tower step: encode up to C source tokens
        per lane CAUSALLY against the lane's paged encoder-KV prefix, then
        project and page-write the chunk's cross-attention K/V.  Feeds as
        in the reference: ``pf_word``/``pf_pos`` [b, C], ``pf_base``,
        ``pf_len`` [b], ``enc_table`` [b, P], ``enc_pages``,
        ``cross_pages``, ``w_offsets`` [b, C].  Writes ``pool`` (and
        ``scales``) in place; returns the encoder output [b, C, d]."""
        x = embed_tokens(self.src_emb, self.src_pos_emb, f["pf_word"],
                         f["pf_pos"])
        for i, layer in enumerate(self.enc):
            x = layer(x, self._paged(pool, scales, f["enc_table"],
                                     f["pf_len"], i, f["enc_pages"],
                                     f["w_offsets"], f["pf_base"]))
        for i, layer in enumerate(self.dec):
            k = layer.cross.heads(layer.cross.k(x), self.d_key)
            v = layer.cross.heads(layer.cross.v(x), self.d_value)
            if scales is not None:
                quantized_paged_cache_write(pool, scales, k, v,
                                            f["cross_pages"],
                                            f["w_offsets"], layer=i,
                                            n_layer=self.n_layer)
            else:
                paged_cache_write(pool, k, v, f["cross_pages"],
                                  f["w_offsets"], layer=i,
                                  n_layer=self.n_layer)
        return x

    def verify_step(self, f: Dict[str, torch.Tensor], pool,
                    scales=None) -> torch.Tensor:
        """The paged decode step over every lane: each lane's tokens
        (``trg_word``/``trg_pos`` [b, K]) write K/V into its self pages
        and attend causally over ``self_table``, then attend over its
        cross pages.  Returns logits [b, K, vocab]."""
        x = embed_tokens(self.trg_emb, self.trg_pos_emb, f["trg_word"],
                         f["trg_pos"])
        for i, layer in enumerate(self.dec):
            x = layer(x,
                      self._paged(pool, scales, f["self_table"],
                                  f["self_lengths"], i, f["self_pages"],
                                  f["self_offsets"], f["self_base"]),
                      self._paged(pool, scales, f["cross_table"],
                                  f["src_lengths"], i))
        return self.vocab_proj(x)

    @torch.no_grad()
    def unified_step(self, f: Dict[str, torch.Tensor], pool, scales=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's unified program: the prefill tower, then the
        decode step, on one pool.  Returns (next_ids int32 [b, K],
        logits [b, K, vocab])."""
        self.paged_prefill_chunk(f, pool, scales)
        logits = self.verify_step(f, pool, scales)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits
