"""Transformer (encoder-decoder NMT) for paged serving — the port of the
serving graphs of ``paddle_tpu/models/transformer.py``.

The reference builds these graphs from Fluid ops; here they are
``nn.Module``s that run the same op sequence eagerly:

* ``prepare_embedding`` — word embedding x sqrt(d_model) + position
  embedding;
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

import torch
import torch.nn.functional as F
from torch import nn

from ..fluid.ops.cache_ops import (paged_cache_write,
                                   quantized_paged_cache_write)
from ..kernels.flash_attention import ragged_decode_attention

__all__ = ["PagedTransformer", "prepare_embedding", "MultiHeadAttention",
           "FeedForward", "PostProcess", "EncoderLayer", "DecoderLayer",
           "Linear", "LayerNorm"]

LN_EPS = 1e-5


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


def prepare_embedding(word: Embedding, pos: Embedding, word_ids: torch.Tensor,
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
        x = prepare_embedding(self.src_emb, self.src_pos_emb, f["pf_word"],
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
        x = prepare_embedding(self.trg_emb, self.trg_pos_emb, f["trg_word"],
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
