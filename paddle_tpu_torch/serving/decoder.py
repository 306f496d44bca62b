"""Transformer dimensions and the dense-cache byte count — the parts of
``paddle_tpu/serving/decoder.py`` that the paged generator shares.  The
dense ``TransformerGenerator`` itself is not ported yet."""

from __future__ import annotations

__all__ = ["dense_kv_bytes_per_slot"]


class _Cfg:
    """Transformer dims shared by every model the generators build."""

    __slots__ = ("src_vocab_size", "trg_vocab_size", "n_layer", "n_head",
                 "d_key", "d_value", "d_model", "d_inner_hid", "max_length")

    def __init__(self, src_vocab_size, trg_vocab_size, n_layer, n_head,
                 d_key, d_value, d_model, d_inner_hid, max_length):
        self.src_vocab_size = src_vocab_size
        self.trg_vocab_size = trg_vocab_size
        self.n_layer = n_layer
        self.n_head = n_head
        self.d_key = d_key
        self.d_value = d_value
        self.d_model = d_model
        self.d_inner_hid = d_inner_hid
        self.max_length = max_length


def dense_kv_bytes_per_slot(cfg: "_Cfg", src_len: int,
                            max_out_len: int) -> int:
    """Device bytes one continuous-batching lane costs in the DENSE
    decoder: worst-case cross K/V (src_len rows) + self K/V (max_out_len
    rows) across every layer, float32 — the baseline the paged pool's
    bytes in use are compared against."""
    return (cfg.n_layer * cfg.n_head * (cfg.d_key + cfg.d_value) * 4
            * (src_len + max_out_len))
