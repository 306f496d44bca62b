"""Dense KV-cache Transformer decoding (greedy and beam) and the
full-re-run decoder it replaces — the port of
``paddle_tpu/serving/decoder.py``.

``TransformerGenerator`` decodes over dense per-lane caches:

* **prefill** — one step per request batch: encode the source and
  project every decoder layer's cross-attention K/V once
  (``models.transformer.decode_prefill``, the unfused attention);
* **decode step** — one step per emitted token: the current token's
  self-attention K/V are written into persistable ``[B, max_out_len, h,
  d]`` caches in place (``cache_write``) and attention runs over each
  lane's live rows (``decode_attention``);
* **greedy / beam** — greedy's argmax is in the program; beam runs the
  ``beam_search`` op each step, with every layer's self caches
  reordered by ``parent_idx`` in the same program (``batch_gather``,
  then ``assign`` back into the cache var), and ``beam_search_decode``
  for the backtrace.

Every program runs through ``fluid.Executor`` (default
``fluid.CUDAPlace(0)``; pass ``place=fluid.CPUPlace()`` or a CPU
executor to run on the CPU) in the generator's ``scope``: on the card
each step signature is captured once in a CUDA graph and replayed
after.  The caches are persistable scope vars, the graph's buffers once
captured; a request's fresh caches replace them in the scope and the
executor copies them into the bound buffers before the next replay.
The continuous-batching surface (``open_slots`` / ``admit_slot`` /
``clear_slot`` / ``step_slots``) writes a lane's rows of those buffers
in place.

``FullRerunDecoder`` is the baseline: the same parameters (shared by
name through the scope), decoded by re-running the whole
training-shaped forward (``transformer()``, pruned to its logits) per
emitted token.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import fluid
from ..fluid import layers
from ..fluid.core.lod import SeqArray
from ..models import transformer as T

__all__ = ["TransformerGenerator", "FullRerunDecoder", "pack_sources",
           "trim_at_end", "dense_kv_bytes_per_slot", "build_backtrace",
           "run_backtrace"]


def pack_sources(seqs: Sequence[np.ndarray], bucket: int = 8):
    """Pad a list of 1-d token arrays to a common bucketed length:
    -> (tokens [b, s] int64, lengths [b] int32)."""
    lengths = np.asarray([len(s) for s in seqs], np.int32)
    s = int(lengths.max())
    s = ((s + bucket - 1) // bucket) * bucket
    out = np.zeros((len(seqs), s), np.int64)
    for i, q in enumerate(seqs):
        out[i, : len(q)] = np.asarray(q, np.int64)
    return out, lengths


def trim_at_end(tokens: np.ndarray, end_id: int) -> List[List[int]]:
    """Cut each row at its first end_id (exclusive)."""
    out = []
    for row in np.asarray(tokens):
        hits = np.where(row == end_id)[0]
        out.append([int(t) for t in (row[: hits[0]] if hits.size else row)])
    return out


class _Cfg:
    """Transformer dims shared by every program the decoders build."""

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


def build_backtrace(end_id: int):
    """The beam backtrace program: ``beam_search_decode`` over a
    trajectory's per-step ids, scores and parents (level-1 feeds, one
    sequence a step) -> (program, sent_ids var, sent_scores var)."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        ids = layers.data("ids", [1], "int64", lod_level=1)
        scores = layers.data("scores", [1], "float32", lod_level=1)
        parents = layers.data("parents", [1], "int32", lod_level=1)
        sent_ids, sent_scores = layers.beam_search_decode(
            ids, scores, parents, end_id=end_id)
    return prog, sent_ids, sent_scores


def run_backtrace(exe, scope, backtrace, ids_steps, score_steps,
                  parent_steps):
    """``backtrace`` (``build_backtrace``'s) over a trajectory through
    ``exe`` in ``scope``.  Its signature is the trajectory's length, so
    each new length is a new step (an eager run, then a capture, on the
    card).  -> (ids NestedSeqArray [b, W, T] best first, scores)."""
    prog, sent_ids, sent_scores = backtrace
    lens = np.full(len(ids_steps), 1, np.int32)
    feed = {"ids": SeqArray(np.stack(ids_steps), lens),
            "scores": SeqArray(np.stack(score_steps), lens),
            "parents": SeqArray(np.stack(parent_steps), lens)}
    with fluid.scope_guard(scope):
        out_ids, out_scores = exe.run(
            prog, feed=feed, fetch_list=[sent_ids, sent_scores],
            mode="infer")
    return out_ids, np.asarray(out_scores)


def _host(t) -> np.ndarray:
    """A fetched device tensor as a numpy array (the step's one wait)."""
    return t.detach().cpu().numpy()


class TransformerGenerator:
    """Serving-side Transformer decoder over dense KV caches.

    Shares parameters with a training graph built by
    ``models.transformer.transformer(param_prefix=...)`` through the
    scope; ``init_params()`` random-initializes it for standalone use.
    Front ends: ``greedy(src, lengths)``, ``beam(src, lengths, W)``; the
    continuous-batching surface is ``open_slots`` / ``admit_slot`` /
    ``clear_slot`` / ``step_slots`` (``scheduler.py``).
    ``causal_encoder=True`` adds the causal triangle to the source
    attention bias: the paged engine's chunked causal prefill, so the
    two decode alike."""

    def __init__(self, src_vocab_size, trg_vocab_size, *, n_layer=6,
                 n_head=8, d_key=64, d_value=64, d_model=512,
                 d_inner_hid=2048, max_length=256, src_len=64,
                 max_out_len=64, scope=None, executor=None, place=None,
                 param_prefix="tf", start_id=0, end_id=1, src_bucket=8,
                 topk_size=None, causal_encoder=False):
        self.cfg = _Cfg(src_vocab_size, trg_vocab_size, n_layer, n_head,
                        d_key, d_value, d_model, d_inner_hid, max_length)
        self.src_len = int(src_len)
        self.max_out_len = int(max_out_len)
        self.prefix = param_prefix
        self.start_id = int(start_id)
        self.end_id = int(end_id)
        self.causal_encoder = bool(causal_encoder)
        self.src_bucket = max(1, int(src_bucket))
        self.topk_size = topk_size
        self.scope = scope or fluid.Scope()
        self.exe = executor or fluid.Executor(place or fluid.CUDAPlace(0))
        self._stats = {"bucket_hits": 0, "bucket_misses": 0}
        self._buckets: Dict[int, int] = {}
        self._prefills: Dict[int, tuple] = {}     # s_bucket -> programs
        self._beam_steps: Dict[int, tuple] = {}   # W -> programs
        self._decode_prog = None                  # the backtrace
        self._slots = None                        # open_slots batch size
        self._build_step()

    # -- cache vars ----------------------------------------------------------
    def _cache_names(self):
        p = self.prefix
        return ([(f"{p}@kcache{i}", f"{p}@vcache{i}")
                 for i in range(self.cfg.n_layer)],
                [(f"{p}@crossk{i}", f"{p}@crossv{i}")
                 for i in range(self.cfg.n_layer)])

    def _declare_caches(self, block):
        c = self.cfg
        self_names, cross_names = self._cache_names()
        self_caches, cross_caches = [], []
        for (kn, vn), (ckn, cvn) in zip(self_names, cross_names):
            self_caches.append({
                "k": block.create_var(
                    name=kn, shape=[-1, self.max_out_len, c.n_head, c.d_key],
                    dtype="float32", persistable=True),
                "v": block.create_var(
                    name=vn, shape=[-1, self.max_out_len, c.n_head,
                                    c.d_value],
                    dtype="float32", persistable=True)})
            cross_caches.append({
                "k": block.create_var(
                    name=ckn, shape=[-1, -1, c.n_head, c.d_key],
                    dtype="float32", persistable=True),
                "v": block.create_var(
                    name=cvn, shape=[-1, -1, c.n_head, c.d_value],
                    dtype="float32", persistable=True)})
        return self_caches, cross_caches

    # -- program builders ----------------------------------------------------
    def _step_feeds(self):
        tw = layers.data("trg_word", [1], "int64")
        tp = layers.data("trg_pos", [1], "int64")
        ci = layers.data("cache_index", [], "int32")
        sl = layers.data("self_lengths", [], "int32")
        srl = layers.data("src_lengths", [], "int32")
        return tw, tp, ci, sl, srl

    def _build_step(self):
        c = self.cfg
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup), fluid.unique_name.guard():
            tw, tp, ci, sl, srl = self._step_feeds()
            self_c, cross_c = self._declare_caches(prog.global_block())
            logits = T.decode_step(tw, tp, ci, sl, srl, self_c, cross_c,
                                   c.trg_vocab_size, c.max_length, c.n_layer,
                                   c.n_head, c.d_key, c.d_value, c.d_model,
                                   c.d_inner_hid, self.prefix)
            next_ids = layers.argmax(logits, axis=-1)       # [b, 1] int32
        self._step = (prog, startup, next_ids, logits)

    def _build_beam_step(self, W: int):
        c = self.cfg
        K = self.topk_size or min(2 * W, c.trg_vocab_size)
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup), fluid.unique_name.guard():
            # the beam grid rides in twice: [b, W] for the beam_search op
            # and flattened [b*W, 1] for the per-lane decode tower
            pre_ids = layers.data("pre_ids", [W], "int64")
            pre_scores = layers.data("pre_scores", [W], "float32")
            tok = layers.data("trg_word", [1], "int64")     # [bW, 1]
            tp = layers.data("trg_pos", [1], "int64")
            ci = layers.data("cache_index", [], "int32")
            sl = layers.data("self_lengths", [], "int32")
            srl = layers.data("src_lengths", [], "int32")
            self_c, cross_c = self._declare_caches(prog.global_block())
            logits = T.decode_step(tok, tp, ci, sl, srl, self_c, cross_c,
                                   c.trg_vocab_size, c.max_length, c.n_layer,
                                   c.n_head, c.d_key, c.d_value, c.d_model,
                                   c.d_inner_hid, self.prefix)
            probs = layers.softmax(
                layers.reshape(logits, [-1, W, c.trg_vocab_size]))
            topk_scores, topk_idx = layers.topk(probs, k=K)
            sel_ids, sel_scores, parent = layers.beam_search(
                pre_ids, pre_scores, topk_idx, topk_scores, W,
                end_id=self.end_id)
            # each selected hypothesis continues from its PARENT's cache:
            # every layer's k/v reordered along the beam axis in the same
            # step (the gather is a new tensor, read whole before the
            # assign writes the cache var)
            for cache in self_c:
                for key, d_head in (("k", c.d_key), ("v", c.d_value)):
                    var = cache[key]
                    flat = layers.reshape(
                        var, [-1, W, self.max_out_len * c.n_head * d_head])
                    picked = layers.batch_gather(flat, parent)
                    layers.assign(
                        layers.reshape(picked, [-1, self.max_out_len,
                                                c.n_head, d_head]),
                        output=var)
        self._beam_steps[W] = (prog, startup, sel_ids, sel_scores, parent)
        return self._beam_steps[W]

    def _build_prefill(self, s: int):
        c = self.cfg
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup), fluid.unique_name.guard():
            sw = layers.data("src_word", [s], "int64")
            sp = layers.data("src_pos", [s], "int64")
            sb = layers.data("src_slf_attn_bias", [c.n_head, s, s],
                             "float32")
            enc, kvs = T.decode_prefill(sw, sp, sb, c.src_vocab_size,
                                        c.max_length, c.n_layer, c.n_head,
                                        c.d_key, c.d_value, c.d_model,
                                        c.d_inner_hid, self.prefix)
        fetches = [enc] + [x for kv in kvs for x in kv]
        self._prefills[s] = (prog, startup, fetches)
        return self._prefills[s]

    def _build_backtrace(self):
        self._decode_prog = build_backtrace(self.end_id)
        return self._decode_prog

    # -- parameter init ------------------------------------------------------
    def init_params(self, seed: Optional[int] = None) -> None:
        """Random-init every parameter (standalone use; trained scopes
        share parameters by name instead) with the prefill and step
        startup programs, which together cover the full set.  They run
        eagerly, on an executor of their own at this generator's place: a
        program that draws on the host is never captured."""
        pre_prog, pre_start, _ = self._prefills.get(self.src_len) or \
            self._build_prefill(self.src_len)
        if seed is not None:
            pre_start.random_seed = seed
            self._step[1].random_seed = seed
        exe = fluid.Executor(self.exe.place)
        with fluid.scope_guard(self.scope):
            exe.run(pre_start)
            exe.run(self._step[1])

    # -- prefill + cache state ----------------------------------------------
    def _bucketize(self, s: int) -> int:
        b = self.src_bucket
        return min(((s + b - 1) // b) * b, self.src_len) \
            if s <= self.src_len else s

    def prefill(self, src_tokens: np.ndarray, src_lengths: np.ndarray):
        """Run the prefill tower on a padded [b, s] source batch; returns
        (enc_output, cross_ks, cross_vs) as device tensors, the cross K/V
        one per decoder layer [b, s_bucket, h, d]."""
        c = self.cfg
        src_tokens = np.asarray(src_tokens)
        src_lengths = np.asarray(src_lengths, np.int32)
        b, s_true = src_tokens.shape
        s = self._bucketize(s_true)
        if s != s_true:
            padded = np.zeros((b, s), src_tokens.dtype)
            padded[:, :s_true] = src_tokens
            src_tokens = padded
        if s in self._prefills:
            self._stats["bucket_hits"] += 1
        else:
            self._stats["bucket_misses"] += 1
        self._buckets[s] = self._buckets.get(s, 0) + 1
        prog, _, fetches = self._prefills.get(s) or self._build_prefill(s)
        feed = {"src_word": src_tokens.astype(np.int64),
                "src_pos": np.tile(np.arange(s, dtype=np.int64), (b, 1)),
                "src_slf_attn_bias": T.make_attn_bias(
                    src_lengths, s, c.n_head, causal=self.causal_encoder)}
        with fluid.scope_guard(self.scope):
            outs = self.exe.run(prog, feed=feed, fetch_list=fetches,
                                return_numpy=False, mode="infer")
        enc = outs[0]
        ks = [outs[1 + 2 * i] for i in range(c.n_layer)]
        vs = [outs[2 + 2 * i] for i in range(c.n_layer)]
        return enc, ks, vs

    def _zero_self_caches(self, batch: int):
        c = self.cfg
        self_names, _ = self._cache_names()
        for kn, vn in self_names:
            for name, d in ((kn, c.d_key), (vn, c.d_value)):
                self.scope.set_var(name, torch.zeros(
                    (batch, self.max_out_len, c.n_head, d),
                    dtype=torch.float32, device=self.exe.device))

    def _set_cross_caches(self, ks, vs, repeat: int = 1):
        _, cross_names = self._cache_names()
        for (ckn, cvn), k, v in zip(cross_names, ks, vs):
            if repeat > 1:      # beam: every hypothesis shares its source
                k = torch.repeat_interleave(k, repeat, dim=0)
                v = torch.repeat_interleave(v, repeat, dim=0)
            self.scope.set_var(ckn, k)
            self.scope.set_var(cvn, v)

    # -- greedy --------------------------------------------------------------
    def greedy(self, src_tokens, src_lengths, max_new: Optional[int] = None,
               stop_at_end: bool = True) -> np.ndarray:
        """KV-cache greedy decode of a whole batch; returns the raw token
        matrix [b, n_steps] (trim with ``trim_at_end``).  Each step feeds
        the last step's ids as they lie on the device; reading them is
        the step's one wait."""
        src_tokens = np.asarray(src_tokens)
        src_lengths = np.asarray(src_lengths, np.int32)
        b = src_tokens.shape[0]
        max_new = min(max_new or self.max_out_len, self.max_out_len)
        _, ks, vs = self.prefill(src_tokens, src_lengths)
        self._zero_self_caches(b)
        self._set_cross_caches(ks, vs)
        prog, _, next_ids, _logits = self._step
        cur = np.full((b, 1), self.start_id, np.int64)
        out = []
        done = np.zeros(b, bool)
        with fluid.scope_guard(self.scope):
            for t in range(max_new):
                feed = {"trg_word": cur,
                        "trg_pos": np.full((b, 1), t, np.int64),
                        "cache_index": np.full(b, t, np.int32),
                        "self_lengths": np.full(b, t + 1, np.int32),
                        "src_lengths": src_lengths}
                nxt, = self.exe.run(prog, feed=feed, fetch_list=[next_ids],
                                    return_numpy=False, mode="infer")
                host = _host(nxt).reshape(b)
                out.append(host)
                done |= (host == self.end_id)
                if stop_at_end and done.all():
                    break
                cur = nxt
        return np.stack(out, axis=1)

    # -- beam ----------------------------------------------------------------
    def beam(self, src_tokens, src_lengths, beam_size: int,
             max_new: Optional[int] = None, return_trace: bool = False):
        """KV-cache beam decode: the beam_search op each step and
        beam_search_decode for the backtrace.  Returns (NestedSeqArray
        [b, W, T] best first, scores [b, W]), and with
        ``return_trace=True`` the per-step (ids, scores, parents)
        trajectory too."""
        W = int(beam_size)
        src_tokens = np.asarray(src_tokens)
        src_lengths = np.asarray(src_lengths, np.int32)
        b = src_tokens.shape[0]
        max_new = min(max_new or self.max_out_len, self.max_out_len)
        _, ks, vs = self.prefill(src_tokens, src_lengths)
        self._zero_self_caches(b * W)
        self._set_cross_caches(ks, vs, repeat=W)
        prog, _, sel_ids_v, sel_scores_v, parent_v = \
            self._beam_steps.get(W) or self._build_beam_step(W)

        lane_src_lengths = np.repeat(src_lengths, W)
        pre_ids = np.full((b, W), self.start_id, np.int64)
        pre_scores = np.concatenate(
            [np.zeros((b, 1), np.float32),
             np.full((b, W - 1), -1e9, np.float32)], axis=1)
        ids_steps = [pre_ids]
        score_steps = [pre_scores]
        parent_steps = [np.zeros((b, W), np.int32)]
        with fluid.scope_guard(self.scope):
            for t in range(max_new):
                feed = {"pre_ids": pre_ids, "pre_scores": pre_scores,
                        "trg_word": pre_ids.reshape(b * W, 1),
                        "trg_pos": np.full((b * W, 1), t, np.int64),
                        "cache_index": np.full(b * W, t, np.int32),
                        "self_lengths": np.full(b * W, t + 1, np.int32),
                        "src_lengths": lane_src_lengths}
                si, ss, pa = self.exe.run(
                    prog, feed=feed,
                    fetch_list=[sel_ids_v, sel_scores_v, parent_v],
                    mode="infer")
                pre_ids = np.asarray(si).astype(np.int64)
                pre_scores = np.asarray(ss).astype(np.float32)
                ids_steps.append(pre_ids)
                score_steps.append(pre_scores)
                parent_steps.append(np.asarray(pa).astype(np.int32))
                if (pre_ids == self.end_id).all():
                    break
        out_ids, out_scores = self._backtrace(ids_steps, score_steps,
                                              parent_steps)
        if return_trace:
            return out_ids, out_scores, (ids_steps, score_steps,
                                         parent_steps)
        return out_ids, out_scores

    def _backtrace(self, ids_steps, score_steps, parent_steps):
        return run_backtrace(self.exe, self.scope,
                             self._decode_prog or self._build_backtrace(),
                             ids_steps, score_steps, parent_steps)

    # -- continuous-batching surface (scheduler.py) --------------------------
    def open_slots(self, n_slots: int) -> None:
        """Allocate the fixed in-flight batch: zeroed self caches and
        cross caches at the configured src_len for ``n_slots`` lanes."""
        c = self.cfg
        self._slots = int(n_slots)
        self._zero_self_caches(self._slots)
        _, cross_names = self._cache_names()
        for ckn, cvn in cross_names:
            for name, d in ((ckn, c.d_key), (cvn, c.d_value)):
                self.scope.set_var(name, torch.zeros(
                    (self._slots, self.src_len, c.n_head, d),
                    dtype=torch.float32, device=self.exe.device))

    def admit_slot(self, slot: int, src_tokens_1d) -> int:
        """Prefill ONE request (bucketed source length) and write its
        cross K/V into lane ``slot`` of the cross caches, zero the lane's
        self caches (both in place).  Returns the true source length (the
        lane's src_lengths entry)."""
        if self._slots is None:
            raise RuntimeError("open_slots() before admit_slot()")
        src = np.asarray(src_tokens_1d).reshape(1, -1)
        s_true = src.shape[1]
        if s_true > self.src_len:
            # the slot's cross caches are fixed at src_len; truncating
            # would serve a different prompt than greedy()/prefill()
            raise ValueError(
                f"admit_slot: prompt length {s_true} exceeds the "
                f"generator's src_len {self.src_len}; raise src_len or "
                f"truncate explicitly at the call site")
        _, ks, vs = self.prefill(src, np.array([s_true], np.int32))
        self_names, cross_names = self._cache_names()
        for i, (ckn, cvn) in enumerate(cross_names):
            for name, lane in ((ckn, ks[i]), (cvn, vs[i])):
                cur = self.scope.find_var(name)
                cur[slot].zero_()
                cur[slot, :lane.shape[1]] = lane[0]
        self.clear_slot(slot)
        return s_true

    def clear_slot(self, slot: int) -> None:
        """Zero a lane's self caches (its cross K/V is overwritten at the
        next admission)."""
        self_names, _ = self._cache_names()
        for kn, vn in self_names:
            for name in (kn, vn):
                self.scope.find_var(name)[slot].zero_()

    def step_slots(self, tokens, positions, src_lengths) -> np.ndarray:
        """One decode step across every lane at its own write position
        and mask length (continuous batching).  Returns the next tokens
        [B] int32."""
        b = self._slots
        tokens = np.asarray(tokens)
        positions = np.asarray(positions, np.int64)
        prog, _, next_ids, _logits = self._step
        feed = {"trg_word": tokens.reshape(b, 1).astype(np.int64),
                "trg_pos": positions.reshape(b, 1),
                "cache_index": positions.reshape(b).astype(np.int32),
                "self_lengths": (positions.reshape(b) + 1).astype(np.int32),
                "src_lengths": np.asarray(src_lengths, np.int32)}
        with fluid.scope_guard(self.scope):
            nxt, = self.exe.run(prog, feed=feed, fetch_list=[next_ids],
                                return_numpy=False, mode="infer")
        return _host(nxt).reshape(b)

    def kv_bytes_per_slot(self) -> int:
        """Device bytes one continuous-batching lane costs in this dense
        decoder (what the paged pool saves): ``dense_kv_bytes_per_slot``."""
        return dense_kv_bytes_per_slot(self.cfg, self.src_len,
                                       self.max_out_len)

    def cache_stats(self) -> Dict[str, object]:
        """Prefill bucket hits and misses beside the executor's
        executable-cache counters."""
        out: Dict[str, object] = dict(self._stats)
        out["buckets"] = dict(self._buckets)
        out["executable"] = self.exe.cache_stats()["executable"]
        out["kv_bytes_per_slot"] = self.kv_bytes_per_slot()
        return out


class FullRerunDecoder:
    """The O(L^2) baseline: greedy and beam decoding by re-running the
    whole training-shaped forward (``transformer()`` with the unfused
    attention, pruned to its logits) per emitted token.  Shares
    parameters with a ``TransformerGenerator`` by name through the
    scope."""

    def __init__(self, src_vocab_size, trg_vocab_size, *, n_layer=6,
                 n_head=8, d_key=64, d_value=64, d_model=512,
                 d_inner_hid=2048, max_length=256, src_len=64,
                 trg_len=64, scope=None, executor=None, place=None,
                 param_prefix="tf", start_id=0, end_id=1,
                 causal_encoder=False):
        self.cfg = _Cfg(src_vocab_size, trg_vocab_size, n_layer, n_head,
                        d_key, d_value, d_model, d_inner_hid, max_length)
        self.src_len = int(src_len)
        self.trg_len = int(trg_len)
        self.prefix = param_prefix
        self.start_id = int(start_id)
        self.end_id = int(end_id)
        self.causal_encoder = bool(causal_encoder)
        self.scope = scope or fluid.Scope()
        self.exe = executor or fluid.Executor(place or fluid.CUDAPlace(0))
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            _, predict, _ = T.transformer(
                src_vocab_size, trg_vocab_size, max_length,
                n_layer=n_layer, n_head=n_head, d_key=d_key,
                d_value=d_value, d_model=d_model, d_inner_hid=d_inner_hid,
                dropout_rate=0.0, src_seq_len=self.src_len,
                trg_seq_len=self.trg_len, param_prefix=param_prefix)
        self.startup = startup
        self.program = fluid.io.prune_program(main, [predict])
        self.predict = predict
        self._selects: Dict[tuple, tuple] = {}

    def init_params(self, seed: Optional[int] = None) -> None:
        """Random-init every parameter with the startup program, eagerly,
        on an executor of its own at this decoder's place."""
        if seed is not None:
            self.startup.random_seed = seed
        with fluid.scope_guard(self.scope):
            fluid.Executor(self.exe.place).run(self.startup)

    def _feeds(self, src_tokens, src_lengths):
        """The feed entries a decode does not change (source tokens,
        positions, the three attention biases), built once per decode;
        the loop swaps ``trg_word`` in each step."""
        c = self.cfg
        b = src_tokens.shape[0]
        return {
            "src_word": src_tokens.astype(np.int64),
            "src_pos": np.tile(np.arange(self.src_len, dtype=np.int64),
                               (b, 1)),
            "trg_pos": np.tile(np.arange(self.trg_len, dtype=np.int64),
                               (b, 1)),
            "src_slf_attn_bias": T.make_attn_bias(
                src_lengths, self.src_len, c.n_head,
                causal=self.causal_encoder),
            "trg_slf_attn_bias": T.make_attn_bias(
                np.full(b, self.trg_len), self.trg_len, c.n_head,
                causal=True),
            "trg_src_attn_bias": self._cross_bias(src_lengths, b),
        }

    def _cross_bias(self, src_lengths, b):
        c = self.cfg
        valid = (np.arange(self.src_len)[None, :]
                 < np.asarray(src_lengths)[:, None])
        bias = np.where(valid[:, None, None, :], 0.0, -1e9)
        return np.broadcast_to(
            bias, (b, c.n_head, self.trg_len, self.src_len)
        ).astype(np.float32).copy()

    def _pad_src(self, src_tokens):
        src_tokens = np.asarray(src_tokens)
        b, s = src_tokens.shape
        if s < self.src_len:
            out = np.zeros((b, self.src_len), src_tokens.dtype)
            out[:, :s] = src_tokens
            return out
        return src_tokens[:, : self.src_len]

    def _logits(self, feed, trg, t):
        """Whole-forward logits at position ``t`` [b, V]: one O(L^2)
        step, sliced on the device."""
        feed["trg_word"] = trg
        with fluid.scope_guard(self.scope):
            out, = self.exe.run(self.program, feed=feed,
                                fetch_list=[self.predict],
                                return_numpy=False, mode="infer")
        return _host(out[:, t])

    def logits_at(self, src_tokens, src_lengths, trg_prefix_padded, t):
        feed = self._feeds(self._pad_src(src_tokens), src_lengths)
        return self._logits(feed, trg_prefix_padded, t)

    def greedy(self, src_tokens, src_lengths, max_new: Optional[int] = None,
               stop_at_end: bool = True) -> np.ndarray:
        src_tokens = np.asarray(src_tokens)
        src_lengths = np.asarray(src_lengths, np.int32)
        b = src_tokens.shape[0]
        max_new = min(max_new or self.trg_len, self.trg_len)
        feed = self._feeds(self._pad_src(src_tokens), src_lengths)
        trg = np.zeros((b, self.trg_len), np.int64)
        trg[:, 0] = self.start_id
        out = []
        done = np.zeros(b, bool)
        for t in range(max_new):
            logits = self._logits(feed, trg, t)
            nxt = logits.argmax(-1)
            out.append(nxt)
            done |= (nxt == self.end_id)
            if t + 1 < self.trg_len:
                trg[:, t + 1] = nxt
            if stop_at_end and done.all():
                break
        return np.stack(out, axis=1)

    # -- beam (the selection op is the KV path's) ----------------------------
    def _select_prog(self, W: int, K: int):
        key = (W, K)
        if key in self._selects:
            return self._selects[key]
        c = self.cfg
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup), fluid.unique_name.guard():
            pre_ids = layers.data("pre_ids", [W], "int64")
            pre_scores = layers.data("pre_scores", [W], "float32")
            probs = layers.data("probs", [W, c.trg_vocab_size], "float32")
            topk_scores, topk_idx = layers.topk(probs, k=K)
            sel_ids, sel_scores, parent = layers.beam_search(
                pre_ids, pre_scores, topk_idx, topk_scores, W,
                end_id=self.end_id)
        self._selects[key] = (prog, sel_ids, sel_scores, parent)
        return self._selects[key]

    def beam(self, src_tokens, src_lengths, beam_size: int,
             max_new: Optional[int] = None, topk_size: Optional[int] = None):
        """Full-re-run beam decode: each step forwards every b*W
        hypothesis prefix through the whole model, then selects with the
        beam_search op the KV path uses.  Returns the per-step (ids,
        scores, parents) trajectory."""
        c = self.cfg
        W = int(beam_size)
        K = topk_size or min(2 * W, c.trg_vocab_size)
        src_tokens = np.asarray(src_tokens)
        src_lengths = np.asarray(src_lengths, np.int32)
        b = src_tokens.shape[0]
        max_new = min(max_new or self.trg_len, self.trg_len)
        prog, sel_ids_v, sel_scores_v, parent_v = self._select_prog(W, K)

        lane_src = np.repeat(src_tokens, W, axis=0)
        lane_len = np.repeat(src_lengths, W)
        lane_feed = self._feeds(self._pad_src(lane_src), lane_len)
        prefix = np.zeros((b * W, self.trg_len), np.int64)
        prefix[:, 0] = self.start_id
        pre_ids = np.full((b, W), self.start_id, np.int64)
        pre_scores = np.concatenate(
            [np.zeros((b, 1), np.float32),
             np.full((b, W - 1), -1e9, np.float32)], axis=1)
        ids_steps = [pre_ids]
        score_steps = [pre_scores]
        parent_steps = [np.zeros((b, W), np.int32)]
        for t in range(max_new):
            logits = self._logits(lane_feed, prefix, t)             # [bW, V]
            z = logits - logits.max(-1, keepdims=True)
            e = np.exp(z)
            probs = (e / e.sum(-1, keepdims=True)).reshape(
                b, W, c.trg_vocab_size).astype(np.float32)
            with fluid.scope_guard(self.scope):
                si, ss, pa = self.exe.run(
                    prog, feed={"pre_ids": pre_ids,
                                "pre_scores": pre_scores, "probs": probs},
                    fetch_list=[sel_ids_v, sel_scores_v, parent_v],
                    mode="infer")
            pre_ids = np.asarray(si).astype(np.int64)
            pre_scores = np.asarray(ss).astype(np.float32)
            parent = np.asarray(pa).astype(np.int32)
            # each selected hypothesis continues its parent's PREFIX
            view = prefix.reshape(b, W, self.trg_len)
            view = np.take_along_axis(view, parent[:, :, None], axis=1)
            if t + 1 < self.trg_len:
                view[:, :, t + 1] = pre_ids
            prefix = view.reshape(b * W, self.trg_len)
            ids_steps.append(pre_ids)
            score_steps.append(pre_scores)
            parent_steps.append(parent)
            if (pre_ids == self.end_id).all():
                break
        return ids_steps, score_steps, parent_steps
