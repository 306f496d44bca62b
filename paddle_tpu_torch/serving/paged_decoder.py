"""Paged-KV Transformer serving on one GPU — the port of
``PagedTransformerGenerator`` from ``paddle_tpu/serving/paged_decoder.py``.

* **one pooled KV tensor** ``[h, R, page_size, d]`` on the device, shared
  by every lane, layer and role (encoder-KV, cross-KV, decoder-self-KV);
  a logical page spans all layers and K+V of a page_size-token span;
* **per-request page tables** from the host-side ``PageAllocator``, fed
  to the device as int32 data each step (a new page id changes no
  signature);
* **chunked prefill**: the source is encoded CAUSALLY in fixed-size
  chunks in the SAME step that decodes the in-flight lanes
  (``build_unified_program``); lanes in neither phase ride along with
  trash-page writes and length-1 masks;
* **prefix sharing**: full prompt chunks are content-addressed (chain
  hashes), so identical prompt prefixes map to the same physical pages
  with refcounts;
* **beam search** (``beam``): the b*W beam lanes decode over shared
  pages.  After each step a hypothesis takes its parent's page table,
  page by page, under refcounts; a lane about to write a shared,
  partly filled page first gets its own copy in the same step
  (copy-on-write, ``paged_page_copy``), never a copy of the whole cache;
* **a host-RAM tier and sessions** (``host_pages``, ``session_store``):
  evicted prefix chunks demote to host RAM and promote back bit for bit
  on the next hit, and whole lanes suspend to checksummed artifacts
  (``serving/sessions.SessionStore``) and resume without re-prefill.
  The bytes move through two fixed-width programs of their own
  (``paged_page_gather`` / ``paged_page_scatter``, ``xfer_width`` pages
  a step), each captured once.

As in the reference, the generator builds the unified prefill+decode
step as a Fluid program and runs it through ``fluid.Executor`` in its
``scope``, where the pool (and the int8 pool's scale sidecar) are
persistable vars that the step's paged KV writes update in place.  On
the card the first ``lane_step`` at a lane count runs eagerly and is
captured in a CUDA graph; every later one at that lane count replays it
(``cache_stats()["executable"]``; ``aot_warm`` does the capture ahead of
traffic).  The beam step is a program of its own, run the same way: one
capture per (b, W), the scope's pool its buffer as it is the unified
step's.  The host-side logic (admission, page tables, feeds, greedy,
the beam's table reorder and copy-on-write, demotion, suspend and
resume) is the reference's, line for line, so both packages make the
same decisions on the same requests.
Pools may be float32, bfloat16 or int8 (with a float32 per-(row, slot)
scale sidecar).

Speculative and constrained decoding compose two of these generators
(``serving/speculative.SpeculativeGenerator``).  Not ported yet, and
refused with ``NotImplementedError`` when asked for: the sharded mesh,
``build_manifest_program`` and the static HBM estimates.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from .. import fluid
from ..fluid import layers
from ..fluid.analysis.dataflow import ProgramView
from ..fluid.analysis.recompile import enumerate_buckets
from ..fluid.executor import _host_tensor
from ..models import transformer as T
from ..observability import tracing as _obs_tracing
from .decoder import (_Cfg, build_backtrace, dense_kv_bytes_per_slot,
                      run_backtrace)
from .paging import (PageAllocator, PoolCapacityError, TRASH_PAGE,
                     chunk_hashes)

__all__ = ["PagedTransformerGenerator", "copy_weights", "kv_page_bytes",
           "build_unified_program", "default_num_pages"]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


_KV_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}
_KV_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "int8": torch.int8}


def kv_page_bytes(n_layer: int, n_head: int, d_head: int, page_size: int,
                  kv_dtype: str = "float32") -> int:
    """Device bytes ONE logical page costs: ``2 * n_layer`` physical rows
    of ``[page_size, n_head * d_head]`` K/V in ``kv_dtype``, plus — for
    int8 pools — the fp32 block scale each (row, slot) carries in the
    sidecar."""
    if kv_dtype not in _KV_ITEMSIZE:
        raise ValueError(f"kv_page_bytes: unsupported kv_dtype "
                         f"{kv_dtype!r} (one of {sorted(_KV_ITEMSIZE)})")
    rows = 2 * n_layer
    data = rows * page_size * n_head * d_head * _KV_ITEMSIZE[kv_dtype]
    scales = rows * page_size * 4 if kv_dtype == "int8" else 0
    return data + scales


def _host_kv(v) -> torch.Tensor:
    """A payload's slab as a CPU tensor: a tensor as it is, an array
    (numpy, or ``ml_dtypes`` bfloat16 as its bits) through the
    executor's host conversion."""
    return v.detach().cpu() if isinstance(v, torch.Tensor) \
        else _host_tensor(v)


def _host_slabs(*slabs):
    """Slabs (or None) as host values, copied off the card through pinned
    memory with one wait for all: numpy arrays, but a bf16 slab stays a
    CPU ``torch.bfloat16`` tensor (numpy has no bfloat16)."""
    host, wait = [], None
    for t in slabs:
        if t is not None and t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            wait = torch.cuda.current_stream(t.device)
            t = h
        elif t is not None:
            t = t.clone()
        host.append(t)
    if wait is not None:
        wait.synchronize()
    return [t if t is None or t.dtype == torch.bfloat16 else t.numpy()
            for t in host]


# decode-time cache state (paged pool + sidecar, dense per-lane caches):
# never weights, so never copy_weights material — carrying them across
# scopes would drag stale cache contents (and for the pool, the wrong
# dtype) into the destination generator
_CACHE_MARKERS = ("@kv_pool", "@kv_scales", "@kcache", "@vcache",
                  "@crossk", "@crossv")


def copy_weights(src_scope, dst_scope, prefix: Optional[str] = None,
                 dst_prefix: Optional[str] = None) -> int:
    """Copy vars from ``src_scope`` into ``dst_scope`` EXCEPT cache-state
    vars (``_CACHE_MARKERS``): two generators sharing one
    ``param_prefix`` (a float-pool and an int8-pool pair) share weight
    NAMES, so each needs its own scope, but copying cache vars would
    carry stale decode state across.  ``prefix`` restricts the copy to
    one model's ``param_prefix``; ``dst_prefix`` (requires ``prefix``)
    rewrites the leading prefix on the way over.  Unset placeholders are
    skipped.  ``src_scope`` may be a JAX scope: its arrays arrive as
    numpy copies, which the executor uploads at the first step that
    reads them; a tensor of a port scope is cloned where it lies.
    Returns the number of vars copied."""
    if dst_prefix is not None and prefix is None:
        raise ValueError("copy_weights: dst_prefix requires prefix")
    n = 0
    for name in list(src_scope.vars):
        if any(m in name for m in _CACHE_MARKERS):
            continue
        if prefix is not None and not name.startswith(prefix):
            continue
        val = src_scope.find_var(name)
        if val is None:
            continue
        out_name = name if dst_prefix is None \
            else dst_prefix + name[len(prefix):]
        dst_scope.set_var(out_name, val.detach().clone()
                          if isinstance(val, torch.Tensor)
                          else np.array(np.asarray(val)))
        n += 1
    return n


def default_num_pages(src_len: int, max_out_len: int,
                      page_size: int) -> int:
    """The constructor's pool-sizing default: room for ~8 worst-case
    requests (+ the trash page)."""
    p_src = _ceil_div(src_len, page_size)
    p_out = _ceil_div(max_out_len, page_size)
    return 8 * (2 * p_src + p_out) + 1


def build_unified_program(cfg: _Cfg, *, src_len: int, max_out_len: int,
                          page_size: int, num_pages: int, chunk_size: int,
                          param_prefix: str, kv_dtype: str = "float32",
                          verify_tokens: int = 1,
                          logit_masks: bool = False,
                          shard_axis: Optional[str] = None):
    """Build the unified prefill+decode program DESC — pure Python, no
    device allocation, no scope; the generator's ``_build_unified`` calls
    it with its own config.  The pool (and the int8 sidecar) are
    persistable vars with recorded shapes.  Returns ``(prog, startup,
    next_ids, logits)``; it serializes to the reference's bytes.

    ``verify_tokens=K`` widens the decode half to a per-lane K-token axis
    (``trg_word``/``trg_pos``/``self_pages``/``self_offsets`` [b, K],
    scored causally in one step by ``models.transformer.verify_step``);
    ``logit_masks=True`` adds a ``logit_mask`` [b, K, vocab] additive
    float32 feed applied to the logits before the argmax.  The
    reference's ``shard_axis`` (tensor-parallel annotations) needs a
    mesh and is not ported."""
    if shard_axis:
        raise NotImplementedError("build_unified_program(shard_axis=...): "
                                  "the sharded serving mesh is not ported "
                                  "to paddle_tpu_torch")
    c = cfg
    C = int(chunk_size)
    K = int(verify_tokens)
    p_src = _ceil_div(int(src_len), int(page_size))
    p_out = _ceil_div(int(max_out_len), int(page_size))
    pool_shape = [c.n_head, int(num_pages) * c.n_layer * 2,
                  int(page_size), c.d_key]
    scales_shape = [1, int(num_pages) * c.n_layer * 2, int(page_size)]
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        block = prog.global_block()
        pool = block.create_var(name=f"{param_prefix}@kv_pool",
                                shape=pool_shape, dtype=kv_dtype,
                                persistable=True)
        kv_scales = None
        if kv_dtype == "int8":
            kv_scales = block.create_var(
                name=f"{param_prefix}@kv_scales", shape=scales_shape,
                dtype="float32", persistable=True)
        pf_word = layers.data("pf_word", [C], "int64")
        pf_pos = layers.data("pf_pos", [C], "int64")
        pf_base = layers.data("pf_base", [], "int32")
        pf_len = layers.data("pf_len", [], "int32")
        enc_table = layers.data("enc_table", [p_src], "int32")
        enc_pages = layers.data("enc_pages", [C], "int32")
        cross_pages = layers.data("cross_pages", [C], "int32")
        w_offsets = layers.data("w_offsets", [C], "int32")
        T.paged_prefill_chunk(
            pf_word, pf_pos, pf_base, pf_len, enc_table, enc_pages,
            cross_pages, w_offsets, pool, c.src_vocab_size,
            c.max_length, c.n_layer, c.n_head, c.d_key, c.d_value,
            c.d_model, c.d_inner_hid, param_prefix, kv_scales=kv_scales)
        trg_word = layers.data("trg_word", [K], "int64")
        trg_pos = layers.data("trg_pos", [K], "int64")
        self_table = layers.data("self_table", [p_out], "int32")
        self_pages = layers.data("self_pages", [K], "int32")
        self_offsets = layers.data("self_offsets", [K], "int32")
        self_lengths = layers.data("self_lengths", [], "int32")
        self_base = layers.data("self_base", [], "int32")
        cross_table = layers.data("cross_table", [p_src], "int32")
        src_lengths = layers.data("src_lengths", [], "int32")
        logit_mask = layers.data(
            "logit_mask", [K, c.trg_vocab_size], "float32") \
            if logit_masks else None
        logits = T.verify_step(
            trg_word, trg_pos, self_table, self_pages, self_offsets,
            self_lengths, self_base, cross_table, src_lengths, pool,
            c.trg_vocab_size, c.max_length, c.n_layer, c.n_head,
            c.d_key, c.d_value, c.d_model, c.d_inner_hid, param_prefix,
            kv_scales=kv_scales, n_tokens=K, logit_mask=logit_mask)
        next_ids = layers.argmax(logits, axis=-1)
    return prog, startup, next_ids, logits


class _Lane:
    """Host bookkeeping for one in-flight slot."""

    __slots__ = ("phase", "src", "s_true", "max_new", "enc_done",
                 "pending_chunk", "enc_table", "cross_table", "self_table",
                 "hashes", "hit_hashes", "inserted_hashes", "enc_owned",
                 "cross_owned", "cur", "pos")

    def __init__(self):
        self.reset()

    def reset(self):
        self.phase = "idle"        # idle | prefill | decode | hold
        self.src = None
        self.s_true = 0
        self.max_new = 0
        self.enc_done = 0
        self.pending_chunk = 0
        self.enc_table: List[int] = []
        self.cross_table: List[int] = []
        self.self_table: List[int] = []
        self.hashes: List[str] = []
        self.hit_hashes: List[str] = []
        self.inserted_hashes: List[str] = []
        self.enc_owned: List[int] = []
        self.cross_owned: List[int] = []
        self.cur = 0
        self.pos = 0


class PagedTransformerGenerator:
    """Serving-side Transformer decoder over a paged KV pool.

    The scheduler surface is page-aware: ``open_slots / admit_slot /
    clear_slot / lane_step`` plus ``can_admit / prompt_infeasible /
    pages_needed`` for admission control.  ``greedy`` decodes a whole
    batch through the same loop, ``beam`` by beam search over shared
    pages (``topk_size``: the candidates a beam offers each step,
    default 2W).  The unified and beam programs run through
    ``executor`` (default ``fluid.Executor(place)``, ``place`` default
    ``fluid.CUDAPlace(0)``: pass ``place=fluid.CPUPlace()`` or a CPU
    executor to run on the CPU) in ``scope`` (default a new one), which
    holds the pool and the weights under their Fluid names.  Weights come
    from ``init_params(seed)`` (the unified startup program), by name from
    ``load_params``, or from another scope through ``copy_weights``."""

    page_aware = True

    def __init__(self, src_vocab_size, trg_vocab_size, *, n_layer=6,
                 n_head=8, d_key=64, d_value=64, d_model=512,
                 d_inner_hid=2048, max_length=256, src_len=64,
                 max_out_len=64, scope=None, executor=None, place=None,
                 param_prefix="tf", start_id=0, end_id=1,
                 page_size=8, num_pages=None, chunk_size=8,
                 prefix_sharing=True, topk_size=None,
                 kv_dtype="float32", mesh=None, mesh_axes=None,
                 host_pages=0, session_store=None, xfer_width=4,
                 demote_watermark=0):
        if mesh is not None or mesh_axes:
            raise NotImplementedError(
                "PagedTransformerGenerator: mesh / mesh_axes (the sharded "
                "serving mesh) not ported to paddle_tpu_torch yet")
        if d_key != d_value:
            raise ValueError("paged KV pool requires d_key == d_value "
                             "(one pool row shape serves both)")
        if kv_dtype not in _KV_ITEMSIZE:
            raise ValueError(f"kv_dtype={kv_dtype!r}: pick one of "
                             f"{sorted(_KV_ITEMSIZE)}")
        self.cfg = _Cfg(src_vocab_size, trg_vocab_size, n_layer, n_head,
                        d_key, d_value, d_model, d_inner_hid, max_length)
        self.src_len = int(src_len)
        self.max_out_len = int(max_out_len)
        self.prefix = param_prefix
        self.start_id = int(start_id)
        self.end_id = int(end_id)
        self.page_size = int(page_size)
        self.chunk = int(chunk_size)
        self.prefix_sharing = bool(prefix_sharing)
        self.topk_size = topk_size
        self.p_src = _ceil_div(self.src_len, self.page_size)
        self.p_out = _ceil_div(self.max_out_len, self.page_size)
        if num_pages is None:
            num_pages = default_num_pages(self.src_len, self.max_out_len,
                                          self.page_size)
        self.num_pages = int(num_pages)
        self.scope = scope or fluid.Scope()
        self.exe = executor or fluid.Executor(place or fluid.CUDAPlace(0))
        self.kv_dtype = kv_dtype
        self._pool_name = f"{param_prefix}@kv_pool"
        self._scales_name = f"{param_prefix}@kv_scales"
        self._pool_shape = (n_head, self.num_pages * n_layer * 2,
                            self.page_size, d_key)
        self._scales_shape = (1, self.num_pages * n_layer * 2,
                              self.page_size)
        self.page_bytes = kv_page_bytes(n_layer, n_head, d_key,
                                        self.page_size, kv_dtype)
        # the host tier: host_pages > 0 attaches a host-RAM demotion tier
        # behind the allocator; session_store enables suspend/resume of
        # whole lanes; both opt-in (the defaults destroy on evict)
        self.host_pages = int(host_pages)
        self.sessions = session_store
        self.xfer_width = max(1, int(xfer_width))
        self.demote_watermark = int(demote_watermark)
        self.alloc = PageAllocator(self.num_pages, self.page_size,
                                   host_pages=self.host_pages)
        self._xfer_progs = None
        self._pending_suspends: Dict[str, Dict] = {}
        self._tier_stats = {"suspends": 0, "suspend_drops": 0,
                            "resumes": 0, "resume_misses": 0,
                            "prefetches": 0, "eager_demotes": 0}
        if self.host_pages > 0:
            self.alloc.set_pager(self._tier_download, self._tier_upload,
                                 page_bytes=self.page_bytes)
        self._lanes: List[_Lane] = []
        self._slots = 0
        self._steps = 0
        self._tracer = _obs_tracing.tracer()
        self._beam_steps: Dict[int, tuple] = {}
        self._decode_prog = None
        self._build_unified()
        self._reset_pool()

    # -- device pool ---------------------------------------------------------
    def _reset_pool(self):
        """A zero pool (and, for int8, a zero scale sidecar) on the
        executor's device, as persistable vars of the scope."""
        dev = self.exe.device
        self.scope.set_var(self._pool_name, torch.zeros(
            self._pool_shape, dtype=_KV_TORCH_DTYPE[self.kv_dtype],
            device=dev))
        if self.kv_dtype == "int8":
            self.scope.set_var(self._scales_name, torch.zeros(
                self._scales_shape, dtype=torch.float32, device=dev))

    def _pool_var(self, block):
        return block.create_var(name=self._pool_name,
                                shape=list(self._pool_shape),
                                dtype=self.kv_dtype, persistable=True)

    def _scales_var(self, block):
        """The int8 pool's fp32 block-scale sidecar (None for float
        pools)."""
        if self.kv_dtype != "int8":
            return None
        return block.create_var(name=self._scales_name,
                                shape=list(self._scales_shape),
                                dtype="float32", persistable=True)

    # -- program builders ----------------------------------------------------
    def _build_unified(self):
        """ONE program = one step: the chunked-prefill tower (causal
        encoder chunk + cross-KV page writes) AND the paged decode step
        over every lane.  Lanes not in a given phase ride along with
        trash-page writes and length-1 masks, so any mix of admitting /
        prefilling / decoding lanes replays the same captured step."""
        self._unified = build_unified_program(
            self.cfg, src_len=self.src_len, max_out_len=self.max_out_len,
            page_size=self.page_size, num_pages=self.num_pages,
            chunk_size=self.chunk, param_prefix=self.prefix,
            kv_dtype=self.kv_dtype)

    def _build_beam_step(self, W: int):
        """The paged beam step: the copy-on-write page copies, the paged
        decode tower over the b*W lanes, and the beam_search selection.
        No cache reorder is in the program: the host gives each
        hypothesis its parent's (shared, refcounted) page table."""
        c = self.cfg
        K = self.topk_size or min(2 * W, c.trg_vocab_size)
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup), fluid.unique_name.guard():
            pool = self._pool_var(prog.global_block())
            kv_scales = self._scales_var(prog.global_block())
            pre_ids = layers.data("pre_ids", [W], "int64")
            pre_scores = layers.data("pre_scores", [W], "float32")
            tok = layers.data("trg_word", [1], "int64")       # [bW, 1]
            tp = layers.data("trg_pos", [1], "int64")
            cow_src = layers.data("cow_src", [], "int32")
            cow_dst = layers.data("cow_dst", [], "int32")
            self_table = layers.data("self_table", [self.p_out], "int32")
            self_pages = layers.data("self_pages", [1], "int32")
            self_offsets = layers.data("self_offsets", [1], "int32")
            self_lengths = layers.data("self_lengths", [], "int32")
            self_base = layers.data("self_base", [], "int32")
            cross_table = layers.data("cross_table", [self.p_src], "int32")
            src_lengths = layers.data("src_lengths", [], "int32")
            if kv_scales is not None:
                pool, kv_scales = layers.paged_page_copy(
                    pool, cow_src, cow_dst, n_layer=c.n_layer,
                    scales=kv_scales)
            else:
                pool = layers.paged_page_copy(pool, cow_src, cow_dst,
                                              n_layer=c.n_layer)
            logits = T.paged_decode_step(
                tok, tp, self_table, self_pages, self_offsets,
                self_lengths, self_base, cross_table, src_lengths, pool,
                c.trg_vocab_size, c.max_length, c.n_layer, c.n_head,
                c.d_key, c.d_value, c.d_model, c.d_inner_hid, self.prefix,
                kv_scales=kv_scales)
            probs = layers.softmax(
                layers.reshape(logits, [-1, W, c.trg_vocab_size]))
            topk_scores, topk_idx = layers.topk(probs, k=K)
            sel_ids, sel_scores, parent = layers.beam_search(
                pre_ids, pre_scores, topk_idx, topk_scores, W,
                end_id=self.end_id)
        self._beam_steps[W] = (prog, startup, sel_ids, sel_scores, parent)
        return self._beam_steps[W]

    def _build_backtrace(self):
        self._decode_prog = build_backtrace(self.end_id)
        return self._decode_prog

    def _backtrace(self, ids_steps, score_steps, parent_steps):
        return run_backtrace(self.exe, self.scope,
                             self._decode_prog or self._build_backtrace(),
                             ids_steps, score_steps, parent_steps)

    def _run(self, feed, fetch_list):
        """One unified step on ``feed`` through the executor, in this
        generator's scope; the fetches stay device tensors."""
        with fluid.scope_guard(self.scope):
            return self.exe.run(self._unified[0], feed=feed,
                                fetch_list=fetch_list, return_numpy=False,
                                mode="infer")

    # -- parameters ----------------------------------------------------------
    def init_params(self, seed: Optional[int] = None) -> None:
        """Random-init every parameter with the unified startup program
        (the Fluid initializers, drawn on the host from ``seed``).  It
        runs eagerly, on an executor of its own at this generator's
        place: a program that draws on the host is never captured, and
        the generator's executor would refuse to run it twice."""
        if seed is not None:
            self._unified[1].random_seed = seed
        with fluid.scope_guard(self.scope):
            fluid.Executor(self.exe.place).run(self._unified[1])

    def _param_vars(self) -> Dict[str, object]:
        """The unified program's parameters: its persistable vars less
        the cache state, by name."""
        return {n: vd for n, vd in
                self._unified[0].desc.global_block().vars.items()
                if vd.persistable and not any(m in n for m in _CACHE_MARKERS)}

    def load_params(self, named_arrays: Mapping[str, np.ndarray],
                    prefix: Optional[str] = None) -> int:
        """Carry weights across from a JAX scope: ``named_arrays`` maps
        Fluid names (``tf.enc0.self.q.w``, ``tf.vocab_proj.w``, ...) to
        arrays, which go into this generator's scope under its own
        ``param_prefix``.  Cache variables (``@kv_pool`` and the like)
        and names outside ``prefix`` (default: this generator's
        ``param_prefix``) are skipped, as ``copy_weights`` skips them.
        Every parameter of the unified program must be present with its
        shape, and nothing is loaded otherwise; returns the number
        loaded."""
        prefix = self.prefix if prefix is None else prefix
        params = self._param_vars()
        vals = {}
        for name, arr in named_arrays.items():
            if any(m in name for m in _CACHE_MARKERS) \
                    or not name.startswith(prefix + "."):
                continue
            dst = f"{self.prefix}.{name[len(prefix) + 1:]}"
            vd = params.get(dst)
            if vd is None:
                raise KeyError(f"load_params: {name!r} names no parameter "
                               f"of the paged Transformer")
            arr = np.asarray(arr)
            if tuple(arr.shape) != tuple(vd.shape):
                raise ValueError(f"load_params: {name!r} has shape "
                                 f"{tuple(arr.shape)}, the model wants "
                                 f"{tuple(vd.shape)}")
            vals[dst] = arr.astype(vd.dtype)
        missing = sorted(set(params) - set(vals))
        if missing:
            raise KeyError(f"load_params: no value for {len(missing)} "
                           f"parameter(s) under {prefix!r}, e.g. "
                           f"{prefix}.{missing[0][len(self.prefix) + 1:]}")
        fluid.scope_from_numpy(vals, self.exe.place, scope=self.scope)
        return len(vals)

    # -- admission accounting ------------------------------------------------
    def _prompt_pages(self, n_tokens: int) -> int:
        return _ceil_div(max(1, int(n_tokens)), self.page_size)

    def _self_pages(self, max_new: int) -> int:
        return _ceil_div(int(max_new), self.page_size) if max_new else 0

    def _resolve_max_new(self, max_new: Optional[int]) -> int:
        """None -> the generator's cap; 0 stays 0 (beam reserves no self
        pages at admission: it allocates them lane by lane)."""
        if max_new is None:
            return self.max_out_len
        return min(int(max_new), self.max_out_len)

    def pages_needed(self, src_tokens, max_new: Optional[int] = None) -> int:
        """Pages an admission would allocate right now (prompt pages for
        chunks the prefix cache does not already hold, x2 for enc+cross,
        plus the reserved decode pages)."""
        src = np.asarray(src_tokens).reshape(-1)
        mn = self._resolve_max_new(max_new)
        hits = 0
        if self.prefix_sharing:
            # count=False: an admission PROBE must not skew the
            # prefix_hit_rate that cache_stats() reports
            hits = len(self.alloc.lookup_chain(
                chunk_hashes(src, self.page_size), count=False))
        return (2 * (self._prompt_pages(len(src)) - hits)
                + self._self_pages(mn))

    def can_admit(self, src_tokens, max_new: Optional[int] = None) -> bool:
        return self.pages_needed(src_tokens, max_new) <= \
            self.alloc.available()

    def prompt_infeasible(self, src_tokens,
                          max_new: Optional[int] = None) -> bool:
        """True when the request could NEVER be admitted: its prompt +
        reserved decode pages exceed the whole pool even with every
        other page free."""
        src = np.asarray(src_tokens).reshape(-1)
        mn = self._resolve_max_new(max_new)
        return (2 * self._prompt_pages(len(src)) + self._self_pages(mn)
                > self.alloc.total_usable)

    # -- continuous-batching surface -----------------------------------------
    def open_slots(self, n_slots: int) -> None:
        if self._lanes:
            for slot in range(len(self._lanes)):
                self.clear_slot(slot)
        self._slots = int(n_slots)
        self._lanes = [_Lane() for _ in range(self._slots)]

    def admit_slot(self, slot: int, src_tokens_1d,
                   max_new: Optional[int] = None) -> int:
        """Allocate the lane's page tables (prefix-cache hits first) and
        queue it for chunked prefill.  No device work happens here — the
        prefill rides the following ``lane_step`` calls, interleaved with
        every other lane's decode."""
        if not self._lanes:
            raise RuntimeError("open_slots() before admit_slot()")
        lane = self._lanes[slot]
        if lane.phase != "idle":
            raise RuntimeError(f"admit_slot: slot {slot} is busy")
        src = np.asarray(src_tokens_1d).reshape(-1).astype(np.int64)
        s_true = len(src)
        if s_true > self.src_len:
            raise ValueError(
                f"admit_slot: prompt length {s_true} exceeds the "
                f"generator's src_len {self.src_len}; raise src_len or "
                f"truncate explicitly at the call site")
        mn = self._resolve_max_new(max_new)
        if self.prompt_infeasible(src, mn):
            raise PoolCapacityError(
                f"request needs {2 * self._prompt_pages(s_true) + self._self_pages(mn)} "
                f"pages for its prompt + decode reservation alone, but the "
                f"pool only has {self.alloc.total_usable} usable pages")
        n_prompt = self._prompt_pages(s_true)
        hashes = chunk_hashes(src, self.page_size)
        hits = self.alloc.lookup_chain(hashes) if self.prefix_sharing \
            else []
        n_hit = len(hits)
        # ref the hit chunks BEFORE allocating: alloc() evicts LRU
        # refcount-0 chunks under pressure, and an un-reffed hit is
        # exactly such a chunk
        for h, _enc, _cross in hits:
            self.alloc.ref_chunk(h)
        try:
            fresh = self.alloc.alloc(2 * (n_prompt - n_hit)
                                     + self._self_pages(mn))
        except PoolCapacityError:
            for h, _enc, _cross in hits:
                self.alloc.unref_chunk(h)
            raise
        n_own = n_prompt - n_hit
        lane.src = src
        lane.s_true = s_true
        lane.max_new = mn
        lane.hashes = hashes
        lane.hit_hashes = [h for h, _, _ in hits]
        lane.inserted_hashes = []
        lane.enc_table = [e for _, e, _ in hits] + fresh[:n_own]
        lane.cross_table = [x for _, _, x in hits] + fresh[n_own:2 * n_own]
        lane.self_table = fresh[2 * n_own:]
        lane.enc_owned = fresh[:n_own]
        lane.cross_owned = fresh[n_own:2 * n_own]
        lane.enc_done = n_hit * self.page_size
        lane.pending_chunk = 0
        lane.cur = self.start_id
        lane.pos = 0
        if lane.enc_done >= s_true:     # whole prompt served from cache
            lane.phase = "decode"
        else:
            lane.phase = "prefill"
        return s_true

    def clear_slot(self, slot: int) -> None:
        """Retire a lane: release every page reference immediately.
        Prefix-cached chunks drop to the evictable list (still hittable,
        reclaimed under pressure); everything else returns to the free
        list."""
        lane = self._lanes[slot]
        if lane.phase == "idle":
            return
        for h in lane.hit_hashes + lane.inserted_hashes:
            self.alloc.unref_chunk(h)
        for p in lane.enc_owned + lane.cross_owned:
            self.alloc.unref(p)
        for p in lane.self_table:
            self.alloc.unref(p)
        lane.reset()

    # -- tiered KV and sessions ----------------------------------------------
    def _xfer(self):
        """Build the device<->host copy programs once: ``down`` gathers W
        whole logical pages into a dense slab the host fetches; ``up``
        scatters such a slab back into the pool, in place.  W
        (``xfer_width``) is fixed and short transfers pad with the trash
        page, so each program is captured once: the tier adds two
        executables and no recompiles."""
        if self._xfer_progs is not None:
            return self._xfer_progs
        c = self.cfg
        W = self.xfer_width
        rows = W * 2 * c.n_layer
        down, d_start = fluid.Program(), fluid.Program()
        with fluid.program_guard(down, d_start), \
                fluid.unique_name.guard():
            block = down.global_block()
            pool = self._pool_var(block)
            kv_scales = self._scales_var(block)
            pages = layers.data("xfer_pages", [W], "int32",
                                append_batch_size=False)
            if kv_scales is not None:
                slab, sslab = layers.paged_page_gather(
                    pool, pages, n_layer=c.n_layer, scales=kv_scales)
                d_fetch = [slab, sslab]
            else:
                slab = layers.paged_page_gather(pool, pages,
                                                n_layer=c.n_layer)
                d_fetch = [slab]
        up, u_start = fluid.Program(), fluid.Program()
        with fluid.program_guard(up, u_start), fluid.unique_name.guard():
            block = up.global_block()
            pool = self._pool_var(block)
            kv_scales = self._scales_var(block)
            pages = layers.data("xfer_pages", [W], "int32",
                                append_batch_size=False)
            data = layers.data("xfer_data",
                               [c.n_head, rows, self.page_size, c.d_key],
                               self.kv_dtype, append_batch_size=False)
            if kv_scales is not None:
                sdata = layers.data("xfer_scales",
                                    [1, rows, self.page_size], "float32",
                                    append_batch_size=False)
                layers.paged_page_scatter(pool, data, pages,
                                          n_layer=c.n_layer,
                                          scales=kv_scales,
                                          scale_data=sdata)
            else:
                layers.paged_page_scatter(pool, data, pages,
                                          n_layer=c.n_layer)
        self._xfer_progs = {"down": (down, d_fetch), "up": up}
        return self._xfer_progs

    def _tier_download(self, pages) -> Dict[str, object]:
        """Device to host: pull whole logical pages.  Groups of
        ``xfer_width`` ride one fixed-signature step each; the slabs are
        joined on the device and cross to the host in one copy per
        tensor (through pinned memory on the card), one wait for all.
        Returns ``{"kv": [h, n*2L, ps, d], "scales": [1, n*2L, ps] or
        None}`` with rows in the order of ``pages``: numpy arrays, but a
        bf16 pool's slab is a CPU ``torch.bfloat16`` tensor (its bits as
        they lie; numpy has no bfloat16)."""
        down, fetches = self._xfer()["down"]
        c = self.cfg
        W, L2, ps = self.xfer_width, 2 * c.n_layer, self.page_size
        kv_parts: List[torch.Tensor] = []
        sc_parts: List[torch.Tensor] = []
        pages = [int(p) for p in pages]
        for i in range(0, len(pages), W):
            grp = pages[i:i + W]
            pad = np.full(W, TRASH_PAGE, np.int32)
            pad[:len(grp)] = grp
            with fluid.scope_guard(self.scope):
                out = self.exe.run(down, feed={"xfer_pages": pad},
                                   fetch_list=fetches, return_numpy=False,
                                   mode="infer")
            kv_parts.append(out[0][:, :len(grp) * L2])
            if len(fetches) > 1:
                sc_parts.append(out[1][:, :len(grp) * L2])
        if not kv_parts:
            kv_parts = [torch.zeros((c.n_head, 0, ps, c.d_key),
                                    dtype=_KV_TORCH_DTYPE[self.kv_dtype])]
        kv, scales = _host_slabs(
            torch.cat(kv_parts, dim=1),
            torch.cat(sc_parts, dim=1) if sc_parts else None)
        return {"kv": kv, "scales": scales}

    def _tier_upload(self, pages, payload) -> None:
        """Host to device: scatter a ``_tier_download`` payload (or an
        artifact's arrays: numpy, ``ml_dtypes`` bfloat16, or a bf16
        tensor) into ``pages``, in place, ``xfer_width`` pages a step;
        the padding rows land on the trash page."""
        up = self._xfer()["up"]
        c = self.cfg
        W, L2, ps = self.xfer_width, 2 * c.n_layer, self.page_size
        kv = _host_kv(payload["kv"])
        scales = payload.get("scales")
        scales = _host_kv(scales) if scales is not None else None
        pages = [int(p) for p in pages]
        if kv.shape[1] != len(pages) * L2:
            raise ValueError(
                f"tier upload: payload holds {kv.shape[1] // L2} pages, "
                f"target list has {len(pages)}")
        for i in range(0, len(pages), W):
            grp = pages[i:i + W]
            pad = np.full(W, TRASH_PAGE, np.int32)
            pad[:len(grp)] = grp
            data = torch.zeros((c.n_head, W * L2, ps, c.d_key),
                               dtype=kv.dtype)
            data[:, :len(grp) * L2] = kv[:, i * L2:(i + len(grp)) * L2]
            feed = {"xfer_pages": pad, "xfer_data": data}
            if self.kv_dtype == "int8":
                sdata = torch.zeros((1, W * L2, ps), dtype=torch.float32)
                if scales is not None:
                    sdata[:, :len(grp) * L2] = \
                        scales[:, i * L2:(i + len(grp)) * L2]
                feed["xfer_scales"] = sdata
            with fluid.scope_guard(self.scope):
                self.exe.run(up, feed=feed, fetch_list=[], mode="infer")

    def session_fingerprint(self) -> str:
        """The artifact key prefix a suspended lane's KV is only valid
        under: model geometry + pool dtype/layout + weights identity
        (the param prefix — two models sharing a scope differ here).
        A changed fingerprint turns every stored session into a clean
        miss (degrade to re-prefill), never a wrong-KV resume."""
        c = self.cfg
        doc = json.dumps([c.src_vocab_size, c.trg_vocab_size, c.n_layer,
                          c.n_head, c.d_key, c.d_value, c.d_model,
                          c.d_inner_hid, c.max_length, self.kv_dtype,
                          self.page_size, self.src_len, self.max_out_len,
                          self.prefix], separators=(",", ":"))
        return hashlib.sha256(doc.encode("utf-8")).hexdigest()[:24]

    def detach_slot(self, slot: int, session_id: str) -> bool:
        """Suspend a lane WITHOUT device work: the lane's page
        references (self pages, cross pages, chunk refs) transfer to a
        pending-suspend record and the slot frees immediately — safe to
        call under the scheduler lock at retire time.  The d2h copy and
        artifact store happen later in ``tier_maintenance`` (off the
        lock).  False when sessions are off or the lane is not in a
        suspendable phase (the caller falls back to ``clear_slot``)."""
        if self.sessions is None:
            return False
        lane = self._lanes[slot]
        if lane.phase not in ("decode", "hold") or not lane.self_table:
            return False
        old = self._pending_suspends.pop(session_id, None)
        if old is not None:
            # same session suspended twice before maintenance ran: the
            # newer lane state supersedes — drop the stale record's refs
            self._release_suspend_refs(old)
        self._pending_suspends[session_id] = {
            "src": np.array(lane.src), "s_true": lane.s_true,
            "max_new": lane.max_new, "pos": lane.pos, "cur": lane.cur,
            "self_table": list(lane.self_table),
            "cross_table": list(lane.cross_table),
            "cross_owned": list(lane.cross_owned),
            "hit_hashes": list(lane.hit_hashes),
            "inserted_hashes": list(lane.inserted_hashes),
            # a fully-cached admit reaches decode without _finish_prefill
            # — it still holds enc-owned refs that must release with the
            # record, not leak
            "enc_owned": list(lane.enc_owned),
        }
        lane.reset()
        return True

    def _release_suspend_refs(self, rec: Dict) -> None:
        for h in rec["hit_hashes"] + rec["inserted_hashes"]:
            self.alloc.unref_chunk(h)
        for p in rec["cross_owned"] + rec["enc_owned"]:
            self.alloc.unref(p)
        for p in rec["self_table"]:
            self.alloc.unref(p)

    def _complete_suspend(self, session_id: str) -> bool:
        """Finish one pending suspend: download the lane's used self
        pages + cross pages, store the checksummed artifact, release the
        page references.  Runs on the serve-loop thread OUTSIDE the
        scheduler lock (this is device and disk I/O).  The references are released even when the store fails:
        the session degrades to re-prefill, the pool never leaks."""
        rec = self._pending_suspends.pop(session_id, None)
        if rec is None:
            return False
        ps = self.page_size
        n_self_used = _ceil_div(rec["pos"], ps) if rec["pos"] else 0
        ok = False
        try:
            cross = self._tier_download(rec["cross_table"])
            own = self._tier_download(rec["self_table"][:n_self_used]) \
                if n_self_used else {"kv": None, "scales": None}
            arrays = {"cross_kv": cross["kv"]}
            if cross["scales"] is not None:
                arrays["cross_scales"] = cross["scales"]
            if own["kv"] is not None:
                arrays["self_kv"] = own["kv"]
                if own["scales"] is not None:
                    arrays["self_scales"] = own["scales"]
            meta = {"pos": rec["pos"], "cur": rec["cur"],
                    "s_true": rec["s_true"], "max_new": rec["max_new"],
                    "src": [int(t) for t in rec["src"]],
                    "n_cross": len(rec["cross_table"]),
                    "n_self": n_self_used}
            ok = self.sessions.put(session_id, self.session_fingerprint(),
                                   meta, arrays)
        except Exception:
            ok = False
        finally:
            self._release_suspend_refs(rec)
        self._tier_stats["suspends" if ok else "suspend_drops"] += 1
        self._tracer.instant("session/suspend", cat="serving",
                             sid=session_id, ok=ok,
                             pages=len(rec["cross_table"]) + n_self_used)
        return ok

    def resume_slot(self, slot: int, session_id: str,
                    max_new: Optional[int] = None):
        """Resume a suspended session into an idle slot: allocate fresh
        cross + self pages, upload the artifact's KV (+ int8 scale
        sidecars), and restore the lane straight to ``decode`` phase at
        its recorded position — no re-prefill.  Runs OUTSIDE the
        scheduler lock (device + disk I/O, like ``admit_slot``).

        Returns ``{"s_true", "pos", "max_new"}`` on success or None on
        any miss — unknown/corrupt/stale artifact, position at the
        generator's cap, or pool pressure — in which case the caller
        degrades to a fresh ``admit_slot`` of the recorded prompt
        (greedy decode is deterministic, so degrading costs prefill
        latency, never wrong tokens)."""
        if self.sessions is None:
            return None
        if not self._lanes:
            raise RuntimeError("open_slots() before resume_slot()")
        lane = self._lanes[slot]
        if lane.phase != "idle":
            raise RuntimeError(f"resume_slot: slot {slot} is busy")
        if session_id in self._pending_suspends:
            # resumed before maintenance flushed it: complete the spill
            # now so the resume reads a stored artifact (one code path)
            self._complete_suspend(session_id)
        got = self.sessions.get(session_id, self.session_fingerprint())
        if got is None:
            self._tier_stats["resume_misses"] += 1
            return None
        meta, arrays = got
        pos = int(meta["pos"])
        ps = self.page_size
        # the self_table feed width is fixed at p_out: a resumed lane
        # continues within the SAME compiled signature, so its total
        # output (recorded pos + continuation) caps at max_out_len
        mn = self._resolve_max_new(max_new)
        mn = min(mn, self.max_out_len - pos)
        if mn <= 0:
            self._tier_stats["resume_misses"] += 1
            return None
        n_cross = int(meta["n_cross"])
        n_self_used = int(meta["n_self"])
        n_self = min(self.p_out, max(n_self_used,
                                     _ceil_div(pos + mn, ps)))
        try:
            pages = self.alloc.alloc(n_cross + n_self)
        except PoolCapacityError:
            self._tier_stats["resume_misses"] += 1
            return None
        cross_pages = pages[:n_cross]
        self_pages = pages[n_cross:]
        try:
            self._tier_upload(cross_pages,
                              {"kv": arrays["cross_kv"],
                               "scales": arrays.get("cross_scales")})
            if n_self_used:
                self._tier_upload(self_pages[:n_self_used],
                                  {"kv": arrays["self_kv"],
                                   "scales": arrays.get("self_scales")})
        except Exception:
            for p in pages:
                self.alloc.unref(p)
            self._tier_stats["resume_misses"] += 1
            return None
        lane.src = np.asarray(meta["src"], np.int64)
        lane.s_true = int(meta["s_true"])
        lane.max_new = mn
        lane.hashes = []
        lane.hit_hashes = []
        lane.inserted_hashes = []
        lane.enc_table = []
        lane.enc_owned = []
        lane.cross_table = cross_pages
        lane.cross_owned = cross_pages
        lane.self_table = self_pages
        lane.enc_done = lane.s_true
        lane.pending_chunk = 0
        lane.cur = int(meta["cur"])
        lane.pos = pos
        lane.phase = "decode"
        self._tier_stats["resumes"] += 1
        self._tracer.instant("session/resume", cat="serving",
                             sid=session_id, slot=slot, pos=pos,
                             pages=len(pages))
        return {"s_true": lane.s_true, "pos": pos, "max_new": mn}

    def tier_maintenance(self, prefetch=None) -> bool:
        """The serve loop's off-lock tier slice: complete pending
        suspends (d2h + artifact store), prefetch-promote a queued
        prompt's demoted chunks during the admission gap, and eager-
        demote LRU chunks down to the free-page watermark.  Returns
        True when any device/disk work happened (the scheduler counts
        that as progress so shutdown drains suspends)."""
        did = False
        for sid in list(self._pending_suspends):
            self._complete_suspend(sid)
            did = True
        if prefetch is not None and self.prefix_sharing \
                and self.alloc.tiered:
            hashes = chunk_hashes(np.asarray(prefetch).reshape(-1),
                                  self.page_size)
            resident = len(self.alloc.lookup_chain(hashes, count=False))
            for h in hashes[resident:]:
                if not self.alloc.promote_chunk(h):
                    break
                self._tier_stats["prefetches"] += 1
                did = True
        if self.demote_watermark and self.alloc.tiered:
            while self.alloc.free_count() < self.demote_watermark:
                if not self.alloc.demote_one():
                    break
                self._tier_stats["eager_demotes"] += 1
                did = True
        if self.sessions is not None \
                and self.sessions.idle_spill_s is not None:
            # suspend-on-idle at the host-RAM level: sessions nobody
            # resumed lately drop their RAM copy (disk keeps them)
            if self.sessions.spill_idle():
                did = True
        return did

    def _finish_prefill(self, lane: _Lane) -> None:
        lane.phase = "decode"
        if self.prefix_sharing:
            full = lane.s_true // self.page_size
            for i in range(len(lane.hit_hashes), full):
                enc, cross = lane.enc_table[i], lane.cross_table[i]
                if self.alloc.insert_chunk(lane.hashes[i], enc, cross):
                    # ownership of BOTH pages transfers to the cache entry
                    lane.inserted_hashes.append(lane.hashes[i])
                    lane.enc_owned.remove(enc)
                    lane.cross_owned.remove(cross)
        # decode only reads CROSS pages: the lane's non-cached encoder-KV
        # pages are dead weight from here on — free them now so admission
        # capacity tracks what a decoding request really holds
        for p in lane.enc_owned:
            self.alloc.unref(p)
        lane.enc_owned = []
        lane.enc_table = []

    def _prefill_arrays(self) -> Dict[str, np.ndarray]:
        """The chunked-prefill half of a unified-step feed: one source
        chunk per lane in phase ``prefill`` (recording each lane's
        ``pending_chunk``); every other lane rides trash-page writes.
        Pair with ``_absorb_prefill()`` after the step ran."""
        B, C, ps = self._slots, self.chunk, self.page_size
        feed = {"pf_word": np.zeros((B, C), np.int64),
                "pf_pos": np.zeros((B, C), np.int64),
                "pf_base": np.zeros(B, np.int32),
                "pf_len": np.ones(B, np.int32),
                "enc_table": np.zeros((B, self.p_src), np.int32),
                "enc_pages": np.full((B, C), TRASH_PAGE, np.int32),
                "cross_pages": np.full((B, C), TRASH_PAGE, np.int32),
                "w_offsets": np.zeros((B, C), np.int32)}
        for slot, lane in enumerate(self._lanes):
            if lane.phase != "prefill":
                continue
            done = lane.enc_done
            m = min(C, lane.s_true - done)
            lane.pending_chunk = m
            feed["pf_word"][slot, :m] = lane.src[done:done + m]
            feed["pf_pos"][slot, :m] = np.arange(done, done + m)
            feed["pf_base"][slot] = done
            feed["pf_len"][slot] = done + m
            feed["enc_table"][slot, :len(lane.enc_table)] = lane.enc_table
            pos = done + np.arange(m)
            feed["enc_pages"][slot, :m] = [lane.enc_table[p // ps]
                                           for p in pos]
            feed["cross_pages"][slot, :m] = [lane.cross_table[p // ps]
                                             for p in pos]
            feed["w_offsets"][slot, :m] = pos % ps
        return feed

    def _decode_arrays(self, n_tokens: int = 1) -> Dict[str, np.ndarray]:
        """Idle-default decode-half feed arrays — idle lanes ride
        trash-page writes, length-1 masks, position 0."""
        B = self._slots
        return {"trg_word": np.zeros((B, n_tokens), np.int64),
                "trg_pos": np.zeros((B, n_tokens), np.int64),
                "self_table": np.zeros((B, self.p_out), np.int32),
                "self_pages": np.full((B, n_tokens), TRASH_PAGE,
                                      np.int32),
                "self_offsets": np.zeros((B, n_tokens), np.int32),
                "self_lengths": np.ones(B, np.int32),
                "self_base": np.zeros(B, np.int32),
                "cross_table": np.zeros((B, self.p_src), np.int32),
                "src_lengths": np.ones(B, np.int32)}

    def _fill_decode_lane(self, dec: Dict[str, np.ndarray], slot: int,
                          lane, tokens, base_pos: int) -> None:
        """Fill one lane's rows of a ``_decode_arrays`` feed: ``tokens``
        embed at positions ``base_pos..base_pos+n-1`` and their K/V
        scatter into the lane's self pages at those slots."""
        ps = self.page_size
        n = len(tokens)
        t = int(base_pos)
        if t + n > len(lane.self_table) * ps:
            raise RuntimeError(
                f"slot {slot}: writing {n} token(s) at position {t} "
                f"runs past the reserved {len(lane.self_table)} "
                f"self pages")
        for j, tok in enumerate(tokens):
            dec["trg_word"][slot, j] = tok
            dec["trg_pos"][slot, j] = t + j
            dec["self_pages"][slot, j] = lane.self_table[(t + j) // ps]
            dec["self_offsets"][slot, j] = (t + j) % ps
        dec["self_table"][slot, :len(lane.self_table)] = lane.self_table
        dec["self_lengths"][slot] = t + n
        dec["self_base"][slot] = t
        dec["cross_table"][slot, :len(lane.cross_table)] = \
            lane.cross_table
        dec["src_lengths"][slot] = lane.s_true

    def _absorb_prefill(self) -> None:
        """Post-step bookkeeping for ``_prefill_arrays``: advance each
        prefilling lane past its pending chunk (the trace instant comes
        AFTER the step ran — a chunk that never ran must not appear in
        the request timeline)."""
        for slot, lane in enumerate(self._lanes):
            if lane.phase != "prefill":
                continue
            self._tracer.instant(
                "lane/prefill_chunk", cat="serving", slot=slot,
                tokens=lane.pending_chunk,
                done=lane.enc_done + lane.pending_chunk,
                total=lane.s_true)
            lane.enc_done += lane.pending_chunk
            lane.pending_chunk = 0
            if lane.enc_done >= lane.s_true:
                self._finish_prefill(lane)

    def step_feed(self) -> Dict[str, np.ndarray]:
        """The full feed of the next ``lane_step`` (prefill half + decode
        half) as host arrays; records each prefilling lane's pending
        chunk like ``lane_step`` does."""
        feed = self._prefill_arrays()
        dec = self._decode_arrays()
        for slot, lane in enumerate(self._lanes):
            if lane.phase == "decode" and lane.self_table:
                self._fill_decode_lane(dec, slot, lane, [lane.cur],
                                       lane.pos)
        feed.update(dec)
        return feed

    def run_feed(self, feed: Mapping[str, np.ndarray]):
        """Run one unified step on ``feed`` through the executor: the
        prefill tower and the decode step write the pool in place.
        Returns (next_ids int32 [B, 1], logits [B, 1, vocab]) as device
        tensors (a signature of its own beside ``lane_step``'s, over the
        same pool)."""
        _, _, next_ids, logits = self._unified
        nxt, lg = self._run(feed, [next_ids, logits])
        return nxt, lg

    def absorb_step(self, next_ids) -> Dict[int, int]:
        """Host bookkeeping after a step ran on ``step_feed()``'s feed:
        prefill lanes advance past their chunk, decode lanes take their
        token from ``next_ids`` ([B] or [B, 1]).  Returns {slot: token}
        for the lanes that decoded.  Feeding another run's ids here is
        how a comparison teacher-forces two generators alike."""
        ids = np.asarray(next_ids).reshape(self._slots)
        decoding = [slot for slot, lane in enumerate(self._lanes)
                    if lane.phase == "decode" and lane.self_table]
        self._steps += 1
        self._absorb_prefill()
        emitted: Dict[int, int] = {}
        for slot in decoding:
            lane = self._lanes[slot]
            tok = int(ids[slot])
            lane.cur = tok
            lane.pos += 1
            emitted[slot] = tok
        return emitted

    def lane_step(self) -> Dict[int, int]:
        """ONE step over every lane: prefill lanes advance one source
        chunk, decode lanes emit one token.  The next ids are the one
        fetch, and reading them is the step's one host wait.  Returns
        {slot: token} for the lanes that decoded."""
        if self._slots == 0:
            raise RuntimeError("open_slots() before lane_step()")
        nxt, = self._run(self.step_feed(), [self._unified[2]])
        return self.absorb_step(nxt.cpu().numpy())

    # -- greedy --------------------------------------------------------------
    def greedy(self, src_tokens, src_lengths, max_new: Optional[int] = None,
               stop_at_end: bool = True) -> np.ndarray:
        """Paged greedy decode of a whole batch: admit every row, then
        lane_step until done.  With ``stop_at_end`` every row stops at
        the first step where all rows have emitted ``end_id``."""
        src_tokens = np.asarray(src_tokens)
        src_lengths = np.asarray(src_lengths, np.int32)
        b = src_tokens.shape[0]
        max_new = min(max_new or self.max_out_len, self.max_out_len)
        self.open_slots(b)
        for i in range(b):
            self.admit_slot(i, src_tokens[i, :src_lengths[i]],
                            max_new=max_new)
        out: List[List[int]] = [[] for _ in range(b)]
        target = max_new
        while True:
            for i, lane in enumerate(self._lanes):
                if lane.phase == "decode" and len(out[i]) >= target:
                    lane.phase = "hold"
            if all(lane.phase in ("hold", "idle") for lane in self._lanes):
                break
            for slot, tok in self.lane_step().items():
                out[slot].append(tok)
            if stop_at_end and target == max_new:
                # columns = the latest first-end index + 1
                firsts = [row.index(self.end_id) + 1
                          if self.end_id in row else None for row in out]
                if all(f is not None or len(out[i]) >= max_new
                       for i, f in enumerate(firsts)):
                    target = min(max_new,
                                 max(f if f is not None else max_new
                                     for f in firsts))
        for i in range(b):
            self.clear_slot(i)
        return np.asarray([row[:target] for row in out], np.int64)

    # -- beam ----------------------------------------------------------------
    def beam(self, src_tokens, src_lengths, beam_size: int,
             max_new: Optional[int] = None, return_trace: bool = False):
        """Paged beam decode: the prompts chunk-prefill through the
        unified step, then b*W beam lanes decode over shared pages, one
        beam step each token.  After a step each selected hypothesis
        takes its parent's page table (every page reffed for the new
        table before the old tables are unreffed); a lane that will
        write into a page it shares gets a fresh page and the step copies
        the shared one into it first (copy-on-write, ``note_cow``).
        Every page is unreffed and every lane cleared in ``finally``,
        also after an error.  Returns (NestedSeqArray [b, W, T] best
        first, scores [b, W]), and with ``return_trace=True`` the
        per-step (ids, scores, parents) trajectory too."""
        W = int(beam_size)
        ps = self.page_size
        src_tokens = np.asarray(src_tokens)
        src_lengths = np.asarray(src_lengths, np.int32)
        b = src_tokens.shape[0]
        bw = b * W
        max_new = min(max_new or self.max_out_len, self.max_out_len)
        self.open_slots(b)
        for i in range(b):
            self.admit_slot(i, src_tokens[i, :src_lengths[i]], max_new=0)
        while any(lane.phase == "prefill" for lane in self._lanes):
            self.lane_step()
        prog, _, sel_ids_v, sel_scores_v, parent_v = \
            self._beam_steps.get(W) or self._build_beam_step(W)

        lane_tables: List[List[int]] = [[] for _ in range(bw)]
        lane_cross = np.zeros((bw, self.p_src), np.int32)
        lane_srclen = np.repeat(src_lengths, W).astype(np.int32)
        for i in range(b):
            tbl = self._lanes[i].cross_table
            for w in range(W):
                lane_cross[i * W + w, :len(tbl)] = tbl
        pre_ids = np.full((b, W), self.start_id, np.int64)
        pre_scores = np.concatenate(
            [np.zeros((b, 1), np.float32),
             np.full((b, W - 1), -1e9, np.float32)], axis=1)
        ids_steps = [pre_ids]
        score_steps = [pre_scores]
        parent_steps = [np.zeros((b, W), np.int32)]
        try:
            with fluid.scope_guard(self.scope):
                for t in range(max_new):
                    off = t % ps
                    cow_src = np.full(bw, TRASH_PAGE, np.int32)
                    cow_dst = np.full(bw, TRASH_PAGE, np.int32)
                    for ln in range(bw):
                        tbl = lane_tables[ln]
                        if off == 0:
                            tbl.append(self.alloc.alloc(1)[0])
                        elif self.alloc.refcount(tbl[-1]) > 1:
                            new = self.alloc.alloc(1)[0]
                            cow_src[ln] = tbl[-1]
                            cow_dst[ln] = new
                            self.alloc.unref(tbl[-1])
                            self.alloc.note_cow()
                            tbl[-1] = new
                    self_table = np.zeros((bw, self.p_out), np.int32)
                    self_pages = np.zeros((bw, 1), np.int32)
                    for ln in range(bw):
                        tbl = lane_tables[ln]
                        self_table[ln, :len(tbl)] = tbl
                        self_pages[ln, 0] = tbl[t // ps]
                    feed = {
                        "pre_ids": pre_ids, "pre_scores": pre_scores,
                        "trg_word": pre_ids.reshape(bw, 1),
                        "trg_pos": np.full((bw, 1), t, np.int64),
                        "cow_src": cow_src, "cow_dst": cow_dst,
                        "self_table": self_table,
                        "self_pages": self_pages,
                        "self_offsets": np.full((bw, 1), off, np.int32),
                        "self_lengths": np.full(bw, t + 1, np.int32),
                        "self_base": np.full(bw, t, np.int32),
                        "cross_table": lane_cross,
                        "src_lengths": lane_srclen,
                    }
                    si, ss, pa = self.exe.run(
                        prog, feed=feed,
                        fetch_list=[sel_ids_v, sel_scores_v, parent_v],
                        mode="infer")
                    pre_ids = np.asarray(si).astype(np.int64)
                    pre_scores = np.asarray(ss).astype(np.float32)
                    parent = np.asarray(pa).astype(np.int32)
                    # the table reorder: each selected hypothesis
                    # continues from its PARENT's pages — ref the new
                    # view of every lane first, then drop the old refs
                    new_tables = []
                    for i in range(b):
                        for w in range(W):
                            src_tbl = lane_tables[i * W + int(parent[i, w])]
                            for p in src_tbl:
                                self.alloc.ref(p)
                            new_tables.append(list(src_tbl))
                    for tbl in lane_tables:
                        for p in tbl:
                            self.alloc.unref(p)
                    lane_tables = new_tables
                    ids_steps.append(pre_ids)
                    score_steps.append(pre_scores)
                    parent_steps.append(parent)
                    if (pre_ids == self.end_id).all():
                        break
        finally:
            for tbl in lane_tables:
                for p in tbl:
                    self.alloc.unref(p)
            for i in range(b):
                self.clear_slot(i)
        out_ids, out_scores = self._backtrace(ids_steps, score_steps,
                                              parent_steps)
        if return_trace:
            return out_ids, out_scores, (ids_steps, score_steps,
                                         parent_steps)
        return out_ids, out_scores

    # -- ahead-of-traffic warm-up -----------------------------------------
    def bucket_set(self, n_slots: int):
        """The unified program's closed signature set at the given lane
        count: the batch axis is the ONLY dynamic feed axis, so this
        enumerates to exactly one signature per serving width (one
        captured step on the card)."""
        return enumerate_buckets(ProgramView(self._unified[0].desc),
                                 batch_buckets=(int(n_slots),))

    def aot_warm(self, n_slots: int) -> None:
        """Resolve the unified step AT THE SERVING LANE COUNT without
        admitting any request: one all-idle ``lane_step`` — every lane
        rides along with trash-page writes and length-1 masks, so no KV
        state or lane bookkeeping changes.  On the card this is the
        step's capture in a CUDA graph.  Lanes are left open at
        ``n_slots`` (the scheduler re-opens them at attach anyway)."""
        if any(lane.phase != "idle" for lane in self._lanes):
            raise RuntimeError(
                "aot_warm: lanes are busy — pre-resolution is for "
                "load/publish time, not mid-traffic")
        self.open_slots(int(n_slots))
        self.lane_step()

    # -- accounting ----------------------------------------------------------
    def kv_bytes_per_slot_dense(self) -> int:
        """What ONE lane costs in the dense-cache decoder — the baseline
        the paged pool's bytes in use are compared against."""
        return dense_kv_bytes_per_slot(self.cfg, self.src_len,
                                       self.max_out_len)

    def kv_bytes_per_token(self) -> int:
        """Device bytes one cached token costs across every layer, K and
        V (int8 pools include their fp32 block-scale sidecar)."""
        return self.page_bytes // self.page_size

    def cache_stats(self) -> Dict[str, object]:
        """Page / prefix / pool-bytes accounting next to the executor's
        executable-cache counters (the zero-recompile assertion surface),
        the host tier's and the session store's counters (the
        reference's shard block is not ported)."""
        pages = self.alloc.stats()
        active = sum(1 for lane in self._lanes
                     if lane.phase not in ("idle",))
        in_use_bytes = self.page_bytes * pages["in_use"]
        return {
            "executable": self.exe.cache_stats()["executable"],
            "pages": pages,
            "steps": self._steps,
            "hbm": {
                "kv_dtype": self.kv_dtype,
                "page_bytes": self.page_bytes,
                "kv_bytes_per_token": self.kv_bytes_per_token(),
                "pool_bytes": self.page_bytes * self.num_pages,
                "bytes_in_use": in_use_bytes,
                "bytes_per_active_slot": (in_use_bytes // active)
                if active else 0,
                "dense_bytes_per_slot": self.kv_bytes_per_slot_dense(),
            },
            "tiers": {
                "host_pages": pages.get("host_pages", 0),
                "host_pages_used": pages.get("host_pages_used", 0),
                "host_chunks": pages.get("host_chunks", 0),
                "demotes": pages.get("demotes", 0),
                "promotes": pages.get("promotes", 0),
                "host_evictions": pages.get("host_evictions", 0),
                "spilled_bytes": pages.get("spilled_bytes", 0),
                "fetched_bytes": pages.get("fetched_bytes", 0),
                "pending_suspends": len(self._pending_suspends),
                **self._tier_stats,
            },
            "sessions": self.sessions.stats()
            if self.sessions is not None else None,
        }
