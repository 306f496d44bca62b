"""Speculative decoding on the paged engine — the port of
``paddle_tpu/serving/speculative.py``.

Decode is the memory-bound hot path: every plain decode step streams the
whole target model (weights and KV pages) to emit ONE token.
Speculative decoding spends k cheap draft-model steps to GUESS k
tokens, then verifies all k in ONE target-model step: when the draft
agrees with the target, each pass over the target's weights buys up to
k+1 tokens instead of one.

``SpeculativeGenerator`` composes two ``PagedTransformerGenerator``s —
the target and a small draft — into one scheduler-facing slot model:

* **draft**: k steps of the draft's prefill+masked-decode program
  (``build_unified_program(verify_tokens=1, logit_masks=True)``) guess
  tokens d_1..d_k; the draft keeps its own paged KV pool and page
  tables, prefilling the same prompt through the same chunked machinery.
* **verify**: ONE step of the target's program built with
  ``verify_tokens=k+1`` scores the inputs [cur, d_1..d_k] at positions
  t..t+k — ``models.transformer.verify_step`` writes every token's K/V
  into the lane's self pages and attends with the ragged kernel's
  per-query causal bound (C = k+1 queries a lane), so position j
  conditions on exactly the tokens before it.  Lanes ride the same
  captured step whatever they do: a plain lane verifies just its
  current token, a draft-short lane pads with trash-page writes — mixed
  speculative/plain traffic never re-captures.
* **accept/reject**: greedy equivalence — accept the longest prefix
  where the target's argmax matches the draft, plus the target's own
  token at the first mismatch (or the bonus k+1-th on full agreement).
  Every emitted token is what plain greedy decoding of the target
  would have produced.  Rollback of rejected tokens is host-side
  position/page-table truncation: the K/V past the accepted point is
  re-written by the next round before any causally-masked read can see
  it.  A written-to self page that is SHARED (refcount > 1) is copied
  (``paged_page_copy``) BEFORE the verify step, so a page another
  holder references is never written.
* **constrained generation**: a per-request grammar
  (``serving/constraints.py``) feeds additive token masks as DATA into
  both the draft and verify programs — masked along the draft's own
  guesses, committed only for the accepted prefix.

Both programs run through the generators' executors in their scopes: on
the card each is captured in a CUDA graph at its lane count, and every
ragged attention of a verify or draft step is the CUDA kernel's launch.
The host logic is the reference's, line for line, so both packages make
the same decisions on the same requests.  Beam search and speculation
are mutually exclusive (``beam()`` raises).  The joint static HBM
estimate is not ported (``estimate_speculative_hbm`` raises).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import fluid
from ..fluid import layers
from ..fluid.analysis.dataflow import ProgramView
from ..fluid.analysis.recompile import enumerate_buckets
from ..observability import tracing as _obs_tracing
from ..utils.sync import RANK_CONSTRAINTS, OrderedLock
from .constraints import Constraint, compile_constraint, masks_along
from .paged_decoder import PagedTransformerGenerator, build_unified_program
from .paging import TRASH_PAGE

__all__ = ["SpeculativeGenerator", "estimate_speculative_hbm"]


def estimate_speculative_hbm(target_config: Dict, draft_config: Dict,
                             k: int = 4, assume_lanes: int = None,
                             assume_donation: bool = True):
    """The reference's joint static peak-HBM plan of a speculative pair,
    priced from two gateway manifests before any construction.  It rests
    on the static HBM planner (``estimate_generator_hbm``,
    ``fluid.analysis.cost``), which is not ported (ROADMAP A14)."""
    raise NotImplementedError(
        "estimate_speculative_hbm: the static HBM planner "
        "(estimate_generator_hbm, ROADMAP A14) is not ported to "
        "paddle_tpu_torch")


class _SpecState:
    """Per-slot speculative bookkeeping beside the target/draft lanes."""

    __slots__ = ("speculative", "constraint", "c_state", "pending",
                 "d_pos")

    def __init__(self):
        self.reset()

    def reset(self):
        self.speculative = False
        self.constraint: Optional[Constraint] = None
        self.c_state = None
        # committed input tokens the draft has not consumed yet (always
        # ends with the target lane's current token); the draft's next
        # write position is d_pos — on full acceptance the draft is one
        # input behind the target and catches up next round
        self.pending: List[int] = []
        self.d_pos = 0


class _Agenda:
    """One lane's drafting work inside a single round."""

    __slots__ = ("queue", "want", "drafts", "fed", "constraint", "mstate")

    def __init__(self, queue, want, constraint, mstate):
        self.queue = list(queue)     # known inputs (committed backlog)
        self.want = int(want)        # draft tokens to produce
        self.drafts: List[int] = []
        self.fed = 0                 # inputs dispatched so far
        self.constraint = constraint
        self.mstate = mstate         # constraint state along the drafts

    @property
    def total_inputs(self) -> int:
        return len(self.queue) + self.want - 1

    def next_input(self) -> Optional[int]:
        if self.fed >= self.total_inputs:
            return None
        seq = self.queue + self.drafts
        return seq[self.fed]


class SpeculativeGenerator:
    """Draft-k-verify-once serving over two paged generators.

    Implements the page-aware managed scheduler protocol
    (``open_slots / admit_slot / clear_slot / lane_step / can_admit /
    prompt_infeasible``) with one extension: ``admit_slot`` takes a
    per-request ``decode`` dict (``{"draft": bool, "constraint": spec}``
    — the scheduler forwards ``Request.decode``) and ``lane_step``
    returns ``{slot: [tokens]}`` — up to k+1 tokens per lane per round.
    Token-for-token parity with plain greedy decoding holds for every
    lane whatever the draft does; speculation and constraints only
    change HOW FAST and WITHIN WHAT grammar the same tokens appear."""

    page_aware = True
    speculative_aware = True

    def __init__(self, target: PagedTransformerGenerator,
                 draft: PagedTransformerGenerator, k: int = 4,
                 draft_name: Optional[str] = None):
        if k < 1:
            raise ValueError(f"speculative k must be >= 1, got {k}")
        tc, dc = target.cfg, draft.cfg
        if (tc.src_vocab_size, tc.trg_vocab_size) != \
                (dc.src_vocab_size, dc.trg_vocab_size):
            raise ValueError(
                "speculative: target and draft must share vocabularies "
                f"(target {tc.src_vocab_size}/{tc.trg_vocab_size}, draft "
                f"{dc.src_vocab_size}/{dc.trg_vocab_size})")
        if (target.start_id, target.end_id) != (draft.start_id,
                                                draft.end_id):
            raise ValueError("speculative: target and draft must share "
                             "start_id/end_id")
        if (target.src_len, target.max_out_len) != (draft.src_len,
                                                    draft.max_out_len):
            raise ValueError(
                "speculative: target and draft must share src_len/"
                f"max_out_len (target {target.src_len}/"
                f"{target.max_out_len}, draft {draft.src_len}/"
                f"{draft.max_out_len})")
        if target.scope is draft.scope and target.prefix == draft.prefix:
            raise ValueError(
                "speculative: target and draft share one scope AND one "
                "param_prefix — their weights would alias; give the "
                "draft its own prefix or its own scope")
        self.target = target
        self.draft = draft
        self.k = int(k)
        self.verify_tokens = self.k + 1
        self.draft_name = draft_name
        self.cfg = target.cfg
        self.prefix = target.prefix
        self.start_id, self.end_id = target.start_id, target.end_id
        self.src_len, self.max_out_len = target.src_len, target.max_out_len
        self.page_size = target.page_size
        self.page_bytes = target.page_bytes
        self.num_pages = target.num_pages
        self.kv_dtype = target.kv_dtype
        self._slots = 0
        self._spec: List[_SpecState] = []
        self._tracer = _obs_tracing.tracer()
        self._constraint_cache: Dict[str, Constraint] = {}
        self._constraint_bytes = 0
        self._constraint_lock = OrderedLock("serving.constraints",
                                            RANK_CONSTRAINTS)
        self._stats = {"rounds": 0, "drafted": 0, "accepted": 0,
                       "bonus": 0, "emitted": 0, "plain_tokens": 0,
                       "draft_steps": 0, "verify_steps": 0,
                       "cow_copies": 0}
        # the TARGET's program at the verify width (k+1 tokens + mask
        # feed) — prefill tower included, so one dispatch per round
        # covers chunked prefill AND k-token verification
        self._verify = build_unified_program(
            tc, src_len=target.src_len, max_out_len=target.max_out_len,
            page_size=target.page_size, num_pages=target.num_pages,
            chunk_size=target.chunk, param_prefix=target.prefix,
            kv_dtype=target.kv_dtype, verify_tokens=self.verify_tokens,
            logit_masks=True)
        # the DRAFT's program: its own prefill tower + a masked 1-token
        # decode (constraints must shape the draft's guesses, or a
        # grammar would reject every speculative token)
        self._draft_prog = build_unified_program(
            dc, src_len=draft.src_len, max_out_len=draft.max_out_len,
            page_size=draft.page_size, num_pages=draft.num_pages,
            chunk_size=draft.chunk, param_prefix=draft.prefix,
            kv_dtype=draft.kv_dtype, verify_tokens=1, logit_masks=True)
        self._cow = None

    # -- parameter init ------------------------------------------------------
    def init_params(self, seed: Optional[int] = None,
                    draft_seed: Optional[int] = None) -> None:
        """Random-init both models (tests/bench; production loads real
        weights through the registry).  ``draft_seed=None`` reuses
        ``seed`` — with identical dims that makes draft == target, the
        accept-rate-1.0 parity configuration."""
        self.target.init_params(seed=seed)
        self.draft.init_params(
            seed=seed if draft_seed is None else draft_seed)

    # -- admission accounting (both pools must fit) --------------------------
    def can_admit(self, src_tokens, max_new: Optional[int] = None) -> bool:
        # conservative for plain requests (they take no draft pages):
        # admission has no per-request decode info, and an admit that
        # later failed on the draft pool would have to unwind the target
        return self.target.can_admit(src_tokens, max_new) and \
            self.draft.can_admit(src_tokens, max_new)

    def prompt_infeasible(self, src_tokens,
                          max_new: Optional[int] = None) -> bool:
        return self.target.prompt_infeasible(src_tokens, max_new) or \
            self.draft.prompt_infeasible(src_tokens, max_new)

    def pages_needed(self, src_tokens,
                     max_new: Optional[int] = None) -> int:
        return self.target.pages_needed(src_tokens, max_new) + \
            self.draft.pages_needed(src_tokens, max_new)

    @property
    def alloc(self):
        """The target's page allocator (the gateway's invariant-check
        hook); the draft pool has its own — ``check_invariants`` covers
        both."""
        return self.target.alloc

    def check_invariants(self) -> None:
        self.target.alloc.check_invariants()
        self.draft.alloc.check_invariants()

    # -- constraints ---------------------------------------------------------
    # memoized compiled constraints: LRU bounded by entry count AND
    # resident mask bytes — specs are client-supplied, so an unbounded
    # memo would let a tenant grow one mask table per request forever,
    # and a count cap alone would still let a few huge DFA grammars
    # (one [vocab] float32 row PER STATE) pin gigabytes of host memory
    _CONSTRAINT_CACHE_MAX = 128
    _CONSTRAINT_CACHE_MAX_BYTES = 256 << 20

    def compile_constraint(self, spec) -> Constraint:
        """Wire spec -> precompiled ``Constraint``, memoized per spec
        (the gateway validates at submit with this; admissions reuse
        the cached automaton instead of re-walking the mask tables).
        Thread-safe: gateway HTTP threads validate concurrently with
        the serve loop's admissions — the CPU-heavy grammar compile
        runs OUTSIDE the lock; the loser of a same-spec race drops its
        duplicate."""
        if isinstance(spec, Constraint):
            return spec
        key = json.dumps(spec, sort_keys=True, default=str)
        with self._constraint_lock:
            c = self._constraint_cache.get(key)
            if c is not None:
                # move-to-back = LRU recency (plain dicts iterate in
                # insertion order)
                self._constraint_cache.pop(key)
                self._constraint_cache[key] = c
                return c
        fresh = compile_constraint(spec, self.cfg.trg_vocab_size,
                                   self.end_id)
        with self._constraint_lock:
            c = self._constraint_cache.get(key)
            if c is not None:       # a racing compile won: reuse its
                return c            # entry, drop the duplicate masks
            self._constraint_cache[key] = fresh
            self._constraint_bytes += fresh.mask_bytes()
            while len(self._constraint_cache) > 1 and (
                    len(self._constraint_cache) >
                    self._CONSTRAINT_CACHE_MAX
                    or self._constraint_bytes >
                    self._CONSTRAINT_CACHE_MAX_BYTES):
                # oldest first (dicts iterate in insertion order); the
                # > 1 guard keeps the just-inserted entry resident even
                # when it alone exceeds the byte budget — the request
                # that brought it still needs it
                old = self._constraint_cache.pop(
                    next(iter(self._constraint_cache)))
                self._constraint_bytes -= old.mask_bytes()
        return fresh

    # -- continuous-batching surface -----------------------------------------
    def open_slots(self, n_slots: int) -> None:
        self.target.open_slots(n_slots)
        self.draft.open_slots(n_slots)
        self._slots = int(n_slots)
        self._spec = [_SpecState() for _ in range(self._slots)]
        # reusable logit-mask feed buffers: allocating + zero-filling a
        # [B, K, vocab] array per dispatch is real host hot-path cost
        # for fully unconstrained traffic — instead, rows a constraint
        # dirtied are tracked and re-zeroed lazily before the next use
        V = self.cfg.trg_vocab_size
        self._dmask = np.zeros((self._slots, 1, V), np.float32)
        self._vmask = np.zeros((self._slots, self.verify_tokens, V),
                               np.float32)
        self._dmask_dirty: set = set()
        self._vmask_dirty: set = set()

    def admit_slot(self, slot: int, src_tokens_1d,
                   max_new: Optional[int] = None,
                   decode: Optional[Dict] = None) -> int:
        """Admit into the target (and, for speculative requests, the
        draft) pool and arm the lane's decode options.  ``decode``:
        ``{"draft": bool (default True), "constraint": spec|Constraint}``
        — what the scheduler forwards from ``Request.decode``."""
        opts = dict(decode or {})
        unknown = set(opts) - {"draft", "constraint"}
        if unknown:
            raise ValueError(f"admit_slot: unknown decode options "
                             f"{sorted(unknown)} (draft, constraint)")
        speculative = bool(opts.get("draft", True))
        constraint = opts.get("constraint")
        constraint = (self.compile_constraint(constraint)
                      if constraint is not None else None)
        s_true = self.target.admit_slot(slot, src_tokens_1d,
                                        max_new=max_new)
        if speculative:
            try:
                self.draft.admit_slot(slot, src_tokens_1d,
                                      max_new=max_new)
            except BaseException:
                # all-or-nothing: a draft-pool refusal must not leak the
                # target admission
                self.target.clear_slot(slot)
                raise
        st = self._spec[slot]
        st.reset()
        st.speculative = speculative
        st.constraint = constraint
        if constraint is not None:
            st.c_state = constraint.start_state()
        if speculative:
            st.pending = [self.start_id]
            st.d_pos = 0
        return s_true

    def clear_slot(self, slot: int) -> None:
        self.target.clear_slot(slot)
        self.draft.clear_slot(slot)
        self._spec[slot].reset()

    # -- copy-on-write protection --------------------------------------------
    def _build_cow(self):
        """Standalone page-copy program over the TARGET pool: [B] src ->
        dst whole-page copies (trash no-ops for idle lanes) — dispatched
        BEFORE a verify that would write a shared page, so a page some
        other holder still references is never mutated."""
        c = self.cfg
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup), fluid.unique_name.guard():
            pool = self.target._pool_var(prog.global_block())
            kv_scales = self.target._scales_var(prog.global_block())
            src = layers.data("cow_src", [], "int32")
            dst = layers.data("cow_dst", [], "int32")
            if kv_scales is not None:
                layers.paged_page_copy(pool, src, dst, n_layer=c.n_layer,
                                       scales=kv_scales)
            else:
                layers.paged_page_copy(pool, src, dst, n_layer=c.n_layer)
        self._cow = prog
        return prog

    def _dispatch_cow(self, pairs: List[Tuple[int, int]]) -> None:
        prog = self._cow or self._build_cow()
        B = self._slots
        for i in range(0, len(pairs), B):
            chunk = pairs[i:i + B]
            src = np.full(B, TRASH_PAGE, np.int32)
            dst = np.full(B, TRASH_PAGE, np.int32)
            for j, (s, d) in enumerate(chunk):
                src[j], dst[j] = s, d
            with fluid.scope_guard(self.target.scope):
                self.target.exe.run(prog, feed={"cow_src": src,
                                                "cow_dst": dst},
                                    mode="infer")

    def _cow_candidates(self, slot: int, n_inputs: int
                        ) -> List[Tuple[int, int, int]]:
        """Scan ONLY: (slot, table index, shared page) triples for the
        self pages this lane's verify round will WRITE (slots
        t..t+n_inputs-1) that are shared (refcount > 1).  No allocation
        and no page-table mutation — the caller allocates EVERY fresh
        page in one all-or-nothing ``alloc(n)`` first, so a pool-
        capacity failure aborts the round before any lane's table is
        touched (surgery before a failed alloc would leave earlier
        lanes pointing at never-copied garbage pages)."""
        tl = self.target._lanes[slot]
        ps = self.target.page_size
        t = tl.pos
        return [(slot, idx, tl.self_table[idx])
                for idx in sorted({(t + j) // ps
                                   for j in range(n_inputs)})
                if self.target.alloc.refcount(tl.self_table[idx]) > 1]

    def _cow_commit(self, cands: List[Tuple[int, int, int]],
                    fresh: List[int]) -> List[Tuple[int, int]]:
        """Page-table surgery once every fresh page is in hand: swap
        the private copy in, drop the shared reference, and return the
        (src, dst) byte-copy pairs for ``_dispatch_cow``.  A page whose
        refcount fell to 1 since the scan (an earlier entry in THIS
        commit dropped the other holder) no longer needs a copy — its
        fresh page goes straight back to the pool."""
        alloc = self.target.alloc
        pairs: List[Tuple[int, int]] = []
        for (slot, idx, page), dst in zip(cands, fresh):
            tl = self.target._lanes[slot]
            if alloc.refcount(page) <= 1:
                alloc.unref(dst)
                continue
            pairs.append((page, dst))
            alloc.unref(page)
            alloc.note_cow()
            self._stats["cow_copies"] += 1
            tl.self_table[idx] = dst
        return pairs

    def rollback_to(self, slot: int, n_tokens: int, cur_token: int) -> None:
        """Explicit truncation of a lane's committed sequence to
        ``n_tokens`` emitted tokens with ``cur_token`` as the pending
        input — the accept/reject path does this implicitly every round;
        exposed for host-side revert policies.  Pure position/page-table
        bookkeeping: reserved pages stay reserved, stale K/V past the
        truncation point is overwritten before any causally-masked read,
        and the next write COW-protects any shared page.  Constrained
        lanes refuse (the automaton state cannot be rewound without the
        emission history — re-admit instead)."""
        st = self._spec[slot]
        if st.constraint is not None:
            raise ValueError("rollback_to: constrained lanes cannot "
                             "rewind the grammar state; re-admit the "
                             "request instead")
        tl = self.target._lanes[slot]
        if tl.phase not in ("decode", "hold"):
            raise RuntimeError(f"rollback_to: slot {slot} is not decoding")
        if not 0 <= int(n_tokens) <= tl.pos:
            raise ValueError(f"rollback_to: n_tokens {n_tokens} outside "
                             f"[0, {tl.pos}]")
        if st.speculative and int(n_tokens) > st.d_pos:
            # after a fully-accepted round the draft is one input
            # behind the commit point; a "rollback" to past its
            # processed depth would need committed tokens this
            # generator does not record — the draft's KV at the gap
            # slot would silently go stale and accept rates degrade
            raise ValueError(
                f"rollback_to: n_tokens {n_tokens} is ahead of the "
                f"draft's processed depth {st.d_pos} — roll back to "
                f"<= {st.d_pos} or re-admit the request")
        tl.pos = int(n_tokens)
        tl.cur = int(cur_token)
        if st.speculative:
            st.pending = [int(cur_token)]
            st.d_pos = int(n_tokens)

    # -- dispatches ----------------------------------------------------------
    def _dispatch_draft(self, plan: Dict[int, Tuple[int, object]]
                        ) -> np.ndarray:
        """One draft-program dispatch: draft prefill chunks for lanes
        still prefilling + one masked decode token per planned lane
        (``plan``: slot -> (input token, mask row or None)).  Returns
        the [B] argmax ids."""
        d = self.draft
        B = self._slots
        feed = d._prefill_arrays()
        dec = d._decode_arrays()
        mask = self._dmask
        for slot in self._dmask_dirty:
            mask[slot] = 0.0
        self._dmask_dirty.clear()
        for slot, (tok, mrow) in plan.items():
            dl = d._lanes[slot]
            st = self._spec[slot]
            # the draft writes at its OWN depth d_pos (it may trail the
            # target's committed position after a fully-accepted round)
            d._fill_decode_lane(dec, slot, dl, [tok], st.d_pos)
            if mrow is not None:
                mask[slot, 0] = mrow
                self._dmask_dirty.add(slot)
        feed.update(dec)
        feed["logit_mask"] = mask
        prog, _, next_ids, _ = self._draft_prog
        with fluid.scope_guard(d.scope):
            out, = d.exe.run(prog, feed=feed, fetch_list=[next_ids],
                             return_numpy=False, mode="infer")
        ids = out.cpu().numpy().reshape(B)
        d._absorb_prefill()
        self._stats["draft_steps"] += 1
        return ids

    def _dispatch_verify(self, rows: Dict[int, Tuple[List[int],
                                                     Optional[List]]]
                         ) -> np.ndarray:
        """ONE target dispatch: chunked prefill for admitting lanes +
        k-token verification for ``rows`` (slot -> (input tokens, mask
        rows)).  Returns the [B, k+1] argmax ids."""
        tgt = self.target
        B, K = self._slots, self.verify_tokens
        cands: List[Tuple[int, int, int]] = []
        for slot, (inputs, _m) in rows.items():
            cands.extend(self._cow_candidates(slot, len(inputs)))
        if cands:
            # all-or-nothing: alloc raises BEFORE any table surgery
            fresh = self.target.alloc.alloc(len(cands))
            cow = self._cow_commit(cands, fresh)
            if cow:
                self._dispatch_cow(cow)
        feed = tgt._prefill_arrays()
        dec = tgt._decode_arrays(K)
        mask = self._vmask
        for slot in self._vmask_dirty:
            mask[slot] = 0.0
        self._vmask_dirty.clear()
        for slot, (inputs, mrows) in rows.items():
            tl = tgt._lanes[slot]
            tgt._fill_decode_lane(dec, slot, tl, inputs, tl.pos)
            if mrows is not None:
                mask[slot, :len(mrows)] = mrows
                self._vmask_dirty.add(slot)
        feed.update(dec)
        feed["logit_mask"] = mask
        prog, _, next_ids, _ = self._verify
        with fluid.scope_guard(tgt.scope):
            out, = tgt.exe.run(prog, feed=feed, fetch_list=[next_ids],
                               return_numpy=False, mode="infer")
        ids = out.cpu().numpy().reshape(B, K)
        tgt._absorb_prefill()
        self._stats["verify_steps"] += 1
        return ids

    # -- the round -----------------------------------------------------------
    def lane_step(self) -> Dict[int, List[int]]:
        """One speculative round over every lane: draft dispatches guess
        up to k tokens per speculative lane, ONE verify dispatch scores
        them (and advances target prefill chunks), accept/reject commits
        the longest matching prefix + the target's own next token.
        Returns {slot: [tokens]} — plain lanes emit one token, drafting
        lanes one to k+1."""
        B = self._slots
        if B == 0:
            raise RuntimeError("open_slots() before lane_step()")
        ready: List[int] = []
        for slot in range(B):
            tl = self.target._lanes[slot]
            if tl.phase != "decode" or not tl.self_table:
                continue
            if tl.pos >= tl.max_new:
                # the lane's reservation is spent (max_new tokens
                # emitted): nothing left to verify — the scheduler
                # retires it from the emitted tokens; a caller stepping
                # lanes itself sees it emit nothing further
                continue
            st = self._spec[slot]
            if st.speculative and \
                    self.draft._lanes[slot].phase == "prefill":
                continue        # the draft's cheap prefill finishes first
            ready.append(slot)

        # ---- draft phase: backlog catch-up + k guesses per lane
        agendas: Dict[int, _Agenda] = {}
        for slot in ready:
            st = self._spec[slot]
            if not st.speculative:
                continue
            tl = self.target._lanes[slot]
            n = min(self.k, tl.max_new - tl.pos - 1)
            if n <= 0:
                continue        # one token left: verify rides plain
            agendas[slot] = _Agenda(st.pending, n, st.constraint,
                                    st.c_state)
        while True:
            plan: Dict[int, Tuple[int, object]] = {}
            for slot, ag in agendas.items():
                tok = ag.next_input()
                if tok is None:
                    continue
                mrow = None
                if ag.constraint is not None:
                    mrow = ag.constraint.mask(ag.mstate)
                plan[slot] = (int(tok), mrow)
            draft_prefilling = any(lane.phase == "prefill"
                                   for lane in self.draft._lanes)
            if not plan and not draft_prefilling:
                break
            ids = self._dispatch_draft(plan)
            for slot in plan:
                ag = agendas[slot]
                keep = ag.fed >= len(ag.queue) - 1
                ag.fed += 1
                self._spec[slot].d_pos += 1
                if keep and len(ag.drafts) < ag.want:
                    tok = int(ids[slot])
                    ag.drafts.append(tok)
                    if ag.constraint is not None:
                        ag.mstate = ag.constraint.advance(ag.mstate, tok)

        # ---- verify phase: ONE target dispatch for every ready lane
        rows: Dict[int, Tuple[List[int], Optional[List]]] = {}
        walks: Dict[int, List] = {}
        for slot in ready:
            tl = self.target._lanes[slot]
            st = self._spec[slot]
            drafts = agendas[slot].drafts if slot in agendas else []
            inputs = [tl.cur] + drafts
            mrows = None
            if st.constraint is not None:
                mrows, states = masks_along(st.constraint, st.c_state,
                                            drafts)
                walks[slot] = states
            rows[slot] = (inputs, mrows)
        if not rows and not any(lane.phase == "prefill"
                                for lane in self.target._lanes):
            return {}
        ids = self._dispatch_verify(rows)

        # ---- accept/reject + commit
        emitted_map: Dict[int, List[int]] = {}
        for slot, (inputs, _m) in rows.items():
            tl = self.target._lanes[slot]
            st = self._spec[slot]
            drafts = inputs[1:]
            n = len(drafts)
            g = ids[slot]
            emitted: List[int] = []
            for i in range(n):
                if int(g[i]) != drafts[i]:
                    break
                emitted.append(drafts[i])
            m = len(emitted)                  # accepted draft tokens
            emitted.append(int(g[m]))         # correction / bonus token
            a = len(emitted)
            old_pos = tl.pos
            tl.cur = emitted[-1]
            tl.pos = old_pos + a
            if st.speculative:
                if n > 0 and a == n + 1:
                    # full acceptance incl. the bonus: the draft never
                    # processed its own last guess — it catches up with
                    # [d_n, bonus] before drafting next round
                    st.pending = [drafts[-1], emitted[-1]]
                    st.d_pos = old_pos + n
                elif n > 0:
                    st.pending = [emitted[-1]]
                    st.d_pos = old_pos + a
                else:
                    st.pending.append(emitted[-1])
            if st.constraint is not None:
                base_state = walks[slot][m] if slot in walks \
                    else st.c_state
                st.c_state = st.constraint.advance(base_state,
                                                   emitted[-1])
            if n > 0:
                self._stats["rounds"] += 1
                self._stats["drafted"] += n
                self._stats["accepted"] += m
                if m == n:
                    self._stats["bonus"] += 1
                self._tracer.instant("lane/speculative_round",
                                     cat="serving", slot=slot,
                                     drafted=n, accepted=m,
                                     emitted=a)
            else:
                self._stats["plain_tokens"] += 1
            self._stats["emitted"] += a
            emitted_map[slot] = emitted
        return emitted_map

    # -- greedy parity front-end ---------------------------------------------
    def greedy(self, src_tokens, src_lengths,
               max_new: Optional[int] = None, stop_at_end: bool = True,
               speculative: bool = True, constraint=None) -> np.ndarray:
        """Speculative greedy decode of a whole batch — token-for-token
        identical to ``PagedTransformerGenerator.greedy`` on the target
        weights, at any accept rate, with speculation on or off."""
        src_tokens = np.asarray(src_tokens)
        src_lengths = np.asarray(src_lengths, np.int32)
        b = src_tokens.shape[0]
        max_new = min(max_new or self.max_out_len, self.max_out_len)
        self.open_slots(b)
        decode = {"draft": bool(speculative)}
        if constraint is not None:
            decode["constraint"] = constraint
        for i in range(b):
            self.admit_slot(i, src_tokens[i, :src_lengths[i]],
                            max_new=max_new, decode=decode)
        out: List[List[int]] = [[] for _ in range(b)]
        target = max_new
        while True:
            for i, lane in enumerate(self.target._lanes):
                if lane.phase == "decode" and len(out[i]) >= target:
                    lane.phase = "hold"
            if all(lane.phase in ("hold", "idle")
                   for lane in self.target._lanes):
                break
            for slot, toks in self.lane_step().items():
                out[slot].extend(toks)
            if stop_at_end and target == max_new:
                # dense stop semantics (the paged/dense decoders' rule):
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

    def beam(self, *a, **k):
        """Mutually exclusive with speculation: beam reorders page
        tables across lanes every step, invalidating the draft/target
        position bookkeeping mid-round.  Route beam workloads to a
        plain ``PagedTransformerGenerator`` group."""
        raise NotImplementedError(
            "beam search and speculative decoding are mutually "
            "exclusive — serve beam requests from a plain paged "
            "generator group")

    # -- ahead-of-traffic warm-up -----------------------------------------
    def aot_warm(self, n_slots: int) -> None:
        """Resolve the draft, verify AND copy-on-write steps at the
        serving lane count without admitting any request (all-idle
        steps: trash-page writes, length-1 masks).  On the card these
        are the three steps' captures in CUDA graphs."""
        if any(lane.phase != "idle" for lane in self.target._lanes) or \
                any(lane.phase != "idle" for lane in self.draft._lanes):
            raise RuntimeError(
                "aot_warm: lanes are busy — pre-resolution is for "
                "load/publish time, not mid-traffic")
        self.open_slots(int(n_slots))
        self._dispatch_draft({})
        self._dispatch_verify({})
        # one trash->trash pair: a no-op copy, but it puts the COW step
        # through its capture (an empty pair list runs nothing)
        self._dispatch_cow([(TRASH_PAGE, TRASH_PAGE)])

    def bucket_set(self, n_slots: int):
        """The closed compile-signature set of the speculative pair at
        the given lane count: the verify program, the draft program,
        and the COW page-copy program — each with the batch axis as its
        only dynamic feed axis (``enumerate_buckets``)."""
        prog = self._cow or self._build_cow()
        out = []
        for p in (self._verify[0], self._draft_prog[0], prog):
            out.extend(enumerate_buckets(ProgramView(p.desc),
                                         batch_buckets=(int(n_slots),)))
        return out

    # -- accounting ----------------------------------------------------------
    def kv_bytes_per_token(self) -> int:
        """Target-pool bytes per cached token (the draft pool's bytes
        are reported separately in ``cache_stats``)."""
        return self.target.kv_bytes_per_token()

    def cache_stats(self) -> Dict[str, object]:
        """Accept-rate + dispatch accounting beside both executors'
        executable-cache counters (the zero-recompile assertion surface
        covers the draft AND verify programs) and both pools' page
        stats."""
        sp = dict(self._stats)
        sp["k"] = self.k
        sp["accept_rate"] = (round(sp["accepted"] / sp["drafted"], 4)
                             if sp["drafted"] else None)
        sp["tokens_per_round"] = (
            round((sp["emitted"] - sp["plain_tokens"])
                  / sp["rounds"], 4) if sp["rounds"] else None)
        tstats = self.target.cache_stats()
        return {
            "executable": tstats["executable"],
            "draft_executable": self.draft.exe.cache_stats()[
                "executable"],
            "pages": tstats["pages"],
            "draft_pages": self.draft.alloc.stats(),
            "hbm": dict(tstats["hbm"],
                        draft_pool_bytes=(self.draft.page_bytes
                                          * self.draft.num_pages)),
            "steps": sp["verify_steps"],
            "speculative": sp,
        }
