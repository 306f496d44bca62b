"""Grammar/JSON-constrained generation: precompiled token masks — the
port's copy of ``paddle_tpu/serving/constraints.py``, host-only (the
same specs give the same mask rows, bit for bit).

Constrained decoding restricts each emitted token to the set a grammar
allows at the current derivation state.  The device half is ONE additive
``logit_mask`` feed (0 for allowed tokens, ``MASKED`` for banned) applied
in-graph before the argmax — masks ride as DATA through the unified
verify/draft programs (serving/paged_decoder.build_unified_program with
``logit_masks=True``), so a constraint change, per request, NEVER
re-captures anything.  This module is the host half: small token-level
automata whose per-state masks are precompiled to numpy rows at
construction, advanced along the committed tokens of a lane.

Two constraint families cover the gateway's wire format
(``compile_constraint``):

* ``{"type": "token_set", "allowed": [ids...]}`` — a constant
  vocabulary restriction (one precompiled mask row).  The end token is
  always allowed unless ``"allow_end": false``.
* ``{"type": "dfa", "start": s, "edges": [[state, token, next], ...],
  "accept": [states...]}`` — a token-level DFA: state ``s`` allows
  exactly the tokens with an outgoing edge, plus the end token in
  accepting states.  JSON-ish templates ("field id, then a value from
  this set, then a separator, ...") compile to exactly this shape.

Why this raises speculative accept rates on structured output: BOTH the
draft and the target argmax over masked logits, so wherever the grammar
pins the next token (single-outgoing-edge states — separators,
brackets, field names) the two models agree by construction, and the
draft's k-token guess survives verification more often.

The mask applied at speculative position j is computed by advancing a
COPY of the committed state along the draft tokens before j — if the
verifier rejects at j, the committed state never advanced, so rollback
is free on the host side too (SpeculativeGenerator owns that walk)."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Constraint", "TokenSetConstraint", "DFAConstraint",
           "compile_constraint", "MASKED"]

# additive mask value for a banned token — the attention-bias constant
# (models/transformer.make_attn_bias): large enough to dominate any
# logit this model family produces, small enough to stay finite in f32
MASKED = -1e9


class Constraint:
    """A token-level constraint: per-state precompiled masks + advance.

    States are opaque hashables; ``mask(state)`` returns the ADDITIVE
    float32 [vocab] row for the NEXT token (0 allowed / MASKED banned),
    ``advance(state, token)`` the successor state.  Implementations
    precompile every mask row at construction — the per-step host cost
    is a dict lookup and a row copy into the feed buffer."""

    vocab_size: int

    def start_state(self):
        raise NotImplementedError

    def mask(self, state) -> np.ndarray:
        raise NotImplementedError

    def advance(self, state, token: int):
        raise NotImplementedError

    def allows(self, state, token: int) -> bool:
        return bool(self.mask(state)[int(token)] == 0.0)

    def mask_bytes(self) -> int:
        """Resident bytes of the precompiled mask table — what a
        memoizing holder (the speculative generator's LRU) must budget
        by: a single huge grammar can outweigh hundreds of small ones."""
        raise NotImplementedError


class TokenSetConstraint(Constraint):
    """Restrict generation to a fixed vocabulary subset (stateless)."""

    def __init__(self, allowed: Iterable[int], vocab_size: int,
                 end_id: Optional[int] = None, allow_end: bool = True):
        self.vocab_size = int(vocab_size)
        ids = sorted({int(t) for t in allowed})
        if allow_end and end_id is not None:
            ids = sorted(set(ids) | {int(end_id)})
        bad = [t for t in ids if not 0 <= t < self.vocab_size]
        if bad:
            raise ValueError(f"token_set: ids {bad} outside vocab "
                             f"[0, {self.vocab_size})")
        if not ids:
            raise ValueError("token_set: empty allowed set would mask "
                             "every token")
        self.allowed = ids
        self._mask = np.full(self.vocab_size, MASKED, np.float32)
        self._mask[ids] = 0.0

    def mask_bytes(self) -> int:
        return int(self._mask.nbytes)

    def start_state(self):
        return 0

    def mask(self, state) -> np.ndarray:
        return self._mask

    def advance(self, state, token: int):
        return 0


class DFAConstraint(Constraint):
    """Token-level DFA with one precompiled mask row per state.

    ``edges`` map (state, token) -> next state; a state allows exactly
    its outgoing tokens, plus ``end_id`` when the state is accepting.
    A state with no outgoing edges and no accept bit would dead-end the
    generation (every token masked) — rejected at construction.
    Advancing on a token the state does not allow parks the automaton
    in the accept-only terminal (emission already ended or the caller
    broke the contract; the mask then only lets the end token out)."""

    _TERMINAL = object()      # post-end parking state: end token only

    def __init__(self, start, edges: Dict[Tuple[object, int], object],
                 accept: Iterable[object], vocab_size: int, end_id: int):
        self.vocab_size = int(vocab_size)
        self.end_id = int(end_id)
        if not 0 <= self.end_id < self.vocab_size:
            raise ValueError(f"dfa: end_id {end_id} outside vocab "
                             f"[0, {self.vocab_size})")
        self.start = start
        self.edges = {(s, int(t)): n for (s, t), n in edges.items()}
        bad = sorted({t for _, t in self.edges
                      if not 0 <= t < self.vocab_size})
        if bad:
            # a negative id would SILENTLY unmask the wrong token
            # (numpy wraps negative indices); an oversized one would
            # IndexError deep in the mask build — both are spec bugs
            # the submit-time 400 path must name
            raise ValueError(f"dfa: edge token ids {bad} outside vocab "
                             f"[0, {self.vocab_size})")
        self.accept = set(accept)
        states = ({start} | self.accept
                  | {s for s, _ in self.edges} | set(self.edges.values()))
        # one linear pass builds state -> outgoing tokens; rescanning
        # the edge dict per state would make construction quadratic in
        # the grammar size (submit-time latency for big JSON templates)
        adjacency: Dict[object, List[int]] = {}
        for (s, t) in self.edges:
            adjacency.setdefault(s, []).append(t)
        self._masks: Dict[object, np.ndarray] = {}
        for s in states:
            row = np.full(self.vocab_size, MASKED, np.float32)
            outgoing = adjacency.get(s, [])
            row[outgoing] = 0.0
            if s in self.accept:
                row[self.end_id] = 0.0
            if not outgoing and s not in self.accept:
                raise ValueError(
                    f"dfa: state {s!r} has no outgoing edges and is not "
                    f"accepting — generation would dead-end with every "
                    f"token masked")
            self._masks[s] = row
        term = np.full(self.vocab_size, MASKED, np.float32)
        term[self.end_id] = 0.0
        self._masks[self._TERMINAL] = term

    def mask_bytes(self) -> int:
        return int(sum(m.nbytes for m in self._masks.values()))

    def start_state(self):
        return self.start

    def mask(self, state) -> np.ndarray:
        return self._masks.get(state, self._masks[self._TERMINAL])

    def advance(self, state, token: int):
        nxt = self.edges.get((state, int(token)))
        if nxt is not None:
            return nxt
        return self._TERMINAL


def compile_constraint(spec, vocab_size: int, end_id: int) -> Constraint:
    """Wire-format constraint spec -> precompiled ``Constraint``.

    Specs are plain JSON (what ``/v1/generate`` carries and the request
    journal replays); an already-built ``Constraint`` passes through so
    in-process callers can hand custom automata straight to the
    generator.  Raises ``ValueError`` on a malformed spec — the gateway
    maps that to HTTP 400 at submit, before anything queues."""
    if isinstance(spec, Constraint):
        return spec
    if not isinstance(spec, dict):
        raise ValueError(f"constraint: expected a spec dict, got "
                         f"{type(spec).__name__}")
    kind = spec.get("type")
    if kind == "token_set":
        if "allowed" not in spec:
            raise ValueError("token_set constraint needs 'allowed'")
        return TokenSetConstraint(
            spec["allowed"], vocab_size, end_id=end_id,
            allow_end=bool(spec.get("allow_end", True)))
    if kind == "dfa":
        try:
            edges_in: Sequence = spec["edges"]
            start = spec["start"]
        except KeyError as e:
            raise ValueError(f"dfa constraint needs {e.args[0]!r}")
        edges: Dict[Tuple[object, int], object] = {}
        for e in edges_in:
            if not isinstance(e, (list, tuple)) or len(e) != 3:
                raise ValueError(
                    f"dfa edge {e!r}: expected [state, token, next]")
            s, t, n = e
            edges[(_key(s), int(t))] = _key(n)
        return DFAConstraint(_key(start), edges,
                             [_key(s) for s in spec.get("accept", [])],
                             vocab_size, end_id)
    raise ValueError(f"constraint: unknown type {kind!r} "
                     "(token_set or dfa)")


def _key(state) -> object:
    """JSON state labels arrive as str/int — normalize to a hashable
    canonical form so "3" and 3 in one spec cannot silently split a
    state in two."""
    if isinstance(state, bool) or not isinstance(state, (int, str)):
        raise ValueError(f"dfa: state labels must be str or int, got "
                         f"{state!r}")
    return str(state)


def masks_along(constraint: Constraint, state, tokens: Sequence[int]
                ) -> Tuple[List[np.ndarray], List[object]]:
    """The speculative mask walk: mask rows for positions 0..len(tokens)
    where position j's mask assumes ``tokens[:j]`` were emitted — the
    per-position masks a verify dispatch feeds (position 0 = the next
    committed emission, later positions condition on the draft's
    guesses).  Returns (len(tokens)+1 mask rows, the states after each
    prefix) so the caller can commit the state for whatever prefix the
    verifier accepts without re-walking."""
    masks = [constraint.mask(state)]
    states = [state]
    for t in tokens:
        state = constraint.advance(state, int(t))
        states.append(state)
        masks.append(constraint.mask(state))
    return masks, states
