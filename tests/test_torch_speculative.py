"""The port's speculative and constrained decoding against the JAX
package, on the CPU, at the reference tests' sizes
(``tests/test_speculative.py``: V=24, 2 layers, 2 heads, d_key=4,
d_model=16, src 8, 8 new tokens, page 4, chunk 4, 64 pages, k=3).

Each package builds its target, an identical-weights draft (accept rate
1.0) and a reseeded draft (which disagrees almost always) over one
scope; the port's scope takes the JAX scope's arrays.  Checked:

* the verify and draft programs serialize to the reference's bytes and
  ``bucket_set`` is the reference's;
* with either draft, the speculative streams equal the JAX package's
  and plain greedy's token for token, and the ``speculative`` counters
  (rounds, drafted, accepted, bonus, emitted, draft and verify steps,
  copy-on-write copies) equal the JAX package's exactly;
* ``token_set`` and DFA-constrained outputs equal the JAX package's,
  speculative or not, and follow the grammar;
* rollback and copy-on-write under prefix sharing make the JAX
  package's page-table moves, with ``check_invariants`` after every
  round; a shared self page is copied before the verify step writes;
  copy-on-write pool exhaustion aborts before any table is touched;
  ``rollback_to`` continues to the same tokens; a draft-pool refusal
  releases the target's pages;
* mixed speculative, plain and constrained traffic through both
  packages' schedulers gives the same tokens per request, and a plain
  group refuses decode options as the reference's does;
* ``beam`` raises; the constraint objects give the reference's mask
  rows and errors; the constraint cache keeps its byte budget and its
  accounting under four threads;
* after ``aot_warm`` a batch at the warmed lane count adds no executable
  miss to either executor.
"""

import threading

import numpy as np
import pytest

from paddle_tpu import fluid as jfluid
from paddle_tpu.serving import ContinuousBatchingScheduler as JaxScheduler
from paddle_tpu.serving import PagedTransformerGenerator as JaxGenerator
from paddle_tpu.serving import SpeculativeGenerator as JaxSpeculative
from paddle_tpu.serving import constraints as jax_constraints
from paddle_tpu.serving import copy_weights as jax_copy_weights
from paddle_tpu_torch import fluid
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      DFAConstraint,
                                      PagedTransformerGenerator,
                                      PoolCapacityError,
                                      SpeculativeGenerator,
                                      TokenSetConstraint,
                                      compile_constraint, copy_weights)
from paddle_tpu_torch.serving import speculative
from paddle_tpu_torch.serving.constraints import MASKED

V, NL, NH, DK, DM, DI = 24, 2, 2, 4, 16, 32
SRC, OUT, PS, CHUNK = 8, 8, 4, 4
END = 1
K = 3
KW = dict(n_layer=NL, n_head=NH, d_key=DK, d_value=DK, d_model=DM,
          d_inner_hid=DI, max_length=64, src_len=SRC, max_out_len=OUT,
          page_size=PS, chunk_size=CHUNK, num_pages=64)
COUNTS = ("rounds", "drafted", "accepted", "bonus", "emitted",
          "plain_tokens", "draft_steps", "verify_steps", "cow_copies")
TOKEN_SET = {"type": "token_set", "allowed": [4, 5, 6]}
DFA = {"type": "dfa", "start": "a",
       "edges": [["a", t, "b"] for t in (2, 3)]
       + [["b", t, "a"] for t in (8, 9)], "accept": ["a"]}


@pytest.fixture(scope="module")
def both():
    """{"jax": (spec same, target, spec other), "port": (...)}: the port's
    over a scope holding the JAX scope's arrays."""
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    kw = dict(KW, scope=scope, executor=exe)
    target = JaxGenerator(V, V, param_prefix="tgt", **kw)
    same = JaxGenerator(V, V, param_prefix="dsame", **kw)
    other = JaxGenerator(V, V, param_prefix="dother", **kw)
    target.init_params(seed=7)
    jax_copy_weights(scope, scope, prefix="tgt", dst_prefix="dsame")
    with jfluid.scope_guard(scope):
        other._unified[1].random_seed = 99
        exe.run(other._unified[1])
    out = {"jax": (JaxSpeculative(target, same, k=K),
                   target, JaxSpeculative(target, other, k=K))}
    tscope = fluid.Scope()
    assert copy_weights(scope, tscope) > 0
    tkw = dict(KW, scope=tscope, executor=fluid.Executor(fluid.CPUPlace()))
    gens = {p: PagedTransformerGenerator(V, V, param_prefix=p, **tkw)
            for p in ("tgt", "dsame", "dother")}
    out["port"] = (SpeculativeGenerator(gens["tgt"], gens["dsame"], k=K),
                   gens["tgt"],
                   SpeculativeGenerator(gens["tgt"], gens["dother"], k=K))
    return out


def _sources(seed=0, n=4):
    rng = np.random.RandomState(seed)
    seqs = [rng.randint(2, V, rng.randint(3, SRC + 1)) for _ in range(n)]
    src = np.zeros((n, SRC), np.int64)
    lens = np.zeros(n, np.int32)
    for i, s in enumerate(seqs):
        src[i, :len(s)] = s
        lens[i] = len(s)
    return seqs, src, lens


def _counts(spec):
    st = spec.cache_stats()["speculative"]
    return {k: st[k] for k in COUNTS}


def _delta(after, before):
    return {k: after[k] - before[k] for k in COUNTS}


def _plain(both, src, lens):
    """Plain greedy of the target in both packages (equal), run on both
    sides so the two targets' prefix caches keep one history."""
    want = both["jax"][1].greedy(src, lens, max_new=OUT, stop_at_end=False)
    got = both["port"][1].greedy(src, lens, max_new=OUT, stop_at_end=False)
    np.testing.assert_array_equal(got, want)
    return got


def _trunc_at_end(row):
    row = [int(t) for t in row]
    return row[:row.index(END) + 1] if END in row else row


def test_programs_serialize_like_the_reference(both):
    jspec, _, _ = both["jax"]
    tspec, _, _ = both["port"]
    for w, g in ((jspec._verify, tspec._verify),
                 (jspec._draft_prog, tspec._draft_prog),
                 ((jspec._build_cow(),), (tspec._build_cow(),))):
        assert g[0].desc.serialize_to_string() == \
            w[0].desc.serialize_to_string()
    assert tspec.bucket_set(4) == jspec.bucket_set(4)
    with pytest.raises(NotImplementedError, match="A14"):
        speculative.estimate_speculative_hbm({}, {})


@pytest.mark.parametrize("draft", ["same", "other"])
def test_streams_and_counts_match_jax(both, draft):
    """Both drafts, speculative without stop_at_end, then plain lanes
    (decode={"draft": False}) with it: the port's streams are the JAX package's and plain greedy's, and every
    speculative counter moves as the JAX package's does."""
    i = 0 if draft == "same" else 2
    _, src, lens = _sources(seed=1)
    ref = _plain(both, src, lens)
    for stop_at_end, spec_on in ((False, True), (True, False)):
        rows, deltas = [], []
        for side in ("jax", "port"):
            spec = both[side][i]
            c0 = _counts(spec)
            rows.append(spec.greedy(src, lens, max_new=OUT,
                                    stop_at_end=stop_at_end,
                                    speculative=spec_on))
            deltas.append(_delta(_counts(spec), c0))
        np.testing.assert_array_equal(rows[1], rows[0])
        if not stop_at_end:
            np.testing.assert_array_equal(rows[1], ref)
        assert deltas[1] == deltas[0]
    st = both["port"][i].cache_stats()["speculative"]
    if draft == "same":
        assert st["accept_rate"] == 1.0
    else:
        assert st["drafted"] > 0 and st["accept_rate"] < 1.0
    both["port"][i].check_invariants()


@pytest.mark.parametrize("constraint", ["token_set", "dfa"])
def test_constrained_outputs_match_jax(both, constraint):
    spec_c = TOKEN_SET if constraint == "token_set" else DFA
    _, src, lens = _sources(seed=9)
    # high and low accept rates, and the grammar on plain lanes
    for i, spec_on in ((0, True), (2, True), (0, False)):
        rows, deltas = [], []
        for side in ("jax", "port"):
            spec = both[side][i]
            c0 = _counts(spec)
            rows.append(spec.greedy(src, lens, max_new=OUT,
                                    stop_at_end=False,
                                    speculative=spec_on,
                                    constraint=spec_c))
            deltas.append(_delta(_counts(spec), c0))
        np.testing.assert_array_equal(rows[1], rows[0])
        assert deltas[1] == deltas[0]
        for row in rows[1]:
            _assert_grammar(constraint, row)


def _assert_grammar(constraint, row):
    if constraint == "token_set":
        assert all(int(t) in {4, 5, 6, END} for t in row), row
        return
    state = "a"
    for t in (int(t) for t in row):
        if state == "TERM":
            assert t == END
        elif t == END:
            assert state == "a"
            state = "TERM"
        else:
            assert t in {"a": {2, 3}, "b": {8, 9}}[state], row
            state = "b" if state == "a" else "a"


def _alloc_state(alloc):
    return (list(alloc._free), dict(alloc._ref),
            {h: list(e) for h, e in alloc._chunks.items()},
            list(alloc._evictable))


def test_rollback_under_prefix_sharing_matches_jax(both):
    """Speculative rounds over lanes whose prompts share a prefix-cached
    chunk, with the mismatched draft (rollback every round): each
    round's tokens, lane tables and both allocators' states are the JAX
    package's, and the invariants hold after every round."""
    rng = np.random.RandomState(5)
    base = rng.randint(2, V, SRC)
    n = 4
    src = np.tile(base, (n, 1)).astype(np.int64)
    src[1:, PS:] = rng.randint(2, V, (n - 1, SRC - PS))
    specs = [both["jax"][2], both["port"][2]]
    for spec in specs:
        spec.open_slots(n)
        spec.admit_slot(0, src[0], max_new=OUT)
    while specs[1].target._lanes[0].phase == "prefill":
        assert specs[1].lane_step() == specs[0].lane_step()
    for spec in specs:
        for i in range(1, n):
            spec.admit_slot(i, src[i], max_new=OUT)
    out = [[] for _ in range(n)]
    while any(len(o) < OUT for o in out):
        want = specs[0].lane_step()
        got = specs[1].lane_step()
        assert got == want
        for slot, toks in got.items():
            out[slot].extend(toks)
        for part in ("target", "draft"):
            assert _alloc_state(getattr(specs[1], part).alloc) == \
                _alloc_state(getattr(specs[0], part).alloc)
        assert [list(ln.self_table) for ln in specs[1].target._lanes] == \
            [list(ln.self_table) for ln in specs[0].target._lanes]
        specs[1].check_invariants()
    for spec in specs:
        for i in range(n):
            spec.clear_slot(i)
    specs[1].check_invariants()
    ref = _plain(both, src, np.full(n, SRC, np.int32))
    np.testing.assert_array_equal(
        ref, np.asarray([o[:OUT] for o in out], np.int64))


def _to_decode(spec, seq):
    """Slot 0 of 4 (the lane count the other tests run at) decoding."""
    spec.open_slots(4)
    spec.admit_slot(0, seq, max_new=OUT)
    while spec.target._lanes[0].phase == "prefill" or \
            spec.draft._lanes[0].phase == "prefill":
        spec.lane_step()


def test_cow_shared_self_page_matches_jax(both):
    """An external holder of a lane's self page: the verify round first
    copies it (one copy-on-write in both packages, the same new table),
    and the shared page's bytes are untouched."""
    seqs, _, _ = _sources(seed=6, n=1)
    tables = []
    for side in ("jax", "port"):
        spec = both[side][0]
        _to_decode(spec, seqs[0])
        tl = spec.target._lanes[0]
        shared = tl.self_table[0]
        spec.target.alloc.ref(shared)
        cow0 = _counts(spec)["cow_copies"]
        before = _pool_rows(spec, shared)
        toks = spec.lane_step()
        assert tl.self_table[0] != shared
        assert _counts(spec)["cow_copies"] == cow0 + 1
        np.testing.assert_array_equal(_pool_rows(spec, shared), before)
        spec.check_invariants()
        tables.append((list(tl.self_table), toks))
        spec.target.alloc.unref(shared)
        spec.clear_slot(0)
        spec.check_invariants()
    assert tables[1] == tables[0]


def _pool_rows(spec, page):
    pool = spec.target.scope.find_var(f"{spec.target.prefix}@kv_pool")
    rows = np.arange(2 * NL) + page * 2 * NL
    return np.array(np.asarray(pool)[:, rows])


def test_cow_pool_exhaustion_aborts_before_surgery(both):
    spec = both["port"][0]
    seqs, _, _ = _sources(seed=13, n=1)
    _to_decode(spec, seqs[0])
    alloc = spec.target.alloc
    tl = spec.target._lanes[0]
    shared = tl.self_table[0]
    alloc.ref(shared)
    hog = []
    try:
        while True:
            try:
                hog.extend(alloc.alloc(1))
            except PoolCapacityError:
                break
        table_before = list(tl.self_table)
        before = _pool_rows(spec, shared)
        with pytest.raises(PoolCapacityError):
            spec.lane_step()
        assert list(tl.self_table) == table_before
        spec.check_invariants()
        np.testing.assert_array_equal(_pool_rows(spec, shared), before)
    finally:
        for p in hog:
            alloc.unref(p)
        alloc.unref(shared)
        spec.clear_slot(0)
    spec.check_invariants()


def test_rollback_to_continues_to_the_same_tokens(both):
    seqs, _, _ = _sources(seed=7, n=1)
    spec = both["port"][0]
    spec.open_slots(1)
    spec.admit_slot(0, seqs[0], max_new=OUT)
    got = []
    while len(got) < 5:
        for _, toks in spec.lane_step().items():
            got.extend(toks)
    spec.rollback_to(0, 2, got[1])
    assert (spec.target._lanes[0].pos, spec.target._lanes[0].cur) == \
        (2, got[1])
    cont = []
    while len(cont) < 3:
        for _, toks in spec.lane_step().items():
            cont.extend(toks)
    assert cont[:3] == got[2:5]
    spec.clear_slot(0)
    spec.check_invariants()
    spec.open_slots(1)
    spec.admit_slot(0, seqs[0], max_new=OUT,
                    decode={"constraint": TOKEN_SET})
    with pytest.raises(ValueError, match="constrained"):
        spec.rollback_to(0, 0, 0)
    spec.clear_slot(0)


def test_draft_pool_refusal_releases_target_pages():
    scope = fluid.Scope()
    kw = dict(KW, scope=scope, executor=fluid.Executor(fluid.CPUPlace()))
    target = PagedTransformerGenerator(V, V, param_prefix="tp", **kw)
    tiny = PagedTransformerGenerator(V, V, param_prefix="dp",
                                     **dict(kw, num_pages=4))
    spec = SpeculativeGenerator(target, tiny, k=2)
    spec.open_slots(1)
    free_before = target.alloc.available()
    with pytest.raises(PoolCapacityError):
        spec.admit_slot(0, np.arange(2, 2 + SRC), max_new=OUT)
    assert target.alloc.available() == free_before
    spec.check_invariants()
    with pytest.raises(ValueError, match="share one scope"):
        SpeculativeGenerator(target, target, k=2)
    with pytest.raises(ValueError, match="k must be"):
        SpeculativeGenerator(target, tiny, k=0)


def test_scheduler_mixed_traffic_matches_jax(both):
    """Nine requests with speculative, plain and constrained decode
    options through 4 lanes of each package's scheduler: the same tokens
    per request, the unconstrained ones plain greedy's."""
    seqs, src, lens = _sources(seed=10, n=9)
    refs = [_trunc_at_end(r) for r in _plain(both, src, lens)]
    out = []
    for sched_cls, side in ((JaxScheduler, "jax"),
                            (ContinuousBatchingScheduler, "port")):
        spec = both[side][2]
        sched = sched_cls(spec, n_slots=4, max_new_tokens=OUT)
        reqs = []
        for i, s in enumerate(seqs):
            decode = {"draft": i % 2 == 0}
            if i % 3 == 2:
                decode["constraint"] = TOKEN_SET
            reqs.append(sched.submit(s, max_new_tokens=OUT, decode=decode))
        sched.run_until_idle()
        assert all(r.done and r.error is None for r in reqs)
        st = sched.stats()
        assert st["finished"] == len(reqs) and st["failed"] == 0
        out.append([r.tokens for r in reqs])
        spec.check_invariants()
    assert out[1] == out[0]
    for i, toks in enumerate(out[1]):
        if i % 3 == 2:
            assert all(t in {4, 5, 6, END} for t in toks)
        else:
            assert toks == refs[i]


def test_plain_group_refuses_decode_options(both):
    """A plain group refuses a grammar or a draft at submit; a request
    whose alias re-resolves to a plain group before admission fails
    without a token served off-grammar, and an explicit opt-out is
    served plain (the reference's rules)."""
    spec, target, _ = both["port"]
    sched = ContinuousBatchingScheduler(target, n_slots=2,
                                        max_new_tokens=OUT)
    with pytest.raises(ValueError):
        sched.submit(np.arange(2, 6), max_new_tokens=4,
                     decode={"draft": True})
    routes = {"m": "spec"}
    sched = ContinuousBatchingScheduler(
        max_new_tokens=OUT, resolve=lambda alias: routes.get(alias, alias))
    sched.add_model("spec", spec, 2)
    sched.add_model("plain", target, 2)
    req = sched.submit(np.arange(2, 6), max_new_tokens=4, model="m",
                       decode={"constraint": TOKEN_SET})
    routes["m"] = "plain"
    sched.run_until_idle()
    assert req.done and isinstance(req.error, ValueError)
    assert req.tokens == []
    ok = sched.submit(np.arange(2, 6), max_new_tokens=4, model="m")
    optout = sched.submit(np.arange(2, 6), max_new_tokens=4, model="plain",
                          decode={"draft": False})
    sched.run_until_idle()
    assert ok.error is None and optout.error is None
    assert optout.tokens == ok.tokens


def test_beam_raises_and_decode_options_are_checked(both):
    spec = both["port"][0]
    with pytest.raises(NotImplementedError, match="mutually"):
        spec.beam(np.zeros((1, SRC), np.int64), np.full(1, SRC, np.int32),
                  beam_size=2)
    spec.open_slots(1)
    with pytest.raises(ValueError, match="unknown decode options"):
        spec.admit_slot(0, np.arange(2, 6), max_new=4, decode={"beam": 2})


def test_constraint_objects_match_jax():
    """The same specs give the same mask rows, states and errors."""
    specs = [TOKEN_SET, DFA,
             {"type": "token_set", "allowed": [3], "allow_end": False},
             {"type": "dfa", "start": 0, "edges": [[0, 2, 1], [1, 3, 0]],
              "accept": [0]}]
    for spec_c in specs:
        ours = compile_constraint(spec_c, V, END)
        ref = jax_constraints.compile_constraint(spec_c, V, END)
        assert type(ours).__name__ == type(ref).__name__
        assert ours.mask_bytes() == ref.mask_bytes()
        s, r = ours.start_state(), ref.start_state()
        for tok in (2, 8, 3, 9, END, 5):
            assert ours.mask(s).tobytes() == ref.mask(r).tobytes()
            s, r = ours.advance(s, tok), ref.advance(r, tok)
        rows, states = speculative.masks_along(ours, ours.start_state(),
                                               [2, 8, 4])
        jrows, jstates = jax_constraints.masks_along(
            ref, ref.start_state(), [2, 8, 4])
        assert [m.tobytes() for m in rows] == [m.tobytes() for m in jrows]
    c = compile_constraint({"type": "token_set", "allowed": [3, 4]}, V, END)
    assert isinstance(c, TokenSetConstraint)
    assert c.mask(0)[5] == MASKED == jax_constraints.MASKED
    assert isinstance(compile_constraint(DFA, V, END), DFAConstraint)
    bad = [{"type": "token_set"}, {"type": "nope"}, [1, 2],
           {"type": "dfa", "start": 0, "edges": [[0, 2, 1]], "accept": []},
           {"type": "dfa", "start": 0, "edges": [[0, V + 10, 0]],
            "accept": [0]},
           {"type": "dfa", "start": 0, "edges": [[0, -1, 0]],
            "accept": [0]},
           {"type": "dfa", "edges": []},
           {"type": "dfa", "start": True, "edges": [], "accept": []}]
    for b in bad:
        with pytest.raises(ValueError):
            compile_constraint(b, V, END)
        with pytest.raises(ValueError):
            jax_constraints.compile_constraint(b, V, END)
    with pytest.raises(ValueError):
        TokenSetConstraint([], V, end_id=None)


def test_constraint_cache_byte_budget(both):
    spec = both["port"][0]
    spec._constraint_cache.clear()
    spec._constraint_bytes = 0
    row = V * 4
    spec._CONSTRAINT_CACHE_MAX_BYTES = 2 * row
    try:
        spec.compile_constraint({"type": "token_set", "allowed": [3]})
        spec.compile_constraint({"type": "token_set", "allowed": [4]})
        assert len(spec._constraint_cache) == 2
        spec.compile_constraint({"type": "token_set", "allowed": [5]})
        assert len(spec._constraint_cache) == 2
        assert spec._constraint_bytes <= 2 * row
        spec._CONSTRAINT_CACHE_MAX_BYTES = row // 2
        spec.compile_constraint({"type": "token_set", "allowed": [6]})
        assert len(spec._constraint_cache) == 1
    finally:
        del spec._CONSTRAINT_CACHE_MAX_BYTES
        spec._constraint_cache.clear()
        spec._constraint_bytes = 0


def test_constraint_cache_thread_safety(both):
    spec = both["port"][0]
    spec._constraint_cache.clear()
    spec._constraint_bytes = 0
    spec._CONSTRAINT_CACHE_MAX_BYTES = 4 * V * 4
    errs = []

    def worker(i):
        try:
            for j in range(60):
                spec.compile_constraint(
                    {"type": "token_set", "allowed": [2 + (i + j) % 10]})
        except Exception as e:          # pragma: no cover - the bug
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert not errs, errs
        assert spec._constraint_bytes == sum(
            c.mask_bytes() for c in spec._constraint_cache.values())
        assert spec._constraint_lock.rank == 46
    finally:
        del spec._CONSTRAINT_CACHE_MAX_BYTES
        spec._constraint_cache.clear()
        spec._constraint_bytes = 0


def test_no_executable_miss_after_aot_warm(both):
    """``aot_warm(4)`` resolves the draft, verify and copy-on-write steps
    at 4 lanes: speculative, plain and constrained batches of 4 then
    add hits and no miss on either executor, as in the JAX package."""
    _, src, lens = _sources(seed=3)
    deltas = []
    for side in ("jax", "port"):
        spec = both[side][2]
        spec.aot_warm(4)
        c0 = spec.cache_stats()
        spec.greedy(src, lens, max_new=OUT, stop_at_end=False)
        spec.greedy(src, lens, max_new=OUT, stop_at_end=False,
                    speculative=False, constraint=DFA)
        c1 = spec.cache_stats()
        deltas.append({k: c1[k]["misses"] - c0[k]["misses"]
                       for k in ("executable", "draft_executable")})
        assert c1["executable"]["hits"] > c0["executable"]["hits"]
    assert deltas[1] == deltas[0] == {"executable": 0,
                                      "draft_executable": 0}


@pytest.mark.parametrize("draft", ["same", "other"])
def test_chip_smoke_draft_margin_probe(both, draft):
    """``chip_smoke.draft_margin_probe``, which holds the card's
    identical draft to an accept rate of 1.0 but for its own near ties:
    it accounts for every drafted token, finds a rejection in each round
    without the bonus token (none with the identical draft), excuses a
    rejection only where the draft's margin is under the tolerance, and
    takes its wrappers off after the block."""
    import torch

    import chip_smoke

    spec = both["port"][0 if draft == "same" else 2]
    _, src, lens = _sources(seed=4)
    seen = {}
    for tol in (0.0, float("inf")):
        c0 = _counts(spec)
        with chip_smoke.draft_margin_probe(torch, spec, tol) as rec:
            spec.greedy(src, lens, max_new=OUT, stop_at_end=False)
        d = _delta(_counts(spec), c0)
        assert rec["untracked"] == 0 and rec["drafted"] == d["drafted"] > 0
        assert len(rec["rejections"]) == d["rounds"] - d["bonus"]
        assert rec["excused" if tol else "unexcused"] == \
            len(rec["rejections"])
        assert rec["unexcused" if tol else "excused"] == 0
        assert all(m >= 0 for _, _, m in rec["rejections"])
        seen[tol] = rec["rejections"]
        assert "_dispatch_verify" not in vars(spec)
        assert "_dispatch_draft" not in vars(spec)
        assert "run" not in vars(spec.draft.exe)
    assert seen[0.0] == seen[float("inf")]
    assert (len(seen[0.0]) > 0) == (draft == "other")
