"""The port's Executor: its executable and structure caches, the seed
buffer of a step, ``run_steps`` and ``run_pipeline``, on the CPU.

On the card a step is captured in a CUDA graph at its first run and
replayed after; on the CPU the executor keeps the same caches, static
buffers and copies and runs the step eagerly where the card replays it,
so these tests hold that bookkeeping:

* ``cache_stats()`` counts hits, misses, evictions and sizes as the JAX
  executor does on the same call sequences;
* the seed buffer of steps 1-3 holds ``op_seed(seed, step, salt)`` of
  each random op, and ``keep_scale`` keyed on a tensor seed gives the
  int's mask, so dropout masks are the parent's bit for bit;
* ``run_steps`` equals k ``run()`` calls bitwise (fetches and final
  scope) on a 2-layer Transformer with dropout, draws a new mask each
  step, and matches the JAX package's ``run_steps`` on fit_a_line from
  one copied scope (float32, summation order only: 1e-5);
* ``run_pipeline`` equals the synchronous loop bitwise, also when it
  streams to ``on_fetch`` and when a state fetch forces each step;
* a var replaced in the scope is read at its new value, and two scopes
  run through one executor keep their own state.
"""

import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.models import fit_a_line as jfit
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import executor as texec
from paddle_tpu_torch.fluid.lowering import op_seed
from paddle_tpu_torch.kernels.flash_attention import keep_scale
from paddle_tpu_torch.models import fit_a_line as tfit
from paddle_tpu_torch.models import transformer as TT

V, S, NL, NH, DM = 64, 8, 2, 2, 16
SEED = 11
FIT_TOL = dict(rtol=1e-5, atol=1e-5)


def _programs(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    return main, startup


def _fc_program(fluid):
    main, startup = _programs(fluid)
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        h = fluid.layers.fc(input=x, size=2)
    return main, startup, h


def _stats(exe):
    s = exe.cache_stats()
    return {k: {c: s[k][c] for c in ("hits", "misses", "evictions", "size")}
            for k in ("executable", "structure")}


def _both_fc():
    """The fc program in each package with its executor and scope, the
    startup program run: [(run, exe)], run(feed) stepping main."""
    out = []
    for fluid in (jfluid, tfluid):
        main, startup, h = _fc_program(fluid)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)

        def run(feed, main=main, exe=exe, scope=scope, h=h):
            exe.run(main, feed=feed, fetch_list=[h], scope=scope)
        out.append((run, exe))
    return out


def test_cache_stats_match_the_reference():
    """tests/test_executor.py::test_cache_stats_and_log_recompiles's call
    sequence, without the log flag: the same counts after each call."""
    (jrun, jexe), (trun, texe) = _both_fc()
    assert _stats(texe) == _stats(jexe)
    assert _stats(texe)["executable"] == {"hits": 0, "misses": 1,
                                          "evictions": 0, "size": 1}
    feed8 = {"x": np.ones((8, 4), np.float32)}
    for feed in (feed8, feed8, {"x": np.ones((16, 4), np.float32)}):
        jrun(feed)
        trun(feed)
        assert _stats(texe) == _stats(jexe)
    assert _stats(texe)["executable"]["misses"] == 3
    assert _stats(texe)["structure"] == {"hits": 2, "misses": 2,
                                         "evictions": 0, "size": 2}
    jexe.close()
    texe.close()
    assert _stats(texe) == _stats(jexe)
    assert _stats(texe)["executable"]["size"] == 0
    assert _stats(texe)["executable"]["misses"] == 3


def test_cache_eviction_counts_match_the_reference(monkeypatch):
    """tests/test_executor.py::test_cache_eviction_counts: five batch
    sizes through a 3-entry cache evict as the reference's LRU does."""
    monkeypatch.setattr(jfluid.Executor, "CACHE_CAPACITY", 3)
    monkeypatch.setattr(tfluid.Executor, "CACHE_CAPACITY", 3)
    (jrun, jexe), (trun, texe) = _both_fc()
    for bs in (1, 2, 3, 4, 5, 2):
        feed = {"x": np.ones((bs, 4), np.float32)}
        jrun(feed)
        trun(feed)
        assert _stats(texe) == _stats(jexe)
    assert _stats(texe)["executable"]["evictions"] == 4
    assert _stats(texe)["executable"]["size"] == 3


# -- a small Transformer with dropout -----------------------------------------

def _transformer():
    main, startup = _programs(tfluid)
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        loss, _, _ = TT.transformer(
            V, V, 2 * S, n_layer=NL, n_head=NH, d_key=DM // NH,
            d_value=DM // NH, d_model=DM, d_inner_hid=2 * DM,
            dropout_rate=0.1, src_seq_len=S, trg_seq_len=S, fused=True,
            materialize_attn_bias=False, fused_vocab_loss=True)
        tfluid.optimizer.Adam(1e-3).minimize(loss)
    init = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=init)
    return main, loss, tfluid.scope_to_numpy(init)


def _feeds(n, batch=2):
    rng = np.random.RandomState(3)
    pos = np.tile(np.arange(S), (batch, 1))
    return [{"src_word": rng.randint(0, V, (batch, S)), "src_pos": pos,
             "trg_word": rng.randint(0, V, (batch, S)), "trg_pos": pos,
             "lbl_word": rng.randint(0, V, (batch, S)),
             "lbl_weight": np.ones((batch, S), np.float32)}
            for _ in range(n)]


def _dropout_io(main):
    """(X, Out) of the program's first dropout op."""
    op = next(op for op in main.global_block().ops if op.type == "dropout")
    return op.input("X")[0], op.output("Out")[0]


def _assert_scopes_equal(a, b, names):
    got, want = tfluid.scope_to_numpy(a, names), tfluid.scope_to_numpy(
        b, names)
    for n in names:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_run_steps_equals_k_runs_bitwise():
    main, loss, init = _transformer()
    fetch = [loss, *_dropout_io(main)]
    feeds = _feeds(4)
    cpu = tfluid.CPUPlace()
    s_run, s_steps = (tfluid.scope_from_numpy(init, cpu) for _ in range(2))
    exe = tfluid.Executor(cpu)
    want = [exe.run(main, feed=f, fetch_list=fetch, scope=s_run)
            for f in feeds]
    exe2 = tfluid.Executor(cpu)
    got = exe2.run_steps(main, feeds=feeds, fetch_list=fetch,
                         scope=s_steps)
    assert len(got) == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    _assert_scopes_equal(s_steps, s_run, list(init))
    # one miss, then three replays; a new dropout mask every step
    assert exe2.cache_stats()["executable"]["hits"] == 3
    masks = [(out == 0) & (x != 0) for _, x, out in got]
    assert all(m.any() and not np.array_equal(masks[i], m)
               for j, m in enumerate(masks) for i in range(j))
    losses = [float(r[0]) for r in got]
    assert len(set(losses)) == 4


def test_run_steps_rejects_feeds_of_two_signatures():
    main, loss, init = _transformer()
    feeds = _feeds(2) + _feeds(1, batch=3)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.scope_from_numpy(init, tfluid.CPUPlace())
    with pytest.raises(ValueError, match="feed #2 signature differs"):
        exe.run_steps(main, feeds=feeds, fetch_list=[loss], scope=scope)


def test_run_steps_matches_the_reference_on_fit_a_line():
    """Both packages' run_steps, 4 SGD steps of fit_a_line from the JAX
    startup program's arrays."""
    rng = np.random.RandomState(5)
    feeds = [{"x": rng.randn(16, 13).astype(np.float32),
              "y": rng.randn(16, 1).astype(np.float32)} for _ in range(4)]
    runs = []
    for fluid, fit in ((jfluid, jfit), (tfluid, tfit)):
        main, startup = _programs(fluid)
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            _, loss, _ = fit.build()
        runs.append((fluid, main, startup, loss))
    (jf, jmain, jstartup, jloss), (tf, tmain, _, tloss) = runs
    jscope, jexe = jf.Scope(), jf.Executor(jf.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    init = {n: np.asarray(jscope.find_var(n)) for n in jscope.vars
            if jscope.find_var(n) is not None}
    want = jexe.run_steps(jmain, feeds=feeds, fetch_list=[jloss],
                          scope=jscope)
    tscope = tf.scope_from_numpy(init, tf.CPUPlace())
    got = tf.Executor(tf.CPUPlace()).run_steps(
        tmain, feeds=feeds, fetch_list=[tloss], scope=tscope)
    np.testing.assert_allclose([float(r[0]) for r in got],
                               [float(r[0]) for r in want], **FIT_TOL)
    after = tf.scope_to_numpy(tscope, list(init))
    for n in init:
        np.testing.assert_allclose(after[n], np.asarray(jscope.find_var(n)),
                                   err_msg=n, **FIT_TOL)


def test_run_pipeline_equals_the_sync_loop_bitwise():
    main, loss, init = _transformer()
    feeds = _feeds(5)
    cpu = tfluid.CPUPlace()
    scopes = [tfluid.scope_from_numpy(init, cpu) for _ in range(4)]
    exe = tfluid.Executor(cpu)
    want = [exe.run(main, feed=f, fetch_list=[loss], scope=scopes[0])
            for f in feeds]
    got = tfluid.Executor(cpu).run_pipeline(
        main, loader=feeds, fetch_list=[loss], scope=scopes[1],
        fetch_every=2)
    streamed = []
    n = tfluid.Executor(cpu).run_pipeline(
        main, loader=lambda: iter(feeds), fetch_list=[loss],
        scope=scopes[2], fetch_every=3, on_fetch=streamed.append)
    assert n == 5 and len(got) == len(streamed) == 5
    for g, s, w in zip(got, streamed, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(s[0], w[0])
    for s in scopes[1:3]:
        _assert_scopes_equal(s, scopes[0], list(init))
    # a fetched parameter is materialized at each step, before the next
    # step updates it in place
    params = [p.name for p in main.global_block().all_parameters()]
    w = next(p for p in params if "emb" in p)
    got = tfluid.Executor(cpu).run_pipeline(
        main, loader=feeds[:3], fetch_list=[loss, w], scope=scopes[3],
        fetch_every=8)
    for g, f in zip(got, want):
        np.testing.assert_array_equal(g[0], f[0])
    assert not np.array_equal(got[0][1], got[2][1])
    np.testing.assert_array_equal(
        got[2][1], tfluid.scope_to_numpy(scopes[3], [w])[w])


def test_seed_buffer_holds_each_ops_seed(monkeypatch):
    """The seeds each step's random ops read are op_seed(seed, step,
    salt), in the plan's salt order, for steps 1-3 (one miss, two
    replays)."""
    main, loss, init = _transformer()
    seen = []
    real = texec.run_block_ops

    def spy(plan, env, seeds, seed_buf, *rest):
        seen.append((plan.salts, list(seeds),
                     seed_buf.numpy().view(np.uint32).tolist()))
        return real(plan, env, seeds, seed_buf, *rest)

    monkeypatch.setattr(texec, "run_block_ops", spy)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.scope_from_numpy(init, tfluid.CPUPlace())
    for feed in _feeds(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert len(seen) == 3
    for step, (salts, seeds, buf) in enumerate(seen, 1):
        want = [op_seed(SEED, step, salt) for salt in salts]
        assert len(salts) > 0 and seeds == want and buf == want
    assert seen[0][2] != seen[1][2]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**32 - 1])
def test_keep_scale_takes_a_tensor_seed(seed):
    """The mask keyed on a 0-d int32 tensor holding the seed's bits (an
    entry of the seed buffer) is the int seed's, bit for bit."""
    bits = torch.from_numpy(np.array([seed], np.uint32).view(np.int32))[0]
    bh = torch.arange(3)[:, None, None]
    rows, cols = torch.arange(40)[:, None], torch.arange(70)[None, :]
    want = keep_scale(seed, bh, rows, cols, 0.3)
    got = keep_scale(bits, bh, rows, cols, 0.3)
    assert torch.equal(got, want)
    assert 0 < int((want == 0).sum()) < want.numel()


def _fit_program():
    main, startup = _programs(tfluid)
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        _, loss, _ = tfit.build()
    return main, startup, loss


def _fit_feed(i):
    rng = np.random.RandomState(20 + i)
    return {"x": rng.randn(8, 13).astype(np.float32),
            "y": rng.randn(8, 1).astype(np.float32)}


def test_a_replaced_scope_var_is_read_at_its_new_value():
    main, startup, loss = _fit_program()
    cpu = tfluid.CPUPlace()
    exe = tfluid.Executor(cpu)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    for i in range(2):
        exe.run(main, feed=_fit_feed(i), fetch_list=[loss], scope=scope)
    w = next(p.name for p in main.global_block().all_parameters()
             if p.name.endswith(".w_0"))
    snapshot = tfluid.scope_to_numpy(scope)
    snapshot[w] = np.zeros_like(snapshot[w])
    scope.set_var(w, torch.zeros(tuple(snapshot[w].shape)))
    got = exe.run(main, feed=_fit_feed(2), fetch_list=[loss], scope=scope)
    # the same step from the same values, on a fresh executor
    ref = tfluid.scope_from_numpy(snapshot, cpu)
    ref._rng_seed, ref._rng_step = scope._rng_seed, scope._rng_step - 1
    want = tfluid.Executor(cpu).run(main, feed=_fit_feed(2),
                                    fetch_list=[loss], scope=ref)
    np.testing.assert_array_equal(got[0], want[0])
    _assert_scopes_equal(scope, ref, list(snapshot))


def test_two_scopes_keep_their_own_state():
    """Two scopes stepped in turns through one executor end as each does
    alone on an executor of its own."""
    main, startup, loss = _fit_program()
    cpu = tfluid.CPUPlace()
    init = tfluid.Scope()
    tfluid.Executor(cpu).run(startup, scope=init)
    init = tfluid.scope_to_numpy(init)
    shared = tfluid.Executor(cpu)
    a, b = (tfluid.scope_from_numpy(init, cpu) for _ in range(2))
    alone = [tfluid.scope_from_numpy(init, cpu) for _ in range(2)]
    exes = [tfluid.Executor(cpu) for _ in range(2)]
    for i in range(4):
        for k, scope in enumerate((a, b)):
            feed = _fit_feed(10 * k + i)
            got = shared.run(main, feed=feed, fetch_list=[loss], scope=scope)
            want = exes[k].run(main, feed=feed, fetch_list=[loss],
                               scope=alone[k])
            np.testing.assert_array_equal(got[0], want[0])
    _assert_scopes_equal(a, alone[0], list(init))
    _assert_scopes_equal(b, alone[1], list(init))
    assert shared.cache_stats()["executable"] == {
        "hits": 7, "misses": 1, "evictions": 0, "size": 1}


def test_a_startup_plan_lists_its_host_draws():
    """uniform_random draws on the host: the plan names it (the card
    refuses to replay such a program), and the CPU reruns it."""
    main, startup, loss = _fit_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scopes = [tfluid.Scope() for _ in range(2)]
    for s in scopes:
        exe.run(startup, scope=s)
    plan = exe._plan(exe._program_key(startup), startup, [], [])
    assert "uniform_random" in plan.host_rng_ops
    _assert_scopes_equal(scopes[0], scopes[1],
                         [n for n, v in scopes[0].vars.items()
                          if v is not None])
