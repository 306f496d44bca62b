"""Transformer training through the port's Fluid front end and Executor,
against the JAX package, on the CPU.

The JAX startup program initializes the scope; its arrays go into a
port Scope (``scope_from_numpy``), and both packages run 3 Adam steps of
the same ``transformer()`` program on the same feed with dropout off:
with a materialized attention bias (the plain backward, as the
reference routes a biased attention) and without one (the causal,
bias-free path the flash kernels take on the card; here their plain
counterparts).  Tolerances: float32 on both sides, summation order only
(XLA's fused reductions against eager PyTorch), so the losses agree to
2e-5 relative, and after 3 steps of Adam at lr 1e-3 every parameter
agrees to 2e-5 absolute (Adam's step is at most lr per element, and a
gradient near zero can flip the sign of a ~1e-4 step).

With dropout on, the port's steps are deterministic in (seed, step) and
train; and the trained scope serves through the port's paged generator
under its ``param_prefix`` names, with the training graph's logits.  Under ``torch.profiler`` the executor
labels each op's work with its type.
"""

import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.serving import PagedTransformerGenerator, copy_weights

V, S, NL, NH, DM = 64, 16, 2, 2, 16
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
PARAM_TOL = dict(rtol=0, atol=2e-5)


def build(fluid, T, dropout=0.0, **kw):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        avg_cost, _, _ = T.transformer(
            V, V, 2 * S, n_layer=NL, n_head=NH, d_key=DM // NH,
            d_value=DM // NH, d_model=DM, d_inner_hid=2 * DM,
            dropout_rate=dropout, src_seq_len=S, trg_seq_len=S, fused=True,
            param_prefix="tf", **kw)
        fluid.optimizer.Adam(1e-3).minimize(avg_cost)
    return main, startup, avg_cost


def feed_data(materialize_attn_bias, batch=4):
    rng = np.random.RandomState(0)
    lens = rng.randint(S // 2, S + 1, batch)
    feed = {"src_word": rng.randint(0, V, (batch, S)),
            "src_pos": np.tile(np.arange(S), (batch, 1)),
            "trg_word": rng.randint(0, V, (batch, S)),
            "trg_pos": np.tile(np.arange(S), (batch, 1)),
            "lbl_word": rng.randint(0, V, (batch, S)),
            "lbl_weight": (np.arange(S)[None, :] < lens[:, None]).astype(
                np.float32)}
    if materialize_attn_bias:
        feed.update(
            src_slf_attn_bias=JT.make_attn_bias(lens, S, NH),
            trg_slf_attn_bias=JT.make_attn_bias(lens, S, NH, causal=True),
            trg_src_attn_bias=JT.make_attn_bias(lens, S, NH))
    return feed


def jax_run(kw, feed, steps):
    main, startup, loss = build(jfluid, JT, **kw)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in scope.vars
                if scope.find_var(n) is not None}
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                  for _ in range(steps)]
        after = {n: np.asarray(scope.find_var(n)) for n in init}
    return init, losses, after


@pytest.mark.parametrize("materialize_attn_bias", [True, False],
                         ids=["bias", "causal"])
def test_three_adam_steps_match_reference(materialize_attn_bias):
    kw = dict(materialize_attn_bias=materialize_attn_bias,
              fused_vocab_loss=not materialize_attn_bias)
    feed = feed_data(materialize_attn_bias)
    init, want_losses, want = jax_run(kw, feed, steps=3)

    main, _, loss = build(tfluid, TT, **kw)
    cpu = tfluid.CPUPlace()
    scope = tfluid.scope_from_numpy(init, cpu)
    exe = tfluid.Executor(cpu)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(3)]
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    assert losses[-1] < losses[0]
    got = tfluid.scope_to_numpy(scope, list(init))
    for name in init:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **PARAM_TOL)
    # the parameters moved, and Adam's bias-correction powers advanced
    assert not np.array_equal(got["tf.enc0.self.q.w"],
                              init["tf.enc0.self.q.w"])
    np.testing.assert_allclose(got["tf.enc0.self.q.w_beta1_pow_acc_0"],
                               [0.9 ** 4], rtol=1e-6)


def test_dropout_steps_are_seeded_train_and_serve():
    """Dropout on: the startup program draws from the program seed, a step
    is a function of (seed, step), and the loss falls.  The trained scope
    then serves through the paged generator (one-scope contract)."""
    kw = dict(dropout=0.1, materialize_attn_bias=False,
              fused_vocab_loss=True)
    feed = feed_data(False)
    runs = []
    for _ in range(2):
        main, startup, loss = build(tfluid, TT, **kw)
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        runs.append([float(exe.run(main, feed=feed, fetch_list=[loss],
                                   scope=scope)[0]) for _ in range(8)])
    assert runs[0] == runs[1]
    assert len(set(runs[0])) == len(runs[0])
    assert runs[0][-1] < runs[0][0]

    params = [p.name for p in main.global_block().all_parameters()]
    gen = PagedTransformerGenerator(
        V, V, n_layer=NL, n_head=NH, d_key=DM // NH, d_value=DM // NH,
        d_model=DM, d_inner_hid=2 * DM, max_length=2 * S, src_len=S,
        max_out_len=4, page_size=4, num_pages=32, chunk_size=4,
        place=tfluid.CPUPlace(), param_prefix="tf")
    assert gen.load_params(tfluid.scope_to_numpy(scope, params)) \
        == len(params)
    out = gen.greedy(feed["src_word"][:2], [S, S - 3], max_new=4,
                     stop_at_end=False)
    assert out.shape == (2, 4) and ((out >= 0) & (out < V)).all()


def test_serving_modules_compute_the_fluid_programs_logits():
    """The serving program and the training program are one model: a
    port scope trained for 2 Adam steps, copied by ``copy_weights`` into
    the paged generator's scope, decodes 4 tokens greedily through the
    generator's Executor; the training graph's ``predict``, fed the same
    source and the decoded prefix, gives the same logits at each
    position.  The serving encoder is causal (the reference's chunked
    prefill), so the forward gets a causal source bias.  float32 on both
    sides, summation order only: 1e-4 absolute on logits of magnitude
    ~1."""
    main, startup, loss = build(tfluid, TT, materialize_attn_bias=False,
                                fused_vocab_loss=True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(2):
        exe.run(main, feed=feed_data(False), fetch_list=[loss], scope=scope)
    forward = tfluid.Program()
    with tfluid.program_guard(forward, tfluid.Program()), \
            tfluid.unique_name.guard():
        _, predict, _ = TT.transformer(
            V, V, 2 * S, n_layer=NL, n_head=NH, d_key=DM // NH,
            d_value=DM // NH, d_model=DM, d_inner_hid=2 * DM,
            dropout_rate=0.0, src_seq_len=S, trg_seq_len=S, fused=True,
            materialize_attn_bias=True, param_prefix="tf")

    n_new = 4
    gen = PagedTransformerGenerator(
        V, V, n_layer=NL, n_head=NH, d_key=DM // NH, d_value=DM // NH,
        d_model=DM, d_inner_hid=2 * DM, max_length=2 * S, src_len=S,
        max_out_len=n_new, page_size=4, num_pages=32, chunk_size=4,
        place=tfluid.CPUPlace(), param_prefix="tf")
    assert copy_weights(scope, gen.scope, prefix="tf") >= \
        len(main.global_block().all_parameters())
    src = np.random.RandomState(3).randint(2, V, S)
    gen.open_slots(1)
    gen.admit_slot(0, src, max_new=n_new)
    tokens, served = [], []
    while len(tokens) < n_new:
        ids, logits = gen.run_feed(gen.step_feed())
        for slot, tok in gen.absorb_step(ids.numpy()).items():
            tokens.append(tok)
            served.append(logits[slot, 0].numpy())
    gen.clear_slot(0)

    trg = np.zeros(S, np.int64)
    trg[0] = gen.start_id
    trg[1:n_new] = tokens[:-1]
    full = np.full(1, S)
    feed = {"src_word": src[None], "src_pos": np.arange(S)[None],
            "trg_word": trg[None], "trg_pos": np.arange(S)[None],
            "src_slf_attn_bias": TT.make_attn_bias(full, S, NH, causal=True),
            "trg_slf_attn_bias": TT.make_attn_bias(full, S, NH, causal=True),
            "trg_src_attn_bias": TT.make_attn_bias(full, S, NH),
            "lbl_word": np.zeros((1, S), np.int64),
            "lbl_weight": np.ones((1, S), np.float32)}
    got, = exe.run(forward, feed=feed, fetch_list=[predict], scope=scope)
    np.testing.assert_allclose(np.asarray(got)[0, :n_new], np.stack(served),
                               rtol=0, atol=1e-4)
    assert tokens == list(np.argmax(np.asarray(got)[0, :n_new], axis=-1))


def test_a_running_profiler_sees_each_fluid_op():
    """Under torch.profiler the executor labels each op's work with its
    type (what profile_training.py reads); the step's result is the
    same."""
    main, startup, loss = build(tfluid, TT, materialize_attn_bias=False,
                                fused_vocab_loss=True)
    feed = feed_data(False)
    exe = tfluid.Executor(tfluid.CPUPlace())

    def first_step():
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]

    plain = first_step()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        profiled = first_step()
    names = {e.name for e in prof.events()}
    assert {"fused_attention", "fused_attention_grad", "layer_norm_grad",
            "lookup_table_grad", "adam"} <= names
    np.testing.assert_array_equal(profiled, plain)
