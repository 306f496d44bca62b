"""Learning to rank in the port: ``chip_smoke.build_ranking``'s
LambdaRank and RankNet programs through both packages on the CPU.

* Both programs (a shared 46 -> 128 -> 64 -> 1 tanh scorer, named
  parameters; ``lambda_rank_cost`` or ``rank_loss``, Adam; the AUC tower
  on every document) serialize to the reference's bytes.
* Three Adam steps from the reference's initial scope on seeded queries:
  each step's loss within LOSS_RTOL and AUC bit for bit, every parameter
  after them within PARAM_ATOL.
* ``lambda_rank_cost`` over graded labels and quantized scores (ties in
  both): the cost within OUT_RTOL, its gradient within GRAD_RTOL; and
  ``auc`` over saturated, tied probabilities bit for bit.  The cost is
  not held bit for bit here: the reference's ``exp`` and ``log`` are
  XLA's own approximations, and the port's cost is the same bits on the
  card and the CPU instead (``loss_ops.softplus_exact``).
"""

import numpy as np
import pytest

import chip_smoke
from paddle_tpu import fluid as jfluid
from paddle_tpu_torch import fluid as tfluid
from tests.test_torch_conv_ops import as_np, compare_op

SMALL = dict(features=46, hidden=(16, 8), ndcg_num=10, lr=1e-3)
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
PACKAGES = {"jax": jfluid, "port": tfluid}
KINDS = ("lambdarank", "ranknet")


def _build(pkg, kind, dims=SMALL):
    return chip_smoke.build_ranking(PACKAGES[pkg], kind, **dims)


@pytest.mark.parametrize("kind", KINDS)
def test_ranking_programs_match_reference_bytes(kind):
    for dims in (chip_smoke.RANK, SMALL):
        j, t = _build("jax", kind, dims), _build("port", kind, dims)
        for a, b in zip(j[:2], t[:2]):
            assert b.serialize_to_string() == a.serialize_to_string()
    ops = [op.type for op in t[0].global_block().ops]
    loss_op = "lambda_rank_cost" if kind == "lambdarank" else "rank_loss"
    for op in (loss_op, loss_op + "_grad", "auc", "top_k", "adam"):
        assert op in ops, op
    # one scorer's parameters, shared by every tower
    assert len(t[0].global_block().all_parameters()) == 5


def _feeds(kind, fluid, steps=3):
    rng = np.random.RandomState(11)
    return [chip_smoke.ranking_batch(np, fluid, rng, kind, 6, (3, 20), 48,
                                     SMALL["features"])
            for _ in range(steps)]


@pytest.mark.parametrize("kind", KINDS)
def test_ranking_trains_as_the_reference(kind):
    j, t = _build("jax", kind), _build("port", kind)
    params = [p.name for p in t[0].global_block().all_parameters()]
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(j[1])
        init = {n: np.asarray(scope.find_var(n)) for n in scope.vars
                if scope.find_var(n) is not None}
        want = [[np.asarray(v) for v in exe.run(j[0], feed=f,
                                                fetch_list=[j[2], j[3]])]
                for f in _feeds(kind, jfluid)]
        want_params = {n: np.asarray(scope.find_var(n)) for n in params}
    cpu = tfluid.CPUPlace()
    tscope = tfluid.scope_from_numpy(init, cpu)
    texe = tfluid.Executor(cpu)
    got = [texe.run(t[0], feed=f, fetch_list=[t[2], t[3]], scope=tscope)
           for f in _feeds(kind, tfluid)]
    np.testing.assert_allclose([float(g[0]) for g in got],
                               [float(w[0]) for w in want], rtol=LOSS_RTOL)
    for g, w in zip(got, want):
        assert g[1].dtype == w[1].dtype
        np.testing.assert_array_equal(g[1], w[1])
    for n in params:
        np.testing.assert_allclose(np.asarray(tscope.find_var(n)),
                                   want_params[n], rtol=0, atol=PARAM_ATOL,
                                   err_msg=n)


@pytest.mark.parametrize("ndcg_num", [1, 5, 10])
def test_lambda_rank_cost_matches_reference_with_ties(ndcg_num):
    rng = np.random.RandomState(20 + ndcg_num)
    b, t = 16, 32
    lengths = rng.randint(1, t + 1, b).astype(np.int32)
    lengths[0] = t
    score = (np.round(rng.randn(b, t, 1) * 2) / 2).astype(np.float32)
    label = rng.randint(0, 3, (b, t, 1)).astype(np.float32)
    compare_op("lambda_rank_cost",
               {"Score": ("seq", score, lengths),
                "Label": ("seq", label, lengths)}, {"ndcg_num": ndcg_num},
               ("Score",))


def test_auc_is_the_reference_bitwise_with_ties():
    rng = np.random.RandomState(30)
    n = 4000
    p = 1.0 / (1.0 + np.exp(-rng.randn(n) * 3))
    p[rng.rand(n) < 0.3] = 1.0                  # saturated: tied
    p[rng.rand(n) < 0.2] = 0.0
    p = np.round(p * 64).astype(np.float32) / 64
    specs = {"Out": ("t", np.stack([1 - p, p], axis=1)),
             "Indices": ("t", np.zeros((n, 1), np.int32)),
             "Label": ("t", rng.randint(0, 2, (n, 1)).astype(np.int32))}
    jo, to = compare_op("auc", specs, {}, exact=True)
    assert 0.0 < float(as_np(to["AUC"][0])) < 1.0
