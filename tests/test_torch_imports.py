"""The port stands alone, and its entry points never fall back silently.

* ``paddle_tpu_torch`` (every module), ``chip_smoke``,
  ``profile_serving``, ``tune_flash_bwd``, ``batch_norm_probe`` and
  ``segment_sum_probe`` import in a process where
  importing ``jax`` or ``paddle_tpu`` raises.
* Without CUDA, an entry point raises unless the caller asks for the
  CPU by name (``device="cpu"``, ``fluid.CPUPlace()``, a generator's
  ``place=fluid.CPUPlace()``); ``chip_smoke.py`` exits non-zero and
  prints no result,
  also when it sits in a directory without the rest of the repo, and
  it fails a faulty serving profile of its ``--parent-package`` turns.
* Every public function (and method) defined in a file that both
  packages have takes the reference's parameter names, in its order,
  less the explicit list ``NOT_TAKEN``; the parameters the port cannot
  honour raise ``NotImplementedError`` (found by an ``ast`` walk of the
  two files, so no module is imported for it).
* The port registers 233 of the reference's 234 ops, each under the
  reference's name (all but ``switch_moe``).
"""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch import fluid, resolve_device
from paddle_tpu_torch.serving import PagedTransformerGenerator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ISOLATED = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                               "paddle_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import profile_serving
import tune_flash_bwd
import batch_norm_probe
import segment_sum_probe
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
assert not bad, bad
print(" ".join(names))
"""


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


# the modules of the LSTM slice, among those imported
SLICE_3 = {"paddle_tpu_torch.fluid.core.lod",
           "paddle_tpu_torch.fluid.ops.rnn_ops",
           "paddle_tpu_torch.fluid.ops.sequence_ops",
           "paddle_tpu_torch.fluid.layers.recurrent",
           "paddle_tpu_torch.fluid.layers.sequence",
           "paddle_tpu_torch.kernels.lstm",
           "paddle_tpu_torch.models.sentiment"}


# the modules of the book's first two chapters and the bf16 recipe
BOOK = {"paddle_tpu_torch.fluid.nets",
        "paddle_tpu_torch.fluid.layers.tensor",
        "paddle_tpu_torch.models.fit_a_line",
        "paddle_tpu_torch.models.recognize_digits"}


# the modules of the semantic role labeling slice
SRL = {"paddle_tpu_torch.fluid.ops.crf_ops",
       "paddle_tpu_torch.fluid.evaluator",
       "paddle_tpu_torch.models.label_semantic_roles"}


# the modules of the sparse embeddings and the optimizer front end
SPARSE = {"paddle_tpu_torch.fluid.core.selected_rows",
          "paddle_tpu_torch.fluid.regularizer",
          "paddle_tpu_torch.fluid.clip",
          "paddle_tpu_torch.fluid.learning_rate_decay",
          "paddle_tpu_torch.fluid.data_feeder",
          "paddle_tpu_torch.models.ctr",
          "paddle_tpu_torch.models.word2vec",
          "paddle_tpu_torch.models.recommender"}


# the modules of the speculative, constrained and tiered serving slice
SPECULATIVE_TIERS = {"paddle_tpu_torch.serving.speculative",
                     "paddle_tpu_torch.serving.constraints",
                     "paddle_tpu_torch.serving.sessions",
                     "paddle_tpu_torch.resilience",
                     "paddle_tpu_torch.resilience.chaos"}


# the modules of the persistence and inference-engine slice
PERSISTENCE = {"paddle_tpu_torch.fluid.io",
               "paddle_tpu_torch.fluid.checkpoint",
               "paddle_tpu_torch.fluid.ops.io_ops",
               "paddle_tpu_torch.fluid.ops.quant_ops",
               "paddle_tpu_torch.fluid.transforms",
               "paddle_tpu_torch.fluid.transforms.quantize",
               "paddle_tpu_torch.fluid.pipeline_io",
               "paddle_tpu_torch.fluid.profiler",
               "paddle_tpu_torch.serving.engine",
               "paddle_tpu_torch.utils.reader"}


# the modules of the static analyzer and cost model slice
ANALYSIS = {"paddle_tpu_torch.fluid.analysis",
            "paddle_tpu_torch.fluid.analysis.diagnostics",
            "paddle_tpu_torch.fluid.analysis.dataflow",
            "paddle_tpu_torch.fluid.analysis.passes",
            "paddle_tpu_torch.fluid.analysis.recompile",
            "paddle_tpu_torch.fluid.analysis.cost",
            "paddle_tpu_torch.fluid.analysis.comms",
            "paddle_tpu_torch.tools",
            "paddle_tpu_torch.tools.plint"}


# the modules of the serving gateway and compile cache slice
GATEWAY = {"paddle_tpu_torch.utils.sync",
           "paddle_tpu_torch.utils.journal",
           "paddle_tpu_torch.observability.metrics",
           "paddle_tpu_torch.observability.server",
           "paddle_tpu_torch.fluid.compile_cache",
           "paddle_tpu_torch.kernels._build",
           "paddle_tpu_torch.serving.gateway",
           "paddle_tpu_torch.serving.gateway.router",
           "paddle_tpu_torch.serving.gateway.journal",
           "paddle_tpu_torch.serving.gateway.registry",
           "paddle_tpu_torch.serving.gateway.gateway",
           "paddle_tpu_torch.serving.gateway.server",
           "paddle_tpu_torch.tools.aot_compile",
           "paddle_tpu_torch.tools.gateway",
           "paddle_tpu_torch.tools.obs"}


# the modules of the closed train -> publish -> canary -> promote slice
LIFECYCLE = {"paddle_tpu_torch.resilience.retry",
             "paddle_tpu_torch.resilience.guardrails",
             "paddle_tpu_torch.resilience.service",
             "paddle_tpu_torch.resilience.trainer",
             "paddle_tpu_torch.parallel",
             "paddle_tpu_torch.parallel.master",
             "paddle_tpu_torch.parallel.master_service",
             "paddle_tpu_torch.lifecycle",
             "paddle_tpu_torch.lifecycle.journal",
             "paddle_tpu_torch.lifecycle.canary",
             "paddle_tpu_torch.lifecycle.publish",
             "paddle_tpu_torch.lifecycle.controller",
             "paddle_tpu_torch.tools.lifecycle"}


# the modules of the multi-process control plane slice
CONTROL_PLANE = {"paddle_tpu_torch.serving.paging",
                 "paddle_tpu_torch.launch",
                 "paddle_tpu_torch.serving.fleet",
                 "paddle_tpu_torch.serving.fleet.router",
                 "paddle_tpu_torch.serving.fleet.server",
                 "paddle_tpu_torch.serving.fleet.supervisor",
                 "paddle_tpu_torch.tools.fleet",
                 "paddle_tpu_torch.parallel",
                 "paddle_tpu_torch.parallel.coordinator",
                 "paddle_tpu_torch.resilience.trainer",
                 "paddle_tpu_torch.resilience.service",
                 "paddle_tpu_torch.resilience.chaos",
                 "paddle_tpu_torch.tools.syncheck"}


def test_port_imports_without_jax_or_reference():
    out = _run(["-c", _ISOLATED], cwd=ROOT)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 50                   # every module was imported
    want = (SLICE_3 | BOOK | SPARSE | SRL | SPECULATIVE_TIERS | PERSISTENCE
            | ANALYSIS | GATEWAY | LIFECYCLE | CONTROL_PLANE)
    assert want <= names, want - names


# ops of the semantic role labeling slice: the CRF, chunk evaluation,
# ModelAverage's accumulation, and the general tensor and reduce ops
SRL_OPS = {"linear_chain_crf", "crf_decoding", "chunk_eval",
           "average_accumulates", "gather", "scatter", "slice", "split",
           "one_hot", "shape", "multiplex", "truncated_gaussian_random",
           "reduce_mean", "reduce_max", "reduce_min", "reduce_prod"}


# ops of the speech and detection slice: CTC, the GRU ops, the rest of
# nn_ops and the detection ops
SPEECH_DETECTION_OPS = {
    "warpctc", "edit_distance", "ctc_align", "dynamic_gru", "lstm_unit",
    "gru_unit", "depthwise_conv2d", "conv2d_transpose", "conv3d", "pool3d",
    "l2_normalize", "nce", "im2sequence", "prior_box", "bipartite_match",
    "multiclass_nms", "detection_output", "iou_similarity",
    "positive_negative_pair", "ssd_loss"}


# ops of the loss and miscellaneous slice: the rest of loss_ops.py and
# misc_ops.py but lstmp and isfinite
LOSS_MISC_OPS = {
    "cross_entropy_with_selfnorm", "cross_entropy_over_beam",
    "smooth_l1_loss", "huber_loss", "hinge_loss", "squared_l2_distance",
    "auc", "precision_recall", "lambda_rank_cost", "pad", "crop", "rotate",
    "scale_sub_region", "selective_fc", "lod_reset", "label_smooth",
    "rank_loss", "margin_rank_loss", "log_loss", "modified_huber_loss",
    "conv_shift", "row_conv", "max_pool2d_with_index", "unpool",
    "roi_pool", "spp", "minus", "l1_norm", "is_empty", "assign_value",
    "bilinear_tensor_product", "hsigmoid", "sampling_id",
    "bilinear_interp"}


# the KV tier's page transfers
TIER_OPS = {"paged_page_gather", "paged_page_scatter",
            "quantized_paged_page_gather", "quantized_paged_page_scatter"}


# the feed / fetch, checkpoint IO and print ops, and the int8 ops
IO_QUANT_OPS = {"feed", "fetch", "save", "load", "save_combine",
                "load_combine", "print", "quantize", "dequantize",
                "quantized_mul", "quantized_matmul", "quantized_conv2d"}


# the level-2 sequence slice: nine sequence ops and lstmp
SEQUENCE_OPS = {"sequence_context", "nested_sequence_pool",
                "sequence_concat", "sequence_reshape", "sequence_slice",
                "sequence_erase", "sequence_mask_op", "kmax_seq_score",
                "sub_nested_seq", "lstmp"}


def test_registered_ops_are_a_subset_of_the_reference():
    """The port registers 233 of the reference's 234 ops, each under the
    reference's name, the SRL slice's 16, the speech and detection
    slice's 20, the loss and miscellaneous slice's 34, the KV tier's 4
    transfers, the persistence slice's 12 IO and int8 ops, the
    guardrails' ``isfinite`` and the level-2 sequence slice's 10 among
    them; only ``switch_moe`` is left."""
    from paddle_tpu.fluid.core.registry import registered_ops as jops

    ported, ref = set(fluid.registered_ops()), set(jops())
    assert len(SRL_OPS) == 16 and SRL_OPS <= ported
    assert len(SPEECH_DETECTION_OPS) == 20
    assert SPEECH_DETECTION_OPS <= ported
    assert len(LOSS_MISC_OPS) == 34 and LOSS_MISC_OPS <= ported
    assert len(TIER_OPS) == 4 and TIER_OPS <= ported
    assert len(IO_QUANT_OPS) == 12 and IO_QUANT_OPS <= ported
    assert "isfinite" in ported
    assert len(SEQUENCE_OPS) == 10 and SEQUENCE_OPS <= ported
    assert ported <= ref, ported - ref
    assert ref - ported == {"switch_moe"}
    assert (len(ported), len(ref)) == (233, 234)


def test_entry_points_refuse_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedTransformerGenerator(24, 24, n_layer=1, n_head=2, d_key=4,
                                  d_value=4, d_model=8, d_inner_hid=8,
                                  max_length=16, src_len=8, max_out_len=4,
                                  page_size=4, num_pages=8)
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul \
        .allow_bf16_reduced_precision_reduction is False
    with pytest.raises(NotImplementedError, match="mesh"):
        PagedTransformerGenerator(24, 24, place=fluid.CPUPlace(),
                                  mesh_axes={"model": 2})


def test_executor_runs_on_the_card_unless_given_cpu_place(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (fluid.Executor, lambda: fluid.Executor(fluid.CUDAPlace(0)),
                 lambda: fluid.scope_from_numpy({"w": [1.0]})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(TypeError, match="CUDAPlace or CPUPlace"):
        fluid.Executor("cpu")
    exe = fluid.Executor(fluid.CPUPlace())
    assert exe.device == torch.device("cpu")
    scope = fluid.scope_from_numpy({"w": [1.0]}, fluid.CPUPlace())
    assert scope.find_var("w").device == torch.device("cpu")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = ROOT
    out = _run(["chip_smoke.py"], cwd=cwd, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _profile(package, **kw):
    rec = {"package": package, "requests": 8, "finished": 8, "steps": 33,
           "unprofiled": {"steps": 40}, "pool_gib": 0.375,
           "peak_mem_gib": 0.8 if package == "parent" else 0.95}
    return dict(rec, **kw)


@pytest.mark.parametrize("fault", [None, "error", "unfinished", "steps",
                                   "pool_cloned"])
def test_chip_smoke_fails_a_faulty_serving_profile(fault):
    """``chip_smoke.py --parent-package`` holds the serving profiles run
    in turns (parent, this, this, parent): a run that failed or left a
    request unfinished, runs that took different steps, and a median
    peak that grows over the parent's by the pool's bytes each fail the
    smoke."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    peaks = [_profile(p) for p in ("parent", "this", "this", "parent")]
    if fault == "error":
        peaks[1] = {"package": "this", "error": 1, "stderr": "Traceback"}
    elif fault == "unfinished":
        peaks[2]["finished"] = 7
    elif fault == "steps":
        peaks[3]["steps"] = 34
    elif fault == "pool_cloned":
        for p in peaks[1:3]:
            p["peak_mem_gib"] = 0.8 + 0.375
    fails = chip_smoke.in_turns_failures(peaks)
    assert (fails == []) == (fault is None), fails


def _smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def _rows():
    """Two images' detection rows: class, score, a box."""
    return np.float32([
        [[1, 0.9, 0.1, 0.1, 0.4, 0.4], [2, 0.8, 0.5, 0.5, 0.9, 0.9],
         [-1, -1, -1, -1, -1, -1]],
        [[3, 0.7, 0.2, 0.2, 0.6, 0.6], [3, 0.6, 0.6, 0.1, 0.9, 0.3],
         [-1, -1, -1, -1, -1, -1]]])


@pytest.mark.parametrize("fault", [None, "ulp", "near_tie_score",
                                   "near_tie_iou", "class", "score"])
def test_chip_smoke_detection_rows_compare(fault):
    """``chip_smoke.detection_rows_compare`` (phase 21's rows, card vs
    CPU): an ulp apart is equal; two rows whose scores lie within
    NEAR_TIE swapped, or a box kept on one side whose IoU with a kept
    box of its class is within NEAR_TIE of the NMS threshold, is a near
    tie; another class or score differs."""
    cs = _smoke()
    cpu, card = _rows(), _rows()
    if fault == "ulp":
        card[0, 0, 1] = np.nextafter(card[0, 0, 1], np.float32(2))
    elif fault == "near_tie_score":
        cpu[1, 1, 1] = card[1, 1, 1] = 0.7 - 2e-6
        card[1, [0, 1]] = card[1, [1, 0]]
    elif fault == "near_tie_iou":
        # IoU of [0.1, 0.1, 0.4, 0.4] and [0.1, 0.1, 0.4, b] equal to the
        # threshold 0.45 (a suppression that flipped): b = 0.235
        card[0, 2] = [1, 0.5, 0.1, 0.1, 0.4, 0.235]
    elif fault == "class":
        card[0, 1, 0] = 4
    elif fault == "score":
        card[1, 0, 1] = 0.71
    out = cs.detection_rows_compare(np, card, cpu)
    assert out["equal"] + len(out["near_ties"]) + len(out["differ"]) == 2
    if fault in (None, "ulp"):
        assert out["equal"] == 2, out
    elif fault.startswith("near_tie"):
        assert [t[0] for t in out["near_ties"]] == [1 if "score" in fault
                                                    else 0], out
        assert not out["differ"]
    else:
        assert out["differ"] and not out["near_ties"], out


@pytest.mark.parametrize("fault", [None, "ulp", "near_tie_score",
                                   "near_tie_iou", "score", "box"])
def test_chip_smoke_map_decisions_compare(fault):
    """``chip_smoke.map_decisions_compare`` (phase 21's DetectionMAP,
    card vs CPU): rows an ulp apart decide alike; a false positive and a
    true positive of two images whose scores lie within NEAR_TIE on both
    sides and swap ranks, or a box whose IoU with its ground truth lies
    at the overlap threshold, is a near tie (and moves the mAP); a score
    or a box moved past it differs."""
    from paddle_tpu_torch.fluid.evaluator import DetectionMAP

    cs = _smoke()
    gts = [[[1.0, 0.1, 0.1, 0.4, 0.4]], [[1.0, 0.0, 0.0, 1.0, 1.0]]]
    cpu = np.float32([
        [[1, 0.9, 0.1, 0.1, 0.4, 0.4], [1, 0.5, 0.6, 0.6, 0.9, 0.9]],
        [[1, 0.5000004, 0.0, 0.0, 1.0, 0.5], [-1, -1, -1, -1, -1, -1]]])
    card = cpu.copy()
    if fault == "ulp":
        card[0, 1, 1] = np.nextafter(card[0, 1, 1], np.float32(0))
    elif fault == "near_tie_score":
        card[0, 1, 1], card[1, 0, 1] = cpu[1, 0, 1], cpu[0, 1, 1]
    elif fault == "near_tie_iou":
        card[1, 0, 5] = np.nextafter(np.float32(0.5), np.float32(0))
    elif fault == "score":
        card[0, 1, 1] = 0.6
    elif fault == "box":
        card[1, 0, 5] = 0.4
    out = cs.map_decisions_compare(np, DetectionMAP._iou, card, cpu, gts)
    maps = []
    for rows in (card, cpu):
        m = DetectionMAP(0.5)
        m.update(cs.detections_of(np, rows), gts)
        maps.append(float(m.eval()))
    if fault in (None, "ulp"):
        assert out == {"near_ties": [], "differ": []}, out
        assert maps[0] == maps[1]
    elif fault.startswith("near_tie"):
        assert [t[:2] for t in out["near_ties"]] == [(1, 1)], out
        assert not out["differ"] and maps[0] != maps[1], (out, maps)
    else:
        assert [d[:2] for d in out["differ"]] == [(1, 1)], out
        assert not out["near_ties"] and maps[0] != maps[1], (out, maps)


def test_chip_smoke_grads_by_conditioning():
    """``chip_smoke.grads_by_conditioning`` (phase 21's gradients, card
    vs CPU): each within SSD_GRAD_REL_L2 in relative L2, and the median
    distance within SSD_NOISE_RATIO times the CPU's own under a one-ulp
    nudge of the input."""
    cs = _smoke()
    g = [np.linspace(-1, 1, 11, dtype=np.float32) + i for i in range(3)]
    loss = np.float32(3.0)
    cpu = [loss] + g
    nudged = [loss] + [x * np.float32(1 + 1e-3) for x in g]
    near = [loss] + [x * np.float32(1 + 2e-3) for x in g]
    out = cs.grads_by_conditioning(np, near, cpu, nudged)
    assert out[-1] and abs(out[2] - 2e-3) < 1e-4
    far = [loss] + [x * np.float32(1 + 1e-2) for x in g]
    assert not cs.grads_by_conditioning(np, far, cpu, nudged)[-1]
    one_off = [loss, g[0], g[1] * np.float32(1.2), g[2]]
    out = cs.grads_by_conditioning(np, one_off, cpu, cpu)
    assert not out[-1] and out[1] == 1


def test_chip_smoke_host_syncs_in():
    """``chip_smoke.host_syncs_in`` counts the synchronize calls that
    start inside the host's ranges of a name.  The range's device copy
    (its kernels' span on the card's timeline, which ends after the
    host's range) does not count: the profiler's own synchronize at its
    exit, which starts after the last host range, stays out."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    cs = _smoke()

    def ev(name, start, end, device=DeviceType.CPU):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))

    step = "chip_smoke/step"
    events = []
    for i in range(3):
        t = 100.0 * i
        events += [ev(step, t, t + 90),
                   ev(step, t + 5, t + 95, DeviceType.CUDA),
                   ev("cudaStreamSynchronize", t + 60, t + 89),
                   ev("cudaLaunchKernel", t + 10, t + 11)]
    # the profiler's exit: after the last host range, inside its device
    # copy
    events.append(ev("cudaDeviceSynchronize", 292, 293))
    assert cs.host_syncs_in(events, step) == 3
    # a sync inside a host range counts, whatever its kind
    events.append(ev("cudaEventSynchronize", 150, 151))
    assert cs.host_syncs_in(events, step) == 4
    assert cs.on_device(events[1]) and not cs.on_device(events[0])


# reference parameters a port function does not take, by (file under the
# package, function): the port's own internals (emitter contexts, the
# lowering)
NOT_TAKEN = {
    ("fluid/core/registry.py", "EmitCtx.__init__"): {"rng"},
    ("fluid/core/registry.py", "OpInfo.__init__"): {"grad_maker",
                                                     "needs_out_slots"},
    ("fluid/lowering.py", "run_block_ops"): {"desc", "block_idx",
                                             "step_key"},
}


# entry points of the control plane slice the check must reach
CONTROL_PLANE_ENTRIES = {
    ("launch.py", "launch"), ("launch.py", "launch_hosts"),
    ("launch.py", "find_free_port"),
    ("serving/paging.py", "affinity_key"),
    ("serving/fleet/router.py", "FleetRouter.__init__"),
    ("serving/fleet/router.py", "FleetRouter.generate"),
    ("serving/fleet/router.py", "FleetRouter.proxy"),
    ("serving/fleet/router.py", "FleetRouter.drain"),
    ("serving/fleet/server.py", "FleetRouterServer.__init__"),
    ("serving/fleet/supervisor.py", "FleetSupervisor.__init__"),
    ("serving/fleet/supervisor.py", "FleetSupervisor.start"),
    ("tools/fleet.py", "main"),
    ("parallel/coordinator.py", "PodCoordinator.__init__"),
    ("parallel/coordinator.py", "PodCoordinator.step_sync"),
    ("parallel/coordinator.py", "CoordinatorServer.__init__"),
    ("parallel/coordinator.py", "PodClient.__init__"),
    ("parallel/coordinator.py", "PodClient.step_sync"),
    ("parallel/coordinator.py", "agree_verdicts"),
    ("parallel/coordinator.py", "pack_arrays"),
    ("resilience/trainer.py", "ResilientTrainer.__init__"),
    ("resilience/trainer.py", "ResilientTrainer.run"),
    ("resilience/service.py", "run_supervised"),
    ("tools/syncheck.py", "check_file"), ("tools/syncheck.py", "main")}


def _public_params(path):
    """{function or Class.method: [parameter names]} of a file's public
    top-level functions and public classes' public methods and
    ``__init__``."""
    out = {}
    for node in ast.parse(open(path).read()).body:
        defs = [(node.name, node)] if isinstance(node, ast.FunctionDef) \
            else []
        if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            defs = [(f"{node.name}.{m.name}", m) for m in node.body
                    if isinstance(m, ast.FunctionDef)
                    and (not m.name.startswith("_") or m.name == "__init__")]
        for name, fn in defs:
            if name.startswith("_"):
                continue
            a = fn.args
            out[name] = [x.arg for x in a.posonlyargs + a.args
                         + a.kwonlyargs] + (["**"] if a.kwarg else [])
    return out


def test_public_signatures_keep_the_reference_parameter_names():
    port_dir = os.path.join(ROOT, "paddle_tpu_torch")
    missing, shared, compared = {}, 0, set()
    for here, _, files in os.walk(port_dir):
        for f in files:
            rel = os.path.relpath(os.path.join(here, f), port_dir)
            ref = os.path.join(ROOT, "paddle_tpu", rel)
            if not f.endswith(".py") or not os.path.exists(ref):
                continue
            want, got = _public_params(ref), _public_params(
                os.path.join(port_dir, rel))
            for name in sorted(set(want) & set(got)):
                shared += 1
                compared.add((rel, name))
                skip = NOT_TAKEN.get((rel, name), set())
                names = [n for n in want[name] if n not in skip]
                if "**" in got[name]:
                    # a port function with **kwargs takes the other names
                    # there: it passes them on, or refuses them with
                    # NotImplementedError (Executor.run's validate and
                    # guard, cost_analysis); its named ones keep the order
                    names = [n for n in names if n in got[name]]
                if [n for n in got[name] if n in names] != names:
                    missing[(rel, name)] = (want[name], got[name])
                if skip & set(got[name]) or not skip <= set(want[name]):
                    missing[(rel, name)] = ("stale NOT_TAKEN", sorted(skip))
    assert shared >= 100
    assert CONTROL_PLANE_ENTRIES <= compared, CONTROL_PLANE_ENTRIES - compared
    assert not missing, missing


def test_reference_only_parameters_are_taken_or_refused():
    """What the reference's parameters do in the port: ``fc``'s
    ``use_mkldnn`` and ``flash_attention``'s ``block_q`` / ``block_k``
    are accepted and change nothing, ``keep_scale`` takes ``seed_u32``
    by name, ``append_backward``'s ``callbacks`` run on each op it
    appends, an ``impl`` other than None raises, and ``Executor``'s
    ``compile_cache`` is taken: the executor consults exactly that
    cache (False: none)."""
    from paddle_tpu_torch.fluid.backward import append_backward
    from paddle_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 8, 8, generator=g) for _ in range(3))
    want = fa.flash_attention(q, k, v, causal=True)
    got = fa.flash_attention(q, k, v, causal=True, block_q=16, block_k=32)
    assert torch.equal(got, want)
    with pytest.raises(NotImplementedError, match="impl"):
        fa.flash_attention(q, k, v, impl="pallas")
    pool = torch.zeros(2, 4, 4, 8)
    with pytest.raises(NotImplementedError, match="impl"):
        fa.ragged_decode_attention(
            torch.zeros(1, 1, 2, 8), pool, torch.zeros(1, 1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
            layer=0, n_layer=1, impl="xla")
    rows = torch.arange(4)[:, None]
    assert torch.equal(fa.keep_scale(seed_u32=3, bh=0, rows=rows,
                                     cols=rows.T, rate=0.5),
                       fa.keep_scale(3, 0, rows, rows.T, 0.5))
    from paddle_tpu_torch.fluid.compile_cache import CompileCache

    cache = CompileCache(os.path.join(ROOT, "no-such-dir"))
    exe = fluid.Executor(fluid.CPUPlace(), compile_cache=cache)
    assert exe._aot_cache() is cache and cache.keys() == []
    assert "cache" in exe.cache_stats()["persistent"]
    assert fluid.Executor(fluid.CPUPlace(),
                          compile_cache=False)._aot_cache() is None
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [4], "float32")
        h = fluid.layers.fc(x, size=3, use_mkldnn=True)
        loss = fluid.layers.mean(h)
        seen = []
        append_backward(loss, callbacks=[lambda block, op: seen.append(
            op.type)])
    assert seen[0] == "fill_constant" and "mul_grad" in seen
    assert h.shape[-1] == 3
