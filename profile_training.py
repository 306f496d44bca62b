#!/usr/bin/env python3
"""Profile a training step of the PyTorch/CUDA port on one GPU.

    python3 profile_training.py [--model transformer|lstm|resnet50|
                                 alexnet|googlenet|smallnet] [--amp]
                                [--batch N] [--steps 3] [--out FILE]
                                [--package-root DIR]

Builds a training program ``chip_smoke.py`` trains: ``transformer``
(default; Transformer-base, L=256, bench.py's recipe, batch 64, in
float32 or, with ``--amp``, in its bf16 recipe ``amp_dtype="bfloat16"``),
``lstm`` (the RNN benchmark model, hidden 512, T=100, Adam 2e-3,
batch 128, the same ragged batch) or an image model in bench.py's
recipe (``resnet50``: 224 px, 1000 classes, Momentum 0.1 / 0.9;
``alexnet``, ``googlenet``, ``smallnet``: Momentum 0.01 / 0.9; bf16
images over f32 master weights, batch 128, one fixed batch kept on the
card; the startup program run on the card, as bench.py runs it), runs
two warm-up steps (the first
runs eagerly and is captured in a CUDA graph: its wall ms is
``first_step_ms``; every later step replays the graph), five steps
timed without the profiler (their median wall ms), then ``--steps``
steps under ``torch.profiler``.  Prints one JSON line: the card, the
first step's ms, peak memory, the executor's hits, the captured graph
(nodes, kernel nodes, graph launches a step), wall ms per step,
device-busy ms per step (the sum of kernel
times; the step runs on one stream, so kernels do not overlap), the
device's idle share, device ms per step by kernel family (the flash
and LSTM kernels, matrix products, elementwise, reductions, the rest), kernel
launches and host synchronisations per step, and per Fluid op type the
host ms per step and the device span its kernels cover (the executor
labels each op's work with its type while a profiler runs, which only
an eager step does: a replayed step has no per-op host time).  With
``--out``, the full tables go to that file.  A host sync counts when a
step makes it (a synchronize call inside a step's profiler range).
``--package-root DIR`` profiles the ``paddle_tpu_torch`` of another
checkout (a ``git archive`` of an earlier commit) with this script's
programs and counts; where that package's executor has no cache or
graph, those fields are null.  For an image model one more step then
runs eagerly (``lowering.run_block_ops``) under the profiler, for the
device time of each Fluid op type's kernels
(``eager_device_ms_by_op_type``: the kernels a replayed step runs too)
and the ``batch_norm`` ops' share of it (forward and backward).  Needs
one CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.abspath(__file__))
UNPROFILED_STEPS = 5

# kernel-name fragments -> family, first match wins
FAMILIES = (("lstm_fwd", ("lstm_fwd_kernel",)),
            ("flash_fwd", ("fwd_kernel", "fwd_bf16_kernel", "fwd_wg_kernel")),
            ("flash_dq", ("dq_kernel", "dq_wg_kernel")),
            ("flash_dkv", ("dkv_kernel", "dkv_wg_kernel")),
            ("matmul", ("gemm", "Gemm", "cutlass", "xmma", "nvjet")),
            ("elementwise", ("elementwise", "vectorized", "unrolled")),
            ("reduce", ("reduce", "Reduce", "softmax", "norm")),
            ("index", ("index", "gather", "scatter")))


STEP = "profile_training/step"


def family(name: str) -> str:
    for fam, frags in FAMILIES:
        if any(f in name for f in frags):
            return fam
    return "other"


def eager_op_ms(torch, main_prog, loss, feed, scope):
    """One step of ``main_prog`` run eagerly on the scope's state under
    the profiler -> {Fluid op type: device ms of the kernels its ops
    launch}.  The lowering labels each op's work with its type while a
    profiler runs; a grad op's kernels are launched from autograd's own
    thread while the op's range is open, so each kernel goes to the
    range open when the PyTorch op that launched it started."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.fluid.lowering import (BlockPlan, run_block_ops,
                                                 seed_tensor, step_seeds)

    plan = BlockPlan(main_prog.desc.global_block(), list(feed),
                     [loss.name])
    env = {n: scope.find_var(n) for n in plan.state_in}
    env.update(feed)
    dev = torch.device("cuda", 0)
    seeds = step_seeds(plan, main_prog.random_seed or 0, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            torch.no_grad():
        run_block_ops(plan, env, seeds, seed_tensor(seeds).to(dev), dev)
        torch.cuda.synchronize()
    types = {op.type for op in plan.ops}
    events = prof.events()
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in events if e.name in types
                    and "CUDA" not in str(getattr(e, "device_type", "")))
    starts = [r[0] for r in ranges]
    out = defaultdict(float)
    for evt in events:
        kernels = getattr(evt, "kernels", None) or ()
        i = bisect.bisect_right(starts, evt.time_range.start) - 1
        if not kernels or i < 0 or evt.time_range.start > ranges[i][1]:
            continue
        out[ranges[i][2]] += sum(k.duration for k in kernels) / 1e3
    return dict(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("transformer", "lstm", "resnet50",
                                        "alexnet", "googlenet", "smallnet"),
                    default="transformer")
    ap.add_argument("--amp", action="store_true",
                    help="the Transformer's bf16 recipe (amp_dtype)")
    ap.add_argument("--batch", type=int, default=None,
                    help="default 64 (transformer) or 128 (lstm, image "
                    "models)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="file for the kernel and op tables")
    ap.add_argument("--package-root", metavar="DIR", default=None,
                    help="profile the paddle_tpu_torch package under DIR")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_training: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    if args.package_root:       # its package, this script's programs
        sys.path.insert(0, os.path.abspath(args.package_root))
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models.transformer import transformer

    card = cs.card_line()
    image = args.model in cs.IMAGE_NETS
    if image:
        batch = args.batch or cs.IMAGE_BATCH
        seq = None
        main_prog, startup, loss = cs.build_image(fluid, args.model)
        feed = cs.device_feed(torch, cs.image_feed(torch, np, args.model,
                                                   batch),
                              torch.device("cuda", 0))
    elif args.model == "lstm":
        batch = args.batch or cs.LSTM_BATCH
        seq = cs.LSTM_T
        main_prog, startup, loss = cs.build_rnn_benchmark(fluid)
        feed = cs.lstm_feed(np, fluid, batch, cs.rnn_benchmark_lengths(batch))
    else:
        batch = args.batch or cs.TRAIN_BATCH
        seq = cs.SEQ
        main_prog, startup, loss = cs.build_training(
            fluid, transformer, cs.AMP if args.amp else None)
        feed = cs.train_feed(np, batch)
    place = fluid.CUDAPlace(0)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
    first_ms = (time.perf_counter() - t0) * 1e3
    exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
    # the same steps without the profiler: the fetched loss comes back as
    # a numpy array, so each step has ended when its clock stops
    plain = []
    for _ in range(UNPROFILED_STEPS):
        t0 = time.perf_counter()
        exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
        plain.append(time.perf_counter() - t0)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            # the fetched loss comes back as a numpy array: the step, and
            # the card's work for it, has ended when its run returns
            with torch.profiler.record_function(STEP):
                exe.run(main_prog, feed=feed, fetch_list=[loss],
                        scope=scope)
        wall = time.perf_counter() - t0
    op_types = {op.type for op in main_prog.global_block().ops}
    step_ms = wall / args.steps * 1e3
    found, busy, idle = cs.device_busy(prof.events(), wall * 1e3)
    busy /= args.steps
    by_family = defaultdict(float)
    kernels = []
    for name, (us, n) in found.items():
        by_family[family(name)] += us
        kernels.append((us, n, name))
    launches = sum(n for _, n, _ in kernels)
    # per Fluid op type: host time of its annotation on the calling
    # thread, and the span its kernels cover on the device timeline
    by_op, dev_by_op = defaultdict(float), defaultdict(float)
    for evt in prof.events():
        if evt.name not in op_types:
            continue
        if "CUDA" in str(getattr(evt, "device_type", "")):
            dev_by_op[evt.name] += evt.time_range.elapsed_us() / 1e3 \
                / args.steps
        else:
            by_op[evt.name] += evt.cpu_time_total / 1e3 / args.steps
    syncs = cs.host_syncs_in(prof.events(), STEP)
    graph_launches = sum(evt.count for evt in prof.key_averages()
                         if evt.key == "cudaGraphLaunch")
    rec = {"card": card, "model": args.model,
           "amp_dtype": cs.AMP if (args.amp and args.model == "transformer")
           or image else None, "batch": batch, "seq": seq,
           "steps": args.steps, "first_step_ms": first_ms,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "executable": (exe.cache_stats()["executable"]
                          if hasattr(exe, "cache_stats") else None),
           "graph": cs.step_graph(exe) if hasattr(exe, "graphs") else None,
           "graph_launches_per_step": graph_launches / args.steps,
           "wall_ms_per_step": step_ms,
           "unprofiled_step_ms_median":
               sorted(plain)[len(plain) // 2] * 1e3,
           "device_busy_ms_per_step": busy,
           "device_idle_share": idle,
           "device_ms_per_step_by_family": {
               k: v / 1e3 / args.steps for k, v in sorted(
                   by_family.items(), key=lambda kv: -kv[1])},
           "kernel_launches_per_step": launches / args.steps,
           "host_syncs_per_step": syncs / args.steps,
           "host_ms_per_step_by_op_type": dict(sorted(
               by_op.items(), key=lambda kv: -kv[1])[:15]),
           "device_span_ms_per_step_by_op_type": dict(sorted(
               dev_by_op.items(), key=lambda kv: -kv[1])[:15])}
    if image:
        eager = eager_op_ms(torch, main_prog, loss, feed, scope)
        total = sum(eager.values())
        rec["eager_device_ms"] = total
        rec["eager_device_ms_by_op_type"] = dict(sorted(
            eager.items(), key=lambda kv: -kv[1]))
        rec["batch_norm_device_share"] = (
            eager.get("batch_norm", 0.0) + eager.get("batch_norm_grad", 0.0)
        ) / total if total else None
    print(json.dumps(rec), flush=True)
    if args.out is None:
        return 0
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(json.dumps(rec, indent=1) + "\n\nkernels by device time "
                "(us per step, launches per step, name)\n")
        for us, n, name in sorted(kernels, reverse=True):
            f.write(f"{us / args.steps:12.1f} {n / args.steps:8.1f}  "
                    f"{name[:160]}\n")
        f.write("\nhost ms, device span ms per step by Fluid op type\n")
        for k, v in sorted(by_op.items(), key=lambda kv: -kv[1]):
            f.write(f"{v:10.3f} {dev_by_op.get(k, 0.0):10.3f}  {k}\n")
        f.write("\n" + prof.key_averages().table(
            sort_by="self_cpu_time_total", row_limit=40))
    return 0


if __name__ == "__main__":
    sys.exit(main())
