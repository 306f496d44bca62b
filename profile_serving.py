#!/usr/bin/env python3
"""Profile the PyTorch/CUDA port's serving path on one GPU.

    python3 profile_serving.py [--package-root DIR] [--out FILE]

Serves ``chip_smoke.py``'s 8 seeded requests (Transformer-base, page 16,
chunk 32, 8 slots, 32 new tokens, float32 KV pool) through
``ContinuousBatchingScheduler`` over ``PagedTransformerGenerator``
(built by ``chip_smoke.make_generator``; an earlier package's, which
takes ``device=`` and steps an eager ``nn.Module``, by
``earlier_generator``): once to warm up, then once
under ``torch.profiler``, which starts after the run's warm-up step
(``aot_warm``: the unified step's capture), where the run's clock
starts.  Prints one JSON line, per unified step: wall ms (host clock
over the run), device-busy ms (the sum of kernel times; the step runs
on one stream), the device's idle share (1 - busy / wall, over the same
steps), kernel launches and CUDA graph launches, host synchronisations
(the runtime's synchronize calls in the window, over the steps; the
run's one closing device synchronize is among them), the
ragged paged-attention kernels' device ms and device launches, the
wrapper's entry calls, and device ms by kernel family; beside them
tokens/s and TTFT p50 of the profiled run, the same three and the wall
ms a step of the unprofiled warm-up run (``unprofiled``: the profiler
adds host time to every step), the executor's counters and the peak
device memory of the whole process (generator, weights, pool, warm-up
and both runs) and of the serving alone (both runs, from the resident
weights and pool on).  Then it times the ragged wrapper's host cost:
``time.perf_counter`` over 1000 calls at the decode self-attention
shape (C = 1, 4 pages), issued without a sync between.

Before the warm-up run, ``aot_warm`` runs once under the allocator's
history (``warm_memory``: what it leaves allocated, its peak, and its
live blocks of 4 MiB or more with their pools and origins); the run's
own ``aot_warm`` is then a hit (for this package; an earlier one steps
its idle lanes once more).

``--package-root`` imports ``paddle_tpu_torch`` from another checkout
(an earlier commit unpacked by ``git archive``), so the same
measurement runs on both, in turns; ``chip_smoke.py`` and
``profile_training.py`` always come from this one.  With ``--out`` the
kernel table and the host's table by PyTorch op go to that file.  Needs one CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.abspath(__file__))
HOST_CALLS = 1000


def _load(name: str):
    """A script of this checkout by path, whatever sys.path holds."""
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def earlier_generator(cs):
    """An earlier package's generator (``device=``, no executor) with the
    two calls of this one that ``chip_smoke.serve_once`` makes: its
    warm-up ``aot_warm(n)`` is one all-idle ``lane_step`` at ``n``
    lanes, and its ``cache_stats`` an ``executable`` block of zeros
    (reported as null)."""
    from paddle_tpu_torch.serving import PagedTransformerGenerator

    class Earlier(PagedTransformerGenerator):
        def aot_warm(self, n_slots):
            self.open_slots(n_slots)
            self.lane_step()

        def cache_stats(self):
            return dict(super().cache_stats(),
                        executable={"hits": 0, "misses": 0})

    return Earlier(cs.VOCAB, cs.VOCAB, kv_dtype="float32", device="cuda",
                   **cs.MODEL, **cs.SERVE)


def warm_memory(torch, gen, n_slots):
    """``aot_warm`` at the serving width under the allocator's history:
    the device memory it leaves allocated and its peak over what was
    allocated before (MiB), and the blocks of 4 MiB or more still
    allocated after it, each with its pool (the default pool's id is
    (0, 0); a CUDA graph's is its own) and the innermost frame of the
    port that allocated it."""
    before = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=100000)
    gen.aot_warm(n_slots)
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    blocks = []
    for seg in snap["segments"]:
        for b in seg["blocks"]:
            # a block with frames was allocated under the history
            if b["state"] != "active_allocated" or b["size"] < 4 << 20 \
                    or not b.get("frames"):
                continue
            frames = [f"{f['filename'].split('paddle_tpu_torch')[-1]}:"
                      f"{f['line']} {f['name']}" for f in b["frames"]
                      if "paddle_tpu_torch" in f["filename"]]
            blocks.append({"mib": b["size"] / 2**20,
                           "pool": str(seg.get("segment_pool_id")),
                           "origin": frames[0] if frames else None})
    return {"allocated_mib": (torch.cuda.memory_allocated() - before)
            / 2**20,
            "peak_mib": (torch.cuda.max_memory_allocated() - before)
            / 2**20,
            "blocks": sorted(blocks, key=lambda b: -b["mib"])}


def host_us_per_call(torch, fa, cs, gen, dev):
    """Host microseconds per ``ragged_decode_attention`` call at the
    decode self-attention shape, over HOST_CALLS calls without a sync."""
    case = cs.kernel_cases(torch, gen)["decode_self"]
    pool, _ = cs.make_pools(torch, gen, dev)["float32"]
    s = case["sets"][0]
    q, table = s["q"].to(dev), s["table"].to(dev)
    lengths, base = case["lengths"].to(dev), case["q_base"].to(dev)
    kw = dict(layer=s["layer"], n_layer=cs.MODEL["n_layer"], causal=True,
              sm_scale=cs.MODEL["d_key"] ** -0.5)
    for _ in range(10):
        fa.ragged_decode_attention(q, pool, table, lengths, base, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fa.ragged_decode_attention(q, pool, table, lengths, base, **kw)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / HOST_CALLS * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", default=ROOT,
                    help="checkout whose paddle_tpu_torch to profile")
    ap.add_argument("--out", default=None, help="file for the kernel table")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.package_root))
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch.kernels.flash_attention as fa
    cs = _load("chip_smoke")
    pt = _load("profile_training")

    card = cs.card_line()
    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    from paddle_tpu_torch.serving import PagedTransformerGenerator
    current = "place" in inspect.signature(
        PagedTransformerGenerator).parameters
    gen = cs.make_generator("cuda", "float32") if current \
        else earlier_generator(cs)
    gen.init_params(seed=cs.SEED)
    resident = torch.cuda.memory_allocated()
    load_peak = torch.cuda.max_memory_allocated()
    srcs = cs.prompts(np)
    torch.cuda.reset_peak_memory_stats()
    memory = warm_memory(torch, gen, cs.N_SLOTS)
    warm, ok = cs.serve_once(torch, np, fa, gen, srcs)
    if not ok:
        print(f"profile_serving: warm-up run failed: {warm}",
              file=sys.stderr)
        return 1
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    rec, ok = cs.serve_once(torch, np, fa, gen, srcs, on_start=prof.start)
    prof.stop()
    if not ok:
        print(f"profile_serving: profiled run failed: {rec}", file=sys.stderr)
        return 1

    steps = rec["steps"]
    found, busy, idle = cs.device_busy(prof.events(),
                                       rec["step_ms"] * steps)
    busy /= steps
    by_family = defaultdict(float)
    n_kernels, ragged_us, ragged_n, kernels = 0, 0.0, 0, []
    for name, (us, n) in found.items():
        ragged = "ragged" in name
        by_family["ragged" if ragged else pt.family(name)] += us
        n_kernels += n
        if ragged:
            ragged_us += us
            ragged_n += n
        kernels.append((us, n, name))
    syncs = sum(1 for e in prof.events() if e.name in cs.SYNC_CALLS)
    graph_launches = sum(evt.count for evt in prof.key_averages()
                         if evt.key == "cudaGraphLaunch")
    out = {"card": card, "package_root": os.path.abspath(args.package_root),
           "kv_dtype": "float32", "requests": rec["requests"],
           "finished": rec["finished"], "steps": steps,
           "wall_ms_per_step": rec["step_ms"],
           "device_busy_ms_per_step": busy,
           "device_idle_share": idle,
           "host_syncs_per_step": syncs / steps,
           "graph_launches_per_step": graph_launches / steps,
           "decode_tok_per_s": rec["decode_tok_per_s"],
           "ttft_p50_s": rec["ttft_p50_s"],
           "unprofiled": {k: warm[k] for k in (
               "step_ms", "decode_tok_per_s", "ttft_p50_s", "steps")},
           "executable": rec["executable"] if current else None,
           "executable_during_serve": (rec["executable_during_serve"]
                                       if current else None),
           "resident_gib": resident / 2**30,
           "pool_gib": gen.cache_stats()["hbm"]["pool_bytes"] / 2**30,
           "serve_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "peak_mem_gib": max(load_peak,
                               torch.cuda.max_memory_allocated()) / 2**30,
           "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
           "warm_memory": memory,
           "ragged_ms_per_step": ragged_us / 1e3 / steps,
           "ragged_device_launches_per_step": ragged_n / steps,
           "ragged_calls_per_step": rec["launches_per_step"],
           "kernel_launches_per_step": n_kernels / steps,
           "device_ms_per_step_by_family": {
               k: v / 1e3 / steps for k, v in sorted(
                   by_family.items(), key=lambda kv: -kv[1])},
           "ragged_host_us_per_call": host_us_per_call(
               torch, fa, cs, torch.Generator().manual_seed(cs.SEED), dev)}
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(json.dumps(out, indent=1) + "\n\nkernels by device time "
                    "(us per step, launches per step, name)\n")
            for us, n, name in sorted(kernels, reverse=True):
                f.write(f"{us / steps:12.1f} {n / steps:8.1f}  "
                        f"{name[:160]}\n")
            f.write("\n" + prof.key_averages().table(
                sort_by="self_cpu_time_total", row_limit=40))
    return 0


if __name__ == "__main__":
    sys.exit(main())
