#!/usr/bin/env python3
"""Profile the PyTorch/CUDA port's serving path on one GPU.

    python3 profile_serving.py [--package-root DIR] [--out FILE]

Serves ``chip_smoke.py``'s 8 seeded requests (Transformer-base, page 16,
chunk 32, 8 slots, 32 new tokens, float32 KV pool) through
``ContinuousBatchingScheduler`` over ``PagedTransformerGenerator``: once
to warm up, then once under ``torch.profiler``, which starts after the
run's warm-up step, where the run's clock starts.  Prints one JSON line,
per unified step: wall ms (host clock over the run), device-busy ms (the
sum of kernel times; the step runs on one stream), the device's idle
share (1 - busy / wall, over the same steps), the ragged paged-attention
kernels' device ms and device launches, the wrapper's entry calls, and
device ms by kernel family.  Then it times the ragged wrapper's host
cost: ``time.perf_counter`` over 1000 calls at the decode self-attention
shape (C = 1, 4 pages), issued without a sync between.

``--package-root`` imports ``paddle_tpu_torch`` from another checkout
(an earlier commit unpacked by ``git archive``), so the same
measurement runs on both; ``chip_smoke.py`` and ``profile_training.py``
always come from this one.  With ``--out`` the kernel table goes to that
file.  Needs one CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
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
    gen = cs.make_generator("cuda", "float32")
    gen.init_params(seed=cs.SEED)
    srcs = cs.prompts(np)
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
    by_family = defaultdict(float)
    n_kernels, ragged_us, ragged_n, kernels = 0, 0.0, 0, []
    for evt in prof.key_averages():
        us = pt._dev_us(evt)
        if us > 0 and "CUDA" in str(getattr(evt, "device_type", "")):
            ragged = "ragged" in evt.key
            by_family["ragged" if ragged else pt.family(evt.key)] += us
            n_kernels += evt.count
            if ragged:
                ragged_us += us
                ragged_n += evt.count
            kernels.append((us, evt.count, evt.key))
    busy = sum(by_family.values()) / 1e3 / steps
    out = {"card": card, "package_root": os.path.abspath(args.package_root),
           "kv_dtype": "float32", "requests": rec["requests"],
           "finished": rec["finished"], "steps": steps,
           "wall_ms_per_step": rec["step_ms"],
           "device_busy_ms_per_step": busy,
           "device_idle_share": 1.0 - busy / rec["step_ms"],
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
