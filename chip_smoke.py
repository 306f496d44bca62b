#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paged serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card; it imports
``paddle_tpu_torch`` and never JAX or ``paddle_tpu``.  Phases:

1. the card's name and power limit, as ``nvidia-smi`` gives them;
2. build the CUDA kernel from the checkout's sources (``nvcc``, sm_90a);
3. hold the kernel against its plain PyTorch version on the card at the
   serving path's shapes (decode C=1 over self pages, decode C=1 over
   cross pages, prefill C=32), for float32, bfloat16 and int8 pools,
   with dead lanes and lengths that end mid-page;
4. serve 8 seeded requests (prompts of 64-256 tokens, 32 new tokens)
   through ``ContinuousBatchingScheduler`` over a Transformer-base
   ``PagedTransformerGenerator`` once per pool dtype, and check that
   every request finished and that the kernel served every attention
   call (18 launches per step at 6 layers);
5. replay the same requests teacher-forced through a card generator and
   a CPU generator (``device="cpu"``, plain path) with the same weights
   and compare the logits of every decoding lane;
6. time the kernel and its plain version at the path's shapes.

It prints a ``serving`` line, a ``kernels`` line and, last, the
``{"ok": true, ...}`` line; per-case detail goes to standard error.  Any
failed check exits 1 without the last line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016

# Transformer-base as the repo serves it (bench.py's serving section)
VOCAB = 32768
MODEL = dict(n_layer=6, n_head=8, d_key=64, d_value=64, d_model=512,
             d_inner_hid=2048)
SERVE = dict(max_length=257, src_len=256, max_out_len=64, page_size=16,
             chunk_size=32, num_pages=1024)
N_REQUESTS, N_SLOTS, MAX_NEW = 8, 8, 32
KV_DTYPES = ("float32", "bfloat16", "int8")

# H100 SXM data-sheet peaks (dense): HBM3 rate and the fp32 rate outside
# the tensor cores (the kernel's arithmetic is fp32 on CUDA cores)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# kernel vs plain on the same inputs: both compute in fp32; they differ
# only in summation order (64-term dots, per-page partial softmax sums
# vs one softmax over all pages) and in expf vs torch.exp rounding
KERNEL_ATOL, KERNEL_RTOL = 1e-4, 1e-4
# card vs CPU logits, teacher-forced: fp32 end to end (TF32 off), so the
# float32 pool differs only by summation order through 12 layers; a
# bf16 or int8 pool also rounds K/V on write, and a value that lands on
# the other side of a rounding boundary moves one key element by one
# bf16 ulp (2^-8 relative) or one int8 step (scale/127)
LOGIT_ATOL = {"float32": 1e-3, "bfloat16": 1e-2, "int8": 1e-2}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


# -- phase 3/6: the kernel against its plain version ------------------------

def kernel_cases(torch, gen):
    """Argument sets at the serving path's shapes: 8 lanes, 8 heads,
    D=64, page 16; a prefill chunk of 32 rows over up to 16 encoder
    pages, a decode row over up to 4 self pages and over up to 16 cross
    pages.  Lengths end mid-page; lane 5 is dead (length 0) and lane 4
    idles the way the serving path idles a lane (length 1 on page 0)."""
    B = N_SLOTS
    n_layer = MODEL["n_layer"]
    pages = SERVE["num_pages"]
    pf_len = torch.tensor([32, 69, 100, 256, 1, 0, 161, 250])
    pf_base = torch.clamp((pf_len - 1) // 32 * 32, min=0)
    self_len = torch.tensor([1, 17, 33, 64, 1, 0, 48, 63])
    src_len = torch.tensor([64, 100, 256, 77, 1, 0, 129, 200])
    specs = {  # name: (C, causal, P, lengths, q_base)
        "prefill": (32, True, 16, pf_len, pf_base),
        "decode_self": (1, True, 4, self_len,
                        torch.clamp(self_len - 1, min=0)),
        "decode_cross": (1, False, 16, src_len, torch.zeros(B, dtype=torch.long)),
    }
    cases = {}
    for name, (C, causal, P, lengths, q_base) in specs.items():
        sets = []
        for k in range(16):            # distinct pages: L2 stays cold
            table = torch.randperm(pages - 1, generator=gen)[:B * P] + 1
            table = table.reshape(B, P).to(torch.int32)
            table[4] = 0               # idle lane on the trash page
            q = torch.randn(B, C, MODEL["n_head"], MODEL["d_key"],
                            generator=gen)
            sets.append(dict(q=q, table=table, layer=k % n_layer))
        cases[name] = dict(C=C, causal=causal, P=P, sets=sets,
                           lengths=lengths.to(torch.int32),
                           q_base=q_base.to(torch.int32))
    return cases


def make_pools(torch, gen, dev):
    """One pool per dtype, [H, R, ps, D] over 1024 logical pages."""
    from paddle_tpu_torch.fluid.ops.quant_ops import (abs_max_scale,
                                                      quantize_array)
    H, D, ps = MODEL["n_head"], MODEL["d_key"], SERVE["page_size"]
    R = SERVE["num_pages"] * MODEL["n_layer"] * 2
    g = torch.Generator(device=dev)
    g.manual_seed(int(torch.randint(0, 2**31, (1,), generator=gen)))
    f32 = torch.randn(H, R, ps, D, device=dev, generator=g)
    sc = abs_max_scale(f32, axis=(1, 2))                      # [R, ps]
    i8 = quantize_array(f32, sc, axis=(1, 2))
    return {"float32": (f32, None), "bfloat16": (f32.to(torch.bfloat16), None),
            "int8": (i8, sc.reshape(1, R, ps).contiguous())}


def bound(case, pool, scales):
    """Least time for the work these inputs need: each live page's K and
    V slabs (and scales) read once per head, q/out/tables once; 4*C*ps*D
    fp32 operations per live page and head (the two dot products)."""
    H, _r, ps, D = pool.shape
    C, P = case["C"], case["P"]
    B = len(case["lengths"])
    live = sum(min(P, math.ceil(int(n) / ps)) for n in case["lengths"])
    item = pool.element_size()
    nbytes = live * H * 2 * ps * D * item
    if scales is not None:
        nbytes += live * 2 * ps * 4
    nbytes += 2 * B * C * H * D * 4 + B * P * 4 + 2 * B * 4
    ops = live * H * 4 * C * ps * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def run_case(fa, case, s, pool, scales, plain):
    fn = fa.ragged_attention_plain if plain else fa.ragged_decode_attention
    args = (s["q"], pool, s["table"], case["lengths"], case["q_base"])
    if plain:
        return fn(*args, s["layer"], MODEL["n_layer"], case["causal"],
                  MODEL["d_key"] ** -0.5, scales=scales)
    return fn(*args, layer=s["layer"], n_layer=MODEL["n_layer"],
              causal=case["causal"], sm_scale=MODEL["d_key"] ** -0.5,
              scales=scales)


def time_case(torch, fa, case, pool, scales, plain, iters):
    """ms per call: CUDA events around ``iters`` calls that rotate over
    16 argument sets on distinct pages (more than L2 holds)."""
    sets = case["sets"]
    for s in sets[:4]:
        run_case(fa, case, s, pool, scales, plain)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        run_case(fa, case, sets[i % len(sets)], pool, scales, plain)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# -- phase 4/5: serving -----------------------------------------------------

def make_generator(device, kv_dtype):
    from paddle_tpu_torch.serving import PagedTransformerGenerator
    return PagedTransformerGenerator(VOCAB, VOCAB, device=device,
                                     kv_dtype=kv_dtype, **MODEL, **SERVE)


def prompts(np):
    rng = np.random.RandomState(SEED)
    return [rng.randint(2, VOCAB, rng.randint(64, SERVE["src_len"] + 1))
            for _ in range(N_REQUESTS)]


def serve_once(torch, np, fa, gen, srcs):
    """The main path: requests in through the scheduler's thread, tokens
    out.  Returns (run record, every request finished)."""
    from paddle_tpu_torch.serving import ContinuousBatchingScheduler

    gen.open_slots(N_SLOTS)
    gen.lane_step()                 # warm-up: one all-idle step
    torch.cuda.synchronize()
    sched = ContinuousBatchingScheduler(gen, n_slots=N_SLOTS,
                                        max_new_tokens=MAX_NEW)
    steps0 = gen.cache_stats()["steps"]
    fa.ragged_decode_attention.launches = 0
    t0 = time.perf_counter()
    sched.serve()
    reqs = [sched.submit(s, max_new_tokens=MAX_NEW) for s in srcs]
    done = all(r.wait(timeout=600) for r in reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sched.shutdown(timeout=30)
    launches = fa.ragged_decode_attention.launches
    steps = gen.cache_stats()["steps"] - steps0
    tokens = sum(len(r.tokens) for r in reqs)
    ttft = [r.first_token - r.submitted for r in reqs
            if r.first_token is not None]
    rec = {"requests": len(reqs),
           "finished": sum(r.done and r.error is None for r in reqs),
           "errors": [repr(r.error) for r in reqs if r.error is not None],
           "tokens": tokens, "wall_s": wall, "steps": steps,
           "launches": launches,
           "launches_per_step": launches / max(1, steps),
           "decode_tok_per_s": tokens / wall,
           "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft else None,
           "step_ms": wall / max(1, steps) * 1e3}
    return rec, done and rec["finished"] == len(reqs)


def teacher_forced(np, gpu, cpu, srcs):
    """Same requests, same weights, same feeds on the card and on the CPU;
    each step both absorb the card's tokens.  Returns the largest logit
    difference over decoding lanes and the share of steps where the two
    argmaxes agree."""
    for g in (gpu, cpu):
        g.open_slots(len(srcs))
        for i, s in enumerate(srcs):
            g.admit_slot(i, s, max_new=MAX_NEW)
    counts = [0] * len(srcs)
    worst, agree, total = 0.0, 0, 0
    while any(ln.phase != "idle" for ln in gpu._lanes):
        feed, feed_c = gpu.step_feed(), cpu.step_feed()
        if any(not np.array_equal(feed[k], feed_c[k]) for k in feed):
            raise AssertionError("card and CPU generators built different "
                                 "feeds for the same requests")
        ids_g, lg = gpu.run_feed(feed)
        ids_c, lc = cpu.run_feed(feed)
        ids_g = ids_g.cpu().numpy()
        ids_c = ids_c.numpy()
        emitted = cpu.absorb_step(ids_g)
        gpu.absorb_step(ids_g)
        for slot, tok in emitted.items():
            diff = (lg[slot].cpu() - lc[slot]).abs().max().item()
            worst = max(worst, diff)
            agree += int(ids_c[slot, 0] == tok)
            total += 1
            counts[slot] += 1
            if tok == gpu.end_id or counts[slot] >= MAX_NEW:
                gpu.clear_slot(slot)
                cpu.clear_slot(slot)
    return worst, agree / max(1, total)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import paddle_tpu_torch.kernels.flash_attention as fa
    from paddle_tpu_torch.kernels import _build

    failures = []
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)

    # -- build
    t0 = time.perf_counter()
    lib = _build.build_all([fa.KERNEL_NAME])[fa.KERNEL_NAME]
    log(f"built {lib.name} in {time.perf_counter() - t0:.1f}s")
    build_log = lib.with_name(lib.name + ".log")
    if build_log.exists():          # ptxas: registers, spills, barriers
        for ln in build_log.read_text().splitlines():
            if "ptxas" in ln and "Compile time" not in ln:
                log(ln)

    # -- kernel vs plain on the card
    dev = torch.device("cuda", 0)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    cases = kernel_cases(torch, gen)
    for case in cases.values():
        case["lengths"] = case["lengths"].to(dev)
        case["q_base"] = case["q_base"].to(dev)
        for s in case["sets"]:
            s["q"] = s["q"].to(dev)
            s["table"] = s["table"].to(dev)
    pools = make_pools(torch, gen, dev)
    max_err = 0.0
    for kv, (pool, scales) in pools.items():
        for name, case in cases.items():
            case_err = 0.0
            for s in case["sets"][:4]:
                got = run_case(fa, case, s, pool, scales, False)
                want = run_case(fa, case, s, pool, scales, True)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                ok = bool(torch.allclose(got, want, atol=KERNEL_ATOL,
                                         rtol=KERNEL_RTOL))
                dead = bool((got[5] == 0).all())
                case_err = max(case_err, err)
                if not ok or not dead:
                    failures.append(f"kernel {kv}/{name}: max_abs_err "
                                    f"{err} (dead lane zero: {dead})")
            max_err = max(max_err, case_err)
            log(f"kernel vs plain {kv}/{name}: max_abs_err {case_err}")

    # -- serving, the main path, once per pool dtype
    srcs = prompts(np)
    runs = []
    launches = 0
    weights = None
    for kv in KV_DTYPES:
        g = make_generator("cuda", kv)
        if weights is None:
            g.init_params(seed=SEED)
            weights = {k: v.detach().cpu()
                       for k, v in g.model.state_dict().items()}
        else:
            g.model.load_state_dict(weights)
        rec, ok = serve_once(torch, np, fa, g, srcs)
        rec["kv_dtype"] = kv
        launches += rec["launches"]
        want = 3 * MODEL["n_layer"] * rec["steps"]
        if not ok:
            failures.append(f"serving {kv}: {rec['finished']} of "
                            f"{rec['requests']} requests finished "
                            f"{rec['errors']}")
        if rec["launches"] != want or rec["steps"] == 0:
            failures.append(f"serving {kv}: {rec['launches']} kernel "
                            f"launches in {rec['steps']} steps, want {want}")
        runs.append(rec)
        del g
        torch.cuda.empty_cache()
        log(f"served {kv}: {json.dumps(rec)}")

        # teacher-forced card vs CPU on the same feeds
        gpu = make_generator("cuda", kv)
        cpu = make_generator("cpu", kv)
        gpu.model.load_state_dict(weights)
        cpu.model.load_state_dict(weights)
        t0 = time.perf_counter()
        worst, agree = teacher_forced(np, gpu, cpu, srcs)
        rec["logits_max_abs_err_vs_cpu"] = worst
        rec["token_agreement_vs_cpu"] = agree
        log(f"teacher-forced {kv}: max |dlogit| {worst}, argmax agreement "
            f"{agree} ({time.perf_counter() - t0:.1f}s)")
        if not worst <= LOGIT_ATOL[kv]:
            failures.append(f"logits {kv}: card vs CPU max_abs_err {worst} "
                            f"> {LOGIT_ATOL[kv]}")
        del gpu, cpu
        torch.cuda.empty_cache()

    # -- timings at the path's shapes
    timing = []
    for kv, (pool, scales) in pools.items():
        for name, case in cases.items():
            ms = time_case(torch, fa, case, pool, scales, False, 200)
            pms = time_case(torch, fa, case, pool, scales, True, 20)
            ms2 = time_case(torch, fa, case, pool, scales, False, 200)
            b_ms, b_by = bound(case, pool, scales)
            timing.append({"kv_dtype": kv, "case": name, "ms": ms,
                           "ms_repeat": ms2, "plain_ms": pms,
                           "bound_ms": b_ms, "bound_by": b_by})
    fp32 = [t for t in timing if t["kv_dtype"] == "float32"]
    b_bytes = sum(t["bound_ms"] for t in fp32 if t["bound_by"] == "bytes")
    b_ops = sum(t["bound_ms"] for t in fp32 if t["bound_by"] != "bytes")
    kernels = [{
        "name": fa.KERNEL_NAME,
        "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/kernels/flash_attention.py:181",
        "launches": launches,
        "max_abs_err": max_err,
        # one call of each of the step's three shapes, float32 pool
        "ms": sum(t["ms"] for t in fp32),
        "plain_ms": sum(t["plain_ms"] for t in fp32),
        "bound_ms": b_bytes + b_ops,
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": None,
    }]
    for t in timing:
        log(json.dumps(t))

    print(json.dumps({"serving": {"card": card, "runs": runs}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    if failures:
        for f in failures:
            log(f"chip_smoke: FAIL: {f}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
