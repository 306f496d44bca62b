#!/usr/bin/env python3
"""Time variants of the bf16 flash-attention backward kernels at D = 64
(``dq_wg_kernel``, ``dkv_wg_kernel``) on one GPU.

    python3 tune_flash_bwd.py [--variants NAME ...]

A variant is ``paddle_tpu_torch/kernels/csrc/flash_attention_bwd.cu``
with some of its named constants changed (``VARIANTS``): the ring depth
and the blocks an SM each kernel asks for.  Every
variant is built by nvcc, all at once, into
``paddle_tpu_torch/kernels/build/variants/`` (gitignored) and bound to
the wrappers in place of the package's dq and dk/dv entries
(``chip_smoke.flash_library``).  At the training path's shape (B=64,
L=256, H=8, D=64, 'blhd', bf16), causal and not, each variant's dq and
dk/dv are timed on the device clock (``chip_smoke.device_ms``) at the
step's dropout 0.1 and at 0, and averaged over the step's 12 full and 6
causal attentions; the variants run in turns (the list, then the list
reversed), so each number is the mean of two turns.  The error of dq,
dk and dv against the plain backward, max |kernel - plain| over max(1,
max |plain|) (chip_smoke's FLASH_TOL measure), is taken there and at
B=1, L=4096 (64 key or query tiles a block: where a long tensor-core
chain would bias the sums), on the same seeded inputs for every
variant.  Prints the card and one JSON line a
variant; needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "flash_attention_bwd"

# name -> {constant of flash_attention_bwd.cu: the value it takes}
VARIANTS = {
    "shipped": {},
    "ring3": {"kBwdStages": "3"},
    "dq_3_blocks": {"kDqBlocks": "3"},
    "dkv_2_blocks": {"kDkvBlocks": "2"},
}


def variant_source(text: str, changes: dict) -> str:
    """``text`` with each ``constexpr <type> NAME = <value>;`` of
    ``changes`` given its new value; raises if a name is not found once."""
    for name, value in changes.items():
        pat = re.compile(rf"(constexpr \w+ {name} = )[^;]+;")
        text, n = pat.subn(rf"\g<1>{value};", text)
        if n != 1:
            raise ValueError(f"{name}: {n} definitions in {SOURCE}.cu")
    return text


def build_variants(names):
    """{name: loaded library}, one nvcc per variant, all started
    together."""
    from paddle_tpu_torch.kernels import _build

    base = os.path.join(_build.BUILD_DIR, "variants")
    text = (_build.CSRC_DIR / f"{SOURCE}.cu").read_text()
    procs = {}
    for name in names:
        d = os.path.join(base, name)
        os.makedirs(d, exist_ok=True)
        for h in _build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(h, d)
        src = os.path.join(d, f"{SOURCE}.cu")
        with open(src, "w") as f:
            f.write(variant_source(text, VARIANTS[name]))
        lib = os.path.join(d, f"lib{SOURCE}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        libs[name] = (ctypes.CDLL(lib), _wg_registers(log))
    return libs


def _wg_registers(log: str) -> dict:
    """{kernel: ptxas's spill and registers lines} of the warpgroup
    kernels."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = next((k for k in ("dq_wg_kernelILb1", "dq_wg_kernelILb0",
                                    "dkv_wg_kernelILb1", "dkv_wg_kernelILb0")
                        if k in ln), None)
        elif cur and ("registers" in ln or "spill" in ln):
            name = cur.replace("ILb1", "/dropout").replace("ILb0", "")
            out[name] = (out.get(name, "") + " "
                         + ln.split(":", 1)[-1].strip()).strip()
    return out


def errors(torch, cs, fa, dev, B, L, causal):
    """max |kernel - plain| / max(1, max |plain|) of dq, dk, dv at B, L
    (H=8, D=64, bf16, dropout 0.1), on inputs drawn from a seed of their
    own: every variant meets the same ones."""
    gen = torch.Generator()
    gen.manual_seed(cs.SEED + L + int(causal))
    q, k, v, dout = (torch.randn(B, L, 8, 64, generator=gen).to(
        dev, torch.bfloat16) for _ in range(4))
    cfg = (causal, 64 ** -0.5, 0.1, cs.SEED, "blhd", (0, 0))
    out, lse = fa._flash_fwd_cuda(q, k, v, None, *cfg)
    args = (q, k, v, out, dout, lse, torch.empty_like(lse), *cfg)
    got = (fa._flash_dq_cuda(*args), *fa._flash_dkv_cuda(*args))
    p_out, p_lse = fa.flash_forward_plain(q, k, v, None, *cfg)
    want = fa.flash_backward_plain(q, k, v, p_out, dout, p_lse, None, *cfg)
    res = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err, mag = cs._max_err(torch, g, w)
        res[name] = err / max(1.0, mag)
    del got, want
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("tune_flash_bwd: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import paddle_tpu_torch.kernels.flash_attention as fa

    print(cs.card_line(), flush=True)
    libs = build_variants(args.variants)
    dev = torch.device("cuda", 0)
    gen = torch.Generator()
    gen.manual_seed(cs.SEED)
    B, L, H, D = cs.TRAIN_BATCH, cs.SEQ, cs.MODEL["n_head"], cs.MODEL["d_key"]
    q, k, v, dout = (torch.randn(B, L, H, D, generator=gen).to(
        dev, torch.bfloat16) for _ in range(4))
    fwd = {c: fa._flash_fwd_cuda(q, k, v, None, c, D ** -0.5, 0.1, cs.SEED,
                                 "blhd", (0, 0)) for c in (False, True)}

    def bound(name):
        lib = libs[name][0]
        return cs.flash_library(fa, {SOURCE: lib})

    def times(name):
        res = {}
        with bound(name):
            for causal in (False, True):
                out, lse = fwd[causal]
                delta = torch.empty_like(lse)
                for rate in (0.1, 0.0):
                    cfg = (causal, D ** -0.5, rate, cs.SEED if rate else 0,
                           "blhd", (0, 0))
                    a = (q, k, v, out, dout, lse, delta, *cfg)
                    fa._flash_dq_cuda(*a)          # delta for dk/dv
                    for kind, fn in (("dq", fa._flash_dq_cuda),
                                     ("dkv", fa._flash_dkv_cuda)):
                        res[(kind, rate, causal)] = cs.device_ms(
                            torch, lambda: fn(*a), 20)
        return res

    order = args.variants + args.variants[::-1]
    runs = {n: [] for n in args.variants}
    for name in order:
        runs[name].append(times(name))
    n_full = cs.ATTN_PER_STEP - cs.CAUSAL_PER_STEP
    for name in args.variants:
        rec = {"variant": name, "changes": VARIANTS[name],
               "registers": libs[name][1]}
        for kind in ("dq", "dkv"):
            for rate, key in ((0.1, "ms"), (0.0, "ms_dropout0")):
                per = [(n_full * r[(kind, rate, False)]
                        + cs.CAUSAL_PER_STEP * r[(kind, rate, True)])
                       / cs.ATTN_PER_STEP for r in runs[name]]
                rec[f"{kind}_{key}"] = sum(per) / len(per)
                rec[f"{kind}_{key}_turns"] = per
        for key in ("ms", "ms_dropout0"):
            rec[f"pair_{key}"] = rec[f"dq_{key}"] + rec[f"dkv_{key}"]
        with bound(name):
            rec["err_L256"] = {
                "full": errors(torch, cs, fa, dev, B, L, False),
                "causal": errors(torch, cs, fa, dev, B, L, True)}
            rec["err_L4096"] = errors(torch, cs, fa, dev, 1, 4096, False)
        torch.cuda.synchronize()
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
