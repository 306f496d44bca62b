"""aot_compile — pre-warm a model version's compiled bucket set offline;
the port of ``paddle_tpu/tools/aot_compile.py``.

::

    # pre-compile a published version in place (<dir>/compiled/)
    python -m paddle_tpu_torch.tools.aot_compile --root models/ --model nmt \\
        --version 3 --n-slots 8

    # an explicit artifact dir (generator or save_inference_model)
    python -m paddle_tpu_torch.tools.aot_compile --dirname models/nmt/3 \\
        --n-slots 8 --json

    # an engine artifact with a reduced bucket set + ragged time cap
    python -m paddle_tpu_torch.tools.aot_compile --dirname models/cls/1 \\
        --batch-bucket 1 --batch-bucket 8 --max-time 64

A publish pipeline runs it once, offline, on the card the version will
serve on (``--cpu``: on the CPU), and every serving process that later
loads the version — gateway hot swap, restart, a fresh replica — loads
each signature's stored record and the kernel libraries its steps
launch (``fluid/compile_cache.py``) instead of building them with
``nvcc``.  A warm start still runs each signature's eager step and CUDA
graph capture, which cannot be stored.  The second run over an
already-warm version reports zero compiles and byte-stable cache keys.
``--mesh`` (a sharded generator) fails with exit 1: the serving mesh is
ROADMAP A15.

Exit status: 0 = bucket set resolved, 1 = pre-compilation failed,
2 = bad arguments / missing artifact.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional


def _dir_bytes(cache_dir: str) -> int:
    return int(sum(
        os.path.getsize(os.path.join(cache_dir, n))
        for n in os.listdir(cache_dir)) if os.path.isdir(cache_dir)
        else 0)


def precompile(dirname: str, n_slots: int = 4,
               max_time: Optional[int] = None,
               cache_dir: Optional[str] = None,
               place=None, draft_dirname: Optional[str] = None,
               speculate_k: int = 4, **overrides) -> Dict:
    """Resolve every compile signature of the artifact at ``dirname``
    into its persistent cache (default ``<dirname>/compiled/``).

    Loads the artifact through a throwaway ``ModelRegistry`` (so the
    engine-vs-generator manifest handling, weight placement, and cache
    mounting are EXACTLY what serving does), then:

    * generator artifacts: ``aot_warm(n_slots)`` — the unified
      prefill+decode step at the serving lane count;
    * engine artifacts: ``preresolve(max_time)`` — every enumerated
      batch/time bucket signature;
    * ``draft_dirname``: warm the pair as a
      ``SpeculativeGenerator`` — the target's k+1-token VERIFY
      step and COW page-copy land in the target artifact's
      ``compiled/``, the draft's masked decode step in the
      draft's, so a gateway loading the pair performs zero process
      compiles.

    The models run on the card unless ``place`` is ``CPUPlace``.
    Returns ``{"kind", "signatures", "compiles", "loads", "keys",
    "cache_dir", "bytes"}``; ``compiles`` on a second run over the same
    artifact is zero.
    """
    from ..serving.gateway.registry import (COMPILED_SUBDIR,
                                            ModelRegistry)

    dirname = os.path.abspath(dirname)
    if not os.path.isdir(dirname):
        raise FileNotFoundError(f"no artifact at {dirname}")
    reg = ModelRegistry(place=place)
    if draft_dirname is not None:
        if cache_dir is not None:
            raise ValueError(
                "precompile: --cache is incompatible with a draft — "
                "each artifact of the pair owns its compiled/ subdir")
        from ..serving.speculative import SpeculativeGenerator

        draft_dirname = os.path.abspath(draft_dirname)
        if not os.path.isdir(draft_dirname):
            raise FileNotFoundError(f"no draft artifact at "
                                    f"{draft_dirname}")
        for what, d in (("target", dirname), ("draft", draft_dirname)):
            kind = reg._manifest(d).get("kind", "engine")
            if kind != "generator":
                # fail with the artifact named, not an AttributeError
                # from deep inside SpeculativeGenerator
                raise ValueError(
                    f"speculative pre-warm needs generator artifacts; "
                    f"the {what} at {d} is kind {kind!r}")
        tkey = reg.load("aot", "prewarm", dirname=dirname, **overrides)
        # the mesh override shapes BOTH halves: a sharded target with a
        # replicated draft would warm executables the sharded gateway
        # pair never dispatches
        d_over = {k: v for k, v in overrides.items()
                  if k == "mesh_axes"}
        dkey = reg.load("aotdraft", "prewarm", dirname=draft_dirname,
                        **d_over)
        target, draft = reg.instance(tkey), reg.instance(dkey)
        spec = SpeculativeGenerator(target, draft, k=int(speculate_k))
        spec.aot_warm(int(n_slots))
        t_cache = os.path.join(dirname, COMPILED_SUBDIR)
        d_cache = os.path.join(draft_dirname, COMPILED_SUBDIR)
        st_t = target.exe.cache_stats()["persistent"]
        st_d = draft.exe.cache_stats()["persistent"]
        keys = []
        for c in (target.exe._aot_cache(), draft.exe._aot_cache()):
            if c is not None:
                keys.extend(c.keys())
        return {
            "kind": "speculative",
            "signatures": len(spec.bucket_set(int(n_slots))),
            "compiles": st_t["misses"] + st_d["misses"],
            "loads": st_t["hits"] + st_d["hits"],
            "stores": st_t["stores"] + st_d["stores"],
            "cache_dir": t_cache,
            "draft_cache_dir": d_cache,
            "keys": keys,
            "bytes": _dir_bytes(t_cache) + _dir_bytes(d_cache),
        }
    key = reg.load("aot", "prewarm", dirname=dirname, **overrides)
    inst = reg.instance(key)
    if cache_dir is not None:
        # redirect the instance's executor at an external cache dir
        # (the default is the artifact's own compiled/ subdir)
        from ..fluid.compile_cache import CompileCache

        inst.exe.set_compile_cache(CompileCache(cache_dir))
    else:
        cache_dir = os.path.join(dirname, COMPILED_SUBDIR)
    if callable(getattr(inst, "aot_warm", None)):
        kind = "generator"
        inst.aot_warm(int(n_slots))
        signatures = 1
    else:
        kind = "engine"
        signatures = inst.preresolve(max_time=max_time)
    st = inst.exe.cache_stats()["persistent"]
    cache = inst.exe._aot_cache()
    return {
        "kind": kind,
        "signatures": signatures,
        "compiles": st["misses"],
        "loads": st["hits"],
        "stores": st["stores"],
        "cache_dir": cache_dir,
        "keys": cache.keys() if cache is not None else [],
        "bytes": _dir_bytes(cache_dir),
    }


def _resolve_version_dir(root: str, model: str,
                         version: Optional[str]) -> Optional[str]:
    """``--root/--model[/--version]`` -> artifact dir: the explicit
    version, else the CURRENT marker, else the newest published
    version.  ``None`` (caller exits 2) when none exist."""
    from ..fluid import io as fio

    version = version or fio.current_model_version(root, model)
    if version is None:
        versions = fio.list_model_versions(root, model)
        if not versions:
            print(f"aot_compile: no versions of {model} under "
                  f"{root}", file=sys.stderr)
            return None
        version = versions[-1]
    return fio.model_version_dir(root, model, version)


def main(argv: Optional[List[str]] = None) -> int:
    from .. import fluid

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.aot_compile",
        description="Pre-compile a model version's closed bucket set "
                    "into its persistent compile cache.")
    ap.add_argument("--dirname", help="artifact directory (generator or "
                    "save_inference_model layout)")
    ap.add_argument("--root", help="model store root (versioned layout)")
    ap.add_argument("--model", help="model name under --root")
    ap.add_argument("--version", help="version under --root/--model "
                    "(default: the CURRENT marker, else newest)")
    ap.add_argument("--n-slots", type=int, default=4,
                    help="serving lane count to compile a generator at "
                         "(must match the gateway's n_slots; default 4)")
    ap.add_argument("--max-time", type=int, default=None,
                    help="time cap closing ragged engine feeds")
    ap.add_argument("--batch-bucket", type=int, action="append",
                    default=None, metavar="N",
                    help="override the engine's batch buckets "
                         "(repeatable; default: the artifact's own)")
    ap.add_argument("--time-bucket", type=int, default=None,
                    help="override the engine's time bucket")
    ap.add_argument("--cache", default=None, metavar="DIR",
                    help="external cache directory (default: the "
                         "artifact's compiled/ subdir)")
    ap.add_argument("--draft-dirname", default=None,
                    help="draft generator artifact to pair with the "
                         "target (speculative decoding): warms the "
                         "draft/verify/cow step set")
    ap.add_argument("--draft-model", default=None,
                    help="draft model name under --root")
    ap.add_argument("--draft-version", default=None,
                    help="draft version under --root/--draft-model "
                         "(default: CURRENT marker, else newest)")
    ap.add_argument("--speculate-k", type=int, default=4,
                    help="draft tokens per verify round (default 4; "
                         "must match the gateway's speculate_k)")
    ap.add_argument("--mesh", action="append", default=None,
                    metavar="AXIS=N",
                    help="mesh axis for a SHARDED generator pre-warm, "
                         "e.g. --mesh model=2 (repeatable; not ported: "
                         "the serving mesh is ROADMAP A15, exit 1)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--cpu", action="store_true",
                    help="resolve on the CPU (default: the card)")
    args = ap.parse_args(argv)

    if args.dirname:
        dirname = args.dirname
    elif args.root and args.model:
        dirname = _resolve_version_dir(args.root, args.model,
                                       args.version)
        if dirname is None:
            return 2
    else:
        ap.print_usage(file=sys.stderr)
        print("aot_compile: pass --dirname or --root + --model",
              file=sys.stderr)
        return 2

    draft_dirname = args.draft_dirname
    if draft_dirname is None and args.draft_model:
        if not args.root:
            print("aot_compile: --draft-model needs --root (or pass "
                  "--draft-dirname)", file=sys.stderr)
            return 2
        draft_dirname = _resolve_version_dir(args.root,
                                             args.draft_model,
                                             args.draft_version)
        if draft_dirname is None:
            return 2

    overrides = {}
    if args.batch_bucket:
        overrides["batch_buckets"] = tuple(args.batch_bucket)
    if args.time_bucket is not None:
        overrides["time_bucket"] = args.time_bucket
    if args.mesh:
        mesh_axes = {}
        for spec in args.mesh:
            ax, _, n = spec.partition("=")
            if not ax or not n.isdigit() or int(n) < 1:
                print(f"aot_compile: bad --mesh {spec!r} (want AXIS=N)",
                      file=sys.stderr)
                return 2
            mesh_axes[ax] = int(n)
        overrides["mesh_axes"] = mesh_axes
    try:
        report = precompile(dirname, n_slots=args.n_slots,
                            max_time=args.max_time,
                            cache_dir=args.cache,
                            draft_dirname=draft_dirname,
                            speculate_k=args.speculate_k,
                            place=fluid.CPUPlace() if args.cpu else None,
                            **overrides)
    except FileNotFoundError as e:
        print(f"aot_compile: {e}", file=sys.stderr)
        return 2
    except Exception as e:
        print(f"aot_compile: pre-compilation failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        print(f"aot_compile: {report['kind']} artifact, "
              f"{report['signatures']} signature(s): "
              f"{report['compiles']} compiled, {report['loads']} loaded "
              f"from cache, {len(report['keys'])} entr(ies) "
              f"({report['bytes']} bytes) at {report['cache_dir']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
