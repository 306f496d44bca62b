"""plint — static analysis of serialized ProgramDesc files; the port of
``paddle_tpu/tools/plint.py``, with the same flags, output and exit
codes.

::

    python -m paddle_tpu_torch.tools.plint model/__model__.json
    python -m paddle_tpu_torch.tools.plint prog.json --level structural
    python -m paddle_tpu_torch.tools.plint prog.json --fetch mean_0.tmp_0 --json
    python -m paddle_tpu_torch.tools.plint prog.json --cost --budget 16000000000
    python -m paddle_tpu_torch.tools.plint prog.json --cost --batch-bucket 8 \
        --fail-on unregistered-cost-rule --fail-on value-shape-op

Programs that arrive via serialization (save_inference_model output,
checkpoints, transpiled programs shipped between processes) are exactly
the ones no build-time check ever saw — plint runs the analyzer suite
(fluid/analysis) over the canonical-JSON wire format and reports every
finding with block/op coordinates.  ``--cost`` switches to the static
cost family (peak-HBM planner, roofline estimate, recompile-hazard
lint + bucket enumeration, sharded-comms tally); ``--budget BYTES``
turns "static peak exceeds budget" into an error-severity finding, so
the exit status doubles as an admission gate.  The roofline prices the
card (``--chip h100``, the default).  ``--shard`` (the reference's
whole-program sharding propagation) is not ported: it exits 2, naming
ROADMAP A15.

Exit status: 0 = no error-severity findings (and no ``--fail-on``
matches), 1 = errors (or matches) found, 2 = could not read/parse the
input, or an analysis the port does not have.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _load_program(path: str):
    from paddle_tpu_torch.fluid.framework import Program

    with open(path, "rb") as f:
        data = f.read()
    return Program.parse_from_string(data)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.plint",
        description="Static analyzer / linter for serialized ProgramDesc "
                    "JSON (see paddle_tpu_torch/fluid/analysis).")
    ap.add_argument("program", help="path to a serialized program "
                    "(canonical JSON, as written by "
                    "ProgramDesc.serialize_to_string / save_inference_model)")
    ap.add_argument("--level",
                    choices=("structural", "full", "cost", "shard"),
                    default="full",
                    help="structural = desc-only passes; full adds the "
                         "abstract shape/dtype re-check (default); cost "
                         "runs the static cost family instead; shard "
                         "(SPMD sharding inference) is not ported: exit 2")
    ap.add_argument("--cost", action="store_true",
                    help="shorthand for --level cost")
    ap.add_argument("--shard", action="store_true",
                    help="shorthand for --level shard (not ported: "
                    "exit 2, ROADMAP A15)")
    ap.add_argument("--replicated-giant-bytes", type=int, default=None,
                    metavar="BYTES",
                    help="threshold for shard/replicated-giant: a "
                    "persistable this large left fully replicated on "
                    "the model axis is an error (default 256 MiB)")
    ap.add_argument("--fetch", action="append", default=None,
                    metavar="VAR", help="var name you intend to fetch "
                    "(liveness root for dead-code findings; repeatable)")
    ap.add_argument("--budget", type=int, default=None, metavar="BYTES",
                    help="HBM budget: the statically planned peak "
                    "exceeding it is an error (exit 1)")
    ap.add_argument("--chip", default=None,
                    help="chip spec for the roofline/comms estimate "
                    "(h100; default: detected or h100)")
    ap.add_argument("--assume-batch", type=int, default=1, metavar="N",
                    help="substitute N for dynamic batch dims in the "
                    "byte/flop accounting (default 1)")
    ap.add_argument("--batch-bucket", action="append", type=int,
                    default=None, metavar="N",
                    help="declared batch bucket for the bucket-set "
                    "enumeration (repeatable)")
    ap.add_argument("--time-bucket", action="append", type=int,
                    default=None, metavar="N",
                    help="declared time bucket for ragged feeds "
                    "(repeatable)")
    ap.add_argument("--mesh-axis", action="append", default=None,
                    metavar="AXIS=N", help="mesh axis extent for the "
                    "comms estimate, e.g. --mesh-axis dp=8 (repeatable)")
    ap.add_argument("--dcn-axis", action="append", default=None,
                    metavar="AXIS", help="mesh axis that crosses hosts "
                    "(priced at DCN bandwidth; repeatable)")
    ap.add_argument("--fail-on", action="append", default=None,
                    metavar="CODE", help="exit 1 if any finding carries "
                    "this code, regardless of severity (repeatable) — "
                    "e.g. unregistered-cost-rule, value-shape-op")
    ap.add_argument("--json", action="store_true",
                    help="emit the findings as JSON instead of text")
    ap.add_argument("--max-findings", type=int, default=None,
                    help="cap the number of findings printed (text mode)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress info-severity findings (text mode)")
    args = ap.parse_args(argv)

    try:
        program = _load_program(args.program)
    except Exception as e:
        # any load failure (missing file, bad JSON, schema-invalid desc
        # raising TypeError/KeyError deep in from_dict) is rc=2, reserving
        # rc=1 strictly for error-severity findings
        print(f"plint: cannot load {args.program!r}: {e}", file=sys.stderr)
        return 2

    level = "cost" if args.cost else \
        ("shard" if args.shard else args.level)
    options = {"assume_batch": args.assume_batch}
    if args.replicated_giant_bytes is not None:
        options["replicated_giant_bytes"] = args.replicated_giant_bytes
    if args.budget is not None:
        options["budget_bytes"] = args.budget
    if args.chip:
        options["chip"] = args.chip
    if args.batch_bucket:
        options["batch_buckets"] = tuple(args.batch_bucket)
    if args.time_bucket:
        options["time_buckets"] = tuple(args.time_bucket)
    if args.dcn_axis:
        options["dcn_axes"] = tuple(args.dcn_axis)
    if args.mesh_axis:
        axes = {}
        for spec in args.mesh_axis:
            name, _, size = spec.partition("=")
            if not size:
                print(f"plint: --mesh-axis wants AXIS=N, got {spec!r}",
                      file=sys.stderr)
                return 2
            axes[name] = int(size)
        options["mesh_axes"] = axes

    try:
        diag = program.analyze(level=level, fetch_list=args.fetch,
                               options=options)
    except NotImplementedError as e:     # the "shard" level (ROADMAP A15)
        print(f"plint: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(diag.to_dict(), indent=2, sort_keys=True))
    else:
        print(diag.render(max_findings=args.max_findings,
                          min_severity="warning" if args.quiet else "info"))
    failed = diag.has_errors
    for code in (args.fail_on or ()):
        hits = diag.by_code(code)
        if hits:
            failed = True
            print(f"plint: --fail-on {code}: {len(hits)} finding(s)",
                  file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
