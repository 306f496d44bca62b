"""paddle_tpu_torch.fluid.analysis — the port of
``paddle_tpu.fluid.analysis``: a pass-based static analyzer over
ProgramDesc.

Because the program is *data* (core/desc.py), whole-program verification
is a walk over plain Python objects: compiler-style passes over the
whole desc report every finding at once with exact coordinates.

Entry points:

* ``analyze_program(program, level=..., fetch=...)`` → ``Diagnostics``
  (also surfaced as ``Program.analyze``);
* ``Executor.run(..., validate="off|structural|full|cost")`` pre-flight
  (or ``PADDLE_TPU_VALIDATE=<level>``), fingerprint-cached per program;
* ``python -m paddle_tpu_torch.tools.plint program.json`` for serialized
  programs (the ones most likely to be malformed).

Levels: ``"structural"`` runs the desc-only passes (structural, dataflow,
grad_link, sharding); ``"full"`` adds the abstract shape/dtype re-check,
which runs every registered emitter on ``meta`` tensors; ``"cost"`` runs
the structural passes plus the static cost family — the liveness-based
peak-HBM planner + roofline op cost model (cost.py, priced at the card's
``ChipSpec``), the recompile-hazard lint with closed bucket-set
enumeration (recompile.py), and the sharded-collective estimator
(comms.py).  Cost-family passes attach structured data to
``Diagnostics.reports`` alongside their findings.  The reference's
``"shard"`` level (whole-program sharding propagation, its
``shardprop.py``) is not ported: it raises (ROADMAP A15).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .comms import estimate_comms
from .cost import (CHIP_SPECS, ChipSpec, OpCost, cost_rule, get_chip,
                   plan_program, roofline)
from .dataflow import ProgramView, block_liveness, live_ops
from .diagnostics import ERROR, INFO, WARNING, Diagnostics, Finding
from .passes import PASSES, AnalysisContext
from .recompile import enumerate_buckets, feed_vars

__all__ = ["Diagnostics", "Finding", "ERROR", "WARNING", "INFO",
           "ProgramView", "block_liveness", "live_ops",
           "LEVELS", "analyze_program", "structural_errors",
           "ProgramValidationError", "ChipSpec", "CHIP_SPECS",
           "get_chip", "OpCost", "cost_rule", "plan_program",
           "roofline", "estimate_comms", "enumerate_buckets", "feed_vars"]

LEVELS = {
    "structural": ("structural", "dataflow", "grad_link", "sharding"),
    "full": ("structural", "dataflow", "grad_link", "sharding",
             "shape_check"),
    "cost": ("structural", "dataflow", "grad_link", "sharding",
             "cost", "recompile", "comms"),
}


class ProgramValidationError(RuntimeError):
    """Raised by the executor pre-flight when a program has error-severity
    findings; carries the full Diagnostics for programmatic access."""

    def __init__(self, diagnostics: Diagnostics, context: str = ""):
        self.diagnostics = diagnostics
        head = (f"program failed static analysis"
                f"{' (' + context + ')' if context else ''}:")
        super().__init__(head + "\n" + diagnostics.render(max_findings=20))


def _desc_of(program):
    return getattr(program, "desc", program)


def _fetch_names(fetch) -> List[str]:
    out = []
    for f in fetch or ():
        name = getattr(f, "name", None)
        out.append(name if isinstance(name, str) else str(f))
    return out


def check_level(level: str) -> None:
    """Raise unless ``level`` is one of ``LEVELS``; the reference's
    ``"shard"`` level raises ``NotImplementedError`` naming what is
    missing."""
    if level == "shard":
        raise NotImplementedError(
            "analysis level 'shard' (whole-program sharding propagation, "
            "the reference's fluid/analysis/shardprop.py) is not ported "
            "to paddle_tpu_torch (ROADMAP A15)")
    if level not in LEVELS:
        raise ValueError(f"analyze_program: level must be one of "
                         f"{sorted(LEVELS)}, got {level!r}")


def analyze_program(program, level: str = "full",
                    fetch: Optional[Sequence] = None,
                    passes: Optional[Sequence[str]] = None,
                    options: Optional[dict] = None) -> Diagnostics:
    """Run the pass suite over ``program`` (a Program, ProgramDesc, or
    anything with a ``.desc``).

    ``fetch`` (var names or Variables) seeds the liveness roots — pass the
    values you intend to read so dead-code findings reflect real intent.
    ``passes`` overrides the level's pass selection by name.
    ``options`` feeds the cost-family passes (assume_batch, chip,
    budget_bytes, batch_buckets/time_buckets, mesh_axes, dcn_axes).
    """
    check_level(level)
    selected = tuple(passes) if passes is not None else LEVELS[level]
    unknown = set(selected) - {name for name, _ in PASSES}
    if unknown:
        raise ValueError(f"analyze_program: unknown passes {sorted(unknown)}")
    ctx = AnalysisContext(_desc_of(program), fetch=_fetch_names(fetch),
                          fetch_given=fetch is not None, options=options)
    diag = Diagnostics()
    for name, fn in PASSES:
        if name in selected:
            fn(ctx, diag)
    return diag


def structural_errors(program) -> List[str]:
    """Flat-string form of the structural pass (``Finding.legacy()``),
    the reference's ``validate_program`` strings."""
    diag = analyze_program(program, passes=("structural",),
                           level="structural")
    return [f.legacy() for f in diag.errors()]
