"""Diagnostics: the shared report type every analysis pass emits into —
the port's copy of ``paddle_tpu/fluid/analysis/diagnostics.py``.

The reference surfaces program defects as C++ exceptions thrown one at a
time from ``OpDesc::CheckAttrs`` / ``InferShape`` / the executor's
var-existence walk (executor.cc:36-75) — first error wins, no coordinates
beyond the op type.  Because our program is *data* (core/desc.py), a pass
can instead walk the whole ProgramDesc and report every finding at once,
each carrying exact coordinates (``block/op#/slot``) and a severity, the
way a compiler reports diagnostics.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

__all__ = ["ERROR", "WARNING", "INFO", "SEVERITIES", "Finding",
           "Diagnostics"]

# severity vocabulary, strongest first
ERROR = "error"
WARNING = "warning"
INFO = "info"
SEVERITIES = (ERROR, WARNING, INFO)


class Finding:
    """One defect (or observation) found by one pass, with coordinates.

    ``block``/``op`` are indices into the ProgramDesc (``op`` is None for
    block- or program-level findings); ``slot`` names the input/output slot
    involved and ``var`` the variable, when one is.  ``legacy()`` renders
    the flat string the reference's validators return for the same
    defect, so the two packages' findings compare as strings too.
    """

    __slots__ = ("severity", "pass_name", "code", "message", "block", "op",
                 "op_type", "slot", "var")

    def __init__(self, severity: str, pass_name: str, code: str,
                 message: str, block: Optional[int] = None,
                 op: Optional[int] = None, op_type: Optional[str] = None,
                 slot: Optional[str] = None, var: Optional[str] = None):
        assert severity in SEVERITIES, severity
        self.severity = severity
        self.pass_name = pass_name
        self.code = code
        self.message = message
        self.block = block
        self.op = op
        self.op_type = op_type
        self.slot = slot
        self.var = var

    @property
    def where(self) -> str:
        """Coordinate prefix — ``block B op#I (type)`` like the reference's
        validator / executor messages, degrading gracefully."""
        if self.block is None:
            return ""
        if self.op is None:
            return f"block {self.block}"
        return f"block {self.block} op#{self.op} ({self.op_type})"

    def legacy(self) -> str:
        """The flat error-string form the reference's
        ``validate_program`` returns."""
        w = self.where
        return f"{w}: {self.message}" if w else self.message

    def render(self) -> str:
        w = self.where
        loc = f" @ {w}" if w else ""
        slot = f" slot={self.slot}" if self.slot else ""
        var = f" var={self.var!r}" if self.var else ""
        return (f"[{self.severity}] {self.pass_name}/{self.code}{loc}"
                f"{slot}{var}: {self.message}")

    def to_dict(self) -> Dict[str, Any]:
        return {"severity": self.severity, "pass": self.pass_name,
                "code": self.code, "message": self.message,
                "block": self.block, "op": self.op, "op_type": self.op_type,
                "slot": self.slot, "var": self.var}

    def __repr__(self):
        return f"Finding({self.render()})"


class Diagnostics:
    """An ordered collection of Findings with severity accessors — the one
    report type shared by every pass and every consumer (Program.analyze,
    the executor pre-flight, plint)."""

    def __init__(self, findings: Optional[Iterable[Finding]] = None):
        self.findings: List[Finding] = list(findings or ())
        # structured pass outputs (cost/recompile/comms reports): data
        # too rich for a Finding message — {pass_name: dict}
        self.reports: Dict[str, Any] = {}

    def add(self, finding: Finding) -> Finding:
        self.findings.append(finding)
        return finding

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    def infos(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == INFO]

    @property
    def has_errors(self) -> bool:
        return any(f.severity == ERROR for f in self.findings)

    def by_pass(self, pass_name: str) -> List[Finding]:
        return [f for f in self.findings if f.pass_name == pass_name]

    def by_code(self, code: str) -> List[Finding]:
        return [f for f in self.findings if f.code == code]

    def render(self, max_findings: Optional[int] = None,
               min_severity: str = INFO) -> str:
        """Human-readable report, errors first."""
        keep = SEVERITIES[: SEVERITIES.index(min_severity) + 1]
        ordered = [f for sev in SEVERITIES for f in self.findings
                   if f.severity == sev and sev in keep]
        shown = ordered if max_findings is None else ordered[:max_findings]
        lines = [f.render() for f in shown]
        if max_findings is not None and len(ordered) > max_findings:
            lines.append(f"... and {len(ordered) - max_findings} more")
        counts = (f"{len(self.errors())} error(s), "
                  f"{len(self.warnings())} warning(s), "
                  f"{len(self.infos())} info")
        return "\n".join(lines + [counts]) if lines else counts

    def to_dict(self) -> Dict[str, Any]:
        out = {"findings": [f.to_dict() for f in self.findings],
               "counts": {"error": len(self.errors()),
                          "warning": len(self.warnings()),
                          "info": len(self.infos())}}
        if self.reports:
            out["reports"] = dict(self.reports)
        return out

    def __iter__(self):
        return iter(self.findings)

    def __len__(self):
        return len(self.findings)

    def __repr__(self):
        return (f"Diagnostics(errors={len(self.errors())}, "
                f"warnings={len(self.warnings())}, "
                f"infos={len(self.infos())})")
