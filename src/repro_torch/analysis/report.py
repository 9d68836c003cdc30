"""Typed findings core for the static analysis layer (``repro/analysis/
report.py``).

Every rule in :mod:`repro_torch.analysis.trace_lint` and
:mod:`repro_torch.analysis.ast_lint` emits :class:`Finding` records into an
:class:`AnalysisReport`; ``python -m repro_torch.analysis`` renders the
report as JSON or markdown and gates on ``report.ok(strict=True)`` (zero
error-severity findings).  Framework-neutral: nothing here imports torch.

Severity levels (most to least severe):

  * ``error``   -- a broken contract; fails the ``--strict`` gate.
  * ``warning`` -- a likely hazard that needs a human look.
  * ``info``    -- a contract that could not be proven either way
    (e.g. donation declared but no output can alias the buffer).

Suppressions are source pragmas consumed by the AST front end --
``# analysis: allow(rule-id)`` on (or one line above) the offending
line, ``# analysis: allow-file(rule-id)`` anywhere in the file -- the
rule catalog is the docstring of :mod:`repro_torch.analysis`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

SEVERITIES: Tuple[str, ...] = ("error", "warning", "info")


@dataclass(frozen=True)
class Finding:
    """One verified contract violation (or unprovable contract).

    ``rule`` is the stable rule id (the catalog in
    :mod:`repro_torch.analysis`),
    ``where`` locates it (``path:line`` for source findings, a plan
    cell label like ``plan[backend=cuda,dtype=bf16,...]`` for traced
    findings), ``message`` states the defect in one line and
    ``detail`` carries the evidence (extracted vs expected bytes,
    the offending source line, ...).
    """

    rule: str
    severity: str
    where: str
    message: str
    detail: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}; "
                             f"expected one of {SEVERITIES}")

    def to_dict(self) -> Dict[str, str]:
        return {"rule": self.rule, "severity": self.severity,
                "where": self.where, "message": self.message,
                "detail": self.detail}

    def render(self) -> str:
        tail = f"  [{self.detail}]" if self.detail else ""
        return (f"{self.severity.upper():7s} {self.rule:18s} "
                f"{self.where}: {self.message}{tail}")


@dataclass
class AnalysisReport:
    """An ordered collection of :class:`Finding` records.

    Reports merge (``merge``), filter (``errors`` / ``by_rule``), and
    render (``to_json`` / ``to_markdown``); the CI gate is
    ``ok(strict=True)`` -- True only with zero error-severity findings.
    """

    findings: List[Finding] = field(default_factory=list)

    def add(self, rule: str, severity: str, where: str, message: str,
            detail: str = "") -> None:
        """Append one finding (validates the severity level)."""
        self.findings.append(Finding(rule, severity, where, message, detail))

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def merge(self, other: "AnalysisReport") -> "AnalysisReport":
        """Fold another report's findings into this one (returns self)."""
        self.findings.extend(other.findings)
        return self

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    def counts(self) -> Dict[str, int]:
        """Severity -> number of findings (all severities present)."""
        out = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            out[f.severity] += 1
        return out

    def by_rule(self) -> Dict[str, List[Finding]]:
        out: Dict[str, List[Finding]] = {}
        for f in self.findings:
            out.setdefault(f.rule, []).append(f)
        return out

    def ok(self, strict: bool = True) -> bool:
        """Gate predicate: strict=True fails on any error finding,
        strict=False additionally fails on warnings."""
        if strict:
            return not self.errors
        return not self.errors and not self.warnings

    def to_json(self, indent: int = 2) -> str:
        """Render as a stable JSON document (counts + findings)."""
        return json.dumps({"counts": self.counts(),
                           "findings": [f.to_dict() for f in self.findings]},
                          indent=indent)

    def to_markdown(self) -> str:
        """Render as a markdown table grouped by rule, worst first."""
        lines = ["# Static analysis report", ""]
        c = self.counts()
        lines.append(f"{c['error']} error(s), {c['warning']} warning(s), "
                     f"{c['info']} info.")
        if not self.findings:
            lines.append("")
            lines.append("No findings.")
            return "\n".join(lines)
        lines += ["", "| severity | rule | where | message |",
                  "|---|---|---|---|"]
        order = {s: i for i, s in enumerate(SEVERITIES)}
        for f in sorted(self.findings,
                        key=lambda f: (order[f.severity], f.rule, f.where)):
            msg = f.message.replace("|", "\\|")
            lines.append(f"| {f.severity} | {f.rule} | {f.where} | {msg} |")
        return "\n".join(lines)

    def render(self) -> str:
        return "\n".join(f.render() for f in self.findings)
