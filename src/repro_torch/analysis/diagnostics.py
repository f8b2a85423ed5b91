"""Structured diagnostics for the port's contract checks (the port's own
copy of ``repro/analysis/diagnostics.py``).

Every checker emits :class:`Diagnostic` records instead of printing or
raising: a frozen (checker, code, severity, message, target, context)
tuple.  ``code`` is the stable machine name (``comm.factor-payload``,
``dtype.f64-promotion``, ...) that tests and CI key on; ``message``
is the human explanation.  A :class:`Report` aggregates diagnostics
across checkers/targets and maps to a process exit code: 1 iff any
ERROR-level diagnostic, 0 otherwise (WARNINGs never fail the gate —
e.g. phase-step factor bytes over their budget are merely reported).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional


class Severity:
    ERROR = "ERROR"
    WARNING = "WARNING"
    INFO = "INFO"


_ORDER = {Severity.ERROR: 0, Severity.WARNING: 1, Severity.INFO: 2}


@dataclass(frozen=True)
class Diagnostic:
    checker: str                 # e.g. "comm-linearity"
    code: str                    # stable machine name, dotted
    severity: str                # Severity.*
    message: str                 # human-readable explanation
    target: str = ""             # lint target name ("bert-large/dist", ...)
    context: Mapping[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"checker": self.checker, "code": self.code,
                "severity": self.severity, "message": self.message,
                "target": self.target, "context": dict(self.context)}

    def render(self) -> str:
        loc = f" [{self.target}]" if self.target else ""
        return f"{self.severity:7s} {self.code}{loc}: {self.message}"


@dataclass
class Report:
    diagnostics: List[Diagnostic] = field(default_factory=list)

    def add(self, diag: Diagnostic) -> None:
        self.diagnostics.append(diag)

    def extend(self, diags) -> None:
        self.diagnostics.extend(diags)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity == Severity.ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity == Severity.WARNING]

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def exit_code(self) -> int:
        return 1 if self.errors else 0

    def render(self) -> str:
        lines = [d.render() for d in sorted(
            self.diagnostics,
            key=lambda d: (_ORDER.get(d.severity, 9), d.checker, d.code))]
        lines.append(f"mkor-lint: {len(self.errors)} error(s), "
                     f"{len(self.warnings)} warning(s), "
                     f"{len(self.diagnostics)} diagnostic(s) total")
        return "\n".join(lines)

    def to_json(self, path: Optional[str] = None) -> str:
        payload = json.dumps(
            {"diagnostics": [d.to_dict() for d in self.diagnostics],
             "n_errors": len(self.errors),
             "n_warnings": len(self.warnings),
             "exit_code": self.exit_code()},
            indent=2, default=str)
        if path:
            with open(path, "w") as f:
                f.write(payload + "\n")
        return payload
