"""Diagnostic records, rule catalog, and the verification result type.

Every finding the verifier emits is a `Diagnostic` with a stable rule ID
from `RULES`, a severity, and provenance in the "{op_type}:{block}/
{op_idx}" format shared with FLAGS_op_trace_scopes — the verifier and
the profiler's op scopes name an op the same way. The catalog, the
severities and the messages are the JAX package's, word for word.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

ERROR = "error"
WARN = "warn"

# Rule catalog: id -> (default severity, one-line description). The IDs
# are stable — tools, tests, and suppression lists key on them; add new
# rules at the end of their band, never renumber. Full catalog with
# examples: docs/static_analysis.md.
RULES = {
    # registry band (00x)
    "PTV001": (ERROR, "op type has no registered lowering"),
    "PTV002": (ERROR, "saved op version newer than this build supports"),
    # dataflow band (01x)
    "PTV010": (ERROR, "op reads a var that is declared nowhere"),
    "PTV011": (ERROR, "op reads a var before any op produces it"),
    "PTV012": (WARN, "op unreachable from the fetch targets (dead)"),
    "PTV013": (WARN, "op output is never read, fetched, or persisted"),
    "PTV014": (WARN, "var overwritten before anything reads it"),
    "PTV015": (WARN, "inplace op aliases a var that a later op reads"),
    # spec band (02x)
    "PTV020": (ERROR, "inferred shape contradicts the declared shape"),
    "PTV021": (ERROR, "inferred dtype contradicts the declared dtype"),
    "PTV022": (ERROR, "abstract evaluation of the lowering failed"),
    # interface band (03x)
    "PTV030": (ERROR, "feed does not match a declared program input"),
    "PTV031": (ERROR, "fetch target is never materialised at top level"),
    # control-flow band (04x)
    "PTV040": (ERROR, "control-flow sub-block reference is inconsistent"),
    # memory band (05x) — the static memory planner (analysis/memory.py)
    "PTV050": (ERROR, "estimated peak HBM exceeds the memory budget"),
    "PTV051": (ERROR, "a single tensor alone exceeds the memory budget"),
    "PTV052": (WARN, "large dead buffers are eligible for reuse"),
    # sharding band (06x) — the static sharding analyzer
    # (analysis/sharding.py)
    "PTV060": (ERROR, "operands disagree on a mesh axis (layout-"
                      "inconsistent op)"),
    "PTV061": (WARN, "implicit reshard on a hot path (per-op resharded "
                     "bytes over threshold)"),
    "PTV062": (WARN, "non-divisible shard dim silently replicated"),
    "PTV063": (WARN, "op has no sharding propagation rule (conservative "
                     "replicate + reshard)"),
}


@dataclasses.dataclass
class Diagnostic:
    rule: str
    message: str
    severity: str = ""          # defaulted from RULES when empty
    op_type: Optional[str] = None
    block: int = 0
    op_idx: Optional[int] = None
    var: Optional[str] = None

    def __post_init__(self):
        if not self.severity:
            self.severity = RULES[self.rule][0]

    @property
    def where(self) -> str:
        """Provenance in the op-trace-scope format; program-level
        findings (feed/fetch checks) have no op to point at."""
        if self.op_type is None:
            return "program"
        idx = "?" if self.op_idx is None else self.op_idx
        return f"{self.op_type}:{self.block}/{idx}"

    def to_dict(self) -> dict:
        d = {"rule": self.rule, "severity": self.severity,
             "where": self.where, "message": self.message}
        if self.var:
            d["var"] = self.var
        return d

    def __str__(self):
        return f"{self.rule} [{self.severity}] at {self.where}: " \
               f"{self.message}"


class ProgramVerificationError(RuntimeError):
    """Raised by FLAGS_program_verify=error (and the memory gate) before
    the executor prepares a run."""

    def __init__(self, result: "VerifyResult"):
        self.result = result
        errs = result.errors()
        shown = "; ".join(str(d) for d in errs[:5])
        more = f" (+{len(errs) - 5} more)" if len(errs) > 5 else ""
        super().__init__(
            f"program verification failed with {len(errs)} error(s): "
            f"{shown}{more} — see docs/static_analysis.md; set "
            f"FLAGS_program_verify=warn|off to bypass")


class VerifyResult:
    """All findings from one `verify_program` call."""

    def __init__(self, findings: Optional[List[Diagnostic]] = None):
        self.findings: List[Diagnostic] = list(findings or [])

    def add(self, rule, message, **kw):
        self.findings.append(Diagnostic(rule, message, **kw))

    def extend(self, other: "VerifyResult"):
        self.findings.extend(other.findings)

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.findings if d.severity == ERROR]

    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.findings if d.severity == WARN]

    def by_rule(self, rule: str) -> List[Diagnostic]:
        return [d for d in self.findings if d.rule == rule]

    @property
    def ok(self) -> bool:
        """True when no error-severity findings (warnings allowed)."""
        return not self.errors()

    def raise_if_errors(self):
        if not self.ok:
            raise ProgramVerificationError(self)

    def summary(self) -> str:
        e, w = self.errors(), self.warnings()
        if not self.findings:
            return "program verification: clean"
        shown = "; ".join(str(d) for d in (e + w)[:3])
        more = len(self.findings) - min(3, len(self.findings))
        tail = f" (+{more} more)" if more else ""
        return (f"program verification: {len(e)} error(s), "
                f"{len(w)} warning(s): {shown}{tail}")

    def to_dict(self) -> dict:
        return {"ok": self.ok,
                "counts": {"error": len(self.errors()),
                           "warn": len(self.warnings())},
                "findings": [d.to_dict() for d in self.findings]}

    def __repr__(self):
        return (f"VerifyResult({len(self.errors())} errors, "
                f"{len(self.warnings())} warnings)")
