"""Finding model + JSON/SARIF emission + baseline suppression (a copy of
``repro/analysis/findings.py``, DESIGN.md §10).

A ``Finding`` is one rule violation at one location.  The three analyzer
layers (``astlint``, ``launch_audit``, ``wire_checks``) all report through
this type so the CLI can merge, suppress, and serialize them uniformly.

Suppression has two mechanisms:

  * inline pragma — ``# repro-lint: allow=<rule>[,<rule>...]`` on the
    flagged line (or on the ``def`` line to cover a whole function for
    astlint rules).  For invariants that are *deliberate*, with the
    justification living next to the code.
  * baseline file — committed JSON (the port's is
    ``src/repro_torch/analysis/baseline.json``) listing
    ``{"rule": ..., "path": ..., "reason": ...}`` entries; matches every
    finding of that rule in that file.  For grandfathered findings that
    should not fail CI but are not endorsed in-code.

Severities: ``error`` (contract violation — fails ``--ci``), ``warning``
(likely bug — fails ``--ci``), ``info`` (advisory — never fails).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Sequence

SEVERITIES = ("error", "warning", "info")

# SARIF severity mapping (SARIF has no "info"/"note" distinction we need)
_SARIF_LEVEL = {"error": "error", "warning": "warning", "info": "note"}


@dataclasses.dataclass
class Finding:
    rule: str                   # rule id, kebab-case (see astlint.RULES etc.)
    severity: str               # 'error' | 'warning' | 'info'
    path: str                   # repo-relative path ('' for repo-level rules)
    line: int                   # 1-based; 0 when not tied to a line
    message: str
    suppressed: bool = False    # set by apply_baseline / inline pragma
    suppressed_by: str = ""     # 'pragma' | 'baseline'

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in {SEVERITIES}")

    def key(self) -> str:
        return f"{self.path}:{self.line}:{self.rule}"

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.path else "<repo>"
        sup = f" [suppressed:{self.suppressed_by}]" if self.suppressed else ""
        return f"{loc}: {self.severity}: {self.rule}: {self.message}{sup}"


def active(findings: Iterable[Finding]) -> List[Finding]:
    """Findings that should fail --ci: unsuppressed errors and warnings."""
    return [f for f in findings
            if not f.suppressed and f.severity in ("error", "warning")]


# ---------------------------------------------------------------------------
# baseline / suppression file
# ---------------------------------------------------------------------------

def load_baseline(path: Optional[str]) -> List[Dict]:
    if path is None:
        return []
    try:
        with open(path) as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return []
    entries = data.get("suppressions", [])
    for e in entries:
        if "rule" not in e:
            raise ValueError(f"baseline entry missing 'rule': {e}")
    return entries


def apply_baseline(findings: Sequence[Finding],
                   entries: Sequence[Dict]) -> List[Finding]:
    """Mark findings matched by a baseline entry as suppressed (in place).

    An entry matches on ``rule`` plus, when present, ``path`` (exact
    repo-relative match) and ``line``.  Line-less entries survive edits that
    move code around; line-pinned entries are for one of several findings of
    the same rule in one file.
    """
    for f in findings:
        if f.suppressed:
            continue
        for e in entries:
            if e["rule"] != f.rule:
                continue
            if "path" in e and e["path"] != f.path:
                continue
            if "line" in e and int(e["line"]) != f.line:
                continue
            f.suppressed = True
            f.suppressed_by = "baseline"
            break
    return list(findings)


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------

def to_json(findings: Sequence[Finding]) -> str:
    payload = {
        "version": 1,
        "findings": [dataclasses.asdict(f) for f in findings],
        "counts": {
            "total": len(findings),
            "active": len(active(findings)),
            "suppressed": sum(1 for f in findings if f.suppressed),
        },
    }
    return json.dumps(payload, indent=2, sort_keys=True)


def to_sarif(findings: Sequence[Finding], *,
             tool_name: str = "repro_torch.analysis") -> str:
    """Minimal SARIF 2.1.0 document (one run, one result per finding)."""
    rules = sorted({f.rule for f in findings})
    results = []
    for f in findings:
        res = {
            "ruleId": f.rule,
            "level": _SARIF_LEVEL[f.severity],
            "message": {"text": f.message},
        }
        if f.path:
            res["locations"] = [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": max(f.line, 1)},
                },
            }]
        if f.suppressed:
            res["suppressions"] = [{
                "kind": "external" if f.suppressed_by == "baseline"
                else "inSource",
            }]
        results.append(res)
    doc = {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                    "master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": tool_name,
                "rules": [{"id": r} for r in rules],
            }},
            "results": results,
        }],
    }
    return json.dumps(doc, indent=2, sort_keys=True)
