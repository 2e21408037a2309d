"""Certificate: the serializable verdict of a static-analysis pass.

Counterpart of ``repro/analyze/certificate.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_plan.py``
holds the two equal.

One ``Certificate`` summarizes a full verification run: every invariant the
verifier knows about appears in ``checks`` (pass/fail + how many subjects it
swept + capped counterexamples), so a consumer can distinguish "proved" from
"not applicable" — an invariant with zero subjects passed vacuously and says
so.  ``plan.artifact`` embeds the dict form in plan artifacts (outside the
canonical plan-identity bytes, like ``solve_ms``) and re-derives it on every
cache load; the mutation self-tests assert *which* invariant a hazard kills.
"""

from __future__ import annotations

from dataclasses import dataclass, field

CERTIFICATE_VERSION = 1

# Counterexamples kept per invariant: enough to localize the hazard without
# bloating artifacts when a mutation breaks every placement at once.
MAX_VIOLATIONS = 8


@dataclass(frozen=True)
class Violation:
    """One counterexample: which invariant broke, where, and the op/var
    indices that witness it."""

    invariant: str
    subject: str                       # e.g. "pool:best_fit", "swap:swdoa@123"
    message: str
    ops: tuple[int, ...] = ()          # op indices of the counterexample
    vars: tuple[int, ...] = ()         # variable ids involved

    def to_dict(self) -> dict:
        return {
            "invariant": self.invariant,
            "subject": self.subject,
            "message": self.message,
            "ops": list(self.ops),
            "vars": list(self.vars),
        }


@dataclass
class Certificate:
    """Per-invariant pass/fail over one verification sweep."""

    version: int = CERTIFICATE_VERSION
    # invariant name -> {"ok": bool, "subjects": int, "violations": [...]}
    checks: dict[str, dict] = field(default_factory=dict)
    notes: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(c["ok"] for c in self.checks.values())

    def failed(self) -> list[str]:
        """Names of the invariants that did not hold, sorted."""
        return sorted(n for n, c in self.checks.items() if not c["ok"])

    def add(self, invariant: str, subjects: int, violations: list[Violation]) -> None:
        """Record one invariant's sweep.  Repeated calls for the same
        invariant (one per subject) accumulate."""
        entry = self.checks.setdefault(
            invariant, {"ok": True, "subjects": 0, "violations": []}
        )
        entry["subjects"] += subjects
        for v in violations:
            entry["ok"] = False
            if len(entry["violations"]) < MAX_VIOLATIONS:
                entry["violations"].append(v.to_dict())

    def note(self, msg: str) -> None:
        self.notes.append(msg)

    def violations(self) -> list[dict]:
        out = []
        for name in sorted(self.checks):
            out.extend(self.checks[name]["violations"])
        return out

    # ------------------------------------------------------------- serde
    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "ok": self.ok,
            "checks": {
                n: {
                    "ok": c["ok"],
                    "subjects": c["subjects"],
                    "violations": list(c["violations"]),
                }
                for n, c in sorted(self.checks.items())
            },
            "notes": list(self.notes),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Certificate":
        cert = cls(version=d.get("version", CERTIFICATE_VERSION))
        for n, c in d.get("checks", {}).items():
            cert.checks[n] = {
                "ok": bool(c.get("ok", False)),
                "subjects": int(c.get("subjects", 0)),
                "violations": list(c.get("violations", ())),
            }
        cert.notes = list(d.get("notes", ()))
        return cert

    # ------------------------------------------------------------ display
    def summary_lines(self) -> list[str]:
        lines = []
        for name in sorted(self.checks):
            c = self.checks[name]
            mark = "ok  " if c["ok"] else "FAIL"
            line = f"{mark} {name}: {c['subjects']} subject(s)"
            if not c["ok"]:
                first = c["violations"][0]
                line += f" — {first['message']}"
            lines.append(line)
        lines.extend(f"note {n}" for n in self.notes)
        return lines
