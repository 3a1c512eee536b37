"""Diagnostic types of the Program-IR verifier (counterpart of
``paddle_tpu/analysis/diagnostics.py``, same classes, location format
and rendering).

A :class:`Diagnostic` pins one finding to a (block, op, var) location
with a stable ``PTxxx`` code, so that tooling (the ``lint`` verb, the
Executor's verify hook, the tests) matches on codes instead of message
text. Every code of the port uses it: the program rules PT001-PT017,
the memory planner's PT030-PT033 and the KV-pool check PT034.
"""
from __future__ import annotations

from typing import List, Sequence

__all__ = ["Diagnostic", "ProgramVerifyError", "Severity",
           "render_diagnostics"]


class Severity(object):
    """Ordered severities; ERROR is the only level that fails a verify."""

    ERROR = "error"
    WARNING = "warning"
    INFO = "info"

    _ORDER = {ERROR: 2, WARNING: 1, INFO: 0}

    @classmethod
    def rank(cls, sev) -> int:
        return cls._ORDER.get(sev, 0)


class Diagnostic(object):
    """One finding: code, severity, location, message and fix hint."""

    __slots__ = ("code", "severity", "message", "block_idx", "op_idx",
                 "var", "hint")

    def __init__(self, code, severity, message, block_idx=None, op_idx=None,
                 var=None, hint=None):
        self.code = code
        self.severity = severity
        self.message = message
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.var = var
        self.hint = hint

    @property
    def is_error(self) -> bool:
        return self.severity == Severity.ERROR

    def location(self) -> str:
        """``block0:op3`` (and the var), the one format every rule's
        findings print."""
        parts = []
        if self.block_idx is not None and self.op_idx is not None:
            parts.append("block%d:op%d" % (self.block_idx, self.op_idx))
        elif self.block_idx is not None:
            parts.append("block%d" % self.block_idx)
        elif self.op_idx is not None:
            parts.append("op%d" % self.op_idx)
        if self.var:
            parts.append("var %r" % self.var)
        return " ".join(parts)

    def __str__(self):
        loc = self.location()
        s = "%s %s%s: %s" % (self.code, self.severity,
                             (" [%s]" % loc) if loc else "", self.message)
        if self.hint:
            s += " (hint: %s)" % self.hint
        return s

    def __repr__(self):
        return "Diagnostic(%s)" % self


def render_diagnostics(diags: Sequence[Diagnostic], label=None) -> str:
    """Human-readable report: one line per diagnostic, errors first, and
    a severity tally."""
    if not diags:
        return ""
    ordered = sorted(diags, key=lambda d: (-Severity.rank(d.severity),
                                           d.block_idx or 0, d.op_idx or 0))
    lines = ["%s:" % label] if label else []
    lines += ["  " + str(d) if label else str(d) for d in ordered]
    n_err = sum(1 for d in diags if d.severity == Severity.ERROR)
    n_warn = sum(1 for d in diags if d.severity == Severity.WARNING)
    lines.append(("  " if label else "") +
                 "%d error(s), %d warning(s)" % (n_err, n_warn))
    return "\n".join(lines)


class ProgramVerifyError(RuntimeError):
    """Raised by ``verify(..., strict=True)``, the Executor's verify hook
    and its memory preflight: one exception listing every diagnostic,
    instead of the error a lowering of the malformed program would
    raise later."""

    def __init__(self, diagnostics: List[Diagnostic], context=None):
        self.diagnostics = list(diagnostics)
        head = "program verification failed"
        if context:
            head += " (%s)" % context
        super(ProgramVerifyError, self).__init__(
            head + "\n" + render_diagnostics(self.diagnostics))

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.is_error]
