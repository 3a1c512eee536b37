"""Static checks of the port (counterpart of ``paddle_tpu/analysis``).

A walk over a Program dispatches to registered rules and returns
:class:`Diagnostic` s with stable ``PTxxx`` codes, the JAX package's
codes, severities and messages:

- ``verify(program, rules=None, strict=False, fetches=None)``: the
  program rules PT001-PT017 (``rules.py``); ``strict`` raises
  :class:`ProgramVerifyError` on an error;
- ``memory``: the static memory planner PT030-PT033 and the KV-pool
  check PT034 (``plan_memory``, ``check_memory``, the Executor's
  preflight, and the release schedule the Executor frees values by);
- ``FLAGS.verify`` / ``PADDLE_TPU_VERIFY=1``: the Executor's verify hook
  and memory preflight; ``python -m paddle_tpu_torch lint <config.py>``:
  the CLI;
- ``check_after_pass``: the self-check ``append_backward`` runs after
  it touches a program.

Not ported yet (ROADMAP.md Queue 1 item 6, which needs collectives and a
mesh): ``comm_rules`` (PT020-PT023), ``sharding`` (PT040-PT045),
``sanitize`` and ``locks``.
"""
from __future__ import annotations

from .diagnostics import (  # noqa: F401
    Diagnostic, ProgramVerifyError, Severity, render_diagnostics,
)
from .runner import (  # noqa: F401
    Rule, ProgramFacts, STRUCTURAL_CODES, check_after_pass, register_rule,
    registered_rules, resolve_rules, verify, verify_or_raise,
)
from . import rules  # noqa: F401  (registers the built-in PT rules)
from .rules import mark_pipeline_stages  # noqa: F401
from . import memory  # noqa: F401

__all__ = [
    "Diagnostic", "ProgramVerifyError", "Severity", "render_diagnostics",
    "Rule", "ProgramFacts", "STRUCTURAL_CODES", "check_after_pass",
    "register_rule", "registered_rules", "resolve_rules", "verify",
    "verify_or_raise", "rules", "mark_pipeline_stages", "memory",
]
