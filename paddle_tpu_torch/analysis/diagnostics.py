"""Diagnostics shared by the verifier and its callers.

Counterpart of ``paddle_tpu/analysis/diagnostics.py``, copied: every
finding is a structured :class:`Diagnostic` (rule id, severity,
block/op location, involved vars, fix hint) that callers can print,
filter, suppress, count, or turn into one :class:`ProgramVerifyError`
at a chosen severity gate. Both packages format a finding alike, so a
test can hold the two verifiers' findings equal.
"""

__all__ = [
    "Diagnostic",
    "ProgramVerifyError",
    "SEVERITIES",
    "at_or_above",
    "filter_diagnostics",
    "format_diagnostics",
    "worst_severity",
]

# Ascending order; gates compare by index.
SEVERITIES = ("info", "warning", "error")


def _sev_index(severity):
    try:
        return SEVERITIES.index(severity)
    except ValueError:
        raise ValueError(
            "unknown severity %r (valid: %s)" % (severity, list(SEVERITIES))
        )


class Diagnostic(object):
    """One structured finding about a Program.

    Attributes:
      rule: stable rule id ("V001", "L003", ...) — what tests and
        suppressions key on.
      name: human slug for the rule ("undefined-input").
      severity: "error" | "warning" | "info".
      message: what is wrong, naming the concrete vars/ops.
      block_idx: block the finding is in (None = whole program).
      op_idx: op index within the block (None = var-level finding).
      op_type: the op's type when op_idx is set.
      var_names: tuple of involved variable names.
      hint: how to fix it (one sentence, actionable).
    """

    __slots__ = ("rule", "name", "severity", "message", "block_idx",
                 "op_idx", "op_type", "var_names", "hint")

    def __init__(self, rule, name, severity, message, block_idx=None,
                 op_idx=None, op_type=None, var_names=(), hint=None):
        _sev_index(severity)  # validate
        self.rule = rule
        self.name = name
        self.severity = severity
        self.message = message
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.op_type = op_type
        self.var_names = tuple(var_names)
        self.hint = hint

    def location(self):
        if self.block_idx is None:
            return "program"
        if self.op_idx is None:
            return "block %d" % self.block_idx
        loc = "block %d op %d" % (self.block_idx, self.op_idx)
        if self.op_type:
            loc += " (%s)" % self.op_type
        return loc

    def as_dict(self):
        return {
            "rule": self.rule,
            "name": self.name,
            "severity": self.severity,
            "message": self.message,
            "block_idx": self.block_idx,
            "op_idx": self.op_idx,
            "op_type": self.op_type,
            "var_names": list(self.var_names),
            "hint": self.hint,
        }

    def __repr__(self):
        return "Diagnostic(%s %s @ %s: %s)" % (
            self.rule, self.severity, self.location(), self.message)

    def __str__(self):
        line = "%-7s %s [%s] %s" % (
            self.severity, self.rule, self.location(), self.message)
        if self.hint:
            line += "\n        hint: %s" % self.hint
        return line


def at_or_above(diagnostics, level):
    """Diagnostics whose severity is >= ``level``."""
    gate = _sev_index(level)
    return [d for d in diagnostics if _sev_index(d.severity) >= gate]


def filter_diagnostics(diagnostics, suppress=()):
    """Drop findings whose rule id OR rule name is in ``suppress``."""
    suppress = set(suppress or ())
    if not suppress:
        return list(diagnostics)
    return [d for d in diagnostics
            if d.rule not in suppress and d.name not in suppress]


def worst_severity(diagnostics):
    """The highest severity present, or None for a clean list."""
    worst = None
    for d in diagnostics:
        if worst is None or _sev_index(d.severity) > _sev_index(worst):
            worst = d.severity
    return worst


def format_diagnostics(diagnostics, header=None):
    """Multi-line human-readable report (what plint prints)."""
    lines = []
    if header:
        lines.append(header)
    for d in diagnostics:
        lines.append(str(d))
    counts = {}
    for d in diagnostics:
        counts[d.severity] = counts.get(d.severity, 0) + 1
    summary = ", ".join(
        "%d %s%s" % (counts[s], s, "s" if counts[s] != 1 else "")
        for s in reversed(SEVERITIES) if s in counts
    ) or "clean"
    lines.append(summary)
    return "\n".join(lines)


class ProgramVerifyError(RuntimeError):
    """Raised when verification finds diagnostics at/above the gate level.

    Carries the full structured list in ``.diagnostics`` so callers
    (tests, tools/plint.py, the Executor gate) don't re-parse the text.
    """

    def __init__(self, diagnostics, origin=None):
        self.diagnostics = list(diagnostics)
        self.origin = origin
        header = "program verification failed"
        if origin:
            header += " (after %s)" % origin
        super(ProgramVerifyError, self).__init__(
            format_diagnostics(self.diagnostics, header=header))
