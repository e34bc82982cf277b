"""Declarative subgraph pattern matching over Program blocks.

A copy of ``paddle_tpu/core/graph_pattern.py`` (graph_pattern_detector.cc
PDPattern/PDNode role), the engine behind the fusion passes of
``core/passes.py``. It reads only ``block.ops`` and each op's ``type``,
``inputs``, ``outputs`` and ``input`` / ``output``, which the port's
``framework`` has as the JAX package's does.

A pattern is an ordered list of op specs. Edges are expressed by shared
var *labels*: binding the same label to a producer's output slot and a
consumer's input slot constrains the two ops to be connected through one
variable. ``detect`` returns non-overlapping matches in program order.

Example — mul followed by elementwise_add through label "mid"::

    pat = GraphPatternDetector()
    pat.op("mul", "mul", inputs={"X": "x", "Y": "w"}, outputs={"Out": "mid"})
    pat.op("add", "elementwise_add", inputs={"X": "mid", "Y": "b"},
           outputs={"Out": "out"})
    for m in pat.detect(block):
        m.op("mul"), m.op_index("add"), m.var("mid")
"""


class Match(object):
    """One subgraph match: pattern-op-name -> (block op index, Operator),
    var label -> var name."""

    def __init__(self, ops, vars_):
        self._ops = ops  # name -> (index, Operator)
        self._vars = vars_  # label -> var name

    def op(self, name):
        return self._ops[name][1]

    def op_index(self, name):
        return self._ops[name][0]

    def op_indices(self):
        return sorted(i for i, _ in self._ops.values())

    def var(self, label):
        return self._vars[label]

    def is_live(self, block):
        """True while every matched op still sits at its recorded index —
        rewriting passes that apply a whole detect() wave must check this
        per match, since an earlier rewrite shifts later indices (a stale
        match would remove the wrong ops)."""
        ops = block.ops
        return all(
            i < len(ops) and ops[i] is op for i, op in self._ops.values()
        )

    def __repr__(self):
        return "Match(ops=%r, vars=%r)" % (
            {k: v[0] for k, v in self._ops.items()}, self._vars)


class _OpSpec(object):
    __slots__ = ("name", "types", "inputs", "outputs", "cond")

    def __init__(self, name, types, inputs, outputs, cond):
        self.name = name
        self.types = frozenset([types] if isinstance(types, str) else types)
        self.inputs = dict(inputs or {})
        self.outputs = dict(outputs or {})
        self.cond = cond


class GraphPatternDetector(object):
    """Ordered-op-spec pattern + backtracking matcher (PDPattern role)."""

    def __init__(self):
        self._specs = []

    def op(self, name, types, inputs=None, outputs=None, cond=None):
        """Add an op node to the pattern.

        name: handle for retrieving the matched op from a Match.
        types: op type string or iterable of acceptable types.
        inputs/outputs: {slot: var_label}; the first var in the slot is
          bound to the label. Same label across specs = same variable.
        cond: optional predicate fn(Operator) -> bool.
        """
        if any(s.name == name for s in self._specs):
            raise ValueError("pattern op %r already defined" % name)
        self._specs.append(_OpSpec(name, types, inputs, outputs, cond))
        return self

    def detect(self, block, overlapping=False):
        """Match the pattern against ``block.ops``.

        Returns a list of :class:`Match`, anchored on the first spec in
        program order. Unless ``overlapping`` is set, matches are made
        disjoint greedily (two matches never share a block op), which is
        what rewriting passes want.
        """
        specs = self._specs
        if not specs:
            return []
        ops = list(block.ops)
        matches = []
        taken = set()

        def try_bind(spec, op, bound_vars):
            """Bind spec's slot labels against op; None on conflict."""
            binds = {}
            for slots, getter in (
                (spec.inputs, op.input),
                (spec.outputs, op.output),
            ):
                for slot, label in slots.items():
                    names = getter(slot)
                    if not names or not names[0]:
                        return None
                    expect = bound_vars.get(label, binds.get(label))
                    if expect is None:
                        binds[label] = names[0]
                    elif expect != names[0]:
                        return None
            return binds

        def candidate(spec, i, op):
            if op.type not in spec.types:
                return False
            if not overlapping and i in taken:
                return False
            return spec.cond is None or spec.cond(op)

        def backtrack(k, bound_ops, bound_vars, used):
            if k == len(specs):
                return Match(dict(bound_ops), dict(bound_vars))
            spec = specs[k]
            for i, op in enumerate(ops):
                if i in used or not candidate(spec, i, op):
                    continue
                binds = try_bind(spec, op, bound_vars)
                if binds is None:
                    continue
                nv = dict(bound_vars)
                nv.update(binds)
                bound_ops[spec.name] = (i, op)
                m = backtrack(k + 1, bound_ops, nv, used | {i})
                if m is not None:
                    return m
                del bound_ops[spec.name]
            return None

        for i, op in enumerate(ops):
            if not candidate(specs[0], i, op):
                continue
            binds = try_bind(specs[0], op, {})
            if binds is None:
                continue
            m = backtrack(1, {specs[0].name: (i, op)}, binds, {i})
            if m is not None:
                matches.append(m)
                if not overlapping:
                    taken |= set(m.op_indices())
        return matches


def producer(block, var_name):
    """(index, op) of the op writing ``var_name``, or None (prefers the
    LAST writer, matching execution order)."""
    found = None
    for i, op in enumerate(block.ops):
        if var_name in op.output_arg_names():
            found = (i, op)
    return found


def consumers(block, var_name, start=0):
    """All (index, op, slot) reading ``var_name`` at or after ``start``."""
    out = []
    for i, op in enumerate(block.ops):
        if i < start:
            continue
        for slot, names in op.inputs.items():
            if var_name in names:
                out.append((i, op, slot))
    return out
