"""Program verifier: structural checks before a program runs.

Counterpart of ``paddle_tpu/analysis/verify.py``, with the same rules,
messages and entry points: one pass over the ``Program`` IR that turns a
malformed graph into structured
:class:`~paddle_tpu_torch.analysis.diagnostics.Diagnostic` findings
naming the block, op index, vars and a fix, instead of a ``KeyError``
deep inside the block interpreter.

Rule catalog:

  V001 undefined-input        error    op reads a name no reachable block declares
  V002 use-before-write       error    op reads a var no earlier op (any block) wrote
  V003 dangling-fetch         error    fetch target missing or never written
  V004 duplicate-output       error    one op lists the same output name twice
  V005 overwritten-before-read warning a non-persistable var is written twice with
                                       no read in between (first write is dead)
  V006 unknown-op             error    op type not in the op registry
  V007 unknown-slot           error    op uses a slot the registry schema lacks
  V008 slot-arity             error    multiple names in a non-duplicable slot
  V009 bad-dtype              error    tensor var declares an unknown dtype
  V010 unknown-shape          warning  a consumed tensor var still has shape=None
  V011 shape-inference-failed warning  deferred registry shape inference failed
  V012 orphaned-grad          warning  @GRAD var never written and never read
  V013 param-not-persistable  error    Parameter with persistable=False
  V014 param-in-subblock      error    Parameter declared outside block 0
  V015 persistable-in-subblock warning persistable var declared in a sub-block
  V016 bad-sub-block          error    control-flow op points at a bad block idx

Entry points: :func:`verify` (collect diagnostics), :func:`check_program`
(raise :class:`ProgramVerifyError` at/above a severity gate), surfaced
as ``Program.verify(level=...)`` and gated into ``Executor.run`` /
``run_multi_step`` (each analysis-cache miss) and ``Predictor`` (load)
by ``FLAGS_verify_program``.
"""

from paddle_tpu_torch.analysis.diagnostics import (
    Diagnostic,
    ProgramVerifyError,
    at_or_above,
    filter_diagnostics,
)

__all__ = ["verify", "check_program", "verify_after_transpile", "RULES"]

# rule id -> (name, severity) — the single source the docs/tests key on.
RULES = {
    "V001": ("undefined-input", "error"),
    "V002": ("use-before-write", "error"),
    "V003": ("dangling-fetch", "error"),
    "V004": ("duplicate-output", "error"),
    "V005": ("overwritten-before-read", "warning"),
    "V006": ("unknown-op", "error"),
    "V007": ("unknown-slot", "error"),
    "V008": ("slot-arity", "error"),
    "V009": ("bad-dtype", "error"),
    "V010": ("unknown-shape", "warning"),
    "V011": ("shape-inference-failed", "warning"),
    "V012": ("orphaned-grad", "warning"),
    "V013": ("param-not-persistable", "error"),
    "V014": ("param-in-subblock", "error"),
    "V015": ("persistable-in-subblock", "warning"),
    "V016": ("bad-sub-block", "error"),
}


def _diag(rule, message, **kwargs):
    name, severity = RULES[rule]
    return Diagnostic(rule, name, severity, message, **kwargs)


def _is_prewritten(v):
    """Vars that carry a value before any op in the program runs: feeds,
    parameters / persistable scope state, initializer-backed globals."""
    from paddle_tpu_torch.framework import Parameter

    return bool(
        getattr(v, "is_data", False)
        or v.persistable
        or isinstance(v, Parameter)
        or getattr(v, "initializer", None) is not None
    )


def _implicit_subblock_inputs(program):
    """sub-block idx -> names its owner op binds as implicit inputs.

    Control-flow mega-ops (recurrent / while / conditional_block) create
    sub-block vars that NO op writes — the scan/loop machinery feeds them
    per iteration, wired through the owner op's name-list attrs
    (input_step_names, pre_state_names, carry_names, ...). The
    def-before-use walk must treat those as pre-written, so collect every
    var-name-shaped attr (plus the owner's inputs) per sub-block."""
    implicit = {}
    nblocks = len(program.blocks)
    for block in program.blocks:
        for op in block.ops:
            tgt = op.attrs.get("sub_block")
            if not isinstance(tgt, int) or not (0 <= tgt < nblocks):
                continue
            names = set(n for n in op.input_arg_names() if n)
            for v in op.attrs.values():
                if isinstance(v, str):
                    names.add(v)
                elif isinstance(v, (list, tuple)):
                    names.update(x for x in v if isinstance(x, str))
            implicit.setdefault(tgt, set()).update(names)
    return implicit


def _writes_by_block(program):
    """block idx -> set of names its ops write (the cross-block write map:
    control-flow sub-blocks write parent vars and vice versa, and op
    order across blocks is the parent op's concern, not this pass's)."""
    writes = {}
    for block in program.blocks:
        names = set()
        for op in block.ops:
            for n in op.output_arg_names():
                if n:
                    names.add(n)
        writes[block.idx] = names
    return writes


def _check_block_dataflow(program, block, writes_by_block, implicit,
                          fed, out):
    """V001/V002/V004/V005 over one block's straight-line op list."""
    # Names written by ops OUTSIDE this block (position-independent:
    # parent ops run before the sub-block's owner op lowers it, and
    # sub-block writes surface through the owner op's outputs). Fed
    # names arrive written from the caller (executor feed dict).
    other_writes = set(fed)
    for idx, names in writes_by_block.items():
        if idx != block.idx:
            other_writes |= names
    other_writes |= implicit.get(block.idx, set())

    written = set()        # names written by earlier ops in THIS block
    last_write = {}        # name -> op idx of last write (V005)
    read_since_write = {}  # name -> True once read after last write

    for i, op in enumerate(block.ops):
        for n in op.input_arg_names():
            if not n:
                continue
            v = block._find_var_recursive(n)
            if v is None:
                out.append(_diag(
                    "V001",
                    "op input %r is not declared in block %d or any "
                    "parent block" % (n, block.idx),
                    block_idx=block.idx, op_idx=i, op_type=op.type,
                    var_names=(n,),
                    hint="declare the variable with block.create_var "
                         "before appending ops that read it, or fix the "
                         "name (typo / stale rename)"))
                continue
            read_since_write[n] = True
            if (n in written or n in other_writes
                    or _is_prewritten(v)):
                continue
            out.append(_diag(
                "V002",
                "op reads %r before any op writes it (not a feed, "
                "parameter, or initializer-backed var)" % n,
                block_idx=block.idx, op_idx=i, op_type=op.type,
                var_names=(n,),
                hint="move the producing op before this one, feed the "
                     "var, or mark it persistable if the scope "
                     "provides it"))

        seen_out = set()
        for n in op.output_arg_names():
            if not n:
                continue
            if n in seen_out:
                out.append(_diag(
                    "V004",
                    "op lists output %r more than once; the later "
                    "write silently clobbers the earlier one" % n,
                    block_idx=block.idx, op_idx=i, op_type=op.type,
                    var_names=(n,),
                    hint="give each output slot entry a distinct "
                         "variable name"))
            seen_out.add(n)
            v = block._find_var_recursive(n)
            if (n in last_write and not read_since_write.get(n, False)
                    and v is not None and not v.persistable
                    and n not in op.input_arg_names()):
                out.append(_diag(
                    "V005",
                    "var %r written at op %d is overwritten here "
                    "without any read in between — the first write is "
                    "dead (likely a name collision)"
                    % (n, last_write[n]),
                    block_idx=block.idx, op_idx=i, op_type=op.type,
                    var_names=(n,),
                    hint="use a fresh unique_name for the intermediate, "
                         "or delete the dead producer"))
            last_write[n] = i
            read_since_write[n] = False
            written.add(n)


def _check_block_schema(program, block, out):
    """V006/V007/V008/V016 against the op registry schemas."""
    from paddle_tpu_torch.core import op_registry

    nblocks = len(program.blocks)
    for i, op in enumerate(block.ops):
        if not op_registry.has_op(op.type):
            out.append(_diag(
                "V006",
                "op type %r is not registered (deserialized from a "
                "newer/foreign program?)" % op.type,
                block_idx=block.idx, op_idx=i, op_type=op.type,
                hint="register the op (paddle_tpu_torch/ops/) or regenerate "
                     "the saved program against this build"))
            continue
        opdef = op_registry.get_op_def(op.type)
        for io, slots, dup in (
            ("input", opdef.input_slots(), opdef.is_duplicable_input),
            ("output", opdef.output_slots(), opdef.is_duplicable_output),
        ):
            declared = op.inputs if io == "input" else op.outputs
            for slot, names in declared.items():
                if slot not in slots:
                    out.append(_diag(
                        "V007",
                        "%s slot %r is not in op %s's schema (valid: "
                        "%s)" % (io, slot, op.type, slots),
                        block_idx=block.idx, op_idx=i, op_type=op.type,
                        var_names=tuple(n for n in names if n),
                        hint="use a schema slot name; grad slots take "
                             "the forward slot name + '@GRAD'"))
                elif len(names) > 1 and not dup(slot):
                    out.append(_diag(
                        "V008",
                        "%s slot %r holds %d names but is not "
                        "duplicable" % (io, slot, len(names)),
                        block_idx=block.idx, op_idx=i, op_type=op.type,
                        var_names=tuple(n for n in names if n),
                        hint="pass one var, or mark the slot duplicable "
                             "('*%s') in the registration" % slot))
        for attr in ("sub_block", "block_idx"):
            if attr in op.attrs and isinstance(op.attrs[attr], int):
                tgt = op.attrs[attr]
                if not (0 <= tgt < nblocks) or tgt == block.idx:
                    out.append(_diag(
                        "V016",
                        "attr %r points at block %d (program has %d "
                        "blocks, op lives in block %d)"
                        % (attr, tgt, nblocks, block.idx),
                        block_idx=block.idx, op_idx=i, op_type=op.type,
                        hint="rebuild the control-flow construct; its "
                             "sub-block was pruned or renumbered"))


def _check_vars(program, block, reads, writes, out):
    """V009/V010/V012/V013/V014/V015 over the block's symbol table."""
    from paddle_tpu_torch.core.types import VarType, canonical_dtype
    from paddle_tpu_torch.framework import Parameter

    for name in sorted(block.vars):
        v = block.vars[name]
        if getattr(v, "type", None) == VarType.LOD_TENSOR and v.dtype:
            try:
                canonical_dtype(v.dtype)
            except Exception:
                out.append(_diag(
                    "V009",
                    "var %r declares unknown dtype %r" % (name, v.dtype),
                    block_idx=block.idx, var_names=(name,),
                    hint="use a canonical dtype name (float32, bfloat16, "
                         "int64, ...)"))
        if (getattr(v, "type", None) == VarType.LOD_TENSOR
                and v.shape is None and name in reads):
            out.append(_diag(
                "V010",
                "var %r is consumed but its shape is still unknown "
                "(deferred shape inference did not resolve it)" % name,
                block_idx=block.idx, var_names=(name,),
                hint="declare the shape on the data var, or call "
                     "program.infer_deferred_shapes(feed_shapes=...) "
                     "once feed shapes are known"))
        if "@GRAD" in name and name not in writes and name not in reads:
            out.append(_diag(
                "V012",
                "gradient var %r is declared but no op writes or reads "
                "it (orphaned by backward/pruning)" % name,
                block_idx=block.idx, var_names=(name,),
                hint="prune it, or check append_backward's no_grad_set "
                     "— a wanted gradient silently has no producer"))
        if isinstance(v, Parameter):
            if not v.persistable:
                out.append(_diag(
                    "V013",
                    "Parameter %r is not persistable — the executor "
                    "will not thread it through the scope" % name,
                    block_idx=block.idx, var_names=(name,),
                    hint="Parameters must keep persistable=True"))
            if block.idx != 0:
                out.append(_diag(
                    "V014",
                    "Parameter %r is declared in sub-block %d; "
                    "parameters live in the global block"
                    % (name, block.idx),
                    block_idx=block.idx, var_names=(name,),
                    hint="create parameters via create_parameter (it "
                         "targets the global block)"))
        elif v.persistable and block.idx != 0:
            out.append(_diag(
                "V015",
                "persistable var %r is declared in sub-block %d; the "
                "scope only threads global-block state" % (name, block.idx),
                block_idx=block.idx, var_names=(name,),
                hint="declare scope-backed state in the global block"))


def _check_fetches(program, fetch_names, writes_all, fed, out):
    gb = program.global_block()
    for n in fetch_names or ():
        v = gb._find_var_recursive(n)
        if v is None:
            out.append(_diag(
                "V003",
                "fetch target %r is not declared in the program" % n,
                var_names=(n,),
                hint="fetch an existing var, or re-run the transpiler "
                     "that renamed/pruned it"))
        elif n not in writes_all and n not in fed and not _is_prewritten(v):
            out.append(_diag(
                "V003",
                "fetch target %r is declared but no op ever writes it"
                % n,
                var_names=(n,),
                hint="fetching it would return uninitialized data; "
                     "fetch the producing op's actual output"))


def _retry_deferred(program, feed_shapes, out):
    """Re-run shape inference deferred at append_op time (V011
    for ops that still fail), so reader-pipeline vars with shape=None
    don't false-positive V010."""
    failures = program.infer_deferred_shapes(feed_shapes=feed_shapes)
    for block_idx, op, err in failures:
        block = program.block(block_idx)
        try:
            op_idx = block.ops.index(op)
        except ValueError:
            op_idx = None
        out.append(_diag(
            "V011",
            "deferred shape inference for %s failed: %s"
            % (op.type, err),
            block_idx=block_idx, op_idx=op_idx, op_type=op.type,
            var_names=tuple(op.output_arg_names()),
            hint="fix the op's input shapes/dtypes; the same failure "
                 "would otherwise surface as an error inside the run"))


def verify(program, fetch_names=None, feed_shapes=None, feed_names=None,
           suppress=()):
    """Run every verifier rule; return the list of Diagnostics.

    fetch_names: optional fetch targets to validate (V003).
    feed_shapes: optional {var name -> shape tuple} used to resolve
      deferred shape inference before shape rules run.
    feed_names: extra var names the caller feeds at run time (counted as
      pre-written even without the is_data mark — pserver grad feeds);
      feed_shapes keys are included automatically.
    suppress: rule ids or names to drop from the result.
    """
    out = []
    fed = set(feed_names or ()) | set(feed_shapes or ())
    if hasattr(program, "infer_deferred_shapes"):
        _retry_deferred(program, feed_shapes, out)

    writes_by_block = _writes_by_block(program)
    implicit = _implicit_subblock_inputs(program)
    writes_all = set()
    for names in writes_by_block.values():
        writes_all |= names
    reads_all = set()
    for block in program.blocks:
        for op in block.ops:
            reads_all.update(n for n in op.input_arg_names() if n)

    for block in program.blocks:
        _check_block_dataflow(program, block, writes_by_block, implicit,
                              fed, out)
        _check_block_schema(program, block, out)
        _check_vars(program, block, reads_all, writes_all, out)
    _check_fetches(program, fetch_names, writes_all, fed, out)
    return filter_diagnostics(out, suppress)


def check_program(program, level="error", fetch_names=None,
                  feed_shapes=None, feed_names=None, suppress=(),
                  origin=None):
    """``verify`` + gate: raise :class:`ProgramVerifyError` when any
    diagnostic sits at/above ``level`` ("error" by default; pass
    level=None to never raise). Returns ALL diagnostics otherwise, so
    callers still see the warnings."""
    diags = verify(program, fetch_names=fetch_names,
                   feed_shapes=feed_shapes, feed_names=feed_names,
                   suppress=suppress)
    if level is not None:
        failing = at_or_above(diags, level)
        if failing:
            raise ProgramVerifyError(failing, origin=origin)
    return diags


def verify_after_transpile(program, origin):
    """Post-transpiler hook (the ``framework/ir`` pass-verification role):
    under ``FLAGS_verify_program`` every transpiler's output graph is
    verified before anything lowers it, blaming the transpiler by name."""
    from paddle_tpu_torch import flags

    if not flags.get("verify_program"):
        return None
    return check_program(program, level="error", origin=origin)
