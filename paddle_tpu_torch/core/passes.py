"""Program-pass framework: registry + PassManager over Program graphs.

Counterpart of ``paddle_tpu/core/passes.py`` (paddle/fluid/framework/ir/
Pass + REGISTER_PASS, pass_builder) for the "inference" strategy that
``AnalysisConfig`` runs, in the reference's order: prune to the
feed-to-fetch slice, fold batch norms, fuse the fc feeding a recurrence
into fusion_lstm / fusion_gru (before fc_fuse, which would otherwise
claim those mul + add chains), then collapse mul + add (+ act) into fc.

A pass is ``fn(program, scope=None, **kwargs) -> program`` (in place or
returning a new Program). Register with :func:`register_pass`; run with
:class:`PassManager` or :func:`apply_pass`.

``fuse_batch_norm`` folds conv (+ bias) + batch_norm
(``transpiler.InferenceTranspiler``); ``seqconv_eltadd_relu_fuse``
collapses sequence_conv + elementwise_add(bias) + relu into
``fusion_seqconv_eltadd_relu``; ``fuse_elewise_add_act`` collapses
elementwise_add + activation (and its grad pair) into
``fused_elemwise_activation``; ``delete_dropout`` turns an inference
dropout into an ``assign``.
"""

import inspect
import logging

from paddle_tpu_torch.core.graph_pattern import (
    GraphPatternDetector,
    consumers,
)

logger = logging.getLogger("paddle_tpu_torch.passes")

_PASSES = {}

__all__ = ["register_pass", "get_pass", "list_passes", "apply_pass",
           "PassManager"]


def register_pass(name, fn=None):
    """REGISTER_PASS analog; usable as a decorator."""

    def deco(f):
        if name in _PASSES:
            raise ValueError("pass %r already registered" % name)
        _PASSES[name] = f
        return f

    return deco(fn) if fn is not None else deco


def get_pass(name):
    if name not in _PASSES:
        raise KeyError(
            "unknown pass %r (have: %s)" % (name, ", ".join(sorted(_PASSES))))
    return _PASSES[name]


def list_passes():
    return sorted(_PASSES)


def apply_pass(program, name, scope=None, **kwargs):
    logger.debug("applying pass %s", name)
    fn = get_pass(name)
    # pipelines broadcast kwargs; hand each pass only what it accepts
    sig = inspect.signature(fn)
    if not any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in sig.parameters.values()):
        kwargs = {k: v for k, v in kwargs.items() if k in sig.parameters}
    out = fn(program, scope=scope, **kwargs)
    return out if out is not None else program


class PassManager(object):
    """Ordered pass pipeline (pass_builder role). ``STRATEGIES`` maps a
    use case to its default pipeline, as AnalysisPredictor's pass lists
    do."""

    STRATEGIES = {
        "inference": ["prune_feed_fetch", "fuse_batch_norm",
                      "fc_lstm_fuse", "embedding_fc_lstm_fuse",
                      "fc_gru_fuse", "seqconv_eltadd_relu_fuse",
                      "fc_fuse"],
        # mixed-precision training
        "amp_bf16": ["amp_rewrite"],
    }

    def __init__(self, passes=None, strategy=None):
        if strategy is not None:
            passes = self.STRATEGIES[strategy] + list(passes or [])
        self.passes = list(passes or [])
        for p in self.passes:
            get_pass(p)  # fail fast on unknown names

    def apply(self, program, scope=None, **kwargs):
        for name in self.passes:
            program = apply_pass(program, name, scope=scope, **kwargs)
        return program


@register_pass("fuse_batch_norm")
def _fuse_batch_norm(program, scope=None, **kwargs):
    """conv (+ bias) + batch_norm fold (ConvBNFusePass / inference
    transpiler role)."""
    from paddle_tpu_torch.transpiler.inference_transpiler import (
        InferenceTranspiler,
    )

    return InferenceTranspiler().transpile(program, scope=scope)


@register_pass("amp_rewrite")
def _amp_rewrite(program, scope=None, dtype="bfloat16", **kwargs):
    """bf16 mixed-precision policy (float16_transpiler role)."""
    from paddle_tpu_torch.transpiler import rewrite_program_amp

    rewrite_program_amp(program, dtype)
    return program


@register_pass("prune_feed_fetch")
def _prune_feed_fetch(program, scope=None, feed_names=None,
                      fetch_names=None, **kwargs):
    """Backward slice to the feed->fetch subgraph (framework/prune.cc).
    No-op unless both name lists are given."""
    if not feed_names or not fetch_names:
        return program
    from paddle_tpu_torch.io import prune_program

    return prune_program(program, feed_names, fetch_names)


def _persistable(block, name):
    v = block.vars.get(name)
    return v is not None and getattr(v, "persistable", False)


def _chain_clear(block, protected, pairs):
    """Every intermediate var of a fusion chain feeds ONLY the next op of
    the chain and is never a feed or fetch target. ``pairs`` =
    [(var_name, expected_consumer_index), ...]."""
    for var_name, consumer_idx in pairs:
        if var_name in protected:
            return False
        if [i for i, _, _ in consumers(block, var_name)] != [consumer_idx]:
            return False
    return True


def _projection_safe(block, mul_op, add_op, bias_name):
    """The fused lowerings compute a plain 2-D product + a bias broadcast
    on the trailing axis; reject mul / add attrs that mean something else
    (fc_fuse_pass's bias-shape checks)."""
    if mul_op.attrs.get("y_num_col_dims", 1) != 1:
        return False
    if add_op is None:
        return True
    bvar = block.vars.get(bias_name)
    if bvar is None or len(getattr(bvar, "shape", ()) or ()) != 1:
        return False
    xn = mul_op.attrs.get("x_num_col_dims", 1)
    return add_op.attrs.get("axis", -1) in (-1, xn)


def _live_matches(pat, block):
    """(match, live) bottom-up: rewriting bottom-up keeps the earlier
    matches' indices valid; a match an earlier rewrite of the wave
    shifted is not live, and the next wave's detect retries it."""
    for m in sorted(pat.detect(block), key=lambda mm: -mm.op_indices()[0]):
        yield m, m.is_live(block)


@register_pass("fc_fuse")
def _fc_fuse(program, scope=None, feed_names=None, fetch_names=None,
             **kwargs):
    """Collapse mul + elementwise_add(persistable bias) [+ activation]
    chains into single ``fc`` ops (fc_fuse_pass.cc role). Intermediates
    read by grad ops (training graphs) fail the single-consumer rule and
    stay. Vars named in feed_names / fetch_names are never absorbed."""
    protected = set(feed_names or ()) | set(fetch_names or ())

    def _rewrite(block, m, with_act):
        if not (_persistable(block, m.var("w"))
                and _persistable(block, m.var("b"))):
            return False
        mul_op, add_op = m.op("mul"), m.op("add")
        if not _projection_safe(block, mul_op, add_op, m.var("b")):
            return False
        pairs = [(m.var("mid"), m.op_index("add"))]
        if with_act:
            pairs.append((m.var("out"), m.op_index("act")))
        if not _chain_clear(block, protected, pairs):
            return False
        idxs = m.op_indices()
        attrs = {
            "in_num_col_dims": mul_op.attrs.get("x_num_col_dims", 1),
            "activation_type": m.op("act").type if with_act else "",
        }
        for i in reversed(idxs):
            block.remove_op(i)
        block.insert_op(
            idxs[0], "fc",
            inputs={"Input": [m.var("x")], "W": [m.var("w")],
                    "Bias": [m.var("b")]},
            outputs={"Out": [m.var("final") if with_act else m.var("out")]},
            attrs=attrs)
        block.vars.pop(m.var("mid"), None)
        if with_act:
            block.vars.pop(m.var("out"), None)
        return True

    for block in program.blocks:
        # longest chain first, so mul + add + act does not half-match
        for with_act in (True, False):
            changed = True
            while changed:
                changed = False
                pat = GraphPatternDetector()
                pat.op("mul", "mul",
                       inputs={"X": "x", "Y": "w"}, outputs={"Out": "mid"})
                pat.op("add", "elementwise_add",
                       inputs={"X": "mid", "Y": "b"}, outputs={"Out": "out"})
                if with_act:
                    pat.op("act", ("relu", "tanh", "sigmoid", "gelu"),
                           inputs={"X": "out"}, outputs={"Out": "final"})
                for m, live in _live_matches(pat, block):
                    changed |= (not live) or _rewrite(block, m, with_act)
    program._bump_version()
    return program


def _fc_rnn_fuse(program, rnn_type, fused_type, feed_names, fetch_names):
    """Shared body of fc_lstm_fuse / fc_gru_fuse (fc_lstm_fuse_pass.cc,
    fc_gru_fuse_pass.cc roles): the projection fc feeding a recurrence
    collapses into one fusion op."""
    protected = set(feed_names or ()) | set(fetch_names or ())
    for block in program.blocks:
        for with_bias in (True, False):
            changed = True
            while changed:
                changed = False
                pat = GraphPatternDetector()
                pat.op("mul", "mul",
                       inputs={"X": "x", "Y": "wx"}, outputs={"Out": "mid"})
                rnn_in = "mid"
                if with_bias:
                    pat.op("add", "elementwise_add",
                           inputs={"X": "mid", "Y": "bx"},
                           outputs={"Out": "proj"})
                    rnn_in = "proj"
                pat.op("rnn", rnn_type, inputs={"Input": rnn_in})
                for m, live in _live_matches(pat, block):
                    if not live:
                        changed = True
                        continue
                    if not _persistable(block, m.var("wx")):
                        continue
                    if with_bias and not _persistable(block, m.var("bx")):
                        continue
                    if not _projection_safe(
                            block, m.op("mul"),
                            m.op("add") if with_bias else None,
                            m.var("bx") if with_bias else None):
                        continue
                    pairs = [(m.var("mid"), m.op_index("add") if with_bias
                              else m.op_index("rnn"))]
                    if with_bias:
                        pairs.append((m.var("proj"), m.op_index("rnn")))
                    if not _chain_clear(block, protected, pairs):
                        continue
                    rnn = m.op("rnn")
                    inputs = {"X": [m.var("x")], "WeightX": [m.var("wx")],
                              "WeightH": rnn.input("Weight")}
                    if with_bias:
                        inputs["BiasX"] = [m.var("bx")]
                    for slot in ("Bias", "H0", "C0", "Length"):
                        if rnn.input(slot):
                            inputs[slot] = rnn.input(slot)
                    idxs = m.op_indices()
                    for i in reversed(idxs):
                        block.remove_op(i)
                    # at the RECURRENCE's (shifted) position, not the
                    # mul's: ops between them may produce its H0 / C0 /
                    # Length, which must stay upstream
                    block.insert_op(
                        m.op_index("rnn") - (len(idxs) - 1), fused_type,
                        inputs=inputs, outputs=dict(rnn.outputs),
                        # a plain copy carries op_role / op_role_var too
                        attrs={k: v for k, v in rnn.attrs.items()
                               if not k.startswith("__")})
                    for var_name, _ in pairs:
                        block.vars.pop(var_name, None)
                    changed = True
    program._bump_version()
    return program


@register_pass("fc_lstm_fuse")
def _fc_lstm_fuse(program, scope=None, feed_names=None, fetch_names=None,
                  **kwargs):
    """mul (+ bias) feeding dynamic_lstm -> fusion_lstm."""
    return _fc_rnn_fuse(program, "dynamic_lstm", "fusion_lstm",
                        feed_names, fetch_names)


@register_pass("fc_gru_fuse")
def _fc_gru_fuse(program, scope=None, feed_names=None, fetch_names=None,
                 **kwargs):
    """mul (+ bias) feeding dynamic_gru -> fusion_gru."""
    return _fc_rnn_fuse(program, "dynamic_gru", "fusion_gru",
                        feed_names, fetch_names)


@register_pass("embedding_fc_lstm_fuse")
def _embedding_fc_lstm_fuse(program, scope=None, feed_names=None,
                            fetch_names=None, **kwargs):
    """lookup_table feeding a fusion_lstm -> fused_embedding_fc_lstm
    (embedding_fc_lstm_fuse_pass.cc role). Runs AFTER fc_lstm_fuse, which
    builds the fusion_lstm this pass extends by one hop."""
    protected = set(feed_names or ()) | set(fetch_names or ())
    for block in program.blocks:
        changed = True
        while changed:
            changed = False
            pat = GraphPatternDetector()
            pat.op("emb", "lookup_table",
                   inputs={"W": "table", "Ids": "ids"},
                   outputs={"Out": "mid"})
            pat.op("lstm", "fusion_lstm", inputs={"X": "mid"})
            for m, live in _live_matches(pat, block):
                if not live:
                    changed = True
                    continue
                if not _persistable(block, m.var("table")):
                    continue
                if not _chain_clear(block, protected,
                                    [(m.var("mid"), m.op_index("lstm"))]):
                    continue
                lstm = m.op("lstm")
                inputs = dict(lstm.inputs)
                inputs.pop("X", None)
                inputs["Ids"] = [m.var("ids")]
                inputs["Embeddings"] = [m.var("table")]
                attrs = {k: v for k, v in lstm.attrs.items()
                         if not k.startswith("__")}
                attrs["padding_idx"] = m.op("emb").attrs.get(
                    "padding_idx", -1)
                idxs = m.op_indices()
                for i in reversed(idxs):
                    block.remove_op(i)
                block.insert_op(m.op_index("lstm") - (len(idxs) - 1),
                                "fused_embedding_fc_lstm", inputs=inputs,
                                outputs=dict(lstm.outputs), attrs=attrs)
                block.vars.pop(m.var("mid"), None)
                changed = True
    program._bump_version()
    return program


@register_pass("seqconv_eltadd_relu_fuse")
def _seqconv_eltadd_relu_fuse(program, scope=None, feed_names=None,
                              fetch_names=None, **kwargs):
    """sequence_conv + elementwise_add(persistable bias) + relu ->
    fusion_seqconv_eltadd_relu (the reference pass of the same name)."""
    protected = set(feed_names or ()) | set(fetch_names or ())
    for block in program.blocks:
        changed = True
        while changed:
            changed = False
            pat = GraphPatternDetector()
            pat.op("conv", "sequence_conv", outputs={"Out": "mid"})
            pat.op("add", "elementwise_add",
                   inputs={"X": "mid", "Y": "b"}, outputs={"Out": "mid2"})
            pat.op("relu", "relu", inputs={"X": "mid2"},
                   outputs={"Out": "out"})
            for m, live in _live_matches(pat, block):
                if not live:
                    changed = True
                    continue
                if not _persistable(block, m.var("b")):
                    continue
                bvar = block.vars.get(m.var("b"))
                if len(getattr(bvar, "shape", ()) or ()) != 1:
                    continue
                if m.op("add").attrs.get("axis", -1) not in (-1, 2):
                    continue
                if not _chain_clear(block, protected, [
                        (m.var("mid"), m.op_index("add")),
                        (m.var("mid2"), m.op_index("relu"))]):
                    continue
                conv = m.op("conv")
                inputs = dict(conv.inputs)
                inputs["Bias"] = [m.var("b")]
                attrs = {k: v for k, v in conv.attrs.items()
                         if not k.startswith("__")}
                idxs = m.op_indices()
                for i in reversed(idxs):
                    block.remove_op(i)
                block.insert_op(idxs[0], "fusion_seqconv_eltadd_relu",
                                inputs=inputs,
                                outputs={"Out": [m.var("out")]},
                                attrs=attrs)
                for label in ("mid", "mid2"):
                    block.vars.pop(m.var(label), None)
                changed = True
    program._bump_version()
    return program


@register_pass("fuse_elewise_add_act")
def _fuse_elewise_add_act(program, scope=None, **kwargs):
    """elementwise_add + activation -> fused_elemwise_activation
    (fuse_elewise_add_act_pass.cc role), forward and backward.

    The fused op exports the sum as IntermediateOut under the add
    output's name, so its other readers keep resolving. The grad pair
    act_grad + elementwise_add_grad collapses into one synthesized
    fused_elemwise_activation_grad when the intermediate gradient flows
    nowhere else; the executor's forward tape pairs it with the fused
    op (``BlockLowerer.grad_pairs``)."""
    acts = ("relu", "tanh", "sigmoid", "gelu")
    for block in program.blocks:
        changed = True
        while changed:
            changed = False
            pat = GraphPatternDetector()
            pat.op("add", "elementwise_add",
                   inputs={"X": "x", "Y": "y"}, outputs={"Out": "mid"})
            pat.op("act", acts, inputs={"X": "mid"}, outputs={"Out": "out"})
            for m, live in _live_matches(pat, block):
                if not live:
                    changed = True
                    continue
                act_type = m.op("act").type
                add_op = m.op("add")
                axis = add_op.attrs.get("axis", -1)
                i_add, i_act = m.op_index("add"), m.op_index("act")
                for i in sorted((i_add, i_act), reverse=True):
                    block.remove_op(i)
                block.insert_op(
                    i_add, "fused_elemwise_activation",
                    inputs={"X": [m.var("x")], "Y": [m.var("y")]},
                    outputs={"Out": [m.var("out")],
                             "IntermediateOut": [m.var("mid")]},
                    attrs=dict(
                        _role_attrs(add_op),
                        functor_list=["elementwise_add", act_type],
                        axis=axis, save_intermediate_out=True))
                _fuse_add_act_grad_pair(block, m, act_type, axis)
                changed = True
    program._bump_version()
    return program


def _role_attrs(src_op):
    """The OpRole (and role-var) attrs of a replaced op, carried onto its
    fused replacement."""
    from paddle_tpu_torch.framework import (
        OP_ROLE_ATTR_NAME,
        OP_ROLE_VAR_ATTR_NAME,
    )

    return {k: src_op.attrs[k] for k in (OP_ROLE_ATTR_NAME,
                                         OP_ROLE_VAR_ATTR_NAME)
            if k in src_op.attrs}


def _fuse_add_act_grad_pair(block, m, act_type, axis):
    """Collapse the backward twin of a fused add + act pair, if present."""
    from paddle_tpu_torch.core.op_registry import ensure_auto_grad_op

    gpat = GraphPatternDetector()
    gpat.op("act_grad", act_type + "_grad",
            inputs={"X": "mid", "Out@GRAD": "dout"},
            outputs={"X@GRAD": "dmid"})
    gpat.op("add_grad", "elementwise_add_grad",
            inputs={"X": "x", "Y": "y", "Out@GRAD": "dmid"})
    for gm in gpat.detect(block):
        if (gm.var("mid") != m.var("mid") or gm.var("x") != m.var("x")
                or gm.var("y") != m.var("y")):
            continue
        # the intermediate gradient must flow nowhere else
        dmid = gm.var("dmid")
        if [i for i, _, _ in consumers(block, dmid)] != [
                gm.op_index("add_grad")]:
            continue
        add_g = gm.op("add_grad")
        dx, dy = add_g.output("X@GRAD"), add_g.output("Y@GRAD")
        ensure_auto_grad_op("fused_elemwise_activation")
        i_ag, i_eg = gm.op_index("act_grad"), gm.op_index("add_grad")
        for i in sorted((i_ag, i_eg), reverse=True):
            block.remove_op(i)
        outputs = {}
        if any(dx):
            outputs["X@GRAD"] = dx
        if any(dy):
            outputs["Y@GRAD"] = dy
        block.insert_op(
            i_ag, "fused_elemwise_activation_grad",
            inputs={"X": [gm.var("x")], "Y": [gm.var("y")],
                    "Out": [m.var("out")], "Out@GRAD": [gm.var("dout")]},
            outputs=outputs,
            attrs=dict(_role_attrs(add_g),
                       functor_list=["elementwise_add", act_type],
                       axis=axis, save_intermediate_out=True))
        block.vars.pop(dmid, None)
        return


@register_pass("delete_dropout")
def _delete_dropout(program, scope=None, **kwargs):
    """Neutralize inference-mode dropout (the identity at is_test with
    upscale_in_train), in every block: later readers read the dropout's
    input, and the op becomes an ``assign``, so fetching the old output
    name still works. The dead Mask var is dropped."""
    for block in program.blocks:
        for i, op in enumerate(block.ops):
            if not (op.type == "dropout"
                    and op.attrs.get("is_test", False)
                    and op.attrs.get("dropout_implementation")
                    == "upscale_in_train"):
                continue
            src, dst = op.input("X")[0], op.output("Out")[0]
            for mask in op.output("Mask"):
                block.vars.pop(mask, None)
            for later in block.ops[i + 1:]:
                for slot, names in list(later.inputs.items()):
                    later.inputs[slot] = [src if n == dst else n
                                          for n in names]
            op.type = "assign"
            op.inputs = {"X": [src]}
            op.outputs = {"Out": [dst]}
    program._bump_version()
    return program
