"""The port's public surface against the committed ``API.spec``: the twin
of ``tests/test_api_spec.py``.

``tools/print_signatures.py`` walks its ``MODULES`` with the package
prefix swapped to ``paddle_tpu_torch``; each spec line must come back
equal (the prefix swapped back), or stand in the explicit lists of
allowed absences below, each entry under the ROADMAP queue A item that
ports it. An entry whose line now matches fails the test too: the slice
that ports it removes its entry. Neither ``API.spec`` nor the tool is
edited. The package's top-level names (which the spec does not walk) are
held to the names ``paddle_tpu/__init__.py`` binds, read with ``ast``.
"""

import ast
import inspect
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import print_signatures  # noqa: E402

MODULES = list(print_signatures.MODULES)

# Modules of the spec that the port does not have yet: module -> A item.
MISSING_MODULES = {
    "paddle_tpu.analysis.liveness": "A item 6",
    "paddle_tpu.analysis.shard_check": "A item 6",
    "paddle_tpu.contrib": "A item 8",
    "paddle_tpu.core.lod": "A item 8",
    "paddle_tpu.data_feeder": "A item 8",
    "paddle_tpu.dataset.common": "A item 8",
    "paddle_tpu.debugger": "A item 6",
    "paddle_tpu.elastic.coordinator": "A item 5",
    "paddle_tpu.elastic.reshard": "A item 7",
    "paddle_tpu.elastic.worker": "A item 7",
    "paddle_tpu.evaluator": "A item 4",
    "paddle_tpu.metrics": "A item 4",
    "paddle_tpu.observability.nan_provenance": "A item 6",
    "paddle_tpu.parallel": "A item 7",
    "paddle_tpu.parallel.mesh": "A item 7",
    "paddle_tpu.parallel.sharding": "A item 7",
    "paddle_tpu.parallel_executor": "A item 7",
    "paddle_tpu.profiler": "A item 6",
    "paddle_tpu.reader.decorator": "A item 8",
    "paddle_tpu.recordio_writer": "A item 8",
    "paddle_tpu.resilience.checkpoint": "A item 5",
    "paddle_tpu.resilience.session": "A item 6",
    "paddle_tpu.serving.snapshot": "A item 5",
}

# Names of modules the port has, whose spec lines it lacks: qualified
# name -> A item (the items of ROADMAP.md's queue A, by their number in
# the list, not by the A1-A11 labels).
MISSING_NAMES = {
    "paddle_tpu.analysis.analyze_liveness": "A item 6",
    "paddle_tpu.analysis.check_sharding": "A item 6",
    "paddle_tpu.analysis.lint_concurrency_paths": "A item 6",
    "paddle_tpu.analysis.lint_concurrency_source": "A item 6",
    "paddle_tpu.analysis.lint_events": "A item 6",
    "paddle_tpu.analysis.lint_program": "A item 6",
    "paddle_tpu.analysis.lint.RULES": "A item 6",
    "paddle_tpu.analysis.lint.lint": "A item 6",
    "paddle_tpu.analysis.lint.lint_events": "A item 6",
    "paddle_tpu.executor.FetchHandle": "A item 6",
    "paddle_tpu.framework.Program.derive_sharding": "A item 7",
    "paddle_tpu.framework.Program.memory_plan": "A item 6",
    "paddle_tpu.io.load_compiled_inference_model": "A item 8",
    "paddle_tpu.io.save_compiled_inference_model": "A item 8",
    "paddle_tpu.io.load_sharded_persistables": "A item 7",
    "paddle_tpu.io.save_sharded_persistables": "A item 7",
    "paddle_tpu.io.save_checkpoint": "A item 7",
    "paddle_tpu.layers.attention.label_smooth": "A item 3",
    "paddle_tpu.layers.attention.rotary_position_embedding": "A item 3",
    "paddle_tpu.layers.io.Preprocessor": "A item 8",
    "paddle_tpu.layers.io.Preprocessor.block": "A item 8",
    "paddle_tpu.layers.io.Preprocessor.inputs": "A item 8",
    "paddle_tpu.layers.io.Preprocessor.outputs": "A item 8",
    "paddle_tpu.layers.io.batch": "A item 8",
    "paddle_tpu.layers.io.double_buffer": "A item 8",
    "paddle_tpu.layers.io.open_files": "A item 8",
    "paddle_tpu.layers.io.open_recordio_file": "A item 8",
    "paddle_tpu.layers.io.py_reader": "A item 8",
    "paddle_tpu.layers.io.read_file": "A item 8",
    "paddle_tpu.layers.io.shuffle": "A item 8",
    "paddle_tpu.layers.nn.Print": "A item 3",
    "paddle_tpu.layers.tensor.create_global_var": "A item 3",
    "paddle_tpu.layers.tensor.create_tensor": "A item 3",
    "paddle_tpu.layers.tensor.has_inf": "A item 3",
    "paddle_tpu.layers.tensor.has_nan": "A item 3",
    "paddle_tpu.layers.tensor.isfinite": "A item 3",
    "paddle_tpu.layers.tensor.load": "A item 3",
    "paddle_tpu.layers.tensor.sum": "A item 3",
}
# observability.memory's ledger and plan
MISSING_NAMES.update(
    ("paddle_tpu.observability.memory." + n, "A item 6") for n in (
        "ENABLED", "KINDS", "MemoryPlan", "MemoryPlan.as_dict",
        "MemoryPlan.top", "RULE", "RULE_NAME", "drop", "enable",
        "enrich_and_raise", "last_plan", "live_by_device", "live_by_kind",
        "live_bytes", "plan_program", "predicted_peak", "register_plan",
        "reset", "take_step_peak", "top_holders", "track",
        "track_state_sharded",))

# Lines that differ on purpose (ROADMAP.md, "Deliberate differences"):
# qualified name -> the parameters the port adds after every one of the
# JAX package's.
DELIBERATE = {
    "paddle_tpu.serving.generation.SlotDecodeSession.generate":
        ", prefix_tokens=None",
}

# Names ``paddle_tpu/__init__.py`` binds that the port's package lacks:
# name -> A item.
MISSING_TOP_LEVEL = {
    "metrics": "A item 4", "evaluator": "A item 4", "average": "A item 4",
    "recordio_writer": "A item 8", "DataFeeder": "A item 8",
    "contrib": "A item 8", "DistributeTranspiler": "A item 8",
    "DistributeTranspilerConfig": "A item 8",
    "LoDTensor": "A item 8", "create_lod_tensor": "A item 8",
    "create_random_int_lodtensor": "A item 8", "SelectedRows": "A item 8",
    "Tensor": "A item 8",
    "profiler": "A item 6", "debugger": "A item 6", "memory_optimize": "A item 6",
    "release_memory": "A item 6",
    "ParallelExecutor": "A item 7", "BuildStrategy": "A item 7",
    "ExecutionStrategy": "A item 7", "elastic": "A item 7",
}

A_ITEMS = {"A item %d" % i for i in range(2, 9)}


def _spec_lines():
    with open(os.path.join(REPO, "API.spec")) as f:
        return [line for line in f.read().splitlines()
                if line.strip() and not line.lstrip().startswith("#")]


def _port_lines(monkeypatch):
    """The port's spec lines, walked module by module (a module the port
    lacks gives none), with the prefix swapped back."""
    lines = set()
    for mod in MODULES:
        port_mod = "paddle_tpu_torch" + mod[len("paddle_tpu"):]
        monkeypatch.setattr(print_signatures, "MODULES", [port_mod])
        try:
            got = list(print_signatures.iter_spec())
        except ModuleNotFoundError as e:
            if not port_mod.startswith(e.name):
                raise
            continue
        lines.update(line.replace("paddle_tpu_torch", "paddle_tpu")
                     for line in got)
    return lines


def _module_of(qual):
    mods = [m for m in MODULES if qual.startswith(m + ".")]
    return max(mods, key=len)


def _allowed(qual):
    mod = _module_of(qual)
    if mod in MISSING_MODULES:
        return MISSING_MODULES[mod]
    return MISSING_NAMES.get(qual)


@pytest.fixture(scope="module")
def port_lines():
    mp = pytest.MonkeyPatch()
    try:
        return _port_lines(mp)
    finally:
        mp.undo()


def test_allowed_absences_name_a_later_item():
    for table in (MISSING_MODULES, MISSING_NAMES, MISSING_TOP_LEVEL):
        for name, item in table.items():
            assert item in A_ITEMS, (name, item)


def test_port_spec_lines_match_api_spec(port_lines):
    spec = _spec_lines()
    missing, stale = [], []
    for line in spec:
        qual = line.split(" ", 1)[0]
        item = _allowed(qual)
        if line in port_lines:
            if item is not None:
                stale.append((line, item))
            continue
        if qual in DELIBERATE:
            continue
        if item is None:
            missing.append(line)
    assert not missing, "spec lines the port lacks, in no A item:\n  " + \
        "\n  ".join(missing[:30])
    assert not stale, "allowed absences the port now has (remove them):" \
        "\n  " + "\n  ".join("%s (%s)" % s for s in stale[:30])
    matched = sum(1 for line in spec if line in port_lines)
    assert matched >= 592, matched


def test_deliberate_differences_add_only_trailing_parameters(port_lines):
    spec = {line.split(" ", 1)[0]: line for line in _spec_lines()}
    port = {line.split(" ", 1)[0]: line for line in port_lines}
    for qual, extra in DELIBERATE.items():
        want = spec[qual]
        assert want.endswith(")")
        assert port[qual] == want[:-1] + extra + ")", (port[qual], want)


def _reference_top_level():
    with open(os.path.join(REPO, "paddle_tpu", "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names += [a.asname or a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets]
    return [n for n in names if not n.startswith("_")]


def test_top_level_names():
    import paddle_tpu_torch as fluid

    lacking = [n for n in _reference_top_level()
               if not hasattr(fluid, n) and n not in MISSING_TOP_LEVEL]
    assert not lacking, lacking
    stale = [n for n in MISSING_TOP_LEVEL if hasattr(fluid, n)]
    assert not stale, stale


def test_c1_names():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import backward, framework, layers
    from paddle_tpu_torch.core import types
    from paddle_tpu_torch.param_attr import WeightNormParamAttr

    assert fluid.append_backward is backward.append_backward
    assert fluid.calc_gradient is backward.calc_gradient
    assert fluid.Place is types.Place and fluid.VarType is types.VarType
    assert fluid.learning_rate_decay is layers.learning_rate_scheduler
    assert fluid.CUDAPinnedPlace is types.CUDAPinnedPlace
    assert isinstance(types.core_version(), str)
    assert fluid.WeightNormParamAttr is WeightNormParamAttr
    assert WeightNormParamAttr(dim=1, name="w").dim == 1
    assert layers.nn.log is layers.ops.log
    for name in ("name_scope", "cpu_places", "tpu_places"):
        assert getattr(fluid, name) is getattr(framework, name)
    assert framework.cpu_places(2) == [fluid.CPUPlace(0), fluid.CPUPlace(1)]
    assert framework.tpu_places([0]) == [fluid.CUDAPlace(0)]
    with framework.name_scope("enc"):
        pass
    for cls, names in ((framework.Block, ("has_var_recursive", "rename_var",
                                          "prepend_op", "iter_parameters")),
                       (framework.Program, ("create_block", "rollback")),
                       (framework.Variable, ("astype",))):
        for n in names:
            assert callable(getattr(cls, n, None)), (cls, n)


def test_slot_decode_session_signature():
    from paddle_tpu_torch.serving.generation import SlotDecodeSession

    params = list(inspect.signature(SlotDecodeSession.__init__).parameters)
    tail = params[params.index("prefix_cache_pages"):]
    assert tail == ["prefix_cache_pages", "degradation", "beam_width",
                    "speculative", "decoder_cfg"], tail
    # beam sessions are ported: a paged beam session builds (its init
    # and copy-on-write programs run) with its lanes free, and a
    # mis-built one raises the JAX package's ValueErrors
    import paddle_tpu_torch as fluid

    with pytest.raises(ValueError, match="paged=True"):
        SlotDecodeSession(None, 2, beam_width=4)
    with pytest.raises(ValueError, match="tile"):
        SlotDecodeSession(None, 6, beam_width=4, paged=True)
    sess = SlotDecodeSession(
        fluid.Executor(fluid.CPUPlace()), 4, max_length=8, d_model=16,
        paged=True, page_size=4, beam_width=2, scope=fluid.Scope(),
        src_vocab_size=10, trg_vocab_size=10, n_layer=1, n_head=2,
        d_inner=32)
    assert (sess.beam_width, sess.free_beams, sess.active_beams) == (
        2, 2, [])
