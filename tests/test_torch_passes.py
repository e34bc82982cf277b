"""The port's graph passes (``paddle_tpu_torch/core/graph_pattern.py``,
``core/passes.py``) and ``AnalysisConfig``, on the CPU: the twins of
``tests/test_graph_pattern.py``'s detector, ``fc_fuse`` and recurrence
fusion tests (structure, and outputs equal to the unfused program's),
then ``AnalysisConfig``'s op-type list against the JAX package's on the
same saved stacked-LSTM, GRU and MLP models, outputs within 1e-5 of the
unfused predictor's and of the JAX package's; ``fuse_batch_norm`` and
``seqconv_eltadd_relu_fuse`` change nothing on a program the port runs
and refuse one that holds the op they rewrite. The port has no
``reduce_mean`` layer: its twins reduce with ``mean``."""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.inference import AnalysisConfig as JAnalysisConfig
from paddle_tpu.inference import create_paddle_predictor as j_create
from paddle_tpu.testing import set_deterministic_params as j_det
from paddle_tpu_torch.core.graph_pattern import (
    GraphPatternDetector,
    consumers,
    producer,
)
from paddle_tpu_torch.core.passes import PassManager, apply_pass, list_passes
from paddle_tpu_torch.inference import (
    AnalysisConfig,
    NativeConfig,
    create_paddle_predictor,
)
from paddle_tpu_torch.testing import fresh_state
from paddle_tpu_torch.testing import set_deterministic_params as t_det

OUT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _mlp_infer_program():
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid.layers.fc(input=x, size=16, act="relu")
        out = fluid.layers.fc(input=h, size=4)
        sm = fluid.layers.softmax(out)
    return main, startup, sm


def test_detector_matches_mul_add_chain():
    main, _, _ = _mlp_infer_program()
    pat = GraphPatternDetector()
    pat.op("mul", "mul", inputs={"X": "x", "Y": "w"}, outputs={"Out": "mid"})
    pat.op("add", "elementwise_add",
           inputs={"X": "mid", "Y": "b"}, outputs={"Out": "out"})
    matches = pat.detect(main.block(0))
    assert len(matches) == 2
    m = matches[0]
    assert m.op("mul").type == "mul"
    assert m.var("mid") in m.op("add").input("X")
    assert not set(matches[0].op_indices()) & set(matches[1].op_indices())


def test_detector_edge_constraint_rejects_disconnected():
    main, _, _ = _mlp_infer_program()
    pat = GraphPatternDetector()
    pat.op("mul", "mul", outputs={"Out": "v"})
    pat.op("sm", "softmax", inputs={"X": "v"})
    assert pat.detect(main.block(0)) == []


def test_producer_consumers_helpers():
    main, _, _ = _mlp_infer_program()
    block = main.block(0)
    mul_out = block.ops[0].output("Out")[0]
    i, op = producer(block, mul_out)
    assert op.type == "mul" and i == 0
    assert [c[1].type for c in consumers(block, mul_out)] == [
        "elementwise_add"]


def _run(main, startup, fetch, feed):
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return exe.run(main, feed=feed, fetch_list=[fetch], scope=scope)[0]


def test_fc_fuse_pass_structure_and_numerics():
    feed = {"x": np.random.RandomState(0).rand(5, 8).astype("float32")}
    main, startup, sm = _mlp_infer_program()
    ref = _run(main, startup, sm, feed)
    apply_pass(main, "fc_fuse")
    types = [op.type for op in main.block(0).ops]
    assert types.count("fc") == 2
    assert "mul" not in types and "elementwise_add" not in types
    fcs = [op for op in main.block(0).ops if op.type == "fc"]
    assert fcs[0].attrs["activation_type"] == "relu"
    assert fcs[1].attrs["activation_type"] == ""
    np.testing.assert_allclose(_run(main, startup, sm, feed), ref,
                               rtol=1e-6, atol=1e-6)


def test_fc_fuse_skips_shared_intermediate():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid.layers.fc(input=x, size=4)
        fluid.layers.elementwise_add(fluid.layers.relu(h),
                                     fluid.layers.tanh(h))
    apply_pass(main, "fc_fuse")
    types = [op.type for op in main.block(0).ops]
    # the fc fused; its activation not absorbed (h has two readers)
    assert "fc" in types and "relu" in types and "tanh" in types


def test_fc_fuse_rejects_axis0_bias():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        w = fluid.layers.create_parameter(shape=[4, 4], dtype="float32",
                                          name="w_ax")
        b = fluid.layers.create_parameter(shape=[3], dtype="float32",
                                          name="b_ax")
        fluid.layers.elementwise_add(fluid.layers.mul(x, w), b, axis=0)
    apply_pass(main, "fc_fuse")
    assert "fc" not in [op.type for op in main.block(0).ops]


def test_fc_fuse_interleaved_matches_stay_correct():
    """The twin of test_fuse_interleaved_matches_stay_correct on fc_fuse
    (the port has no fuse_elewise_add_act yet): two mul + add + act
    chains whose activations come in the inverse order of their
    products. The match rewritten second finds its recorded indices
    shifted by the first rewrite; it must be retried on fresh indices,
    not rewritten with stale ones."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        a = fluid.layers.fc(input=x, size=4)          # ops 0, 1
        b = fluid.layers.fc(input=x, size=4)          # ops 2, 3
        r2 = fluid.layers.relu(b)                     # op 4: b's act
        r1 = fluid.layers.tanh(a)                     # op 5: a's act
        out = fluid.layers.elementwise_add(r1, r2)    # op 6: the output
    feed = {"x": np.array([[1.0, -2.0, 3.0, -4.0]], dtype="float32")}
    ref = _run(main, startup, out, feed)
    apply_pass(main, "fc_fuse")
    ops = main.block(0).ops
    assert [op.type for op in ops] == ["fc", "fc", "elementwise_add"]
    assert [op.attrs["activation_type"] for op in ops[:2]] == [
        "tanh", "relu"]
    assert ops[-1].output("Out") == [out.name]
    np.testing.assert_allclose(_run(main, startup, out, feed), ref,
                               rtol=1e-6, atol=1e-6)


def _rnn_infer_program(rnn="lstm"):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 9
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6, 8], dtype="float32")
        if rnn == "lstm":
            proj = fluid.layers.fc(input=x, size=4 * 12, num_flatten_dims=2)
            out, _ = fluid.layers.dynamic_lstm(input=proj, size=4 * 12)
        else:
            proj = fluid.layers.fc(input=x, size=3 * 12, num_flatten_dims=2)
            out = fluid.layers.dynamic_gru(input=proj, size=12)
        final = fluid.layers.mean(out)
    return main, startup, final


@pytest.mark.parametrize("rnn", ["lstm", "gru"])
def test_fc_rnn_fuse_structure_and_numerics(rnn):
    feed = {"x": np.random.RandomState(2).rand(3, 6, 8).astype("float32")}
    main, startup, final = _rnn_infer_program(rnn)
    ref = _run(main, startup, final, feed)
    apply_pass(main, "fc_%s_fuse" % rnn)
    types = [op.type for op in main.block(0).ops]
    assert "fusion_%s" % rnn in types
    assert "mul" not in types and "dynamic_%s" % rnn not in types
    np.testing.assert_allclose(_run(main, startup, final, feed), ref,
                               rtol=1e-5, atol=1e-6)


def test_fc_rnn_fuse_keeps_late_h0_producer_upstream():
    feed = {"x": np.random.RandomState(4).rand(2, 5, 8).astype("float32")}
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 9
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[5, 8], dtype="float32")
        proj = fluid.layers.fc(input=x, size=4 * 6, num_flatten_dims=2)
        h0 = fluid.layers.fill_constant([2, 6], "float32", 0.3)
        c0 = fluid.layers.fill_constant([2, 6], "float32", 0.1)
        out, _ = fluid.layers.dynamic_lstm(input=proj, size=4 * 6, h_0=h0,
                                           c_0=c0)
        final = fluid.layers.mean(out)
    ref = _run(main, startup, final, feed)
    apply_pass(main, "fc_lstm_fuse")
    types = [op.type for op in main.block(0).ops]
    assert "fusion_lstm" in types
    assert types.index("fill_constant") < types.index("fusion_lstm")
    np.testing.assert_allclose(_run(main, startup, final, feed), ref,
                               rtol=1e-5, atol=1e-6)


def test_inference_strategy_orders_rnn_fuse_before_fc_fuse():
    main, _, final = _rnn_infer_program("lstm")
    fused = PassManager(strategy="inference").apply(
        main, feed_names=["x"], fetch_names=[final.name])
    types = [op.type for op in fused.block(0).ops]
    assert "fusion_lstm" in types and "fc" not in types


def test_embedding_fc_lstm_fuse_chain():
    feed = {"ids": np.random.RandomState(6).randint(0, 50, (2, 7)).astype(
        "int64")}
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 21
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[7], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[50, 8])
        proj = fluid.layers.fc(input=emb, size=4 * 6, num_flatten_dims=2)
        out, _ = fluid.layers.dynamic_lstm(input=proj, size=4 * 6)
        final = fluid.layers.mean(out)
    ref = _run(main, startup, final, feed)
    apply_pass(main, "fc_lstm_fuse")
    apply_pass(main, "embedding_fc_lstm_fuse")
    types = [op.type for op in main.block(0).ops]
    assert "fused_embedding_fc_lstm" in types
    assert "lookup_table" not in types and "fusion_lstm" not in types
    np.testing.assert_allclose(_run(main, startup, final, feed), ref,
                               rtol=1e-5, atol=1e-6)


def test_registered_passes():
    assert set(PassManager.STRATEGIES["inference"]) <= set(list_passes())
    with pytest.raises(KeyError, match="unknown pass"):
        PassManager(["memory_optimize"])


@pytest.mark.parametrize("name,op_type,roadmap", [
    ("fuse_batch_norm", "batch_norm", "A4"),
    ("seqconv_eltadd_relu_fuse", "sequence_conv", "A11")])
def test_unported_op_passes(name, op_type, roadmap):
    """A no-op on a program the port runs; a refusal, naming the ROADMAP
    item, on one that holds the op the pass rewrites (here, as the
    deserialized program of a model the JAX package saved would)."""
    main, _, _ = _mlp_infer_program()
    before = [op.type for op in main.block(0).ops]
    assert [op.type for op in apply_pass(main, name).block(0).ops] == before
    main.block(0).ops[-1].type = op_type
    with pytest.raises(NotImplementedError, match=roadmap):
        apply_pass(main, name)


# -- AnalysisConfig against the JAX package on saved models --------------


def _stacked_lstm(pkg):
    m = __import__(pkg.__name__ + ".models.stacked_lstm",
                   fromlist=["stacked_lstm"])
    _, _, outs = m.build(seq_len=12, dict_size=100, emb_dim=16, hid_dim=16,
                         stacked_num=3)
    return ["words", "length"], outs["predict"]


def _gru(pkg):
    """embedding -> fc -> dynamic_gru -> max pool -> fc(softmax): the
    projection fc feeds only the recurrence, so fc_gru_fuse fires."""
    layers = pkg.layers
    words = layers.data(name="words", shape=[12], dtype="int64")
    length = layers.data(name="length", shape=[1], dtype="int64")
    emb = layers.embedding(input=words, size=[100, 16])
    proj = layers.fc(input=emb, size=3 * 16, num_flatten_dims=2)
    hid = layers.dynamic_gru(input=proj, size=16, length=length)
    pooled = layers.sequence_pool(input=hid, pool_type="max", length=length)
    return ["words", "length"], layers.fc(input=pooled, size=2,
                                          act="softmax")


def _mlp(pkg):
    x = pkg.layers.data(name="x", shape=[8], dtype="float32")
    h = pkg.layers.fc(input=x, size=16, act="relu")
    h = pkg.layers.fc(input=h, size=16, act="tanh")
    return ["x"], pkg.layers.fc(input=h, size=4, act="softmax")


MODELS = {"stacked_lstm": _stacked_lstm, "gru": _gru, "mlp": _mlp}

FEEDS = {
    "x": lambda rng: rng.rand(5, 8).astype("float32"),
    "words": lambda rng: rng.randint(1, 100, (4, 12)).astype("int64"),
    "length": lambda rng: np.array([[12], [7], [3], [12]], "int64"),
}

# what the JAX package's AnalysisConfig gives (checked below as well)
FUSED = {
    "stacked_lstm": ["lookup_table", "fc", "dynamic_lstm", "mul", "mul",
                     "sum", "elementwise_add", "dynamic_lstm", "mul", "mul",
                     "sum", "elementwise_add", "dynamic_lstm",
                     "sequence_pool", "sequence_pool", "mul", "mul", "sum",
                     "elementwise_add", "softmax"],
    "gru": ["lookup_table", "fusion_gru", "sequence_pool", "fc", "softmax"],
    "mlp": ["fc", "fc", "fc", "softmax"],
}


def _save_model(name, path):
    """Built and saved by the port with deterministic parameters."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.unique_name.guard({}), fluid.program_guard(main, startup):
        feed_names, fetch = MODELS[name](fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    t_det(main, scope)
    fluid.io.save_inference_model(path, feed_names, [fetch], exe,
                                  main_program=main, scope=scope)
    rng = np.random.RandomState(12)
    return {n: FEEDS[n](rng) for n in feed_names}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_analysis_config_matches_jax(tmp_path, name):
    path = str(tmp_path / name)
    feed = _save_model(name, path)
    port = create_paddle_predictor(AnalysisConfig(model_dir=path,
                                                  use_tpu=False))
    jax_pred = j_create(JAnalysisConfig(model_dir=path, use_tpu=False))
    types = [op.type for op in port._program.global_block().ops]
    assert types == [op.type for op in
                     jax_pred._program.global_block().ops]
    assert types == FUSED[name]
    (got,) = port.run(feed)
    (plain,) = create_paddle_predictor(NativeConfig(
        model_dir=path, use_tpu=False)).run(feed)
    (jgot,) = jax_pred.run(feed)
    np.testing.assert_allclose(got, plain, rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(got, np.asarray(jgot), rtol=OUT_TOL,
                               atol=OUT_TOL)


def test_jax_saved_model_fuses_alike_in_the_port(tmp_path):
    """The GRU model saved by the JAX package: the port's pipeline fuses
    it as the JAX package's does."""
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = startup.random_seed = 11
    j_unique_name.switch({})
    with jfluid.program_guard(main, startup):
        feed_names, fetch = _gru(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.executor.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        j_det(main, scope)
        jfluid.io.save_inference_model(str(tmp_path), feed_names, [fetch],
                                       exe, main_program=main)
    rng = np.random.RandomState(12)
    feed = {n: FEEDS[n](rng) for n in feed_names}
    port = create_paddle_predictor(AnalysisConfig(model_dir=str(tmp_path),
                                                  use_tpu=False))
    assert [op.type for op in port._program.global_block().ops] == \
        FUSED["gru"]
    (want,) = j_create(JAnalysisConfig(model_dir=str(tmp_path),
                                       use_tpu=False)).run(feed)
    np.testing.assert_allclose(port.run(feed)[0], np.asarray(want),
                               rtol=OUT_TOL, atol=OUT_TOL)
