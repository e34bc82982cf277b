"""PTPB program bytes of the port (``paddle_tpu_torch/core/program_bin.py``)
against the JAX package's (``paddle_tpu/core/program_bin.py``):

- the same program built through both packages (names reset) serializes
  to identical bytes: MNIST, a small Transformer, a small stacked LSTM
  and an MLP, each with its loss and accuracy head, and three of them
  with Adam's backward and update ops too;
- bytes of either package deserialize in the port and serialize back to
  themselves;
- the committed ``tests/golden/mnist_saved_model/__model__`` deserializes
  in the port to the JAX package's ops (types, slots, attrs) and vars.
"""

import os

import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core import program_bin as j_bin
from paddle_tpu_torch.core import program_bin as t_bin
from paddle_tpu_torch.testing import fresh_state

MODEL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                     "mnist_saved_model", "__model__")


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _model(pkg, name):
    return __import__(pkg.__name__ + ".models." + name, fromlist=[name])


def _mlp(pkg):
    x = pkg.layers.data(name="x", shape=[12], dtype="float32")
    y = pkg.layers.data(name="y", shape=[1], dtype="int64")
    h = pkg.layers.fc(input=x, size=24, act="relu")
    pred = pkg.layers.fc(input=h, size=3, act="softmax")
    pkg.layers.accuracy(input=pred, label=y)
    return pkg.layers.mean(pkg.layers.cross_entropy(input=pred, label=y))


def _mnist(pkg):
    return _model(pkg, "mnist").build()[0]


def _transformer(pkg):
    return _model(pkg, "transformer").build(
        src_vocab_size=24, trg_vocab_size=24, max_length=8, n_layer=1,
        n_head=2, d_model=32, d_inner=64, dropout=0.1,
        label_smooth_eps=0.1)[0]


def _stacked_lstm(pkg):
    return _model(pkg, "stacked_lstm").build(
        seq_len=16, dict_size=200, emb_dim=16, hid_dim=16, stacked_num=2)[0]


BUILDS = {"mlp": _mlp, "mnist": _mnist, "transformer": _transformer,
          "stacked_lstm": _stacked_lstm}


def _program(pkg, name, adam):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup):
        loss = BUILDS[name](pkg)
        if adam:
            pkg.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main


def _both(name, adam):
    j_unique_name.switch({})
    jprog = _program(jfluid, name, adam)
    with tfluid.unique_name.guard({}):
        tprog = _program(tfluid, name, adam)
    return jprog, tprog


CASES = [(n, False) for n in BUILDS] + [
    ("mlp", True), ("mnist", True), ("stacked_lstm", True)]


@pytest.mark.parametrize("name,adam", CASES)
def test_same_program_same_bytes(name, adam):
    jprog, tprog = _both(name, adam)
    jbytes = j_bin.serialize_program(jprog)
    tbytes = t_bin.serialize_program(tprog)
    assert len(jbytes) > 1000
    assert tbytes == jbytes


@pytest.mark.parametrize("name", sorted(BUILDS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_round_trip_through_the_port(name, writer):
    jprog, tprog = _both(name, False)
    data = (j_bin.serialize_program(jprog) if writer == "jax"
            else t_bin.serialize_program(tprog))
    back = t_bin.deserialize_program(data)
    assert isinstance(back, tfluid.Program)
    assert t_bin.serialize_program(back) == data
    gb = back.global_block()
    assert [op.type for op in gb.ops] == [
        op.type for op in tprog.global_block().ops]
    params = sorted(p.name for p in gb.all_parameters())
    assert params == sorted(p.name for p in
                            tprog.global_block().all_parameters())
    assert all(gb.vars[p].persistable for p in params)


def test_committed_model_deserializes_to_the_jax_ops():
    with open(MODEL, "rb") as f:
        data = f.read()
    jprog = j_bin.deserialize_program(data)
    tprog = t_bin.deserialize_program(data)
    jb, tb = jprog.global_block(), tprog.global_block()
    assert [op.type for op in tb.ops] == [op.type for op in jb.ops] == [
        "conv2d", "elementwise_add", "relu", "pool2d",
        "conv2d", "elementwise_add", "relu", "pool2d",
        "mul", "elementwise_add", "softmax"]
    for jop, top in zip(jb.ops, tb.ops):
        assert (top.inputs, top.outputs, top.attrs) == (
            jop.inputs, jop.outputs, jop.attrs)
    assert sorted(tb.vars) == sorted(jb.vars)
    for name, jv in jb.vars.items():
        tv = tb.vars[name]
        assert (tv.shape, tv.dtype, tv.persistable, tv.is_data,
                isinstance(tv, tfluid.Parameter)) == (
            jv.shape, jv.dtype, jv.persistable, jv.is_data,
            isinstance(jv, jfluid.Parameter))
    assert t_bin.serialize_program(tprog) == data


def test_bad_magic_and_version_are_refused():
    with pytest.raises(ValueError, match="bad magic"):
        t_bin.deserialize_program(b"XXXX" + b"\0" * 16)
    with pytest.raises(ValueError, match="unsupported PTPB version"):
        t_bin.deserialize_program(b"PTPB" + b"\x07\0\0\0" + b"\0" * 12)
