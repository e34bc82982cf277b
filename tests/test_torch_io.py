"""The port's ``io`` (``paddle_tpu_torch/io.py``) against the JAX
package's, on the CPU:

- persistables, params (one ``.npy`` each, and one ``.npz`` bundle) and
  numbered checkpoints round trip through the port, values and dtypes
  equal, retention and torn directories handled as in the JAX package;
- a model saved by ``paddle_tpu`` runs in the port, and a model saved by
  the port runs in ``paddle_tpu``, outputs within 1e-5 (an MLP, MNIST
  and a small stacked LSTM, deterministic parameters from each package's
  ``set_deterministic_params``);
- int64 state, which the JAX package stores narrowed to int32, loads as
  int64, the dtype the program declares;
- ``prune_program``'s missing-feed error, ``get_inference_program`` and
  ``get_parameter_value(_by_name)``, whose result is a copy the caller
  owns.
"""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.testing import set_deterministic_params as j_det
from paddle_tpu_torch.testing import fresh_state
from paddle_tpu_torch.testing import set_deterministic_params as t_det

OUT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _mlp(pkg):
    x = pkg.layers.data(name="x", shape=[12], dtype="float32")
    h = pkg.layers.fc(input=x, size=24, act="relu")
    pred = pkg.layers.fc(input=h, size=3, act="softmax")
    rng = np.random.RandomState(1)
    return ["x"], pred, {"x": rng.rand(4, 12).astype("float32")}


def _mnist(pkg):
    m = __import__(pkg.__name__ + ".models.mnist", fromlist=["mnist"])
    _, _, outs = m.build()
    rng = np.random.RandomState(2)
    return (["pixel"], outs["predict"],
            {"pixel": rng.rand(2, 1, 28, 28).astype("float32")})


def _stacked_lstm(pkg):
    m = __import__(pkg.__name__ + ".models.stacked_lstm",
                   fromlist=["stacked_lstm"])
    _, _, outs = m.build(seq_len=16, dict_size=200, emb_dim=16, hid_dim=16,
                         stacked_num=2)
    rng = np.random.RandomState(3)
    return (["words", "length"], outs["predict"], {
        "words": rng.randint(1, 200, (3, 16)).astype("int64"),
        "length": np.array([[16], [9], [4]], "int64")})


MODELS = {"mlp": _mlp, "mnist": _mnist, "stacked_lstm": _stacked_lstm}


def _build(pkg, name):
    """(main, startup, feed names, fetch var, feed), names reset."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    if pkg is jfluid:
        j_unique_name.switch({})
        with pkg.program_guard(main, startup):
            rest = MODELS[name](pkg)
    else:
        with tfluid.unique_name.guard({}), pkg.program_guard(main, startup):
            rest = MODELS[name](pkg)
    return (main, startup) + rest


def _save(pkg, name, path):
    """Build, initialize deterministically, save; returns (feed, the
    saving package's own output)."""
    main, startup, feed_names, fetch, feed = _build(pkg, name)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = jfluid.executor.Scope() if pkg is jfluid else tfluid.Scope()
    with pkg.scope_guard(scope):
        exe.run(startup)
        (j_det if pkg is jfluid else t_det)(main, scope)
        infer = pkg.io.prune_program(main.clone(for_test=True), feed_names,
                                     [fetch.name])
        (want,) = exe.run(infer, feed=feed, fetch_list=[fetch])
        pkg.io.save_inference_model(path, feed_names, [fetch], exe,
                                    main_program=main)
    return feed, np.asarray(want)


def _load_and_run(pkg, path, feed):
    exe = pkg.Executor(pkg.CPUPlace())
    scope = jfluid.executor.Scope() if pkg is jfluid else tfluid.Scope()
    with pkg.scope_guard(scope):
        program, feed_names, fetch_vars = pkg.io.load_inference_model(
            path, exe)
        (got,) = exe.run(program, feed={n: feed[n] for n in feed_names},
                         fetch_list=fetch_vars)
    return np.asarray(got)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("saver", ["jax", "port"])
def test_model_saved_by_one_package_runs_in_the_other(tmp_path, name,
                                                      saver):
    src, dst = (jfluid, tfluid) if saver == "jax" else (tfluid, jfluid)
    path = str(tmp_path / name)
    feed, want = _save(src, name, path)
    with open(os.path.join(path, "__meta__.json")) as f:
        meta = json.load(f)
    assert meta["fetch_names"] and meta["feed_names"]
    got = _load_and_run(dst, path, feed)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=OUT_TOL, atol=OUT_TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_both_packages_write_the_same_files(tmp_path, name):
    for pkg, sub in ((jfluid, "j"), (tfluid, "t")):
        _save(pkg, name, str(tmp_path / sub))
    files = sorted(os.listdir(str(tmp_path / "j")))
    assert files == sorted(os.listdir(str(tmp_path / "t")))
    for fn in files:
        with open(str(tmp_path / "j" / fn), "rb") as a, \
                open(str(tmp_path / "t" / fn), "rb") as b:
            assert a.read() == b.read(), fn


def _train_state(tmp_path):
    """An MLP after 3 Adam steps on the port: (main, scope, feed)."""
    main, startup, _, pred, feed = _build(tfluid, "mlp")
    with tfluid.program_guard(main, startup):
        loss = tfluid.layers.mean(pred)
        tfluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    return main, exe, scope


def _values(main, scope, predicate):
    return {v.name: scope.get_value(v.name).clone()
            for v in main.list_vars()
            if predicate(v) and scope.get_value(v.name) is not None}


@pytest.mark.parametrize("kind,filename", [
    ("persistables", None), ("persistables", "bundle.npz"),
    ("params", None), ("params", "bundle.npz")])
def test_save_load_round_trip(tmp_path, kind, filename):
    main, exe, scope = _train_state(tmp_path)
    save = getattr(tfluid.io, "save_" + kind)
    load = getattr(tfluid.io, "load_" + kind)
    predicate = (tfluid.io.is_persistable if kind == "persistables"
                 else tfluid.io.is_parameter)
    want = _values(main, scope, predicate)
    assert want
    path = str(tmp_path / "vars")
    save(exe, path, main, filename=filename, scope=scope)
    fresh = tfluid.Scope()
    load(exe, path, main, filename=filename, scope=fresh)
    got = _values(main, fresh, predicate)
    assert sorted(got) == sorted(want)
    if kind == "params":
        assert not any(n.startswith("learning_rate") or "moment" in n
                       for n in got)
    for n, t in want.items():
        assert got[n].dtype == t.dtype and got[n].device.type == "cpu"
        assert torch.equal(got[n], t), n


def test_loaded_values_own_their_memory(tmp_path):
    main, exe, scope = _train_state(tmp_path)
    path = str(tmp_path / "vars")
    tfluid.io.save_persistables(exe, path, main, scope=scope)
    fresh = tfluid.Scope()
    tfluid.io.load_persistables(exe, path, main, scope=fresh)
    name = "fc_0.w_0"
    on_disk = np.load(os.path.join(path, name + ".npy"))
    fresh.get_value(name).add_(1.0)  # a run writing the state in place
    np.testing.assert_array_equal(
        np.load(os.path.join(path, name + ".npy")), on_disk)
    value = tfluid.io.get_parameter_value_by_name(name, exe, main,
                                                  scope=fresh)
    value[...] = 0.0
    assert float(fresh.get_value(name).abs().sum()) > 0.0
    np.testing.assert_array_equal(
        tfluid.io.get_parameter_value(main.global_block().var(name), exe,
                                      scope=fresh), on_disk + 1.0)


def test_int64_state_saved_narrowed_loads_as_int64(tmp_path):
    """The JAX package keeps int64 state as int32 (64-bit integers off)
    and saves it so; the port loads it as the int64 the program
    declares."""

    def build(pkg):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            counter = main.global_block().create_var(
                name="counter", shape=[2], dtype="int64", persistable=True)
            pkg.layers.assign(pkg.layers.fill_constant([2], "int64", 41),
                              output=counter)
        return main

    jmain = build(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.executor.Scope()
    path = str(tmp_path / "state")
    with jfluid.scope_guard(jscope):
        jexe.run(jmain)
        jfluid.io.save_persistables(jexe, path, jmain)
    assert np.load(os.path.join(path, "counter.npy")).dtype == np.int32
    tmain = build(tfluid)
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    tfluid.io.load_persistables(texe, path, tmain, scope=tscope)
    val = tscope.get_value("counter")
    assert val.dtype == torch.int64
    assert val.tolist() == [41, 41]


def test_checkpoints_round_trip_and_retention(tmp_path):
    main, exe, scope = _train_state(tmp_path)
    want = _values(main, scope, tfluid.io.is_persistable)
    ckpt = str(tmp_path / "ckpt")
    for serial in range(4):
        step_dir = tfluid.io.save_checkpoint(exe, ckpt, main, scope=scope,
                                             serial=serial,
                                             max_num_checkpoints=2)
        assert os.path.exists(os.path.join(step_dir, "__manifest__.json"))
    assert sorted(os.listdir(ckpt)) == ["checkpoint_2", "checkpoint_3"]
    # a torn write (no manifest) and a temp dir are never candidates
    os.makedirs(os.path.join(ckpt, "checkpoint_9"))
    os.makedirs(os.path.join(ckpt, "checkpoint_10.tmp-1"))
    fresh = tfluid.Scope()
    assert tfluid.io.load_checkpoint(exe, ckpt, main, scope=fresh) == 3
    got = _values(main, fresh, tfluid.io.is_persistable)
    assert sorted(got) == sorted(want)
    for n, t in want.items():
        assert torch.equal(got[n], t), n
    assert tfluid.io.load_checkpoint(exe, str(tmp_path / "none"), main,
                                     scope=fresh) is None


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    main, startup, _, _, _ = _build(jfluid, "mlp")
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.executor.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        j_det(main, scope)
        jfluid.io.save_checkpoint(exe, str(tmp_path), main, serial=5)
    tmain = _build(tfluid, "mlp")[0]
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    assert tfluid.io.load_checkpoint(texe, str(tmp_path), tmain,
                                     scope=tscope) == 5
    for p in tmain.global_block().all_parameters():
        np.testing.assert_array_equal(tscope.get_value(p.name).numpy(),
                                      np.asarray(scope.get_value(p.name)))


def test_prune_program_names_the_missing_feed():
    main, _, _, pred, _ = _build(tfluid, "stacked_lstm")
    with pytest.raises(ValueError, match=r"\['length'\]"):
        tfluid.io.prune_program(main, ["words"], [pred.name])
    pruned = tfluid.io.prune_program(main, ["words", "length"], [pred.name])
    types = [op.type for op in pruned.global_block().ops]
    assert "cross_entropy" not in types and "accuracy" not in types
    assert types[-1] == "softmax"


def test_get_inference_program_matches_the_jax_slice():
    progs = []
    for pkg in (jfluid, tfluid):
        main, _, _, pred, _ = _build(pkg, "mnist")
        progs.append(pkg.io.get_inference_program([pred], main))
    jtypes, ttypes = ([op.type for op in p.global_block().ops]
                      for p in progs)
    assert ttypes == jtypes
    assert progs[1]._is_test and "mean" not in ttypes
