"""The port's CheckpointManager and ``io`` checkpoints: the twins of
``tests/test_resilience.py``'s manager and ``io.save_checkpoint`` cases,
and checkpoints carried across the two packages.

- save / restore round trip with per-var digests and the executor's RNG
  state; async saves with retention; a corrupt newest serial is
  quarantined and the previous one restores; temp dirs and ``io``'s v1
  marker manifests are skipped; a ``ckpt.write`` fault is counted and
  leaves no serial; ``io.load_checkpoint`` reads the manager's dirs;
- the async writer holds host copies: steps that run on meanwhile do not
  change what it writes;
- a checkpoint the JAX package wrote restores into the port (int64 state
  stays int64) and the next dropout step's loss equals the JAX
  package's, and the reverse: the files carry the JAX package's dtypes.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.resilience.checkpoint import CheckpointManager as JManager
from paddle_tpu_torch.observability.metrics_registry import REGISTRY
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.resilience.checkpoint import (
    CheckpointManager,
    complete_serials,
    read_manifest,
    verify_checkpoint_dir,
)
from paddle_tpu_torch.testing import fresh_state


@pytest.fixture(autouse=True)
def _fresh():
    with fresh_state():
        yield
    chaos.disable()


def _build_model(fw, seed=17, dropout=False):
    main, startup = fw.Program(), fw.Program()
    with fw.unique_name.guard({}), fw.program_guard(main, startup):
        x = fw.layers.data("x", [4], stop_gradient=False)
        y = fw.layers.data("y", [1])
        h = fw.layers.fc(x, 8, act="relu")
        if dropout:
            h = fw.layers.dropout(h, 0.3)
        pred = fw.layers.fc(h, 1)
        loss = fw.layers.mean(fw.layers.square_error_cost(pred, y))
        fw.optimizer.SGD(0.05).minimize(loss)
    main.random_seed = seed
    return main, startup, loss


def _feed_for(step):
    r = np.random.RandomState(1000 + step)
    return {"x": r.rand(8, 4).astype("float32"),
            "y": r.rand(8, 1).astype("float32")}


def _param(main):
    return main.global_block().all_parameters()[0].name


def _value(name):
    v = fluid.global_scope().get_value(name)
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _setup():
    main, startup, loss = _build_model(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    return main, loss, exe


def test_manager_save_restore_roundtrip(tmp_path):
    main, loss, exe = _setup()
    exe.run(main, feed=_feed_for(0), fetch_list=[loss])
    mgr = CheckpointManager(str(tmp_path), executor=exe, main_program=main)
    mgr.save(step=1)
    w_before = _value(_param(main)).copy()
    fluid.global_scope().set_value(_param(main), np.zeros_like(w_before))
    manifest = mgr.restore()
    assert manifest["step"] == 1 and manifest["serial"] == 1
    np.testing.assert_array_equal(w_before, _value(_param(main)))
    m = read_manifest(str(tmp_path / "checkpoint_1"))
    assert m["rng"]["run_counter"] == exe._run_counter
    assert all(v["sha256"] for v in m["vars"].values())
    assert verify_checkpoint_dir(str(tmp_path / "checkpoint_1")) == []


def test_manager_async_save_and_retention(tmp_path):
    main, loss, exe = _setup()
    mgr = CheckpointManager(str(tmp_path), executor=exe,
                            main_program=main, max_to_keep=2)
    for step in range(1, 6):
        exe.run(main, feed=_feed_for(step), fetch_list=[loss])
        mgr.save_async(step)
    mgr.wait()
    assert mgr.last_error is None
    assert complete_serials(str(tmp_path)) == [4, 5]


def test_async_save_writes_the_values_of_its_step(tmp_path):
    """The writer thread gets host copies: the SGD steps that update the
    parameters in place while it writes leave its files as they were."""
    main, loss, exe = _setup()
    sync = CheckpointManager(str(tmp_path / "s"), executor=exe,
                             main_program=main)
    mgr = CheckpointManager(str(tmp_path / "a"), executor=exe,
                            main_program=main)
    exe.run(main, feed=_feed_for(0), fetch_list=[loss])
    sync.save(step=1)
    mgr.save_async(step=1)
    for step in range(1, 4):
        exe.run(main, feed=_feed_for(step), fetch_list=[loss])
    mgr.wait()
    va = read_manifest(str(tmp_path / "a" / "checkpoint_1"))["vars"]
    vs = read_manifest(str(tmp_path / "s" / "checkpoint_1"))["vars"]
    assert {n: v["sha256"] for n, v in va.items()} == {
        n: v["sha256"] for n, v in vs.items()}


def test_restore_skips_and_quarantines_corrupt_latest(tmp_path):
    main, loss, exe = _setup()
    mgr = CheckpointManager(str(tmp_path), executor=exe, main_program=main)
    mgr.save(step=1)
    exe.run(main, feed=_feed_for(1), fetch_list=[loss])
    mgr.save(step=2)
    d2 = tmp_path / "checkpoint_2"
    victim = next(f for f in os.listdir(d2) if f.endswith(".npy"))
    with open(d2 / victim, "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(b"\xff\xff\xff\xff")
    manifest = mgr.restore()
    assert manifest["serial"] == 1
    assert 2 not in complete_serials(str(tmp_path))
    assert [d for d in os.listdir(tmp_path) if ".corrupt-" in d]


def test_restore_ignores_partial_tmp_dir(tmp_path):
    main, loss, exe = _setup()
    mgr = CheckpointManager(str(tmp_path), executor=exe, main_program=main)
    mgr.save(step=3)
    fake = tmp_path / "checkpoint_9.tmp-12345"
    fake.mkdir()
    np.save(fake / "garbage.npy", np.zeros(3))
    assert mgr.restore()["serial"] == 3
    assert complete_serials(str(tmp_path)) == [3]


def test_restore_skips_v1_marker_manifests(tmp_path):
    main, loss, exe = _setup()
    mgr = CheckpointManager(str(tmp_path), executor=exe, main_program=main)
    mgr.save(step=2)
    fluid.io.save_checkpoint(exe, str(tmp_path), main_program=main,
                             serial=9)
    assert mgr.restore()["serial"] == 2
    assert os.path.isdir(tmp_path / "checkpoint_9")
    assert not [d for d in os.listdir(tmp_path) if ".corrupt-" in d]


def test_restore_empty_dir_returns_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "nope"))
    assert mgr.restore() is None
    assert mgr.latest_serial() is None


def test_checkpoint_failure_counted(tmp_path):
    ctr = REGISTRY.counter("paddle_tpu_checkpoint_failures_total",
                           labels=["stage"])
    before = ctr.value(stage="save")
    main, loss, exe = _setup()
    mgr = CheckpointManager(str(tmp_path), executor=exe, main_program=main)
    chaos.configure("io@site=ckpt.write,p=1,n=1")
    try:
        with pytest.raises(IOError):
            mgr.save(step=1)
    finally:
        chaos.disable()
    assert ctr.value(stage="save") == before + 1
    assert complete_serials(str(tmp_path)) == []


def test_io_save_checkpoint_atomic_and_partial_skipped(tmp_path):
    main, loss, exe = _setup()
    ckpt = tmp_path / "ckpt"
    step_dir = fluid.io.save_checkpoint(exe, str(ckpt), main_program=main,
                                        serial=1)
    assert os.path.exists(os.path.join(step_dir, "__manifest__.json"))
    partial = ckpt / "checkpoint_7"
    partial.mkdir()
    np.save(partial / "w.npy", np.zeros(2))
    (ckpt / "checkpoint_8.tmp-999").mkdir()
    assert fluid.io._checkpoint_serials(str(ckpt)) == [1]
    assert fluid.io.load_checkpoint(exe, str(ckpt), main_program=main) == 1


def test_io_load_checkpoint_reads_manager_dirs(tmp_path):
    main, loss, exe = _setup()
    mgr = CheckpointManager(str(tmp_path), executor=exe, main_program=main)
    mgr.save(step=4)
    w = _value(_param(main)).copy()
    fluid.global_scope().set_value(_param(main), np.zeros_like(w))
    assert fluid.io.load_checkpoint(exe, str(tmp_path),
                                    main_program=main) == 4
    np.testing.assert_array_equal(w, _value(_param(main)))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    """Two dropout steps in one package, a checkpoint, a restore into the
    other (parameters, the learning rate and the executor's run
    counter), then the third step's loss in both: equal within 1e-6. An
    int64 var (a step counter) comes back int64 in the port."""
    jmain, jstart, jloss = _build_model(jfluid, dropout=True)
    tmain, tstart, tloss = _build_model(fluid, dropout=True)
    jscope, tscope = JScope(), fluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    texe.run(tstart, scope=tscope)
    for scope in (jscope, tscope):
        scope.set_value("step_counter", np.asarray([7], "int64"))
    src = (jexe, jmain, jloss, jscope) if writer == "jax" else \
        (texe, tmain, tloss, tscope)
    dst = (texe, tmain, tloss, tscope) if writer == "jax" else \
        (jexe, jmain, jloss, jscope)
    if writer == "port":
        # the same starting weights in both
        for p in tmain.global_block().all_parameters():
            tscope.set_value(p.name, torch.from_numpy(
                np.asarray(jscope.get_value(p.name)).copy()))
    for step in range(2):
        src[0].run(src[1], feed=_feed_for(step), fetch_list=[src[2]],
                   scope=src[3])
    manager = JManager if writer == "jax" else CheckpointManager
    manager(str(tmp_path), executor=src[0], scope=src[3]).save(step=2)
    m = read_manifest(str(tmp_path / "checkpoint_2"))
    assert m["vars"]["step_counter"]["dtype"] in ("int32", "int64")
    restorer = CheckpointManager if writer == "jax" else JManager
    assert restorer(str(tmp_path), executor=dst[0],
                    scope=dst[3]).restore()["serial"] == 2
    assert dst[0]._run_counter == src[0]._run_counter
    if writer == "jax":
        assert tscope.get_value("step_counter").dtype == np.int64
    (a,) = src[0].run(src[1], feed=_feed_for(2), fetch_list=[src[2]],
                      scope=src[3])
    (b,) = dst[0].run(dst[1], feed=_feed_for(2), fetch_list=[dst[2]],
                      scope=dst[3])
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-6)
