"""The port's Predictor API (``paddle_tpu_torch/inference.py``), the
twin of ``tests/test_inference.py`` on the CPU: config -> predictor ->
run equal to the training executor, ``clone()`` serving from four
threads, the C++ reference interpreter (``native/``, built into the
port's ``_build/``) against the torch path, and ``AnalysisConfig``'s
fc fusion. Then what the port adds: ``run_async(...).result()`` equal to
``run`` bit for bit and ``done()``; ``result(timeout=0)`` raising
``FetchTimeoutError`` on a handle that is not ready (a stub event: on
the CPU a handle is done at once) and answering later; outputs that are
copies the caller owns; the feed and fetch descriptions; and
``NativeConfig(use_tpu=True)`` (the card, the default) raising where
CUDA is absent. ``FLAGS_verify_program`` at load is held in
``tests/test_torch_verify.py``."""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.executor import FetchHandle, FetchTimeoutError
from paddle_tpu_torch.inference import (
    AnalysisConfig,
    NativeConfig,
    create_paddle_predictor,
)
from paddle_tpu_torch.testing import fresh_state


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _train_and_save(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[12], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=24, act="relu")
        pred = fluid.layers.fc(input=h, size=3, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    rng = np.random.RandomState(0)
    base = rng.randn(3, 12).astype("float32")
    with fluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(40):
            lbl = rng.randint(0, 3, 32)
            xb = base[lbl] + 0.2 * rng.randn(32, 12).astype("float32")
            exe.run(main, feed={"x": xb, "y": lbl.reshape(-1, 1)},
                    fetch_list=[loss])
        path = str(tmp_path / "model")
        fluid.io.save_inference_model(path, ["x"], [pred], exe,
                                      main_program=main)
        xb = base[[0, 1, 2]] + 0.1
        (want,) = exe.run(main, feed={"x": xb,
                                      "y": np.zeros((3, 1), "int64")},
                          fetch_list=[pred])
    return path, xb, np.asarray(want)


def _cpu(path, cls=NativeConfig, **kwargs):
    return create_paddle_predictor(cls(model_dir=path, use_tpu=False,
                                       **kwargs))


def test_predictor_matches_executor(tmp_path):
    path, xb, want = _train_and_save(tmp_path)
    predictor = _cpu(path)
    (got,) = predictor.run({"x": xb})
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    (got2,) = predictor.run([xb])  # positional form
    np.testing.assert_allclose(got2, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="expected 1 inputs"):
        predictor.run([xb, xb])


def test_predictor_clone_multithreaded(tmp_path):
    path, xb, want = _train_and_save(tmp_path)
    predictor = _cpu(path)
    results = {}

    def serve(tid):
        p = predictor.clone()
        for _ in range(5):
            (out,) = p.run({"x": xb})
            results.setdefault(tid, []).append(out)

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 4
    for outs in results.values():
        assert len(outs) == 5
        for out in outs:
            np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


def test_cpp_reference_interpreter_matches_torch(tmp_path):
    from paddle_tpu_torch import native

    if not native.available():
        pytest.skip("native toolchain unavailable: %s" % native.last_error())
    path, xb, want = _train_and_save(tmp_path)
    got = _cpu(path).run_native_reference({"x": xb})
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_analysis_predictor_fuses_and_matches(tmp_path):
    path, xb, want = _train_and_save(tmp_path)
    analysis = _cpu(path, AnalysisConfig)
    (got,) = analysis.run({"x": xb})
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    types = [op.type for op in analysis._program.global_block().ops]
    assert "fc" in types and "mul" not in types
    # ir_optim off serves the program as loaded
    plain = _cpu(path, AnalysisConfig, ir_optim=False)
    (got2,) = plain.run({"x": xb})
    np.testing.assert_allclose(got2, want, rtol=1e-5, atol=1e-6)
    assert "mul" in [op.type for op in plain._program.global_block().ops]
    # clone shares the optimized program and the weights
    clone = analysis.clone()
    assert clone._program is analysis._program
    assert clone._scope is analysis._scope
    (got3,) = clone.run({"x": xb})
    np.testing.assert_allclose(got3, want, rtol=1e-5, atol=1e-6)
    config = AnalysisConfig(model_dir=path, use_tpu=False)
    config.switch_ir_optim(False)
    assert "mul" in [op.type for op in create_paddle_predictor(
        config)._program.global_block().ops]


def test_run_async_equals_run(tmp_path):
    path, xb, _ = _train_and_save(tmp_path)
    predictor = _cpu(path)
    (want,) = predictor.run({"x": xb})
    handle = predictor.run_async({"x": xb})
    assert isinstance(handle, FetchHandle) and len(handle) == 1
    assert handle.done()
    assert handle.block_until_ready() is handle
    (got,) = handle.result()
    np.testing.assert_array_equal(got, want)
    assert handle.result() is handle.result()  # memoized
    assert handle.result(timeout=0)[0] is handle.result()[0]
    assert isinstance(handle.arrays()[0], torch.Tensor)
    assert handle.fetch_names == predictor.fetch_names


class _PendingEvent(object):
    """A CUDA event stand-in that reports ready only after ``polls``
    queries."""

    def __init__(self, polls):
        self.polls = polls

    def query(self):
        self.polls -= 1
        return self.polls < 0

    def synchronize(self):
        self.polls = -1


def test_result_timeout_raises_and_leaves_the_handle_usable():
    t = torch.arange(6.0).reshape(2, 3)
    handle = FetchHandle([t], ["out"], event=_PendingEvent(10 ** 6))
    assert not handle.done()
    with pytest.raises(FetchTimeoutError) as info:
        handle.result(timeout=0)
    assert info.value.fetch_names == ["out"] and info.value.timeout == 0.0
    with pytest.raises(FetchTimeoutError):
        handle.result(timeout=0.01)
    handle._event = _PendingEvent(3)
    (got,) = handle.result(timeout=5.0)
    np.testing.assert_array_equal(got, t.numpy())
    handle = FetchHandle([t], ["out"], event=_PendingEvent(10 ** 6))
    handle.block_until_ready()
    assert handle.done()


def test_outputs_are_copies_and_descriptions(tmp_path):
    path, xb, want = _train_and_save(tmp_path)
    predictor = _cpu(path)
    (a,) = predictor.run({"x": xb})
    a[...] = -1.0
    (b,) = predictor.run({"x": xb})
    np.testing.assert_allclose(b, want, rtol=1e-5, atol=1e-6)
    assert predictor.feed_names == ["x"]
    assert predictor.feed_shapes == {"x": (-1, 12)}
    assert predictor.feed_dtypes == {"x": "float32"}
    assert predictor.fetch_names == ["fc_1.tmp_2"]


def test_use_tpu_raises_without_cuda(tmp_path, monkeypatch):
    path, _, _ = _train_and_save(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = NativeConfig(model_dir=path)
    assert config.use_tpu
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_paddle_predictor(config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_paddle_predictor(AnalysisConfig(model_dir=path))


def test_launch_counts_hold_under_threads():
    """Predictor clones launch kernels from several threads at once:
    ``Kernel.launch`` must lose no count (a stub entry point stands in
    for the CUDA one)."""
    import sys

    from paddle_tpu_torch.kernels.build import Kernel

    kernel = Kernel("stub", [])
    kernel._fn = lambda *args: 0
    n_threads, per_thread = 16, 2000

    def work():
        for i in range(per_thread):
            kernel.launch(key=i % 3)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert kernel.launches == n_threads * per_thread
    assert sum(kernel.by_key.values()) == n_threads * per_thread
