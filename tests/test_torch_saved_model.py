"""Saved models served by the port, on the CPU:

- the committed ``tests/golden/mnist_saved_model`` (PTPB ``__model__``
  and ``.npy`` parameters, written by the JAX package) through the
  port's ``Executor``, its ``Predictor`` and ``run_native_reference``,
  against ``io_pin.npz`` at the JAX test's tolerance (2e-4 / 2e-5);
- the ``mnist`` entry of ``tests/golden/`` rebuilt through the port as
  ``tests/golden_models.py``'s ``build_golden`` builds it;
- the twin of ``tests/test_attention.py::
  test_transformer_generation_survives_save_load``: a small Transformer
  trained on a copy task, its ``build_inference`` program saved and
  reloaded into a fresh scope, greedy tokens equal to the session's;
- a small Transformer's inference program saved by either package,
  logits within 1e-5 in the other.
"""

import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.models import transformer as j_transformer
from paddle_tpu.testing import set_deterministic_params as j_det
from paddle_tpu_torch import native
from paddle_tpu_torch.inference import NativeConfig, create_paddle_predictor
from paddle_tpu_torch.models import mnist as t_mnist
from paddle_tpu_torch.models import transformer as t_transformer
from paddle_tpu_torch.testing import fresh_state
from paddle_tpu_torch.testing import set_deterministic_params as t_det

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
MODEL_DIR = os.path.join(GOLDEN, "mnist_saved_model")
PIN_RTOL, PIN_ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _pin():
    pin = np.load(os.path.join(MODEL_DIR, "io_pin.npz"))
    feed = {k[len("feed_"):]: pin[k] for k in pin.files
            if k.startswith("feed_")}
    return feed, pin["expected"]


def test_committed_saved_model_serves_via_executor():
    feed, expected = _pin()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    program, feed_names, fetch_vars = tfluid.io.load_inference_model(
        MODEL_DIR, exe, scope=scope)
    assert sorted(feed_names) == sorted(feed)
    assert [v.name for v in fetch_vars] == ["fc_0.tmp_2"]
    (got,) = exe.run(program, feed=feed, fetch_list=fetch_vars, scope=scope)
    np.testing.assert_allclose(got, expected, rtol=PIN_RTOL, atol=PIN_ATOL)


def test_committed_saved_model_serves_via_predictor():
    feed, expected = _pin()
    predictor = create_paddle_predictor(
        NativeConfig(model_dir=MODEL_DIR, use_tpu=False))
    (got,) = predictor.run(feed)
    np.testing.assert_allclose(got, expected, rtol=PIN_RTOL, atol=PIN_ATOL)
    (got2,) = predictor.run_async(feed).result()
    np.testing.assert_array_equal(got2, got)


def test_committed_saved_model_serves_via_cpp():
    if not native.available():
        pytest.skip("native toolchain unavailable: %s"
                    % native.last_error())
    feed, expected = _pin()
    predictor = create_paddle_predictor(
        NativeConfig(model_dir=MODEL_DIR, use_tpu=False))
    got = predictor.run_native_reference(feed)
    np.testing.assert_allclose(got, expected, rtol=PIN_RTOL, atol=PIN_ATOL)


def test_port_reproduces_the_mnist_golden():
    golden = np.load(os.path.join(GOLDEN, "mnist.npz"))
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 11
    with tfluid.unique_name.guard({}), tfluid.program_guard(main, startup):
        _, _, outs = t_mnist.build()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    t_det(main, scope)
    pruned = tfluid.io.prune_program(main.clone(for_test=True), ["pixel"],
                                     [outs["predict"].name])
    (got,) = exe.run(pruned, feed={"pixel": golden["feed_pixel"]},
                     fetch_list=[outs["predict"]], scope=scope)
    np.testing.assert_allclose(got, golden["expected"], rtol=1e-5,
                               atol=1e-6)


VOCAB, SEQ = 24, 8
CFG = dict(src_vocab_size=VOCAB, trg_vocab_size=VOCAB, max_length=SEQ,
           n_layer=1, n_head=2, d_model=32, d_inner=64)


def _copy_task_batch(rng, bs):
    """Target = source; the decoder reads it shifted behind bos = 1."""
    src = rng.randint(3, VOCAB, (bs, SEQ)).astype("int64")
    lens = np.full((bs, 1), SEQ, "int64")
    trg_in = np.concatenate([np.ones((bs, 1), "int64"), src[:, :-1]], 1)
    return {"src_word": src, "src_len": lens, "trg_word": trg_in,
            "trg_len": lens, "label": src.copy()}


def test_transformer_generation_survives_save_load(tmp_path):
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 15
    with tfluid.program_guard(main, startup):
        loss, _, extras = t_transformer.build(dropout=0.0,
                                              label_smooth_eps=0.0, **CFG)
        tfluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    infer_prog = t_transformer.build_inference(main, extras["logits"])
    assert "adam" not in [op.type for op in infer_prog.global_block().ops]
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    rng = np.random.RandomState(16)
    for _ in range(80):
        exe.run(main, feed=_copy_task_batch(rng, 16), fetch_list=[loss])
    src = rng.randint(3, VOCAB, (3, SEQ)).astype("int64")
    src_len = np.full((3, 1), SEQ, "int64")
    want = t_transformer.greedy_generate(
        exe, infer_prog, extras["logits"].name, src, src_len, SEQ)
    assert want.shape == (3, SEQ) and (want[:, 0] == 1).all()

    path = str(tmp_path / "nmt")
    tfluid.io.save_inference_model(
        path, ["src_word", "src_len", "trg_word"],
        [infer_prog.global_block().var(extras["logits"].name)], exe,
        main_program=infer_prog)
    exe2 = tfluid.Executor(tfluid.CPUPlace())
    scope2 = tfluid.Scope()
    loaded, feed_names, fetch_vars = tfluid.io.load_inference_model(
        path, exe2, scope=scope2)
    assert feed_names == ["src_word", "src_len", "trg_word"]
    got = t_transformer.greedy_generate(exe2, loaded, fetch_vars[0].name,
                                        src, src_len, SEQ, scope=scope2)
    np.testing.assert_array_equal(got, want)


def _transformer_infer(pkg, path):
    """A small Transformer's inference program with deterministic
    parameters, saved to ``path``; returns (feed, its logits)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    transformer = j_transformer if pkg is jfluid else t_transformer
    if pkg is jfluid:
        j_unique_name.switch({})
        with pkg.program_guard(main, startup):
            _, _, extras = transformer.build(dropout=0.1, **CFG)
    else:
        with tfluid.unique_name.guard({}), pkg.program_guard(main, startup):
            _, _, extras = transformer.build(dropout=0.1, **CFG)
    infer = transformer.build_inference(main, extras["logits"])
    exe = pkg.Executor(pkg.CPUPlace())
    scope = jfluid.executor.Scope() if pkg is jfluid else tfluid.Scope()
    feed = _copy_task_batch(np.random.RandomState(4), 3)
    feed = {k: feed[k] for k in ("src_word", "src_len", "trg_word")}
    feed["src_len"] = np.array([[8], [5], [2]], "int64")
    with pkg.scope_guard(scope):
        exe.run(startup)
        (j_det if pkg is jfluid else t_det)(main, scope)
        (logits,) = exe.run(infer, feed=feed, fetch_list=[extras["logits"]])
        pkg.io.save_inference_model(path, list(feed), [extras["logits"]],
                                    exe, main_program=infer)
    return feed, np.asarray(logits)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_transformer_saved_by_one_package_serves_in_the_other(tmp_path,
                                                              saver):
    if saver == "jax":
        feed, want = _transformer_infer(jfluid, str(tmp_path))
        (got,) = create_paddle_predictor(NativeConfig(
            model_dir=str(tmp_path), use_tpu=False)).run(feed)
    else:
        feed, want = _transformer_infer(tfluid, str(tmp_path))
        from paddle_tpu.inference import NativeConfig as JConfig
        from paddle_tpu.inference import (
            create_paddle_predictor as j_create,
        )

        (got,) = j_create(JConfig(model_dir=str(tmp_path),
                                  use_tpu=False)).run(feed)
    assert got.shape == (3, SEQ, VOCAB)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
