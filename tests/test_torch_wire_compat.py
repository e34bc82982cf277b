"""Wire compatibility across the packages: a ``paddle_tpu`` client
drives a ``paddle_tpu_torch`` frontend, and a ``paddle_tpu_torch``
client drives a ``paddle_tpu`` frontend.

The models are the JAX package's: the demo MLP saved by
``paddle_tpu.serving.loadgen.build_demo_model`` (each package's
``Predictor`` loads the same directory), and a 2-layer, d_model 64
Transformer trained a few Adam steps on a copy task in the JAX package
and carried into the port with ``convert.params_from_numpy``.

Held equal: greedy wire streams of either frontend to the JAX package's
in-process session; ``encode_array``'s bytes in both packages; the class
NAMES of typed errors across the wire; a prediction through the wire to
the serving frontend's own ``run_reference`` (the wire is bit-exact).
Within 1e-6 relative: the port's predictions to the JAX package's on
the same saved model (fp32 products in another order).
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.inference import NativeConfig as JConfig
from paddle_tpu.inference import create_paddle_predictor as j_predictor
from paddle_tpu.models import transformer as j_transformer
from paddle_tpu.serving import client as j_client
from paddle_tpu.serving import loadgen as j_loadgen
from paddle_tpu.serving import server as j_server
from paddle_tpu.serving.frontend import ServingFrontend as JFrontend
from paddle_tpu.serving.generation import SlotDecodeSession as JSession
from paddle_tpu.testing import set_deterministic_params as j_set_params
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.core.scope import Scope as TScope
from paddle_tpu_torch.inference import NativeConfig as TConfig
from paddle_tpu_torch.inference import create_paddle_predictor as t_predictor
from paddle_tpu_torch.models import transformer as t_transformer
from paddle_tpu_torch.serving import client as t_client
from paddle_tpu_torch.serving import server as t_server
from paddle_tpu_torch.serving.frontend import ServingFrontend as TFrontend
from paddle_tpu_torch.serving.generation import SlotDecodeSession as TSession
from paddle_tpu_torch.testing import fresh_state

PRED_RTOL = 1e-6
VOCAB, SEQ, D, S = 24, 8, 64, 4
CFG = dict(src_vocab_size=VOCAB, trg_vocab_size=VOCAB, n_layer=2,
           n_head=2, d_inner=64)
SESSION = dict(num_slots=S, max_length=SEQ, d_model=D, paged=True,
               page_size=4, steps=2, num_groups=2, **CFG)


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


@pytest.fixture(scope="module")
def saved_demo(tmp_path_factory):
    """The demo MLP saved by the JAX package, loaded by both."""
    path = str(tmp_path_factory.mktemp("wire_demo") / "model")
    j_loadgen.build_demo_model(path, train_steps=5)
    with fresh_state():
        tpred = t_predictor(TConfig(model_dir=path, use_tpu=False))
    return {"jax": j_predictor(JConfig(model_dir=path, use_tpu=False)),
            "torch": tpred}


@pytest.fixture(scope="module")
def models():
    """The JAX Transformer trained 30 Adam steps on a copy task, and the
    port's copy of its parameters."""
    def build(pkg, unique_name, transformer):
        main, startup = pkg.Program(), pkg.Program()
        with unique_name.guard({}), pkg.program_guard(main, startup):
            loss, _, _ = transformer.build(
                dropout=0.0, label_smooth_eps=0.0, max_length=SEQ,
                d_model=D, **CFG)
        return main, startup, loss

    jmain, _, _ = build(jfluid, j_unique_name, j_transformer)
    train, train_startup = jfluid.Program(), jfluid.Program()
    with j_unique_name.guard({}), jfluid.program_guard(train, train_startup):
        loss, _, _ = j_transformer.build(
            dropout=0.0, label_smooth_eps=0.0, max_length=SEQ, d_model=D,
            **CFG)
        jfluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(train_startup, scope=jscope)
    j_set_params(jmain, jscope)
    rng = np.random.RandomState(22)
    for _ in range(30):
        src = rng.randint(3, VOCAB, (16, SEQ)).astype("int64")
        trg = np.full_like(src, 1)
        trg[:, 1:] = src[:, :-1]
        jexe.run(train, feed={
            "src_word": src, "src_len": np.full((16, 1), SEQ, "int64"),
            "trg_word": trg, "trg_len": np.full((16, 1), SEQ, "int64"),
            "label": src}, fetch_list=[loss], scope=jscope)
    with fresh_state():
        tmain, _, _ = build(tfluid, t_unique_name, t_transformer)
    tscope = TScope()
    params_from_numpy(tmain, tscope, {
        p.name: np.asarray(jscope.get_value(p.name))
        for p in jmain.global_block().all_parameters()}, "cpu")
    src = np.random.RandomState(7).randint(3, VOCAB, (4, SEQ)).astype(
        "int64")
    src_len = np.asarray([SEQ, 5, SEQ - 1, 3], "int64")
    jexe2 = jfluid.Executor(jfluid.CPUPlace())
    oracle = JSession(jexe2, scope=jscope.new_scope(), **SESSION)
    want = oracle.generate(src, src_len)
    assert len({tuple(r) for r in want}) == len(src)  # sources differ
    return {"jexe": jexe2, "jscope": jscope,
            "texe": tfluid.Executor(tfluid.CPUPlace()), "tscope": tscope,
            "src": src, "src_len": src_len, "want": want}


def _generate(client_mod, addr, src, src_len):
    cl = client_mod.ServingClient(addr)
    try:
        return np.concatenate([cl.generate_full(src[i],
                                                src_len=int(src_len[i]))
                               for i in range(len(src))])
    finally:
        cl.close()


def test_encode_array_bytes_identical():
    for arr in (np.array([1.0, np.float32(np.nan), -np.inf, 3e-41],
                         "float32").reshape(2, 2),
                np.arange(12, dtype="int64").reshape(3, 4),
                np.asarray(2.5, "float64"),
                np.zeros((0, 3), "int32")):
        assert j_client.encode_array(arr) == t_client.encode_array(arr)
        back = t_client.decode_array(j_client.encode_array(arr))
        assert back.dtype == arr.dtype
        assert back.tobytes() == arr.tobytes()


def test_typed_errors_keep_their_class_names():
    for jcls, tcls in ((j_server.QueueFullError, t_server.QueueFullError),
                       (j_server.DeadlineExceededError,
                        t_server.DeadlineExceededError),
                       (j_server.ServerClosedError,
                        t_server.ServerClosedError),
                       (j_client.StreamBrokenError,
                        t_client.StreamBrokenError)):
        wire = j_client.error_to_wire(jcls("x"))
        assert wire == t_client.error_to_wire(tcls("x"))
        assert type(t_client.error_from_wire(wire)) is tcls
        assert type(j_client.error_from_wire(wire)) is jcls


def test_jax_client_drives_torch_frontend(saved_demo, models):
    """predict on the model the JAX package saved, a greedy generate
    and the typed errors, from the JAX package's client."""
    server = t_server.BatchingServer(saved_demo["torch"], max_batch=8,
                                     workers=1)
    sess = TSession(models["texe"], scope=models["tscope"].new_scope(),
                    **SESSION)
    reqs = j_loadgen.demo_requests(6, seed=5)
    with server, TFrontend(server=server, session=sess) as fe:
        cl = j_client.ServingClient(fe.address)
        for req in reqs:
            got = cl.predict(req)
            for g, w in zip(got, server.run_reference(req)):
                np.testing.assert_array_equal(g, w)
            for g, w in zip(got, saved_demo["jax"].run(req)):
                np.testing.assert_allclose(g, np.asarray(w),
                                           rtol=PRED_RTOL, atol=0)
        with pytest.raises(j_server.DeadlineExceededError):
            cl.predict(reqs[0], deadline_s=0.0)
        with pytest.raises(j_server.ServingError, match="unknown method"):
            cl._request(method="nope")
        cl.close()
        wire = _generate(j_client, fe.address, models["src"],
                         models["src_len"])
    np.testing.assert_array_equal(wire, models["want"])
    assert sess.pool_conserved and sess.free_slots == S


def test_torch_client_drives_jax_frontend(saved_demo, models):
    server = j_server.BatchingServer(saved_demo["jax"], max_batch=8,
                                     workers=1)
    sess = JSession(models["jexe"], scope=models["jscope"].new_scope(),
                    **SESSION)
    reqs = j_loadgen.demo_requests(6, seed=5)
    with server, JFrontend(server=server, session=sess) as fe:
        cl = t_client.ServingClient(fe.address)
        for req in reqs:
            got = cl.predict(req)
            for g, w in zip(got, server.run_reference(req)):
                np.testing.assert_array_equal(g, np.asarray(w))
            for g, w in zip(got, saved_demo["torch"].run(req)):
                np.testing.assert_allclose(w, g, rtol=PRED_RTOL, atol=0)
        with pytest.raises(t_server.DeadlineExceededError):
            cl.predict(reqs[0], deadline_s=0.0)
        with pytest.raises(t_server.ServingError, match="unknown method"):
            cl._request(method="nope")
        assert cl.health() == {"server": "healthy", "decode": "healthy"}
        cl.close()
        wire = _generate(t_client, fe.address, models["src"],
                         models["src_len"])
    np.testing.assert_array_equal(wire, models["want"])
