"""The last op types of the port (``print``, ``load``, ``save``,
``save_combine``, ``load_combine``, ``fused_elemwise_activation``,
``label_smooth``, ``rotary_embedding``), their layers and the two passes
(``fuse_elewise_add_act``, ``delete_dropout``), held against the JAX
package on the CPU.

- every case builds one program through the same layers in both
  packages (names minted alike) and compares what the runs give:
  outputs within 1e-5 of the largest value, files bit-equal with the
  same dtypes, the text ``print`` writes equal to ``jax.debug.print``'s;
- the twins of ``tests/test_layers_misc.py``'s Print / crop / sum /
  load / save / save_combine cases, ``tests/test_attention.py``'s RoPE
  properties, ``tests/test_graph_pattern.py``'s fuse cases and
  ``tests/test_passes.py``'s delete_dropout case; the fused grad op is
  paired with its forward on the forward tape (no rerun);
- a captured ``run_multi_step`` refuses the host I/O ops by name, and
  the eager loop runs them.
"""

import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.passes import apply_pass as j_apply_pass
from paddle_tpu.layer_helper import LayerHelper as JHelper
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.core.passes import apply_pass as t_apply_pass
from paddle_tpu_torch.layer_helper import LayerHelper as THelper
from paddle_tpu_torch.testing import fresh_state

PKGS = {"jax": (jfluid, j_unique_name, JHelper, j_apply_pass),
        "torch": (tfluid, t_unique_name, THelper, t_apply_pass)}


@pytest.fixture(autouse=True)
def _fresh():
    with fresh_state():
        yield


def _build(pkg, net, seed=7):
    fw, names = PKGS[pkg][0], PKGS[pkg][1]
    main, startup = fw.Program(), fw.Program()
    main.random_seed = startup.random_seed = seed
    with names.guard({}), fw.program_guard(main, startup):
        fetch = net(pkg)
    return main, startup, list(fetch)


def _exe(pkg):
    fw = PKGS[pkg][0]
    return fw.Executor(fw.CPUPlace())


def _twin(net, feed=None, steps=1, passes=()):
    """Run ``net`` in both packages (the port's parameters copied from
    the JAX run's startup) for ``steps`` runs; returns {pkg: [fetches of
    every run]}."""
    out, jparams = {}, None
    for pkg in ("jax", "torch"):
        main, startup, fetch = _build(pkg, net)
        for p in passes:
            PKGS[pkg][3](main, p)
        exe = _exe(pkg)
        scope = PKGS[pkg][0].global_scope()
        exe.run(startup)
        params = [p.name for p in main.global_block().all_parameters()]
        if pkg == "jax":
            jparams = {n: np.asarray(scope.get_value(n)) for n in params}
        else:
            params_from_numpy(main, scope, jparams, "cpu")
        runs = []
        for i in range(steps):
            f = feed(i) if callable(feed) else (feed or {})
            runs.append([np.asarray(v) for v in exe.run(
                main, feed=f, fetch_list=fetch)])
        out[pkg] = runs
    return out


def _close(out, tol=1e-5):
    for jrun, trun in zip(out["jax"], out["torch"]):
        for j, t in zip(jrun, trun):
            assert j.shape == t.shape
            scale = max(1.0, float(np.abs(j).max()) if j.size else 1.0)
            np.testing.assert_allclose(t, j, atol=tol * scale, rtol=0)


def _save_op(pkg, x, path, combine=False):
    helper = PKGS[pkg][2]("save_combine" if combine else "save")
    xs = list(x) if combine else [x]
    outs = [helper.create_variable_for_type_inference("float32")
            for _ in xs]
    helper.append_op(type="save_combine" if combine else "save",
                     inputs={"X": xs}, outputs={"Out": outs},
                     attrs={"file_path": path})
    return outs if combine else outs[0]


# -- tests/test_layers_misc.py twins -----------------------------------------

def test_crop_and_sum_layers():
    x = np.arange(24, dtype="float32").reshape(2, 3, 4)

    def net(pkg):
        L = PKGS[pkg][0].layers
        xv = L.data("x", [3, 4])
        return [L.crop(xv, shape=[1, 2, 3], offsets=[1, 1, 0]),
                L.sum([xv, xv, xv])]

    out = _twin(net, {"x": x})
    _close(out)
    np.testing.assert_allclose(out["torch"][0][0], x[1:2, 1:3, 0:3])
    np.testing.assert_allclose(out["torch"][0][1], 3 * x)


def test_print_layer_passthrough_and_text(capfd):
    x = np.asarray([[1.5, 2.5], [-0.125, 3.0]], "float32")

    def net(pkg):
        L = PKGS[pkg][0].layers
        xv = L.data("x", [2])
        return [L.scale(L.Print(xv, message="dbg"), scale=2.0)]

    texts = {}
    for pkg in ("jax", "torch"):
        main, startup, fetch = _build(pkg, net)
        ops = [op for op in main.global_block().ops if op.type == "print"]
        assert ops and ops[0].attrs["message"] == "dbg"
        capfd.readouterr()
        (out,) = _exe(pkg).run(main, feed={"x": x}, fetch_list=fetch)
        np.testing.assert_allclose(np.asarray(out), 2 * x)
        texts[pkg] = capfd.readouterr().out
    assert texts["torch"] == texts["jax"] and texts["torch"].startswith(
        "dbg [[")


def test_load_layer_roundtrip_and_dtype_cast(tmp_path):
    val = np.arange(6, dtype="float32").reshape(2, 3)
    path = os.path.join(str(tmp_path), "w.npy")
    np.save(path, val)
    ipath = os.path.join(str(tmp_path), "v.npy")
    np.save(ipath, np.asarray([1, 2, 3], np.int32))

    def net(pkg):
        L = PKGS[pkg][0].layers
        return [L.scale(L.load(path), scale=1.0),
                L.load(ipath, dtype="float32")]

    out = _twin(net)
    _close(out)
    np.testing.assert_array_equal(out["torch"][0][0], val)
    assert out["torch"][0][1].dtype == np.float32


def test_load_reads_once_per_program_version(tmp_path):
    """The value a ``load`` read stays until the program is edited, as
    the JAX package's trace-time read: rewriting the file changes
    nothing until then."""
    path = os.path.join(str(tmp_path), "w.npy")
    np.save(path, np.ones(3, "float32"))
    main, startup, (w,) = _build("torch", lambda pkg: [
        PKGS[pkg][0].layers.load(path)])
    exe = _exe("torch")
    (a,) = exe.run(main, fetch_list=[w])
    np.save(path, np.full(3, 5.0, "float32"))
    (b,) = exe.run(main, fetch_list=[w])
    np.testing.assert_array_equal(b, a)
    main._bump_version()
    (c,) = exe.run(main, fetch_list=[w])
    np.testing.assert_array_equal(c, np.full(3, 5.0, "float32"))


def test_save_op_writes_during_execution(tmp_path):
    xv = np.asarray([[1.0, 2.0, 3.0]], "float32")
    saved = {}
    for pkg in ("jax", "torch"):
        path = os.path.join(str(tmp_path), pkg, "ckpt", "h.npy")

        def net(pkg, path=path):
            L = PKGS[pkg][0].layers
            x = L.data("x", [3])
            out = _save_op(pkg, L.scale(x, scale=2.0), path)
            return [L.scale(out, scale=3.0)]

        main, startup, fetch = _build(pkg, net)
        (fv,) = _exe(pkg).run(main, feed={"x": xv}, fetch_list=fetch)
        np.testing.assert_allclose(np.asarray(fv), 6 * xv)
        saved[pkg] = np.load(path)
        # reload in a fresh program through layers.load
        p2, s2, (w,) = _build(pkg, lambda pk, path=path: [
            PKGS[pk][0].layers.load(path)])
        (wv,) = _exe(pkg).run(p2, fetch_list=[w])
        np.testing.assert_array_equal(np.asarray(wv), 2 * xv)
    np.testing.assert_array_equal(saved["torch"], saved["jax"])
    assert saved["torch"].dtype == saved["jax"].dtype


def _sgd_net(path, combine):
    def net(pkg):
        L = PKGS[pkg][0].layers
        x = L.data("x", [6])
        y = L.data("y", [1])
        h1 = L.fc(x, 12, act="relu")
        if combine:
            h2 = L.fc(h1, 12, act="relu")
            _o1, o2 = _save_op(pkg, [h1, h2], path[pkg], combine=True)
            pred = L.fc(o2, 1)  # o1 is checkpoint-only
        else:
            pred = L.fc(_save_op(pkg, h1, path[pkg]), 1)
        loss = L.mean(L.square_error_cost(pred, y))
        PKGS[pkg][0].optimizer.SGD(0.05).minimize(loss)
        return [loss]
    return net


@pytest.mark.parametrize("combine", [False, True])
def test_save_ops_pass_gradients_through(tmp_path, combine):
    """save is the identity in the dataflow (its gradient an assign):
    training through it converges, equal to the JAX package's losses;
    with save_combine only one entry feeds the loss and the other's
    gradient is zeros."""
    path = {pkg: os.path.join(str(tmp_path), pkg, "state")
            for pkg in PKGS}
    rng = np.random.RandomState(1)
    w = rng.randn(6, 1).astype("float32")
    xs = [rng.randn(8, 6).astype("float32") for _ in range(20)]
    out = _twin(_sgd_net(path, combine),
                lambda i: {"x": xs[i], "y": xs[i] @ w}, steps=20)
    _close(out)
    losses = [float(r[0].ravel()[0]) for r in out["torch"]]
    assert losses[-1] < 0.5 * losses[0]
    suffix = ".npz" if combine else ".npy"
    a, b = (np.load(path[p] + suffix) for p in ("jax", "torch"))
    if combine:
        assert a.files == b.files == ["arg_0", "arg_1"]
        a, b = a["arg_1"], b["arg_1"]
    np.testing.assert_allclose(b, a, atol=1e-5 * max(1.0, np.abs(a).max()))


def test_save_combine_load_combine_roundtrip(tmp_path):
    xv = np.asarray([[1.0, 2.0, 3.0, 4.0]], "float32")
    got = {}
    for pkg in ("jax", "torch"):
        path = os.path.join(str(tmp_path), pkg, "bundle")

        def net(pk, path=path):
            L = PKGS[pk][0].layers
            x = L.data("x", [4])
            oa, ob = _save_op(pk, [L.scale(x, scale=2.0),
                                   L.scale(x, scale=-1.0)], path,
                              combine=True)
            return [L.elementwise_add(oa, ob)]

        main, startup, fetch = _build(pkg, net)
        (tv,) = _exe(pkg).run(main, feed={"x": xv}, fetch_list=fetch)
        np.testing.assert_allclose(np.asarray(tv), xv)

        def reload(pk, path=path):
            helper = PKGS[pk][2]("load_combine")
            ra = helper.create_variable_for_type_inference("float32")
            rb = helper.create_variable_for_type_inference("float32")
            helper.append_op(type="load_combine", outputs={"Out": [ra, rb]},
                             attrs={"file_path": path})
            return [ra, rb]

        p2, s2, fetch2 = _build(pkg, reload)
        got[pkg] = [np.asarray(v) for v in _exe(pkg).run(
            p2, fetch_list=fetch2)]
    for j, t in zip(got["jax"], got["torch"]):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(got["torch"][0], 2 * xv)


def test_save_writes_int64_as_the_jax_package_does(tmp_path):
    """An int64 value is written int32, as the JAX package holds it on
    its device, so each package's load reads the other's file alike."""
    xv = np.asarray([[3, -4, 5]], "int64")
    files = {}
    for pkg in ("jax", "torch"):
        path = os.path.join(str(tmp_path), pkg, "i.npy")

        def net(pk, path=path):
            L = PKGS[pk][0].layers
            x = L.data("x", [3], dtype="int64")
            helper = PKGS[pk][2]("save")
            out = helper.create_variable_for_type_inference("int64")
            helper.append_op(type="save", inputs={"X": [x]},
                             outputs={"Out": [out]},
                             attrs={"file_path": path})
            return [out]

        main, startup, fetch = _build(pkg, net)
        _exe(pkg).run(main, feed={"x": xv}, fetch_list=fetch)
        files[pkg] = np.load(path)
    assert files["torch"].dtype == files["jax"].dtype
    np.testing.assert_array_equal(files["torch"], files["jax"])


# -- op-for-op parity of the new types ----------------------------------------

@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid", "gelu"])
def test_fused_elemwise_activation_op(act):
    rng = np.random.RandomState(3)
    x = rng.randn(3, 4, 5).astype("float32")
    y = rng.randn(4, 5).astype("float32")

    def net(pkg):
        L = PKGS[pkg][0].layers
        xv = L.data("x", [4, 5])
        yv = L.data("y", [4, 5], append_batch_size=False)
        helper = PKGS[pkg][2]("fused_elemwise_activation")
        out = helper.create_variable_for_type_inference("float32")
        mid = helper.create_variable_for_type_inference("float32")
        helper.append_op(type="fused_elemwise_activation",
                         inputs={"X": [xv], "Y": [yv]},
                         outputs={"Out": [out], "IntermediateOut": [mid]},
                         attrs={"functor_list": ["elementwise_add", act],
                                "axis": 1})
        return [out, mid]

    out = _twin(net, {"x": x, "y": y})
    _close(out)
    np.testing.assert_allclose(out["torch"][0][1], x + y, rtol=1e-6)


@pytest.mark.parametrize("prior", [False, True])
def test_label_smooth_op(prior):
    rng = np.random.RandomState(4)
    lab = np.eye(6, dtype="float32")[rng.randint(0, 6, 5)]
    dist = rng.dirichlet(np.ones(6)).astype("float32")[None, :]

    def net(pkg):
        L = PKGS[pkg][0].layers
        lv = L.data("lab", [6])
        pd = L.data("dist", [1, 6], append_batch_size=False) \
            if prior else None
        return [L.label_smooth(lv, prior_dist=pd, epsilon=0.1)]

    out = _twin(net, {"lab": lab, "dist": dist})
    _close(out)


@pytest.mark.parametrize("position", [None, 0, 5])
def test_rotary_embedding_op(position):
    rng = np.random.RandomState(20)
    B, H, T, d = 2, 2, 8, 8
    feed = {"q": rng.randn(B, H, T, d).astype("float32"),
            "k": rng.randn(B, H, 3, d).astype("float32")}
    if position is not None:
        feed["pos"] = np.asarray([position], "int64")

    def net(pkg):
        L = PKGS[pkg][0].layers
        qd = L.data("q", shape=[H, T, d])
        kd = L.data("k", shape=[H, 3, d])
        pd = (L.data("pos", shape=[1], dtype="int64",
                     append_batch_size=False)
              if position is not None else None)
        return list(L.rotary_position_embedding(qd, kd, position=pd))

    _close(_twin(net, feed))


def test_rotary_embedding_gradient_and_odd_head_dim():
    """The gradient through RoPE equals the JAX package's (``Position``
    takes none); an odd head dim raises the JAX package's message."""
    rng = np.random.RandomState(21)
    feed = {"q": rng.randn(2, 2, 4, 6).astype("float32"),
            "pos": np.asarray([2], "int64")}

    def net(pkg):
        fw = PKGS[pkg][0]
        L = fw.layers
        qd = L.data("q", shape=[2, 4, 6], stop_gradient=False)
        pd = L.data("pos", shape=[1], dtype="int64",
                    append_batch_size=False)
        qo, ko = L.rotary_position_embedding(qd, qd, position=pd)
        loss = L.reduce_sum(L.elementwise_mul(qo, ko))
        return [loss] + fw.backward.calc_gradient([loss], [qd])

    _close(_twin(net, feed))

    def odd(pkg):
        L = PKGS[pkg][0].layers
        qd = L.data("q", shape=[2, 4, 5])
        return list(L.rotary_position_embedding(qd, qd))

    for pkg in ("jax", "torch"):
        main, startup, fetch = _build(pkg, odd)
        with pytest.raises(Exception, match="even head_dim"):
            _exe(pkg).run(main, feed={
                "q": np.zeros((1, 2, 4, 5), "float32")}, fetch_list=fetch)


def test_rotary_embedding_properties():
    """tests/test_attention.py's RoPE properties on the port: norms kept,
    scores depend on relative position only, an offset reproduces the
    matching slice of a longer rotation."""
    rng = np.random.RandomState(20)
    B, H, T, d = 2, 2, 8, 8
    q = rng.randn(B, H, T, d).astype("float32")
    k = rng.randn(B, H, T, d).astype("float32")

    def run(qv, kv, pos=None):
        def net(pkg):
            L = PKGS[pkg][0].layers
            inputs = dict(q=L.data("q", shape=[H, qv.shape[2], d]),
                          k=L.data("k", shape=[H, kv.shape[2], d]))
            if pos is not None:
                inputs["position"] = L.data(
                    "pos", shape=[1], dtype="int64",
                    append_batch_size=False)
            return list(L.rotary_position_embedding(**inputs))

        main, startup, fetch = _build("torch", net)
        feed = {"q": qv, "k": kv}
        if pos is not None:
            feed["pos"] = np.asarray([pos], "int64")
        return [np.asarray(v) for v in _exe("torch").run(
            main, feed=feed, fetch_list=fetch)]

    q_rot, k_rot = run(q, k)
    np.testing.assert_allclose(np.linalg.norm(q_rot, axis=-1),
                               np.linalg.norm(q, axis=-1), rtol=1e-5)
    s0 = np.einsum("bhtd,bhsd->bhts", q_rot, k_rot)
    q_shift, k_shift = run(q, k, pos=5)
    s5 = np.einsum("bhtd,bhsd->bhts", q_shift, k_shift)
    np.testing.assert_allclose(s5, s0, atol=2e-4, rtol=2e-4)
    q_long = np.concatenate([np.zeros_like(q[:, :, :3]), q], axis=2)
    ql_rot, _ = run(q_long, q_long)
    q_off, _ = run(q, k, pos=3)
    np.testing.assert_allclose(q_off, ql_rot[:, :, 3:], atol=2e-5,
                               rtol=2e-5)


# -- the passes ----------------------------------------------------------------

def _add_act_net(pkg):
    fw = PKGS[pkg][0]
    L = fw.layers
    x = L.data(name="x", shape=[6], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    w = L.create_parameter(shape=[6, 6], dtype="float32", name="w_aa")
    z = L.relu(L.elementwise_add(L.matmul(x, w), x))
    pred = L.fc(input=z, size=1)
    loss = L.mean(L.square_error_cost(pred, y))
    fw.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return [loss]


def _add_act_feeds():
    rng = np.random.RandomState(5)
    feeds = [{"x": rng.rand(4, 6).astype("float32"),
              "y": rng.rand(4, 1).astype("float32")} for _ in range(4)]
    return lambda i: feeds[i]


def test_fuse_elewise_add_act_training_parity():
    """Fused against unfused, and against the JAX package's fused run:
    the op list collapses alike, the losses agree, and the synthesized
    grad op differentiates its forward's tape (no rerun)."""
    ref = _twin(_add_act_net, _add_act_feeds(), steps=4)
    fused = _twin(_add_act_net, _add_act_feeds(), steps=4,
                  passes=("fuse_elewise_add_act",))
    _close(fused)
    for a, b in zip(ref["torch"], fused["torch"]):
        np.testing.assert_allclose(b[0], a[0], rtol=1e-5, atol=1e-6)
    types = {}
    for pkg in PKGS:
        main, startup, (loss,) = _build(pkg, _add_act_net)
        PKGS[pkg][3](main, "fuse_elewise_add_act")
        types[pkg] = [op.type for op in main.block(0).ops]
    assert types["torch"] == types["jax"]
    t = types["torch"]
    assert "fused_elemwise_activation" in t and "relu" not in t
    assert "fused_elemwise_activation_grad" in t and "relu_grad" not in t
    assert t.count("elementwise_add_grad") == 1
    exe = _exe("torch")
    exe.run(startup)
    exe.run(main, feed=_add_act_feeds()(0), fetch_list=[loss])
    assert exe.grad_op_reruns == 0


def test_fuse_keeps_intermediate_consumers_working():
    def net(pkg):
        L = PKGS[pkg][0].layers
        x = L.data(name="x", shape=[4], dtype="float32")
        s = L.elementwise_add(x, x)
        return [L.elementwise_add(L.relu(s), s)]

    feed = {"x": np.array([[-1.0, 2.0, -3.0, 4.0]], dtype="float32")}
    out = _twin(net, feed, passes=("fuse_elewise_add_act",))
    _close(out)
    np.testing.assert_allclose(
        out["torch"][0][0], np.array([[-2.0, 8.0, -6.0, 16.0]], "float32"))


def test_fused_grad_op_keeps_backward_role():
    from paddle_tpu_torch.framework import OP_ROLE_ATTR_NAME

    main, startup, _ = _build("torch", _add_act_net)
    roles = {op.type: op.attrs.get(OP_ROLE_ATTR_NAME)
             for op in main.block(0).ops}
    t_apply_pass(main, "fuse_elewise_add_act")
    for op in main.block(0).ops:
        if op.type == "fused_elemwise_activation":
            assert op.attrs[OP_ROLE_ATTR_NAME] == roles["elementwise_add"]
        if op.type == "fused_elemwise_activation_grad":
            assert (op.attrs[OP_ROLE_ATTR_NAME]
                    == roles["elementwise_add_grad"])


def test_delete_dropout_keeps_fetchable_output(tmp_path):
    def net(pkg):
        L = PKGS[pkg][0].layers
        x = L.data("x", [4])
        h = L.fc(x, 4)
        return [L.dropout(h, 0.5,
                          dropout_implementation="upscale_in_train"), h]

    xb = np.random.RandomState(2).rand(2, 4).astype("float32")
    for pkg in PKGS:
        main, startup, (d, h) = _build(pkg, net)
        test_prog = main.clone(for_test=True)
        exe = _exe(pkg)
        exe.run(startup)
        PKGS[pkg][3](test_prog, "delete_dropout")
        types = [op.type for op in test_prog.global_block().ops]
        assert "dropout" not in types and "assign" in types
        out, hv = exe.run(test_prog, feed={"x": xb}, fetch_list=[d, h])
        np.testing.assert_array_equal(np.asarray(out), np.asarray(hv))
    # Predictor(extra_passes=["delete_dropout"]): outputs bit-equal to the
    # predictor without it
    main, startup, (d, h) = _build("torch", net)
    exe = _exe("torch")
    exe.run(startup)
    tfluid.io.save_inference_model(str(tmp_path), ["x"], [d], exe,
                                   main_program=main)
    from paddle_tpu_torch import inference

    plain = inference.create_paddle_predictor(
        inference.NativeConfig(str(tmp_path), use_tpu=False))
    cfg = inference.AnalysisConfig(str(tmp_path), use_tpu=False,
                                   extra_passes=["delete_dropout"])
    deleted = inference.create_paddle_predictor(cfg)
    ops = [op.type for op in deleted._program.global_block().ops]
    assert "dropout" not in ops
    np.testing.assert_array_equal(deleted.run({"x": xb})[0],
                                  plain.run({"x": xb})[0])


# -- host I/O inside a captured loop -------------------------------------------

def test_captured_loop_refuses_host_io_and_eager_loop_runs_it(tmp_path):
    class Capturer(object):
        def capture(self, body, device):
            class Graph(object):
                def replay(self):
                    body()
            return Graph(), 0

    path = os.path.join(str(tmp_path), "h.npy")

    def net(pkg):
        L = PKGS[pkg][0].layers
        x = L.data("x", [3])
        c = L.create_global_var([1, 3], 0.0, "float32", persistable=True,
                                name="acc")
        nxt = L.elementwise_add(c, x)
        L.assign(nxt, output=c)
        return [L.Print(_save_op(pkg, nxt, path), message="acc")]

    main, startup, fetch = _build("torch", net)
    feed = {"x": np.ones((1, 3), "float32")}
    exe = _exe("torch")
    exe.run(startup)
    exe.graph_capturer = Capturer()
    with pytest.raises(RuntimeError, match="'save'|'print'"):
        exe.run_multi_step(main, 3, feed=feed, fetch_list=fetch)
    exe.graph_capturer = None  # the eager loop
    (out,) = exe.run_multi_step(main, 3, feed=feed, fetch_list=fetch)
    np.testing.assert_array_equal(np.asarray(out), np.full((1, 3), 3.0))
    np.testing.assert_array_equal(np.load(path), np.full((1, 3), 3.0))


def test_new_layers_mint_the_jax_package_names(tmp_path):
    """Every layer this slice adds builds the JAX package's program: the
    same op types, slots, variable names and attrs, and the same
    variables with the same dtypes."""
    path = os.path.join(str(tmp_path), "w.npy")
    np.save(path, np.ones((2, 3), "float32"))

    def net(pkg):
        L = PKGS[pkg][0].layers
        x = L.data("x", [2, 3])
        q = L.data("q", [2, 4, 8])
        t = L.create_tensor("float32")
        g = L.create_global_var([1], 0.5, "float32", persistable=True)
        # (a 64-bit dtype stays 64-bit in the port, as ROADMAP's
        # deliberate differences keep it; the JAX package narrows it)
        outs = [L.Print(x, message="m"), L.Print(x), L.load(path),
                L.load(path, dtype="float16"), L.sum([x, x]), L.sum(x),
                L.isfinite(x), L.has_inf(x), L.has_nan(x),
                L.label_smooth(x, epsilon=0.2),
                L.label_smooth(x, prior_dist=x, epsilon=0.1)]
        outs += list(L.rotary_position_embedding(q, q, base=500.0))
        return outs + [t, g]

    sigs = {}
    for pkg in PKGS:
        main, startup, fetch = _build(pkg, net)
        ops = [(op.type, {k: list(v) for k, v in op.inputs.items() if v},
                {k: list(v) for k, v in op.outputs.items() if v},
                {k: v for k, v in op.attrs.items()
                 if not k.startswith("op_")})
               for prog in (main, startup) for op in prog.global_block().ops]
        names = sorted((v.name, str(v.dtype), v.persistable)
                       for v in main.global_block().vars.values())
        sigs[pkg] = (ops, names, [v.name for v in fetch])
    assert sigs["torch"] == sigs["jax"]
