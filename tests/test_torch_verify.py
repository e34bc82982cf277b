"""The port's program verifier (``paddle_tpu_torch/analysis/verify.py``)
against the JAX package's (``paddle_tpu/analysis/verify.py``): the same
program, built the same way in both packages, gives equal diagnostics
(rule, name, severity, message, location, vars; the fix hints name each
package's own files). Under ``FLAGS_verify_program`` the port's
``Executor`` verifies on every analysis-cache miss and its ``Predictor``
at load, as the JAX package's do (the twins of
``tests/test_analysis.py`` ``test_verify_flag_gates_executor`` and
``test_transpiler_hook_verifies_output``)."""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.analysis import ProgramVerifyError as JaxVerifyError
from paddle_tpu.core import program_bin as jax_program_bin
from paddle_tpu_torch import flags
from paddle_tpu_torch.analysis import (
    ProgramVerifyError,
    check_program,
    verify_after_transpile,
    verify_program,
)
from paddle_tpu_torch.core import program_bin
from paddle_tpu_torch.inference import NativeConfig, create_paddle_predictor
from paddle_tpu_torch.testing import fresh_state


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield
    flags.set_flag("verify_program", False)
    jfluid.flags.set_flag("verify_program", False)


def _diags(diags):
    """Diagnostics without their fix hints."""
    out = []
    for d in diags:
        row = d.as_dict()
        row.pop("hint")
        out.append(row)
    return out


def _chain(fluid, b):
    b.create_var(name="a", shape=(2,), dtype="float32", is_data=True)
    b.create_var(name="t", shape=(2,), dtype="float32")
    b.create_var(name="o", shape=(2,), dtype="float32")


def _undefined_input(fluid, p, b):
    b.append_op("relu", inputs={"X": ["missing_input"]},
                outputs={"Out": ["o"]}, infer_shape=False)


def _use_before_write(fluid, p, b):
    b.append_op("relu", inputs={"X": ["t"]}, outputs={"Out": ["o"]})
    b.append_op("relu", inputs={"X": ["a"]}, outputs={"Out": ["t"]})


def _duplicate_output(fluid, p, b):
    b.append_op("relu", inputs={"X": ["a"]}, outputs={"Out": ["o", "o"]},
                infer_shape=False)


def _overwritten(fluid, p, b):
    b.append_op("relu", inputs={"X": ["a"]}, outputs={"Out": ["t"]})
    b.append_op("sigmoid", inputs={"X": ["a"]}, outputs={"Out": ["t"]})
    b.append_op("relu", inputs={"X": ["t"]}, outputs={"Out": ["o"]})


def _unknown_op(fluid, p, b):
    b.append_op("relu", inputs={"X": ["a"]}, outputs={"Out": ["o"]})
    b.ops[0].type = "no_such_op"


def _unknown_slot(fluid, p, b):
    b.append_op("relu", inputs={"X": ["a"], "Bogus": ["a"]},
                outputs={"Out": ["o"]}, infer_shape=False)


def _slot_arity(fluid, p, b):
    b.append_op("relu", inputs={"X": ["a", "t"]}, outputs={"Out": ["o"]},
                infer_shape=False)
    b.append_op("relu", inputs={"X": ["a"]}, outputs={"Out": ["t"]})


def _bad_dtype(fluid, p, b):
    b.append_op("relu", inputs={"X": ["a"]}, outputs={"Out": ["o"]})
    b.vars["t"].dtype = "float13"


def _unknown_shape(fluid, p, b):
    b.create_var(name="u", shape=None, dtype="float32", is_data=True)
    b.append_op("relu", inputs={"X": ["u"]}, outputs={"Out": ["o"]},
                infer_shape=False)


def _orphaned_grad(fluid, p, b):
    b.append_op("relu", inputs={"X": ["a"]}, outputs={"Out": ["o"]})
    b.create_var(name="a@GRAD", shape=(2,), dtype="float32")


def _param_rules(fluid, p, b):
    w = b.create_parameter(name="w", shape=(2,), dtype="float32")
    w.persistable = False
    b.append_op("elementwise_add", inputs={"X": ["a"], "Y": ["w"]},
                outputs={"Out": ["o"]})
    sub = fluid.framework.Block(p, 1, 0)
    p.blocks.append(sub)
    sub.vars["pw"] = fluid.framework.Parameter(sub, "pw", (2,), "float32")
    sub.create_var(name="state", shape=(2,), dtype="float32",
                   persistable=True)
    b.append_op("relu", inputs={"X": ["a"]}, outputs={"Out": ["t"]},
                attrs={"sub_block": 7})


CASES = {
    "V001": _undefined_input,
    "V002": _use_before_write,
    "V004": _duplicate_output,
    "V005": _overwritten,
    "V006": _unknown_op,
    "V007": _unknown_slot,
    "V008": _slot_arity,
    "V009": _bad_dtype,
    "V010": _unknown_shape,
    "V012": _orphaned_grad,
    "V013-V016": _param_rules,
}


def _program(fluid, case):
    p = fluid.Program()
    b = p.global_block()
    _chain(fluid, b)
    CASES[case](fluid, p, b)
    return p


@pytest.mark.parametrize("case", sorted(CASES))
def test_diagnostics_equal_the_jax_verifiers(case):
    kw = dict(fetch_names=["o", "nowhere", "t"], feed_shapes={"a": (2,)})
    want = _diags(jfluid.analysis.verify_program(_program(jfluid, case),
                                                 **kw))
    got = _diags(verify_program(_program(tfluid, case), **kw))
    assert got == want
    # Program.verify(level=None) only collects, in both packages
    assert _diags(_program(tfluid, case).verify(level=None, **kw)) == want
    rules = {d["rule"] for d in got}
    first, _, last = case.partition("-")
    want_rules = {"V%03d" % i for i in range(int(first[1:]),
                                             int((last or first)[1:]) + 1)}
    assert want_rules <= rules
    # the gate: the same findings raise, or the same warnings return
    try:
        jfluid.analysis.check_program(_program(jfluid, case), **kw)
        jax_raised = None
    except JaxVerifyError as e:
        jax_raised = _diags(e.diagnostics)
    try:
        check_program(_program(tfluid, case), **kw)
        raised = None
    except ProgramVerifyError as e:
        raised = _diags(e.diagnostics)
    assert raised == jax_raised


def _gate_program(fluid):
    prog = fluid.Program()
    b = prog.global_block()
    b.create_var(name="a", shape=(2,), dtype="float32", is_data=True)
    b.create_var(name="o", shape=(2,), dtype="float32")
    b.append_op("relu", inputs={"X": ["missing_input"]},
                outputs={"Out": ["o"]}, infer_shape=False)
    return prog


def test_verify_flag_gates_executor():
    """Twin of test_analysis.py's: under the flag a broken program fails
    at its first run with the JAX verifier's findings; without the flag
    the same run fails only inside the interpreter."""
    feed = {"a": np.zeros(2, "float32")}
    jfluid.flags.set_flag("verify_program", True)
    with pytest.raises(JaxVerifyError) as jax_err:
        jfluid.Executor(jfluid.CPUPlace()).run(
            _gate_program(jfluid), feed=feed, fetch_list=["o"])
    exe = tfluid.Executor(tfluid.CPUPlace())
    flags.set_flag("verify_program", True)
    with pytest.raises(ProgramVerifyError) as err:
        exe.run(_gate_program(tfluid), feed=feed, fetch_list=["o"])
    assert _diags(err.value.diagnostics) == _diags(jax_err.value.diagnostics)
    assert err.value.origin == "Executor.run"
    with pytest.raises(ProgramVerifyError) as err:
        exe.run_multi_step(_gate_program(tfluid), 2, feed=feed,
                           fetch_list=["o"])
    assert err.value.origin == "Executor.run_multi_step"
    flags.set_flag("verify_program", False)
    with pytest.raises(RuntimeError) as err:
        exe.run(_gate_program(tfluid), feed=feed, fetch_list=["o"])
    assert not isinstance(err.value, ProgramVerifyError)


def test_executor_verifies_once_per_signature(monkeypatch):
    """The verifier runs on a miss of the analysis cache only: a healthy
    program's later runs of the same signature skip it."""
    from paddle_tpu_torch import executor as exe_mod

    calls = []
    real = exe_mod._maybe_verify
    monkeypatch.setattr(exe_mod, "_maybe_verify",
                        lambda *a: calls.append(a[3]) or real(*a))
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4], dtype="float32")
        y = tfluid.layers.fc(input=x, size=3)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    flags.set_flag("verify_program", True)
    exe.run(startup, scope=scope)
    for _ in range(3):
        exe.run(main, feed={"x": np.ones((2, 4), "float32")},
                fetch_list=[y], scope=scope)
    exe.run(main, feed={"x": np.ones((5, 4), "float32")}, fetch_list=[y],
            scope=scope)
    assert calls == ["Executor.run"] * 2


def _sgd_program(fluid):
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        y = fluid.layers.fc(input=x, size=3)
        loss = fluid.layers.mean(y)
        fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return main


def test_transpiler_hook_verifies_output():
    """Twin of test_analysis.py's: the post-rewrite hook passes a healthy
    optimized program under the flag (the JAX package runs it inside
    GradientMergeTranspiler; the port has no transpiler yet and calls
    the hook itself), gives the JAX verifier's findings on it, is a
    no-op without the flag, and blames the rewrite by name on a broken
    program."""
    from paddle_tpu.transpiler import GradientMergeTranspiler

    with jfluid.unique_name.guard({}):
        jmain = _sgd_program(jfluid)
    with tfluid.unique_name.guard({}):
        tmain = _sgd_program(tfluid)
    assert (_diags(jfluid.analysis.verify_program(jmain))
            == _diags(verify_program(tmain)))
    jfluid.flags.set_flag("verify_program", True)
    GradientMergeTranspiler().transpile(jmain, k_steps=2)
    assert verify_after_transpile(tmain, "rewrite") is None
    flags.set_flag("verify_program", True)
    assert verify_after_transpile(tmain, "rewrite") == verify_program(tmain)
    broken = _gate_program(tfluid)
    with pytest.raises(ProgramVerifyError, match=r"after MyRewrite"):
        verify_after_transpile(broken, "MyRewrite")


def _save_model(tmp_path):
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 3
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[6], dtype="float32")
        pred = tfluid.layers.fc(input=x, size=3, act="softmax")
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        path = str(tmp_path / "model")
        tfluid.io.save_inference_model(path, ["x"], [pred], exe,
                                       main_program=main)
    return path


def _break_model(path):
    """Rename one op input of the saved program to an undeclared var."""
    model = path + "/__model__"
    prog = program_bin.deserialize_program(open(model, "rb").read())
    op = prog.global_block().ops[-1]
    slot = sorted(op.inputs)[0]
    op.inputs[slot] = ["no_such_var"]
    open(model, "wb").write(program_bin.serialize_program(prog))
    return jax_program_bin.deserialize_program(open(model, "rb").read())


def test_predictor_verifies_at_load(tmp_path):
    """A valid saved model loads and serves with the flag on; a broken
    one raises ProgramVerifyError at load with the JAX verifier's
    findings on the same bytes."""
    path = _save_model(tmp_path)
    flags.set_flag("verify_program", True)
    cfg = NativeConfig(model_dir=path, use_tpu=False)
    (out,) = create_paddle_predictor(cfg).run(
        {"x": np.ones((2, 6), "float32")})
    assert out.shape == (2, 3)
    jax_prog = _break_model(path)
    with pytest.raises(ProgramVerifyError) as err:
        create_paddle_predictor(cfg)
    assert err.value.origin == "Predictor load"
    assert "V001" in str(err.value)
    fetch = [n for n in err.value.diagnostics[0].var_names]
    assert fetch == ["no_such_var"]
    with pytest.raises(JaxVerifyError) as jax_err:
        jfluid.analysis.check_program(
            jax_prog, fetch_names=[op.output("Out")[0] for op in
                                   jax_prog.global_block().ops[-1:]])
    assert _diags(err.value.diagnostics) == _diags(jax_err.value.diagnostics)
    flags.set_flag("verify_program", False)
    create_paddle_predictor(cfg)  # no check without the flag
