"""The NLP op types of the PyTorch port against the JAX package, on the CPU.

Twins of ``tests/test_nlp_ops.py``'s CRF, CTC, edit-distance,
``chunk_eval``, ``hsigmoid`` and ``nce`` cases and of
``tests/test_book.py::test_label_semantic_roles_bilstm_crf``: the same
seeded numpy inputs through the JAX op's lowering and the port's.
Values within 1e-5; the gradients of ``linear_chain_crf`` (emissions,
transitions) and ``warpctc`` (logits) within 1e-5 of ``jax.vjp`` over the
JAX package's scans; Viterbi paths (tied scores included), aligned
outputs, edit distances, chunk counts and ``nce``'s sampled classes
equal. Then the plain versions of the port's own kernels (K3
``crf_logz`` forward and backward, K4 ``crf_viterbi``, K5 ``ctc_loss``
with and without ``norm_by_times``) against the JAX lowering, with rows
of length 1, an empty label and an alignment that does not fit its
frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.ops import crf_ops as j_crf
from paddle_tpu.ops import ctc_ops as j_ctc
from paddle_tpu.ops import metric_ops as j_metric
from paddle_tpu.ops import sampling_ops as j_sampling
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import persistables_from_numpy
from paddle_tpu_torch.kernels import crf as kcrf
from paddle_tpu_torch.kernels import ctc as kctc
from paddle_tpu_torch.ops import crf_ops as t_crf
from paddle_tpu_torch.ops import ctc_ops as t_ctc
from paddle_tpu_torch.ops import metric_ops as t_metric
from paddle_tpu_torch.ops import sampling_ops as t_sampling
from paddle_tpu_torch.testing import fresh_state

TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _j(ins):
    return {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}


def _jax_op(lower, ins, attrs):
    """A JAX lowering on ``ins`` as one jitted computation (eager JAX
    would compile each primitive, and each scan, on its own)."""
    return jax.jit(lambda d: lower(None, d, attrs))(_j(ins))


def _jax_vjp(fn, args, cots):
    """``fn``'s outputs at ``args`` and ``jax.vjp`` of ``cots``, jitted."""
    def run(args, cots):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(cots)

    return jax.jit(run)(tuple(jnp.asarray(a) for a in args), cots)


def _t(ins, grad=()):
    return {k: [torch.from_numpy(np.array(a)).requires_grad_(k in grad)
                for a in v] for k, v in ins.items()}


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got, "float64"),
                               np.asarray(want, "float64"), rtol=tol,
                               atol=tol)


def _crf_case(seed, B=4, T=6, K=5, lens=(6, 1, 4, 3)):
    rng = np.random.RandomState(seed)
    return dict(
        Emission=[rng.randn(B, T, K).astype("float32")],
        Transition=[(0.5 * rng.randn(K + 2, K)).astype("float32")],
        Label=[rng.randint(0, K, (B, T)).astype("int64")],
        Length=[np.array(lens, "int64").reshape(-1, 1)])


_JAX_CRF = {}


def _jax_crf(with_length):
    """The JAX op on ``_crf_case(0)`` (with or without its Length input):
    (inputs, upstream g, NLL, Alpha, dx, dtrans), computed once."""
    if with_length not in _JAX_CRF:
        ins = _crf_case(0)
        if not with_length:
            del ins["Length"]
        g = np.random.RandomState(9).randn(4, 1).astype("float32")

        def jfn(x, tr):
            d = dict(_j(ins), Emission=[x], Transition=[tr])
            out = j_crf._lower_linear_chain_crf(None, d, {})
            return out["LogLikelihood"], out["Alpha"]

        x = ins["Emission"][0]
        (nll, alpha), (jdx, jdtr) = _jax_vjp(
            jfn, (x, ins["Transition"][0]),
            (jnp.asarray(g), jnp.zeros(x.shape, jnp.float32)))
        _JAX_CRF[with_length] = tuple(np.asarray(v) for v in (
            nll, alpha, jdx, jdtr)) + (ins, g)
    return _JAX_CRF[with_length]


@pytest.mark.parametrize("with_length", [True, False])
def test_linear_chain_crf_value_and_grad_match_jax(with_length):
    nll, alpha, jdx, jdtr, ins, g = _jax_crf(with_length)
    tins = _t(ins, grad=("Emission", "Transition"))
    out = t_crf._lower_linear_chain_crf(None, tins, {})
    _close(out["LogLikelihood"], nll)
    _close(out["Alpha"], alpha)
    _close(out["EmissionExps"], np.exp(ins["Emission"][0]))
    _close(out["TransitionExps"], np.exp(ins["Transition"][0]))
    dx, dtr = torch.autograd.grad(out["LogLikelihood"],
                                  [tins["Emission"][0], tins["Transition"][0]],
                                  torch.from_numpy(g))
    _close(dx, jdx)
    _close(dtr, jdtr)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("with_label", [False, True])
def test_crf_decoding_matches_jax(tied, with_label):
    """Integer emissions over zero transitions tie many paths: the
    first maximum wins on both sides."""
    ins = _crf_case(1, B=5, T=7, K=4, lens=(7, 1, 3, 0, 5))
    rng = np.random.RandomState(2)
    if tied:
        ins["Emission"] = [rng.randint(-1, 2, (5, 7, 4)).astype("float32")]
        ins["Transition"] = [np.zeros((6, 4), "float32")]
    if not with_label:
        del ins["Label"]
    want = _jax_op(j_crf._lower_crf_decoding, ins, {})["ViterbiPath"]
    got = t_crf._lower_crf_decoding(None, _t(ins), {})["ViterbiPath"]
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _gold_grads(ins, g):
    """The gradient of the gold path's scores (linear in x and the
    transitions) weighted by ``g`` ``[B]``, in numpy."""
    x, lab = ins["Emission"][0], ins["Label"][0]
    b, t, k = x.shape
    lens = ins["Length"][0].reshape(-1)
    dx = np.zeros(x.shape, "float64")
    dtr = np.zeros((k + 2, k), "float64")
    for i in range(b):
        n = min(lens[i], t)
        for s in range(n):
            dx[i, s, lab[i, s]] += g[i]
        for s in range(1, n):
            dtr[2 + lab[i, s - 1], lab[i, s]] += g[i]
        dtr[0, lab[i, 0]] += g[i]
        dtr[1, lab[i, (n - 1) % t]] += g[i]
    return dx, dtr


def test_crf_logz_plain_matches_jax():
    """K3's plain forward (alpha, log Z) and backward (the beta
    recursion's marginals) against the JAX lowering: log Z is the NLL
    plus the gold score, its gradient the NLL's (jax.vjp over the scan)
    plus the gold score's. The rows have lengths 6, 1, 4 and 3."""
    nll, alpha_j, jdx, jdtr, ins, g = _jax_crf(True)
    g = g[:, 0]
    x, tr = (torch.from_numpy(ins[k][0]) for k in ("Emission",
                                                   "Transition"))
    lens = torch.from_numpy(ins["Length"][0].reshape(-1))
    alpha, alpha_n, logz = kcrf.crf_logz_plain(x, tr, lens)
    _close(alpha, alpha_j)
    # the renormalised recursion: alpha less its log-sum-exp at each step
    _close(alpha_n, alpha_j - np.log(np.exp(alpha_j.astype("float64")).sum(
        -1, keepdims=True)))
    gdx, gdtr = _gold_grads(ins, g)
    # log Z - NLL is the gold score, linear in x and the transitions
    gold = []
    for i in range(len(g)):
        gx, gt = _gold_grads(ins, np.eye(len(g))[i])
        gold.append((gx * ins["Emission"][0]).sum()
                    + (gt * ins["Transition"][0]).sum())
    _close(logz.numpy() - nll[:, 0], gold)
    dx, dtr = kcrf.crf_logz_backward_plain(x, tr, lens, alpha_n,
                                           torch.from_numpy(g))
    _close(dx, jdx + gdx)
    _close(dtr, jdtr + gdtr)


def test_crf_viterbi_plain_on_ties_and_short_rows():
    ins = _crf_case(5, B=6, T=5, K=3, lens=(5, 1, 0, 2, 5, 4))
    del ins["Label"]
    ins["Emission"] = [np.random.RandomState(6).randint(
        0, 2, (6, 5, 3)).astype("float32")]
    want = _jax_op(j_crf._lower_crf_decoding, ins, {})["ViterbiPath"]
    got = kcrf.crf_viterbi_plain(
        torch.from_numpy(ins["Emission"][0]),
        torch.from_numpy(ins["Transition"][0]),
        torch.from_numpy(ins["Length"][0].reshape(-1)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ctc_case(seed, B=5, T=6, V=5, L=3):
    """Rows: full, one frame (one label), an empty label, a label with a
    repeat that needs more frames than it has (infeasible), a short
    one."""
    rng = np.random.RandomState(seed)
    label = rng.randint(1, V, (B, L)).astype("int64")
    label[3] = [2, 2, 2]
    return dict(
        Logits=[rng.randn(B, T, V).astype("float32")],
        Label=[label],
        LogitsLength=[np.array([6, 1, 4, 3, 5][:B], "int64").reshape(-1, 1)],
        LabelLength=[np.array([3, 1, 0, 3, 2][:B], "int64").reshape(-1, 1)])


@pytest.mark.parametrize("norm_by_times", [False, True])
@pytest.mark.parametrize("blank", [0, 4])
def test_warpctc_value_and_grad_match_jax(norm_by_times, blank):
    ins = _ctc_case(7)
    if blank:
        ins["Label"][0] = np.where(ins["Label"][0] == blank, 1,
                                   ins["Label"][0])
    attrs = {"blank": blank, "norm_by_times": norm_by_times}
    g = np.random.RandomState(8).rand(5, 1).astype("float32") + 0.5

    def jfn(lg):
        return j_ctc._lower_warpctc(None, dict(_j(ins), Logits=[lg]),
                                    attrs)["Loss"]

    loss, (jdl,) = _jax_vjp(jfn, (ins["Logits"][0],), jnp.asarray(g))
    tins = _t(ins, grad=("Logits",))
    out = t_ctc._lower_warpctc(None, tins, attrs)
    assert np.asarray(loss)[3, 0] > 1e20  # the infeasible row: finite, huge
    _close(out["Loss"].detach(), loss)
    assert not out["WarpCTCGrad"].any()
    (dl,) = torch.autograd.grad(out["Loss"], [tins["Logits"][0]],
                                torch.from_numpy(g))
    _close(dl, jdl)


@pytest.mark.parametrize("norm_by_times", [False, True])
def test_ctc_loss_plain_matches_jax(norm_by_times):
    """K5's plain version: its loss and its dLogits (for an upstream
    gradient of 1) against the JAX lowering and jax.vjp."""
    ins = _ctc_case(11, B=5, T=7, V=6, L=3)
    attrs = {"blank": 0, "norm_by_times": norm_by_times}

    def jfn(lg):
        return j_ctc._lower_warpctc(None, dict(_j(ins), Logits=[lg]),
                                    attrs)["Loss"]

    loss, (jdl,) = _jax_vjp(jfn, (ins["Logits"][0],),
                            jnp.ones((5, 1), jnp.float32))
    got, grad = kctc.ctc_loss_plain(
        torch.from_numpy(ins["Logits"][0]), torch.from_numpy(ins["Label"][0]),
        torch.from_numpy(ins["LogitsLength"][0].reshape(-1)),
        torch.from_numpy(ins["LabelLength"][0].reshape(-1)), 0,
        norm_by_times)
    _close(got, np.asarray(loss)[:, 0])
    _close(grad, jdl)


def test_ctc_align_matches_jax():
    rng = np.random.RandomState(12)
    x = rng.randint(0, 4, (6, 9)).astype("int64")
    ins = {"Input": [x], "InputLength": [np.array([9, 0, 1, 5, 9, 3],
                                                  "int64").reshape(-1, 1)]}
    for blank in (0, 2):
        want = _jax_op(j_ctc._lower_ctc_align, ins, {"blank": blank})
        got = t_ctc._lower_ctc_align(None, _t(ins), {"blank": blank})
        np.testing.assert_array_equal(got["Output"].numpy(),
                                      np.asarray(want["Output"]))
        np.testing.assert_array_equal(got["OutputLength"].numpy(),
                                      np.asarray(want["OutputLength"]))


@pytest.mark.parametrize("normalized", [False, True])
def test_edit_distance_matches_jax(normalized):
    rng = np.random.RandomState(13)
    hyp = rng.randint(0, 4, (7, 8)).astype("int64")
    ref = rng.randint(0, 4, (7, 6)).astype("int64")
    ins = {"Hyps": [hyp], "Refs": [ref],
           "HypsLength": [np.array([8, 0, 3, 5, 1, 8, 2],
                                   "int64").reshape(-1, 1)],
           "RefsLength": [np.array([6, 2, 0, 6, 1, 3, 4],
                                   "int64").reshape(-1, 1)]}
    attrs = {"normalized": normalized}
    want = _jax_op(j_ctc._lower_edit_distance, ins, attrs)
    got = t_ctc._lower_edit_distance(None, _t(ins), attrs)
    np.testing.assert_array_equal(got["Out"].numpy(), np.asarray(want["Out"]))
    assert int(got["SequenceNum"][0]) == int(np.asarray(
        want["SequenceNum"])[0])


def _tags(rng, b, t, n_types, n_tag):
    """Valid-looking tag grids with noise: chunk tags and outside tags."""
    return rng.randint(0, n_types * n_tag + 1, (b, t)).astype("int64")


@pytest.mark.parametrize("scheme,n_tag", [("IOB", 2), ("IOE", 2),
                                          ("IOBES", 4), ("plain", 1)])
@pytest.mark.parametrize("excluded", [[], [1]])
def test_chunk_eval_counts_match_jax(scheme, n_tag, excluded):
    rng = np.random.RandomState(14)
    lab = _tags(rng, 6, 12, 3, n_tag)
    inf = np.where(rng.rand(6, 12) < 0.7, lab, _tags(rng, 6, 12, 3, n_tag))
    ins = {"Inference": [inf], "Label": [lab],
           "Length": [np.array([12, 0, 1, 7, 12, 5], "int64")]}
    attrs = {"chunk_scheme": scheme, "num_chunk_types": 3,
             "excluded_chunk_types": excluded}
    want = _jax_op(j_metric._lower_chunk_eval, ins, attrs)
    got = t_metric._lower_chunk_eval(None, _t(ins), attrs)
    for k in ("NumInferChunks", "NumLabelChunks", "NumCorrectChunks"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert int(want["NumCorrectChunks"][0]) > 0
    for k in ("Precision", "Recall", "F1-Score"):
        _close(got[k], want[k])


def test_chunk_eval_iob_worked_example():
    """tests/test_nlp_ops.py::test_chunk_eval_iob's rows."""
    ins = {"Inference": [np.array([[0, 1, 4, 2, 4]], "int64")],
           "Label": [np.array([[0, 1, 4, 2, 3]], "int64")]}
    got = t_metric._lower_chunk_eval(None, _t(ins), {
        "chunk_scheme": "IOB", "num_chunk_types": 2})
    assert [int(got[k][0]) for k in ("NumLabelChunks", "NumInferChunks",
                                     "NumCorrectChunks")] == [2, 2, 1]
    _close(got["Precision"], [0.5])


def test_hsigmoid_value_and_grad_match_jax():
    rng = np.random.RandomState(15)
    num_classes, d = 7, 5
    ins = {"X": [rng.randn(9, d).astype("float32")],
           "W": [rng.randn(num_classes - 1, d).astype("float32")],
           "Label": [rng.randint(0, num_classes, (9, 1)).astype("int64")],
           "Bias": [rng.randn(num_classes - 1, 1).astype("float32")]}
    attrs = {"num_classes": num_classes}

    def jfn(x, w, b):
        return j_sampling._lower_hierarchical_sigmoid(
            None, dict(_j(ins), X=[x], W=[w], Bias=[b]), attrs)["Out"]

    out, jgrads = _jax_vjp(jfn, tuple(ins[k][0] for k in ("X", "W", "Bias")),
                           jnp.ones((9, 1), jnp.float32))
    tins = _t(ins, grad=("X", "W", "Bias"))
    got = t_sampling._lower_hierarchical_sigmoid(None, tins, attrs)
    _close(got["Out"].detach(), out)
    grads = torch.autograd.grad(got["Out"].sum(), [tins[k][0] for k in (
        "X", "W", "Bias")])
    for a, b in zip(grads, jgrads):
        _close(a, b)
    # the leaf probabilities of one input sum to 1 over the classes
    x = np.tile(ins["X"][0][:1], (num_classes, 1))
    lab = np.arange(num_classes).reshape(-1, 1).astype("int64")
    cost = t_sampling._lower_hierarchical_sigmoid(
        None, _t(dict(ins, X=[x], Label=[lab])), attrs)["Out"]
    _close(np.exp(-cost.numpy()[:, 0]).sum(), 1.0)


def _nce_program(pkg, unique_name, dict_size, d, neg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 21
    with unique_name.guard({}), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[d], dtype="float32")
        lb = pkg.layers.data(name="lb", shape=[1], dtype="int64")
        cost = pkg.layers.nce(x, lb, num_total_classes=dict_size,
                              num_neg_samples=neg)
        loss = pkg.layers.mean(cost)
        pkg.optimizer.SGD(0.1).minimize(loss)
    op = [o for o in main.global_block().ops if o.type == "nce"][0]
    return main, startup, loss, cost, op.output("SampleLabels")[0]


def test_nce_samples_and_cost_match_jax():
    """Two SGD steps through both packages from the JAX package's
    initial state: the sampled classes are equal (the port draws from
    the same threefry keys), costs within 1e-5."""
    rng = np.random.RandomState(16)
    dict_size, d, neg = 30, 8, 5
    feeds = [{"x": rng.randn(6, d).astype("float32"),
              "lb": rng.randint(0, dict_size, (6, 1)).astype("int64")}
             for _ in range(2)]
    res, state = {}, None
    for name, pkg, un in (("jax", jfluid, j_unique_name),
                          ("torch", tfluid, t_unique_name)):
        main, startup, loss, cost, samples = _nce_program(pkg, un, dict_size,
                                                          d, neg)
        exe = pkg.Executor(pkg.CPUPlace())
        if pkg is jfluid:
            from paddle_tpu.core.scope import Scope as JScope

            scope = JScope()
            exe.run(startup, scope=scope)
            state = {v.name: np.asarray(scope.get_value(v.name))
                     for v in main.global_block().vars.values()
                     if v.persistable and scope.get_value(v.name) is not None}
        else:
            # the startup run advances the run counter, as the JAX one did
            scope = tfluid.Scope()
            exe.run(startup, scope=scope)
            persistables_from_numpy(main, scope, state, "cpu")
        res[name] = [[np.asarray(v) for v in exe.run(
            main, feed=f, fetch_list=[cost, samples], scope=scope)]
            for f in feeds]
    for (jc, js), (tc, ts) in zip(res["jax"], res["torch"]):
        np.testing.assert_array_equal(ts, js)
        _close(tc, jc)
    assert not np.array_equal(res["torch"][0][1], res["torch"][1][1])


def test_label_semantic_roles_bilstm_crf_twin():
    """The port's twin of tests/test_book.py's role-labelling capability
    test: BiLSTM emissions and linear_chain_crf trained with Adam on a
    learnable tagging rule; the NLL falls and Viterbi recovers most
    tags."""
    fluid = tfluid
    vocab, n_tags, T, D = 30, 5, 8, 24
    main, startup = fluid.Program(), fluid.Program()
    with t_unique_name.guard({}), fluid.program_guard(main, startup):
        word = fluid.layers.data(name="word", shape=[T], dtype="int64")
        target = fluid.layers.data(name="target", shape=[T], dtype="int64")
        length = fluid.layers.data(name="length", shape=[1], dtype="int64")
        emb = fluid.layers.embedding(input=word, size=[vocab, D])
        proj = fluid.layers.fc(input=emb, size=D * 4, num_flatten_dims=2,
                               bias_attr=False)
        fwd, _ = fluid.layers.dynamic_lstm(input=proj, size=D * 4,
                                           length=length,
                                           use_peepholes=False)
        emission = fluid.layers.fc(input=fwd, size=n_tags,
                                   num_flatten_dims=2)
        crf_cost = fluid.layers.linear_chain_crf(
            emission, target, length=length,
            param_attr=fluid.ParamAttr(name="crfw"))
        avg_cost = fluid.layers.mean(crf_cost)
        fluid.optimizer.Adam(5e-3).minimize(avg_cost)
        decoded = fluid.layers.crf_decoding(
            emission, param_attr=fluid.ParamAttr(name="crfw"),
            length=length)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(6)

    def batch(bs):
        lens = rng.randint(3, T, (bs,))
        w = rng.randint(0, vocab, (bs, T))
        tags = (w % n_tags).astype("int64")
        for i, ln in enumerate(lens):
            w[i, ln:] = 0
            tags[i, ln:] = 0
        return w.astype("int64"), tags, lens.reshape(-1, 1).astype("int64")

    losses = []
    for _ in range(150):
        w, tg, ln = batch(16)
        (lv,) = exe.run(main, feed={"word": w, "target": tg, "length": ln},
                        fetch_list=[avg_cost], scope=scope)
        losses.append(float(np.asarray(lv).ravel()[0]))
    assert losses[-1] < losses[0] * 0.5, losses[::30]
    assert exe.grad_op_reruns == 0
    w, tg, ln = batch(32)
    (path,) = exe.run(main, feed={"word": w, "target": tg, "length": ln},
                      fetch_list=[decoded], scope=scope)
    path = np.asarray(path)
    mask = np.arange(T)[None, :] < ln
    assert (path == tg)[mask].mean() > 0.8
