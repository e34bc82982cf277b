"""Decode snapshots in the PyTorch port against the JAX package, on the
CPU: the twins of ``tests/test_serving_resilience.py``'s snapshot cases
and a parity case across the two packages.

- a mid-flight paged session (a fork group with a forced prefix, shared
  prefix pages, a backlog) snapshots and restores into a fresh session
  whose remaining tokens are bit-identical to the uninterrupted run's;
- a corrupt serial is quarantined and the previous one restores; a
  geometry drift is the typed ``SnapshotMismatchError``; a dense session
  is refused; ``tools/ckpt_inspect.py --verify`` reads the port's
  snapshots (exit 0) and catches a tampered one (exit 2);
- mid-speculation snapshots (n-gram and model drafter) restore
  bit-exactly; a ``snapshot.write`` fault fails the save and leaves the
  session serving; SIGTERM banks a final snapshot and the child dies by
  the signal (``slow``, as the reference marks it);
- parity: the same mid-flight state (greedy, top-k sampled, speculative,
  beam) snapshotted by both packages gives the same file names, shapes,
  dtypes and meta, the pools within 1e-5, and each package restores the
  other's snapshot and finishes with the other's tokens.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as j_transformer
from paddle_tpu.serving.generation import Sampler as JSampler
from paddle_tpu.serving.generation import SlotDecodeSession as JSession
from paddle_tpu.serving.snapshot import DecodeSnapshotManager as JManager
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.core.scope import Scope as TScope
from paddle_tpu_torch.models import transformer as t_transformer
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.resilience.checkpoint import read_manifest
from paddle_tpu_torch.serving.generation import Sampler, SlotDecodeSession
from paddle_tpu_torch.serving.snapshot import (
    DecodeSnapshotManager,
    SnapshotMismatchError,
)
from paddle_tpu_torch.testing import fresh_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import ckpt_inspect  # noqa: E402

VOCAB, SEQ, D, S = 24, 8, 32, 4
CFG = dict(src_vocab_size=VOCAB, trg_vocab_size=VOCAB, n_layer=2,
           n_head=2, d_inner=64)


@pytest.fixture(scope="module")
def trained():
    """One tiny 2-layer Transformer (seeded JAX init) in both packages:
    2 layers so the pools past layer 0 are in every snapshot."""
    jmain, jstart = jfluid.Program(), jfluid.Program()
    jmain.random_seed = jstart.random_seed = 41
    with j_unique_name.guard({}), jfluid.program_guard(jmain, jstart):
        j_transformer.build(dropout=0.0, label_smooth_eps=0.0,
                            max_length=SEQ, d_model=D, **CFG)
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    params = [p.name for p in jmain.global_block().all_parameters()]
    with fresh_state():
        tmain, tstart = tfluid.Program(), tfluid.Program()
        with t_unique_name.guard({}), tfluid.program_guard(tmain, tstart):
            t_transformer.build(dropout=0.0, label_smooth_eps=0.0,
                                max_length=SEQ, d_model=D, **CFG)
        tscope = TScope()
        params_from_numpy(tmain, tscope, {
            n: np.asarray(jscope.get_value(n)) for n in params}, "cpu")
    rng = np.random.RandomState(7)
    src = rng.randint(3, VOCAB, (8, SEQ)).astype("int64")
    src_len = np.asarray([SEQ, 3, SEQ - 1, 5, SEQ, 4, SEQ - 2, SEQ],
                         "int64")
    return {"jexe": jexe, "jscope": jscope,
            "texe": tfluid.Executor(tfluid.CPUPlace()), "tscope": tscope,
            "src": src, "src_len": src_len}


@pytest.fixture(autouse=True)
def _fresh_and_clean():
    with fresh_state():
        yield
    chaos.disable()


def _args(scope, sampler_cls, **kw):
    # each session gets its own child of the model scope: the pgd_*
    # state shadows per child, so oracle, victim and restored never
    # collide
    args = dict(num_slots=S, max_length=SEQ, d_model=D, paged=True,
                page_size=4, steps=2, num_groups=2, prefix_cache_pages=8,
                sampler=sampler_cls(strategy="top_k", top_k=4,
                                    temperature=0.9, seed=11),
                scope=scope.new_scope())
    args.update(CFG)
    args.update(kw)
    return args


def _paged(trained, **kw):
    return SlotDecodeSession(trained["texe"],
                             **_args(trained["tscope"], Sampler, **kw))


def _jpaged(trained, **kw):
    return JSession(trained["jexe"],
                    **_args(trained["jscope"], JSampler, **kw))


def _drive(sess, src, src_len):
    """A fork group with a forced prefix, then a backlog pumped through
    the 4-slot pool."""
    sess.admit_group(src[0], n=2, src_len=int(src_len[0]),
                     prefix_tokens=[int(x) for x in src[0][:5]])
    return [sess.enqueue(src[i], int(src_len[i])) for i in range(1, 6)]


def _finish(sess, done, rids):
    for _ in range(40):
        done.update(sess.pump())
        if len(done) >= len(rids):
            break
    return done


def test_snapshot_restore_is_bit_exact_mid_flight(trained, tmp_path):
    src, src_len = trained["src"], trained["src_len"]
    oracle = _paged(trained)
    orids = _drive(oracle, src, src_len)
    odone = _finish(oracle, {}, orids)

    victim = _paged(trained)
    vrids = _drive(victim, src, src_len)
    vdone = {}
    for _ in range(2):
        vdone.update(victim.pump())
    assert victim._live and victim._pending, "snapshot point too late"
    assert victim.shared_pages > 0 or victim.cached_pages > 0
    mgr = DecodeSnapshotManager(victim, str(tmp_path / "snap"))
    mgr.save()
    mgr.close(save=False)

    restored = _paged(trained)
    mgr2 = DecodeSnapshotManager(restored, str(tmp_path / "snap"))
    assert mgr2.restore() is not None
    assert restored.steps_done == victim.steps_done
    assert restored.pending_requests == victim.pending_requests
    assert restored._pool.state_dict() == victim._pool.state_dict()
    vdone2 = _finish(victim, dict(vdone), vrids)
    rdone = _finish(restored, dict(vdone), vrids)
    for rid in vrids:
        np.testing.assert_array_equal(rdone[rid], vdone2[rid])
    for o_rid, rid in zip(orids, vrids):
        np.testing.assert_array_equal(odone[o_rid], rdone[rid])
    assert restored.pool_conserved
    mgr2.close(save=False)


def test_snapshot_quarantines_corruption_and_falls_back(trained,
                                                        tmp_path):
    sess = _paged(trained)
    sess.admit(trained["src"][0], int(trained["src_len"][0]))
    snap = str(tmp_path / "snap")
    mgr = DecodeSnapshotManager(sess, snap)
    mgr.save(serial=1)
    sess.step()
    mgr.save(serial=2)
    newest = os.path.join(snap, "checkpoint_2")
    victim_file = os.path.join(newest, "pgd_pos.npy")
    blob = bytearray(open(victim_file, "rb").read())
    blob[-1] ^= 0xFF
    open(victim_file, "wb").write(bytes(blob))

    fresh = _paged(trained)
    mgr2 = DecodeSnapshotManager(fresh, snap)
    manifest = mgr2.restore()
    assert manifest is not None and int(manifest["serial"]) == 1
    assert not os.path.exists(newest), "corrupt serial not quarantined"
    assert any(".corrupt-" in d for d in os.listdir(snap))
    mgr.close(save=False)
    mgr2.close(save=False)


def test_snapshot_geometry_mismatch_is_typed_not_quarantined(
        trained, tmp_path):
    sess = _paged(trained)
    sess.admit(trained["src"][0], int(trained["src_len"][0]))
    snap = str(tmp_path / "snap")
    DecodeSnapshotManager(sess, snap).save()
    other = _paged(trained, num_groups=3)
    before = other._pool.state_dict()
    with pytest.raises(SnapshotMismatchError):
        DecodeSnapshotManager(other, snap).restore()
    assert os.path.isdir(os.path.join(snap, "checkpoint_0"))
    assert other._pool.state_dict() == before  # nothing was touched


def test_dense_session_is_refused_with_guidance(trained):
    dense = SlotDecodeSession(trained["texe"], num_slots=S,
                              max_length=SEQ, d_model=D,
                              scope=trained["tscope"].new_scope(), **CFG)
    with pytest.raises(ValueError, match="paged"):
        DecodeSnapshotManager(dense, "/tmp/unused")


def test_ckpt_inspect_knows_the_decode_dialect(trained, tmp_path):
    sess = _paged(trained)
    sess.admit_group(trained["src"][0], n=2,
                     src_len=int(trained["src_len"][0]),
                     prefix_tokens=[int(x) for x in trained["src"][0][:5]])
    snap = str(tmp_path / "snap")
    DecodeSnapshotManager(sess, snap).save(serial=7)
    step_dir = os.path.join(snap, "checkpoint_7")
    assert ckpt_inspect.main([step_dir, "--verify"]) == 0
    mpath = os.path.join(step_dir, "__manifest__.json")
    manifest = json.load(open(mpath))
    ds = manifest["extra"]["decode_snapshot"]
    page = next(iter(ds["pool"]["ref"]))
    ds["pool"]["ref"][page] = int(ds["pool"]["ref"][page]) + 1
    json.dump(manifest, open(mpath, "w"))
    assert ckpt_inspect.main([step_dir, "--verify"]) == 2
    assert ckpt_inspect.main([step_dir]) == 0


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_snapshot_restores_mid_speculation_bit_exact(trained, tmp_path,
                                                     drafter):
    src, src_len = trained["src"], trained["src_len"]

    def spec_sess():
        return _paged(trained, steps=1,
                      speculative={"k": 2, "drafter": drafter})

    victim = spec_sess()
    vrids = [victim.enqueue(src[i], int(src_len[i])) for i in range(5)]
    vdone = {}
    for _ in range(2):
        vdone.update(victim.pump())
    assert victim._live and victim.spec_dispatches > 0
    snap = str(tmp_path / "snap")
    mgr = DecodeSnapshotManager(victim, snap)
    mgr.save()
    mgr.close(save=False)

    restored = spec_sess()
    mgr2 = DecodeSnapshotManager(restored, snap)
    assert mgr2.restore() is not None
    assert (restored.spec_proposed, restored.spec_accepted,
            restored.spec_dispatches) == (victim.spec_proposed,
                                          victim.spec_accepted,
                                          victim.spec_dispatches)
    assert (restored._spec_drafter.state_dict()
            == victim._spec_drafter.state_dict())
    if drafter == "model":
        vp = victim._spec_drafter.param_arrays()
        rp = restored._spec_drafter.param_arrays()
        assert sorted(vp) == sorted(rp) and vp
        for n in vp:
            np.testing.assert_array_equal(rp[n], vp[n], err_msg=n)
    vdone2 = _finish(victim, dict(vdone), vrids)
    rdone = _finish(restored, dict(vdone), vrids)
    for rid in vrids:
        np.testing.assert_array_equal(rdone[rid], vdone2[rid])
    mgr2.close(save=False)
    plain = _paged(trained, steps=1)
    with pytest.raises(SnapshotMismatchError):
        DecodeSnapshotManager(plain, snap).restore()


def test_ckpt_inspect_crosschecks_speculative_bindings(trained, tmp_path,
                                                       capsys):
    sess = _paged(trained, steps=1,
                  speculative={"k": 2, "drafter": "ngram"})
    sess.admit(trained["src"][0], SEQ)
    while sess._live and all(
            int(st["pos"]) < 5 for st in sess._live.values()):
        sess.step()
    assert sess._live, "request finished before spanning two pages"
    snap = str(tmp_path / "snap")
    DecodeSnapshotManager(sess, snap).save(serial=3)
    step_dir = os.path.join(snap, "checkpoint_3")
    assert ckpt_inspect.main([step_dir, "--verify"]) == 0
    assert "speculative: k=2 drafter=ngram" in capsys.readouterr().out
    mpath = os.path.join(step_dir, "__manifest__.json")
    manifest = json.load(open(mpath))
    ds = manifest["extra"]["decode_snapshot"]
    slot = next(iter(ds["slot_pages"]))
    page = int(ds["slot_pages"][slot].pop())
    del ds["pool"]["ref"][str(page)]
    ds["pool"]["free"].append(page)
    ds["live_pages"] = [p for p in ds["live_pages"] if int(p) != page]
    json.dump(manifest, open(mpath, "w"))
    assert ckpt_inspect.main([step_dir, "--verify"]) == 2
    assert "speculative slot" in capsys.readouterr().out


def test_snapshot_write_chaos_fails_save_not_session(trained, tmp_path):
    sess = _paged(trained)
    sess.admit(trained["src"][0], int(trained["src_len"][0]))
    mgr = DecodeSnapshotManager(sess, str(tmp_path / "snap"))
    chaos.configure("io@site=snapshot.write,n=1")
    with pytest.raises(IOError):
        mgr.save(serial=1)
    chaos.disable()
    assert mgr.latest_serial() is None
    sess.step()
    mgr.save(serial=2)
    assert mgr.latest_serial() == 2
    mgr.close(save=False)


def test_save_async_equals_sync_save_and_copies_state(trained, tmp_path):
    """The async writer gets host copies: decoding on after
    ``save_async`` (the pools and loop state updated in place) leaves its
    files equal, digest for digest, to a sync save of the same step."""
    sess = _paged(trained)
    _drive(sess, trained["src"], trained["src_len"])
    sess.pump()
    mgr = DecodeSnapshotManager(sess, str(tmp_path / "a"))
    sync = DecodeSnapshotManager(sess, str(tmp_path / "s"))
    sync.save(serial=1)
    mgr.save_async(serial=1)
    for _ in range(2):
        sess.pump()
    mgr.wait()
    assert mgr.last_error is None
    va = read_manifest(str(tmp_path / "a" / "checkpoint_1"))["vars"]
    vs = read_manifest(str(tmp_path / "s" / "checkpoint_1"))["vars"]
    assert sorted(va) == sorted(vs)
    assert all(va[n]["sha256"] == vs[n]["sha256"] for n in va)


def test_idle_finalize_keeps_the_owner_out_of_a_dispatch(
        trained, tmp_path, monkeypatch):
    """A deferred SIGTERM whose owner thread went idle is finalized from
    a timer thread; the owner cannot open a dispatch window between the
    idle check and the end of the final save."""
    import threading

    sess = _paged(trained)
    sess.admit(trained["src"][0], int(trained["src_len"][0]))
    mgr = DecodeSnapshotManager(sess, str(tmp_path / "snap"))
    kills = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append(sig))
    entered = threading.Event()

    def dispatch():
        sess._begin_op()
        entered.set()
        sess._end_op()

    owner = threading.Thread(target=dispatch)
    seen = {}
    orig_save = mgr.save

    def save(*a, **k):
        owner.start()
        seen["entered_mid_save"] = entered.wait(0.3)
        return orig_save(*a, **k)

    monkeypatch.setattr(mgr, "save", save)
    mgr._stop_signum = signal.SIGTERM
    mgr._finalize_if_idle()
    owner.join(10)
    assert seen == {"entered_mid_save": False}
    assert entered.is_set() and kills == [signal.SIGTERM]
    assert mgr.latest_serial() is not None


_CHILD = r"""
import os, sys, time
import numpy as np
import paddle_tpu_torch as fluid
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.serving.generation import Sampler, SlotDecodeSession
from paddle_tpu_torch.serving.snapshot import DecodeSnapshotManager

snap_dir = sys.argv[1]
VOCAB, SEQ, D, S = 24, 8, 32, 4
CFG = dict(src_vocab_size=VOCAB, trg_vocab_size=VOCAB, n_layer=1,
           n_head=2, d_inner=64)
main, startup = fluid.Program(), fluid.Program()
main.random_seed = 41; startup.random_seed = 41
with fluid.program_guard(main, startup):
    transformer.build(dropout=0.0, label_smooth_eps=0.0,
                      max_length=SEQ, d_model=D, **CFG)
exe = fluid.Executor(fluid.CPUPlace())
exe.run(startup)
sess = SlotDecodeSession(exe, num_slots=S, max_length=SEQ, d_model=D,
                         paged=True, page_size=4, steps=2,
                         sampler=Sampler(seed=3), **CFG)
mgr = DecodeSnapshotManager(sess, snap_dir,
                            install_signal_handlers=True)
rng = np.random.RandomState(7)
src = rng.randint(3, VOCAB, (64, SEQ)).astype("int64")
for i in range(64):
    sess.enqueue(src[i])
print("READY", flush=True)
while sess._pending or sess._live:
    sess.pump()
    time.sleep(0.01)
print("DRAINED", flush=True)  # only reached if SIGTERM never lands
"""


@pytest.mark.slow
def test_sigterm_banks_final_snapshot_and_dies_by_signal(tmp_path):
    from paddle_tpu_torch.resilience.checkpoint import complete_serials

    snap_dir = str(tmp_path / "snap")
    env = dict(os.environ)
    env.pop("FLAGS_chaos_spec", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD, snap_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO)
    try:
        line = proc.stdout.readline().strip()
        assert line == "READY", (line, proc.stderr.read())
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == -signal.SIGTERM, (proc.returncode, err)
    assert "DRAINED" not in out
    serials = complete_serials(snap_dir)
    assert serials, "no final snapshot banked on SIGTERM"
    step_dir = os.path.join(snap_dir, "checkpoint_%d" % serials[-1])
    meta = read_manifest(step_dir)["extra"]["decode_snapshot"]
    assert meta["live"] or meta["pending"]
    assert ckpt_inspect.main([step_dir, "--verify"]) == 0


# -- parity with the JAX package ----------------------------------------------

MODES = {
    "greedy": dict(sampler=None),
    "sampled": dict(),
    "speculative": dict(steps=1, speculative={"k": 2, "drafter": "ngram"}),
    "beam": dict(steps=1, beam_width=2, sampler=None, prefix_cache_pages=0,
                 num_pages=1 + 2 * S * (SEQ // 4 + 1)),
}


def _mode_drive(sess, trained, mode):
    """One load per mode; returns what to compare at the end: request ids
    (or beam claim ids)."""
    src, src_len = trained["src"], trained["src_len"]
    if mode == "beam":
        rids = []
        for i in range(2):
            lane = sess.admit_beam(src[i], int(src_len[i]))
            rids.append(sess.register_beam_owner(lane))
        return rids
    if mode == "speculative":
        return [sess.enqueue(src[i], int(src_len[i])) for i in range(5)]
    return _drive(sess, src, src_len)


def _mode_advance(sess, mode, rounds, done):
    for _ in range(rounds):
        if mode == "beam":
            sess.step()
        else:
            done.update(sess.pump())


def _mode_finish(sess, mode, rids, done):
    if mode == "beam":
        while sess.active_beams:
            sess.step()
        return {r: sess.take_beam_result(r) for r in rids}
    return _finish(sess, done, rids)


def _assert_same_results(mode, got, want, rids):
    for rid in rids:
        if mode == "beam":
            np.testing.assert_array_equal(got[rid]["tokens"],
                                          want[rid]["tokens"])
            np.testing.assert_allclose(got[rid]["scores"],
                                       want[rid]["scores"], atol=1e-5)
        else:
            np.testing.assert_array_equal(got[rid], want[rid])


def _dir(root):
    (d,) = [x for x in os.listdir(root) if x.startswith("checkpoint_")]
    return os.path.join(root, d)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_snapshot_parity_with_jax_package(trained, tmp_path, mode):
    kw = MODES[mode]
    tsess, jsess = _paged(trained, **kw), _jpaged(trained, **kw)
    trids = _mode_drive(tsess, trained, mode)
    jrids = _mode_drive(jsess, trained, mode)
    assert trids == jrids
    tdone, jdone = {}, {}
    _mode_advance(tsess, mode, 2, tdone)
    _mode_advance(jsess, mode, 2, jdone)
    assert tsess._live and jsess._live
    DecodeSnapshotManager(tsess, str(tmp_path / "t")).save(serial=5)
    JManager(jsess, str(tmp_path / "j")).save(serial=5)
    tdir, jdir = _dir(str(tmp_path / "t")), _dir(str(tmp_path / "j"))
    tm, jm = read_manifest(tdir), read_manifest(jdir)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    # the meta is equal but for the beam hypotheses' float scores
    # (within 1e-5, as the pgd_score files)
    tscores, jscores = ([st.pop("score", 0.0) for _k, st in sorted(
        m["extra"]["decode_snapshot"]["live"].items())] for m in (tm, jm))
    np.testing.assert_allclose(tscores, jscores, atol=1e-5)
    assert tm["extra"] == jm["extra"]
    for name, jv in jm["vars"].items():
        tv = tm["vars"][name]
        assert (tv["file"], tv["shape"], tv["dtype"]) == (
            jv["file"], jv["shape"], jv["dtype"]), name
        ta = np.load(os.path.join(tdir, tv["file"]))
        ja = np.load(os.path.join(jdir, jv["file"]))
        if ja.dtype.kind == "f":
            np.testing.assert_allclose(ta, ja, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(ta, ja, err_msg=name)
    assert ckpt_inspect.main([tdir, "--verify"]) == 0

    # the uninterrupted continuations, then each package restores the
    # other's snapshot and finishes with the other's tokens
    twant = _mode_finish(tsess, mode, trids, dict(tdone))
    jwant = _mode_finish(jsess, mode, jrids, dict(jdone))
    _assert_same_results(mode, twant, jwant, trids)
    t_from_j = _paged(trained, **kw)
    assert DecodeSnapshotManager(t_from_j, str(tmp_path / "j")).restore()
    j_from_t = _jpaged(trained, **kw)
    assert JManager(j_from_t, str(tmp_path / "t")).restore()
    _assert_same_results(mode, _mode_finish(t_from_j, mode, trids,
                                            dict(jdone)), jwant, trids)
    _assert_same_results(mode, _mode_finish(j_from_t, mode, jrids,
                                            dict(tdone)), twant, jrids)
