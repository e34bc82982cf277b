"""Checkpoint v2: atomic, digest-verified, asynchronously written,
corruption-tolerant on load.

Counterpart of ``paddle_tpu/resilience/checkpoint.py``, with the same
directory layout, manifest and dtypes on disk, so a checkpoint either
package writes restores into the other, and ``tools/ckpt_inspect.py``
reads both:

* **Atomic**: vars are written to ``checkpoint_<serial>.tmp-<pid>``, the
  manifest is fsynced, and the directory is atomically renamed. A
  checkpoint either exists completely or not at all; temp dirs from a
  killed writer are ignored (and swept) on the next restore.
* **Verified**: the manifest carries a sha256 digest of every var file.
  ``restore`` re-hashes before loading; a corrupt serial is
  *quarantined* (renamed ``.corrupt-<n>``, never deleted) and the scan
  falls back to the next-newest complete serial.
* **Asynchronous**: ``save_async`` copies every value to the host on the
  calling thread (the only part the training step waits for) and hands
  hashing and disk IO to a background writer. The copy is a real copy
  (``core.types.jax_host_array``): the ``.numpy()`` of a CPU tensor
  shares its memory, and the steps that run on while the writer works
  update the scope's tensors in place.
* **Complete**: every persistable var in scope, and the executor's RNG
  state (base seed and run counter), so a resumed process draws the
  same dropout masks as the uninterrupted run.

Values are written in the JAX package's dtypes (an int64 tensor whose
values fit as int32, as the JAX package holds it on its device), and a
restored value takes the dtype and device of the value it replaces in
the scope (or of the program's var), so int64 state stays int64.

Layout::

    <dir>/checkpoint_<serial>/
        <var-name>.npy ...            # '/' in names becomes '__'
        __manifest__.json

Metrics: ``paddle_tpu_checkpoint_save_seconds`` (histogram, full write),
``paddle_tpu_checkpoint_bytes`` (gauge, last save),
``paddle_tpu_checkpoint_failures_total{stage}`` and
``paddle_tpu_checkpoint_restores_total{outcome}``.
"""

import hashlib
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from paddle_tpu_torch.core.types import TensorArray, jax_host_array
from paddle_tpu_torch.observability import blackbox, lock_witness
from paddle_tpu_torch.observability.metrics_registry import REGISTRY
from paddle_tpu_torch.resilience import chaos

__all__ = ["CheckpointManager", "MANIFEST_NAME", "read_manifest",
           "verify_checkpoint_dir", "complete_serials", "assemble_var"]

MANIFEST_NAME = "__manifest__.json"
MANIFEST_VERSION = 2

_save_seconds = REGISTRY.histogram(
    "paddle_tpu_checkpoint_save_seconds",
    "wall seconds per checkpoint write (snapshot excluded)")
_save_bytes = REGISTRY.gauge(
    "paddle_tpu_checkpoint_bytes", "bytes written by the last checkpoint")
_failures = REGISTRY.counter(
    "paddle_tpu_checkpoint_failures_total",
    "checkpoint save/load failures by stage", ["stage"])
_restores = REGISTRY.counter(
    "paddle_tpu_checkpoint_restores_total",
    "checkpoint restore attempts by outcome", ["outcome"])


def _safe_name(var_name):
    return var_name.replace("/", "__")


def _sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _fsync_dir(path):
    """Durability for the rename itself; best-effort on filesystems
    without directory fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def read_manifest(step_dir):
    """The parsed manifest of one checkpoint dir, or None (no/corrupt
    manifest = incomplete checkpoint)."""
    try:
        with open(os.path.join(step_dir, MANIFEST_NAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def verify_checkpoint_dir(step_dir, manifest=None):
    """Re-hash every var file against the manifest. Returns a list of
    human-readable problems (empty = verified). Manifests without digests
    (io.save_checkpoint's marker manifests) verify file presence only.
    Vars stored as shard files (elastic/reshard.py's sharded dialect,
    ``meta["shards"]``) verify every shard's digest AND that the shard
    bytes sum back to the var's logical bytes — a dropped shard must
    fail verification, never reassemble short."""
    manifest = manifest or read_manifest(step_dir)
    if manifest is None:
        return ["no readable %s" % MANIFEST_NAME]
    problems = []
    for name, meta in sorted(manifest.get("vars", {}).items()):
        shards = meta.get("shards")
        entries = shards if shards else [meta]
        shard_bytes = 0
        broken = False
        for ent in entries:
            fname = ent.get("file")
            if not fname:
                problems.append("no file recorded for var %r" % name)
                broken = True
                continue
            path = os.path.join(step_dir, fname)
            if not os.path.exists(path):
                problems.append("missing file for var %r: %s"
                                % (name, fname))
                broken = True
                continue
            want = ent.get("sha256")
            if want and _sha256_file(path) != want:
                problems.append("digest mismatch for var %r (%s)"
                                % (name, fname))
                broken = True
            shard_bytes += int(ent.get("bytes", 0))
        if (shards and not broken and meta.get("bytes") is not None
                and shard_bytes != int(meta["bytes"])):
            problems.append(
                "shard bytes for var %r sum to %d, manifest records %d"
                % (name, shard_bytes, int(meta["bytes"])))
    for fname in manifest.get("files", []):
        if not os.path.exists(os.path.join(step_dir, fname)):
            problems.append("missing file %s" % fname)
    return problems


def assemble_var(step_dir, meta):
    """One var's full host array from its manifest meta: a plain
    single-file var loads directly; a sharded var (``meta["shards"]``,
    written by elastic/reshard.py's ShardedCheckpointManager)
    concatenates its shard files along the recorded split axis. Both
    dialects load through every restore path — a checkpoint written
    under a 4-way mesh restores into a 1-device scope unchanged."""
    shards = meta.get("shards")
    if not shards:
        return np.load(os.path.join(step_dir, meta["file"]),
                       allow_pickle=False)
    pieces = [np.load(os.path.join(step_dir, s["file"]),
                      allow_pickle=False) for s in shards]
    if len(pieces) == 1:
        return pieces[0]
    return np.concatenate(pieces, axis=int(meta.get("shard_axis", 0)))


def complete_serials(checkpoint_dir):
    """Sorted serials whose dir holds a readable manifest. Temp dirs
    (``.tmp-<pid>``), quarantined dirs (``.corrupt-<n>``) and marker-less
    partials never qualify."""
    out = []
    try:
        entries = os.listdir(checkpoint_dir)
    except OSError:
        return out
    for d in entries:
        if not d.startswith("checkpoint_"):
            continue
        suffix = d[len("checkpoint_"):]
        if not suffix.isdigit():
            continue
        if read_manifest(os.path.join(checkpoint_dir, d)) is not None:
            out.append(int(suffix))
    return sorted(out)


def restored_value(arr, current=None, dtype=None):
    """A value read from a checkpoint as the scope should hold it: a
    tensor of the dtype and on the device of ``current`` (the value it
    replaces), else of the declared ``dtype`` (int64 stays int64 where
    the file carries the JAX package's int32), else the array as read.
    Always a copy: no later in-place update of the scope writes into
    the array read."""
    if isinstance(current, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=current.device,
                                                  dtype=current.dtype)
    if dtype:
        from paddle_tpu_torch.core.types import device_dtype

        return torch.from_numpy(np.array(arr)).to(device_dtype(dtype))
    return np.array(arr)


class CheckpointManager(object):
    """See module docstring. ``executor`` provides the RNG state to
    capture (and receive on restore); ``main_program`` narrows the saved
    set to its persistables (default: every array-valued var in scope)."""

    def __init__(self, checkpoint_dir, executor=None, main_program=None,
                 scope=None, max_to_keep=None):
        self.checkpoint_dir = str(checkpoint_dir)
        self._executor = executor
        self._program = main_program
        self._scope = scope
        if max_to_keep is None:
            from paddle_tpu_torch import flags

            try:
                max_to_keep = int(flags.get("checkpoint_max_to_keep"))
            except (KeyError, TypeError, ValueError):
                max_to_keep = 3
        self.max_to_keep = max(1, int(max_to_keep))
        # serials retention must NEVER delete, regardless of age: the
        # elastic runtime pins a published reshape-barrier serial here
        # while late joiners may still be restoring it
        self.pinned_serials = set()
        self._write_lock = lock_witness.make_lock(
            "resilience.checkpoint.write")   # one writer at a time
        self._thread = None
        self.last_error = None
        self.last_saved_serial = None

    # -- capture ------------------------------------------------------------

    def _live_scope(self):
        if self._scope is not None:
            return self._scope
        from paddle_tpu_torch.executor import global_scope

        return global_scope()

    def _var_names(self, scope):
        if self._program is not None:
            return [v.name for v in self._program.list_vars()
                    if getattr(v, "persistable", False)]
        names = []
        s = scope
        while s is not None:
            names.extend(s.local_var_names())
            s = s._parent
        return names

    def _rng_state(self):
        exe = self._executor
        if exe is None:
            return None
        base = getattr(exe, "_base_seed", None)
        counter = getattr(exe, "_run_counter", None)
        if base is None or counter is None:
            return None
        return {"base_seed": int(base), "run_counter": int(counter)}

    def _snapshot(self, scope):
        """Host copies of every saveable var, in the JAX package's dtypes:
        the ONLY part of a save the training thread waits for. Values
        that are not arrays (tensor arrays, rank tables, reader state)
        are skipped: user code rebuilds them."""
        snap = {}
        for name in self._var_names(scope):
            val = scope.get_value(name)
            if val is None or isinstance(val, TensorArray):
                continue
            if not isinstance(val, (torch.Tensor, np.ndarray, np.generic)):
                continue
            arr = jax_host_array(val)
            if arr.dtype == object or arr.dtype.kind in "OU":
                continue
            snap[name] = arr
        return snap

    # -- save ---------------------------------------------------------------

    def save(self, step, serial=None, extra=None):
        """Synchronous save: snapshot + write + rename before returning.
        Returns the final checkpoint path. Raises on failure (async saves
        record to ``last_error`` instead)."""
        snap = self._snapshot(self._live_scope())
        rng = self._rng_state()
        self.wait()
        return self._write(snap, rng, int(step),
                           int(serial if serial is not None else step),
                           extra or {})

    def save_async(self, step, serial=None, extra=None):
        """Snapshot on the calling thread, write on a background one.
        A still-running previous write is joined first (saves are
        ordered; at most one buffered). Returns the serial."""
        snap = self._snapshot(self._live_scope())
        rng = self._rng_state()
        serial = int(serial if serial is not None else step)
        self.wait()
        t = threading.Thread(
            target=self._write_guarded,
            args=(snap, rng, int(step), serial, extra or {}),
            name="paddle-tpu-ckpt-writer", daemon=True)
        self._thread = t
        t.start()
        return serial

    def wait(self):
        """Block until the in-flight async write (if any) finishes."""
        t = self._thread
        if t is not None and t.is_alive():
            t.join()
        self._thread = None

    def _write_guarded(self, snap, rng, step, serial, extra):
        try:
            self._write(snap, rng, step, serial, extra)
        except Exception as exc:  # noqa: BLE001 - async: report, don't kill
            self.last_error = exc

    def _write_one_var(self, tmp_dir, name, arr):
        """Write one var's file(s) into ``tmp_dir``; returns its manifest
        meta. The seam the elastic layer's ShardedCheckpointManager
        overrides to lay a var out as per-shard files instead."""
        fname = _safe_name(name) + ".npy"
        path = os.path.join(tmp_dir, fname)
        np.save(path, arr)
        return {
            "file": fname,
            "sha256": _sha256_file(path),
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "bytes": int(arr.nbytes),
        }

    def _write(self, snap, rng, step, serial, extra):
        t0 = time.perf_counter()
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        final_dir = os.path.join(self.checkpoint_dir,
                                 "checkpoint_%d" % serial)
        tmp_dir = "%s.tmp-%d" % (final_dir, os.getpid())
        shutil.rmtree(tmp_dir, ignore_errors=True)
        try:
            os.makedirs(tmp_dir)
            vars_meta = {}
            total_bytes = 0
            chaos_on = chaos.ENABLED
            for name in sorted(snap):
                arr = snap[name]
                vars_meta[name] = self._write_one_var(tmp_dir, name, arr)
                if chaos_on:
                    # the mid-write kill/IO-fault point: var files exist,
                    # no manifest yet — a crash here MUST be invisible to
                    # the next restore
                    chaos.fault("ckpt.write")
                total_bytes += int(arr.nbytes)
            manifest = {
                "manifest_version": MANIFEST_VERSION,
                "serial": serial,
                "step": step,
                "ts": time.time(),
                "vars": vars_meta,
                "rng": rng,
                "extra": extra,
            }
            mpath = os.path.join(tmp_dir, MANIFEST_NAME)
            with open(mpath, "w") as f:
                json.dump(manifest, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            # Timed acquire [C003]: _write runs inside the SIGTERM
            # handler chain (TrainSession._signal_handler -> save), and
            # the signal may have interrupted the async writer mid-
            # publish on this very process — an untimed acquire would
            # deadlock short of the final checkpoint. 30s bounds a
            # wedged peer; the raise lands in save()/save_async()'s
            # existing failure accounting and the tmp dir is swept.
            if not self._write_lock.acquire(timeout=30.0):
                raise RuntimeError(
                    "checkpoint publish lock held >30s; aborting save "
                    "of serial %d (peer writer wedged?)" % serial)
            try:
                shutil.rmtree(final_dir, ignore_errors=True)  # re-save
                os.replace(tmp_dir, final_dir)
            finally:
                self._write_lock.release()
            _fsync_dir(self.checkpoint_dir)
        except BaseException:
            _failures.inc(stage="save")
            if blackbox.ENABLED:
                import sys

                exc = sys.exc_info()[1]
                blackbox.record(
                    "checkpoint_failure", stage="save", serial=serial,
                    exc_type=type(exc).__name__,
                    exc_message=str(exc)[:500])
            shutil.rmtree(tmp_dir, ignore_errors=True)
            raise
        self.last_saved_serial = serial
        self._prune(keep_serial=serial)
        dt = time.perf_counter() - t0
        _save_seconds.observe(dt)
        _save_bytes.set(total_bytes)
        if blackbox.ENABLED:
            blackbox.record("checkpoint_saved", serial=serial, step=step,
                            bytes=total_bytes, seconds=round(dt, 4))
        return final_dir

    def _prune(self, keep_serial=None):
        serials = complete_serials(self.checkpoint_dir)
        prune = [s for s in serials
                 if s != keep_serial and s not in self.pinned_serials]
        excess = len(serials) - self.max_to_keep
        for s in prune[:max(excess, 0)]:
            shutil.rmtree(
                os.path.join(self.checkpoint_dir, "checkpoint_%d" % s),
                ignore_errors=True)
        # a writer killed mid-save leaves .tmp dirs; they are dead weight
        # once a NEWER complete checkpoint exists — but another process
        # sharing this dir may be writing its .tmp-<pid> RIGHT NOW, and
        # sweeping a live writer's dir turns its rename into a spurious
        # failure, so only dead writers' leftovers are swept
        try:
            for d in os.listdir(self.checkpoint_dir):
                if ".tmp-" not in d or not d.startswith("checkpoint_"):
                    continue
                base, _, pidstr = d[len("checkpoint_"):].partition(".tmp-")
                if not (base.isdigit() and serials
                        and int(base) <= max(serials)):
                    continue
                if pidstr.isdigit() and int(pidstr) != os.getpid():
                    try:
                        os.kill(int(pidstr), 0)
                        continue  # writer alive: not ours to sweep
                    except ProcessLookupError:
                        pass  # dead writer: orphaned leftovers
                    except OSError:
                        continue  # exists but not ours (EPERM): skip
                shutil.rmtree(
                    os.path.join(self.checkpoint_dir, d),
                    ignore_errors=True)
        except OSError:
            pass

    # -- restore ------------------------------------------------------------

    def _quarantine(self, serial, problems):
        """A corrupt checkpoint is EVIDENCE: rename it out of the serial
        namespace instead of deleting, so restores stop considering it
        but an engineer can still autopsy the bytes."""
        src = os.path.join(self.checkpoint_dir, "checkpoint_%d" % serial)
        n = 0
        dst = "%s.corrupt-%d" % (src, n)
        while os.path.exists(dst):
            n += 1
            dst = "%s.corrupt-%d" % (src, n)
        try:
            os.replace(src, dst)
            # bounded evidence locker: keep the newest few corpses — a
            # storage layer that corrupts every save must not fill the
            # volume with model-sized quarantine dirs (which would then
            # break the healthy save path too)
            corpses = sorted(
                d for d in os.listdir(self.checkpoint_dir)
                if ".corrupt-" in d and d.startswith("checkpoint_"))
            for d in corpses[:-4]:
                shutil.rmtree(os.path.join(self.checkpoint_dir, d),
                              ignore_errors=True)
        except OSError:
            dst = None
        _failures.inc(stage="restore")
        _restores.inc(outcome="corrupt_skipped")
        if blackbox.ENABLED:
            blackbox.record(
                "checkpoint_quarantined", serial=serial,
                quarantined_to=dst, problems=problems[:8])
        import logging

        logging.getLogger("paddle_tpu_torch.resilience.checkpoint").warning(
            "checkpoint serial %d failed verification (%s); quarantined "
            "to %s, falling back to an older serial",
            serial, "; ".join(problems[:3]), dst)
        return dst

    def restore(self, serial=None, restore_rng=True):
        """Load the newest *verified* checkpoint (or exactly ``serial``).
        Corrupt/partial serials are quarantined and skipped serial-by-
        serial. Returns the loaded manifest (with ``serial`` key) or None
        when nothing loadable exists."""
        serials = complete_serials(self.checkpoint_dir)
        if serial is not None:
            serials = [s for s in serials if s == int(serial)]
        for s in reversed(serials):
            step_dir = os.path.join(self.checkpoint_dir,
                                    "checkpoint_%d" % s)
            manifest = read_manifest(step_dir)
            if manifest is not None and not manifest.get("vars"):
                # a v1 marker manifest (io.save_checkpoint): complete,
                # but not this manager's dialect — "restoring" it would
                # load zero vars and still report success. Not corrupt
                # either (io.load_checkpoint loads it), so skip without
                # quarantining.
                continue
            problems = verify_checkpoint_dir(step_dir, manifest)
            if problems:
                self._quarantine(s, problems)
                continue
            try:
                self._load_into_scope(step_dir, manifest)
            except Exception as exc:  # noqa: BLE001 - treat as corrupt
                self._quarantine(s, ["load failed: %s" % exc])
                continue
            if restore_rng:
                self._restore_rng(manifest.get("rng"))
            _restores.inc(outcome="ok")
            return manifest
        return None

    def _load_into_scope(self, step_dir, manifest):
        scope = self._live_scope()
        declared = {}
        if self._program is not None:
            declared = {v.name: v.dtype for v in self._program.list_vars()}
        for name, meta in manifest.get("vars", {}).items():
            scope.set_value(name, restored_value(
                assemble_var(step_dir, meta), scope.get_value(name),
                declared.get(name)))

    def _restore_rng(self, rng):
        exe = self._executor
        if exe is None or not rng:
            return
        if hasattr(exe, "_base_seed"):
            exe._base_seed = int(rng["base_seed"])
        if hasattr(exe, "_run_counter"):
            exe._run_counter = int(rng["run_counter"])

    def latest_serial(self):
        serials = complete_serials(self.checkpoint_dir)
        return serials[-1] if serials else None
