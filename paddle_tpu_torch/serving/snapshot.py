"""Preemption-safe decode sessions: atomic, digest-verified snapshot /
restore of a live paged ``SlotDecodeSession``.

Counterpart of ``paddle_tpu/serving/snapshot.py``, in the JAX package's
dialect: the same file names, shapes, dtypes and manifest meta, so
``tools/ckpt_inspect.py`` reads the port's snapshots and each package
restores the other's. :class:`DecodeSnapshotManager` rides
``resilience.CheckpointManager``'s write and restore machinery (temp dir
+ fsynced manifest + atomic rename, per-var sha256 digests, the async
writer, quarantine of corrupt serials):

* **Device state, live pages gathered on the card.** The per-slot loop
  state (``pgd_table`` / ``pgd_pos`` / ``pgd_tok`` / ``pgd_done`` /
  ``pgd_group_of`` / ``pgd_src_mask``, and ``pgd_score`` on a beam
  session) is saved whole; each layer's self-attention pools as
  ``pgd_kpool_i__live`` (the pages with a nonzero refcount, in page-id
  order) and the cross-attention pools as their live group rows. The
  gather runs on the device (``index_select``) and only the live rows
  cross to the host, through pinned staging buffers that the manager
  keeps across captures; dead pages are never read
  (the admit contract), so they are not state. Int64 loop state is
  written int32, as the JAX package holds it.
* **Host allocator state, exactly.** The refcounted ``PagePool`` (free
  list order included), the ``PrefixCache`` trie and its LRU order, slot
  page lists, fork groups, reservations, the leak ledger, the pending
  queue, banked results, trace ids, beam lanes, owners, parent maps and
  the beam result bank, and a speculative session's drafter state (the
  model drafter's parameters and its ``pgd_draft_*`` pools too).
* **Stream order.** The capture runs on the thread that owns the session
  (a frontend's decode worker), on that thread's current stream, after
  its last replay: the gather is queued behind the step that wrote the
  pools. The writer thread gets host arrays only.
* **Bit-exact resumption.** Sampling keys are ``(seed, slot,
  position)``, never a host counter, so a restored session's tokens are
  bit-identical to the uninterrupted run's, eager or captured.
* **Restore in place.** The live rows are scattered into the fresh
  session's existing pool tensors (``index_copy_``) and the loop state
  is copied into its tensors, so a captured decode graph that binds them
  stays valid and no whole-pool copy is made. A geometry drift raises
  :class:`SnapshotMismatchError` before anything is touched.
* **Graceful preemption.** ``install_signal_handlers`` defers a SIGTERM
  / SIGINT that lands mid-dispatch to the session's quiesce point
  (``_after_dispatch``), banks a final sync snapshot, restores the
  previous handlers and re-raises the signal: the process dies by it.
  Where another thread drives the session (a frontend's decode worker),
  the signal always defers to that thread's next quiesce point, so the
  capture runs behind its last dispatch on its stream; an owner with no
  work left is finalized after ``FINALIZE_GRACE_S``.

``snapshot.write`` is a chaos site (per var file, beside the inherited
``ckpt.write``).
"""

import json
import os
import signal
import threading
import time
from collections import deque

import numpy as np
import torch

from paddle_tpu_torch.core.types import jax_host_array
from paddle_tpu_torch.observability import blackbox
from paddle_tpu_torch.observability import tracing as _tracing
from paddle_tpu_torch.resilience import chaos as _chaos
from paddle_tpu_torch.resilience.checkpoint import (
    CheckpointManager,
    assemble_var,
    complete_serials,
    read_manifest,
    verify_checkpoint_dir,
)
from paddle_tpu_torch.serving.generation import Sampler
from paddle_tpu_torch.serving.kv_pool import PagePool, PrefixCache
from paddle_tpu_torch.serving.server import ServingError

__all__ = ["DecodeSnapshotManager", "SnapshotMismatchError",
           "DIALECT", "DIALECT_VERSION"]

DIALECT = "decode_snapshot"
DIALECT_VERSION = 1

_HANDLED_SIGNALS = (signal.SIGTERM, signal.SIGINT)
# seconds a deferred preemption waits for the session's owner thread to
# reach a quiesce point before it is finalized from a timer thread
FINALIZE_GRACE_S = 2.0

# the loop-state vars saved whole (everything else is gathered live)
_SMALL_VARS = ("pgd_table", "pgd_pos", "pgd_tok", "pgd_done",
               "pgd_group_of", "pgd_src_mask")


class SnapshotMismatchError(ServingError):
    """The snapshot's recorded session geometry (slots, pages, groups,
    layers, sampler, beam, speculation) does not match the session being
    restored into: an operator error, not corruption, so the serial is
    left in place, never quarantined."""


def _sampler_state(sampler):
    if sampler is None:
        return None
    if isinstance(sampler, Sampler):
        return {"strategy": sampler.strategy,
                "temperature": sampler.temperature,
                "top_k": sampler.top_k, "seed": sampler.seed}
    return dict(sampler)


class DecodeSnapshotManager(CheckpointManager):
    """Snapshot / restore one paged :class:`SlotDecodeSession`.

    ``interval_steps`` / ``interval_secs`` arm periodic async snapshots
    at the session's quiesce points (after a ``step()`` / admission
    completes, never mid-dispatch). ``install_signal_handlers`` adds the
    preemption path. The manager writes ``checkpoint_<serial>`` dirs
    that ``tools/ckpt_inspect.py`` reads.

    Timings of the last save and restore: ``last_capture_seconds`` (the
    device gather and the host copy), ``last_save_seconds`` (the write),
    ``last_restore_seconds`` (files to the session), and
    ``last_capture_bytes`` (the bytes gathered from the pools).
    """

    def __init__(self, session, snapshot_dir, interval_steps=0,
                 interval_secs=0.0, max_to_keep=None,
                 install_signal_handlers=False):
        if not getattr(session, "_paged", False):
            raise ValueError(
                "DecodeSnapshotManager needs a paged SlotDecodeSession "
                "— the dense layout has no page table to gather live "
                "state through (run the paged session in production; "
                "it is also the fast one)")
        super(DecodeSnapshotManager, self).__init__(
            snapshot_dir, executor=session._exe, main_program=None,
            scope=session._scope, max_to_keep=max_to_keep)
        self._session = session
        self.interval_steps = int(interval_steps)
        self.interval_secs = float(interval_secs)
        self._last_save_steps = session.steps_done
        self._last_save_time = time.monotonic()
        self.last_save_seconds = None
        self.last_capture_seconds = None
        self.last_capture_bytes = 0
        self.last_restore_seconds = None
        self.restored_serial = None
        self._stop_signum = None
        self._closed = False
        self._finalizing = threading.Lock()
        # var name -> pinned host buffer its live rows are copied into,
        # kept across captures (a fresh pinned allocation costs many
        # times the copy); a capture waits for the previous writer, the
        # one reader of these buffers
        self._staging = {}
        # the thread that drives the session (the last to close a
        # dispatch window): a frontend's decode worker, or the caller's
        self._owner = None
        self._prev_handlers = {}
        session._after_dispatch = self._on_quiesce
        if install_signal_handlers:
            self._install_signal_handlers()

    # -- capture ------------------------------------------------------------

    def _config(self):
        s = self._session
        return {
            "num_slots": s._S, "max_length": s._T, "d_model": s._D,
            "page_size": s._ps, "num_pages": s._P, "num_groups": s._G,
            "steps": s._steps, "n_layer": s._n_layer,
            "n_head": s._n_head, "bos_id": s._bos, "eos_id": s._eos,
            "prefix_cache": s._prefix_cache is not None,
            "sampler": _sampler_state(s._sampler),
            "beam_width": s._beam_width,
            "speculative": (
                {"k": int(s._spec_k), "drafter": s._spec_drafter.kind}
                if s._spec_k else None),
        }

    def _small_vars(self):
        s = self._session
        return _SMALL_VARS + (("pgd_score",)
                              if s._beam_width > 1 else ())

    def _gathered_names(self):
        """(var name, "pages" | "groups") of every pool the snapshot
        gathers, in the JAX package's order."""
        s = self._session
        out = []
        for i in range(s._n_layer):
            out += [("pgd_%s_%d" % (k, i), "pages")
                    for k in ("kpool", "vpool")]
            out += [("pgd_%s_%d" % (k, i), "groups")
                    for k in ("kcross", "vcross")]
        if s._spec_k and s._spec_drafter.kind == "model":
            out += [("pgd_draft_%s_0" % k, "pages")
                    for k in ("kpool", "vpool")]
        return out

    def _gather_live(self, scope, live_pages, live_groups):
        """(file names, device tensors): the live rows of every gathered
        pool, selected on the pool's device."""
        names, rows = [], []
        index = {}
        for name, kind in self._gathered_names():
            ids = live_pages if kind == "pages" else live_groups
            if not ids:
                continue
            pool = scope.get_value(name)
            key = (kind, pool.device)
            if key not in index:
                index[key] = torch.as_tensor(ids, dtype=torch.int64,
                                             device=pool.device)
            names.append(name + "__live")
            rows.append(pool.index_select(0, index[key]))
        return names, rows

    def _rows_to_host(self, names, rows):
        """Host numpy arrays of the gathered rows: on a card each row goes
        by a non-blocking copy into its pinned staging buffer (grown when
        the live rows outgrow it), one wait for all of them; on the CPU
        the ``index_select`` copies themselves."""
        if not rows or rows[0].device.type != "cuda":
            return [r.numpy() for r in rows]
        hosts = []
        for name, r in zip(names, rows):
            buf = self._staging.get(name)
            if buf is None or buf.shape[0] < r.shape[0]:
                buf = torch.empty(r.shape, dtype=r.dtype, pin_memory=True)
                self._staging[name] = buf
            h = buf[:r.shape[0]]
            h.copy_(r, non_blocking=True)
            hosts.append(h)
        torch.cuda.current_stream(rows[0].device).synchronize()
        return [h.numpy() for h in hosts]

    def _capture(self):
        """(vars dict, dialect meta): the consistent host and device
        image of the session, taken on the calling thread (the only part
        a decode loop waits for on an async save). Every array is a host
        copy: the steps that follow update the scope's tensors in
        place."""
        s = self._session
        if s.in_dispatch:
            raise RuntimeError(
                "decode snapshot requested mid-dispatch: the host "
                "mirrors and device state are torn inside a "
                "step/admit window — snapshot at a quiesce point")
        t0 = time.perf_counter()
        scope = self._live_scope()
        snap = {}
        for name in self._small_vars():
            snap[name] = jax_host_array(scope.get_value(name))
        live_pages = sorted(s._pool._ref)
        live_groups = sorted(s._group_members)
        names, rows = self._gather_live(scope, live_pages, live_groups)
        hosts = self._rows_to_host(names, rows)
        self.last_capture_bytes = int(sum(h.nbytes for h in hosts))
        snap.update(zip(names, hosts))
        trg = np.full((s._S, s._T), s._eos, dtype="int64")
        for slot, st in s._live.items():
            trg[slot] = st["trg"]
        snap["live_trg"] = trg
        for req in s._pending:
            snap["req_%d_src" % req["id"]] = np.array(req["src"])
        for rid, tokens in s._results.items():
            # completed-but-unclaimed results survive the preemption too
            snap["req_%d_result" % rid] = np.array(tokens)
        for rid, res in s._beam_results.items():
            snap["req_%d_beam_tokens" % rid] = np.array(res["tokens"])
            snap["req_%d_beam_scores" % rid] = np.array(res["scores"])
        meta = {
            "version": DIALECT_VERSION,
            "config": self._config(),
            # beam slots carry their hypothesis lifecycle (done latch and
            # accumulated score) beside the position
            "live": {str(slot): (
                {"pos": int(st["pos"]), "done": bool(st["done"]),
                 "score": float(st["score"])}
                if "done" in st else {"pos": int(st["pos"])})
                for slot, st in s._live.items()},
            "free_slots": list(s._free),
            "slot_pages": {str(k): [int(p) for p in v]
                           for k, v in s._slot_pages.items()},
            "slot_group": {str(k): int(g)
                           for k, g in s._slot_group.items()},
            "free_groups": list(s._free_groups),
            "group_members": {str(g): sorted(m)
                              for g, m in s._group_members.items()},
            "reserved_pages": s._reserved_pages,
            "leaked_pages": s._leaked_pages,
            "leaked_page_ids": sorted(s._leaked_page_ids),
            "pool": s._pool.state_dict(),
            "prefix_cache": (s._prefix_cache.state_dict()
                             if s._prefix_cache is not None else None),
            "live_pages": live_pages,
            "live_groups": live_groups,
            "pending": [{"id": r["id"], "len": r["len"],
                         "prefix": r["prefix"]} for r in s._pending],
            "results": sorted(s._results),
            "owner": {str(slot): int(rid)
                      for slot, rid in s._owner.items()},
            # the restored process continues banked backlog and unclaimed
            # results under their original trace ids
            "trace_ids": {str(rid): str(tid)
                          for rid, tid in s._trace_ids.items()},
            "next_req": s._next_req,
            "steps_done": s.steps_done,
        }
        if s._spec_k:
            # acceptance books and the drafter's own state; a model
            # drafter's parameters travel too (acceptance timing decides
            # which slot a backlog request lands in, and the slot keys
            # the sampler stream); its pools ride the gather above
            meta["speculative"] = {
                "counters": {
                    "proposed": int(s.spec_proposed),
                    "accepted": int(s.spec_accepted),
                    "dispatches": int(s.spec_dispatches),
                },
                "drafter": {"kind": s._spec_drafter.kind,
                            "state": s._spec_drafter.state_dict()},
            }
            if s._spec_drafter.kind == "model":
                dparams = s._spec_drafter.param_arrays()
                meta["speculative"]["drafter"]["params"] = sorted(dparams)
                for pname, arr in dparams.items():
                    snap["spec_dparam__" + pname] = arr
        if s._beam_width > 1:
            # the hypothesis -> slot binding, lane occupancy, the last
            # parent permutation and the banked n-bests: a mid-beam
            # restore resumes the lattice bit-exactly
            meta["beam"] = {
                "width": s._beam_width,
                "lanes": {str(lane): {"slots": [int(x)
                                                for x in b["slots"]]}
                          for lane, b in s._beam_live.items()},
                "free_lanes": [int(x) for x in s._free_lanes],
                "last_parents": {str(lane): [int(p) for p in perm]
                                 for lane, perm
                                 in s._last_parents.items()},
                "owner": {str(lane): int(rid)
                          for lane, rid in s._beam_owner.items()},
                "results": sorted(s._beam_results),
            }
        self.last_capture_seconds = time.perf_counter() - t0
        return snap, meta

    # -- save ---------------------------------------------------------------

    def _write_one_var(self, tmp_dir, name, arr):
        meta = super(DecodeSnapshotManager, self)._write_one_var(
            tmp_dir, name, arr)
        if _chaos.ENABLED:
            # var files exist, no manifest yet: a crash here must be
            # invisible to the next restore
            _chaos.fault("snapshot.write")
        return meta

    def _prepare(self, step, serial, extra):
        # the previous writer reads the staging buffers this capture
        # fills: it finishes first
        self.wait()
        snap, meta = self._capture()
        rng = self._rng_state()
        step = int(self._session.steps_done if step is None else step)
        serial = int(step if serial is None else serial)
        payload = dict(extra or {})
        payload[DIALECT] = meta
        return snap, rng, step, serial, payload

    def save(self, step=None, serial=None, extra=None):
        """Synchronous snapshot (capture, write and rename before
        returning); the preemption finalizer's path. Returns the final
        snapshot dir."""
        snap, rng, step, serial, payload = self._prepare(step, serial,
                                                          extra)
        t0 = time.perf_counter()
        out = self._write(snap, rng, step, serial, payload)
        self.last_save_seconds = time.perf_counter() - t0
        self._mark_saved()
        return out

    def save_async(self, step=None, serial=None, extra=None):
        """Capture on the calling thread (the decode loop pays only the
        device gather and the host copy), write on a background one.
        Returns the serial."""
        snap, rng, step, serial, payload = self._prepare(step, serial,
                                                          extra)
        t = threading.Thread(
            target=self._write_guarded,
            args=(snap, rng, step, serial, payload),
            name="paddle-tpu-decode-snap-writer", daemon=True)
        self._thread = t
        t.start()
        self._mark_saved()
        return serial

    def _mark_saved(self):
        self._last_save_steps = self._session.steps_done
        self._last_save_time = time.monotonic()

    def _snapshot_due(self):
        if (self.interval_steps > 0
                and self._session.steps_done - self._last_save_steps
                >= self.interval_steps):
            return True
        return (self.interval_secs > 0
                and time.monotonic() - self._last_save_time
                >= self.interval_secs)

    # -- restore ------------------------------------------------------------

    def restore(self, serial=None):
        """Load the newest verified decode snapshot (or exactly
        ``serial``) into the attached session. Corrupt or partial serials
        are quarantined and skipped; manifests of other dialects are
        skipped; a geometry mismatch raises
        :class:`SnapshotMismatchError` without quarantining. Returns the
        manifest (with ``serial``) or None when nothing restorable
        exists."""
        t0 = time.perf_counter()
        serials = complete_serials(self.checkpoint_dir)
        if serial is not None:
            serials = [s for s in serials if s == int(serial)]
        for s in reversed(serials):
            step_dir = os.path.join(self.checkpoint_dir,
                                    "checkpoint_%d" % s)
            manifest = read_manifest(step_dir)
            meta = ((manifest or {}).get("extra") or {}).get(DIALECT)
            if meta is None:
                continue  # some other manager's checkpoint: not ours
            problems = verify_checkpoint_dir(step_dir, manifest)
            if problems:
                self._quarantine(s, problems)
                continue
            if meta.get("config") != self._config():
                raise SnapshotMismatchError(
                    "decode snapshot serial %d was taken from a "
                    "different session geometry:\n  recorded:  %s\n  "
                    "restoring: %s" % (s, json.dumps(
                        meta.get("config"), sort_keys=True),
                        json.dumps(self._config(), sort_keys=True)))
            try:
                self._apply(step_dir, manifest, meta)
            except SnapshotMismatchError:
                raise
            except Exception as exc:  # noqa: BLE001 - treat as corrupt
                self._quarantine(s, ["decode apply failed: %s" % exc])
                continue
            self._restore_rng(manifest.get("rng"))
            self.restored_serial = s
            self.last_restore_seconds = time.perf_counter() - t0
            if blackbox.ENABLED:
                blackbox.record("decode_snapshot_restored", serial=s,
                                steps_done=self._session.steps_done)
            return manifest
        return None

    def _apply(self, step_dir, manifest, meta):
        """Rebuild the session from one verified serial. Everything
        fallible (file loads, shape checks, allocator reconstruction with
        ``PagePool.from_state``'s conservation check) happens before the
        first mutation, so a torn snapshot quarantines without leaving
        the session half-restored."""
        s = self._session
        if s.in_dispatch:
            raise RuntimeError("cannot restore mid-dispatch")
        vars_meta = manifest.get("vars", {})
        scope = self._live_scope()

        def load(name):
            return assemble_var(step_dir, vars_meta[name])

        # -- phase 1: load and validate (no session mutation) -------------
        small = {}
        for name in self._small_vars():
            arr, cur = load(name), scope.get_value(name)
            if tuple(arr.shape) != tuple(cur.shape):
                raise SnapshotMismatchError(
                    "snapshot var %r has shape %s, the session's %s"
                    % (name, tuple(arr.shape), tuple(cur.shape)))
            small[name] = (cur, arr)
        live_trg = load("live_trg")
        ids = {"pages": [int(p) for p in meta["live_pages"]],
               "groups": [int(g) for g in meta["live_groups"]]}
        gathered = []
        for name, kind in self._gathered_names():
            if not ids[kind] or name + "__live" not in vars_meta:
                continue
            rows, pool = load(name + "__live"), scope.get_value(name)
            if (tuple(rows.shape) != (len(ids[kind]),) + tuple(
                    pool.shape[1:]) or max(ids[kind]) >= pool.shape[0]):
                raise SnapshotMismatchError(
                    "snapshot var %r__live has shape %s for %d %s; the "
                    "session's pool is %s" % (
                        name, tuple(rows.shape), len(ids[kind]), kind,
                        tuple(pool.shape)))
            gathered.append((pool, ids[kind], rows))
        spec_meta = meta.get("speculative")
        spec_dparams = {}
        if spec_meta is not None:
            spec_dparams = {
                pname: load("spec_dparam__" + pname)
                for pname in (spec_meta.get("drafter") or {}).get(
                    "params", ())}
        pool = PagePool.from_state(meta["pool"])
        cache = None
        if meta.get("prefix_cache") is not None:
            cache = PrefixCache.from_state(pool, meta["prefix_cache"])
        pending = [{
            "id": int(r["id"]),
            "src": np.array(load("req_%d_src" % int(r["id"])),
                            dtype="int64"),
            "len": int(r["len"]),
            "prefix": (None if r["prefix"] is None
                       else [int(t) for t in r["prefix"]]),
        } for r in meta["pending"]]
        results = {int(r): np.array(load("req_%d_result" % int(r)))
                   for r in meta.get("results", ())}
        beam_meta = meta.get("beam")
        beam_results = {}
        if beam_meta is not None:
            beam_results = {
                int(r): {
                    "tokens": np.array(load("req_%d_beam_tokens" % int(r))),
                    "scores": np.array(load("req_%d_beam_scores" % int(r))),
                } for r in beam_meta.get("results", ())}
        live = {}
        for k, v in meta["live"].items():
            st = {"trg": np.array(live_trg[int(k)], dtype="int64"),
                  "pos": int(v["pos"])}
            if "done" in v:
                st["done"] = bool(v["done"])
                st["score"] = float(v["score"])
            live[int(k)] = st

        # -- phase 2: commit, in place ------------------------------------
        for cur, arr in small.values():
            cur.copy_(torch.from_numpy(np.array(arr)).to(cur.dtype))
        for pool_t, id_list, rows in gathered:
            idx = torch.as_tensor(id_list, dtype=torch.int64,
                                  device=pool_t.device)
            src = torch.from_numpy(np.array(rows)).to(
                device=pool_t.device, dtype=pool_t.dtype)
            pool_t.index_copy_(0, idx, src)
        s._pool = pool
        s._prefix_cache = cache
        s._live = live
        s._free = [int(x) for x in meta["free_slots"]]
        s._slot_pages = {int(k): [int(p) for p in v]
                         for k, v in meta["slot_pages"].items()}
        s._slot_group = {int(k): int(g)
                         for k, g in meta["slot_group"].items()}
        s._free_groups = [int(g) for g in meta["free_groups"]]
        s._group_members = {int(g): set(int(m) for m in v)
                            for g, v in meta["group_members"].items()}
        s._reserved_pages = int(meta["reserved_pages"])
        s._leaked_pages = int(meta["leaked_pages"])
        s._leaked_page_ids = set(
            int(p) for p in meta.get("leaked_page_ids", ()))
        s._pending = deque(pending)
        s._results = results
        s._owner = {int(k): int(v) for k, v in meta["owner"].items()}
        s._trace_ids = {int(k): str(v)
                        for k, v in meta.get("trace_ids", {}).items()}
        s._slot_traces = {}
        s._trace_cow = {}
        if s._trace_ids and _tracing.ENABLED:
            # requests live at snapshot time continue their traces under
            # the original ids; queued ones re-bind at re-admission
            by_rid = {rid: slot for slot, rid in s._owner.items()}
            for rid, tid in s._trace_ids.items():
                slot = by_rid.get(rid)
                if slot is None or slot not in s._live:
                    continue
                if _tracing.inflight_get(tid) is None:
                    _tracing.start(tid, endpoint="generate",
                                   origin="session")
                s._slot_traces[slot] = tid
        s._next_req = int(meta["next_req"])
        s.steps_done = int(meta["steps_done"])
        if spec_meta is not None:
            counters = spec_meta.get("counters", {})
            s.spec_proposed = int(counters.get("proposed", 0))
            s.spec_accepted = int(counters.get("accepted", 0))
            s.spec_dispatches = int(counters.get("dispatches", 0))
            s._spec_drafter.load_state_dict(
                (spec_meta.get("drafter") or {}).get("state") or {})
            if spec_dparams:
                s._spec_drafter.load_param_arrays(spec_dparams)
        if beam_meta is not None:
            s._beam_live = {
                int(lane): {"slots": [int(x) for x in b["slots"]]}
                for lane, b in beam_meta["lanes"].items()}
            s._free_lanes = [int(x) for x in beam_meta["free_lanes"]]
            s._last_parents = {
                int(lane): [int(p) for p in perm]
                for lane, perm in beam_meta["last_parents"].items()}
            s._beam_owner = {int(lane): int(rid)
                             for lane, rid in beam_meta["owner"].items()}
            s._beam_results = beam_results
            s._beam_events = {}
            s._last_finished_beams = {}

    # -- preemption plumbing -------------------------------------------------

    def _install_signal_handlers(self):
        if threading.current_thread() is not threading.main_thread():
            return
        for sig in _HANDLED_SIGNALS:
            try:
                self._prev_handlers[sig] = signal.signal(
                    sig, self._signal_handler)
            except (ValueError, OSError):
                pass

    def _uninstall_signal_handlers(self):
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError, TypeError):
                pass
        self._prev_handlers = {}

    def _signal_handler(self, signum, frame):
        if self._closed:
            # already finalized on a thread that could not restore the
            # handlers (a frontend's decode worker): the re-raised signal
            # landed back here, on the main thread; die by it
            try:
                signal.signal(signum, signal.SIG_DFL)
            except (ValueError, OSError):
                pass
            os.kill(os.getpid(), signum)
            return
        self._stop_signum = signum
        if blackbox.ENABLED:
            blackbox.record(
                "preemption_signal", signal=int(signum),
                steps_done=self._session.steps_done,
                in_dispatch=self._session.in_dispatch)
        owner = self._owner
        if (owner is not None and owner is not threading.current_thread()
                and owner.is_alive()):
            # another thread drives the session (a frontend's decode
            # worker): the capture must run there, behind its last
            # dispatch on its stream, so its next quiesce point
            # finalizes; an owner with no work left is finalized here
            # after a grace period
            t = threading.Timer(FINALIZE_GRACE_S, self._finalize_if_idle)
            t.daemon = True
            t.start()
            return
        if not self._session.in_dispatch:
            # idle between dispatches: finalize in handler context
            self._finalize_and_reraise()
        # else: _on_quiesce finalizes once the in-flight window closes

    def _finalize_if_idle(self):
        # the owner opens a dispatch window only under the session's
        # window lock: held from the idle check to the end of the final
        # save, it keeps the owner from tearing the capture
        with self._session._window_lock:
            if not self._closed and not self._session.in_dispatch:
                self._finalize_and_reraise()

    def should_stop(self):
        """True once a preemption signal landed (pollable by a serving
        loop between pumps)."""
        return self._stop_signum is not None

    def _on_quiesce(self):
        """The session's post-dispatch hook: finalize a deferred
        preemption, else take a periodic snapshot when due."""
        self._owner = threading.current_thread()
        if self._stop_signum is not None:
            self._finalize_and_reraise()
        elif not self._closed and self._snapshot_due():
            self.save_async()

    def _finalize_and_reraise(self):
        if not self._finalizing.acquire(blocking=False):
            return  # another thread is banking the final snapshot
        signum = self._stop_signum
        try:
            self.save()
        except Exception:
            # the signal must still propagate if the final snapshot
            # failed
            pass
        self.close(save=False)
        os.kill(os.getpid(), signum)

    # -- lifecycle ----------------------------------------------------------

    def close(self, save=True):
        """Detach from the session and (by default) bank a final sync
        snapshot. Idempotent."""
        if self._closed:
            return
        self._closed = True
        if save:
            try:
                self.save()
            except Exception:
                pass
        else:
            self.wait()
        self._staging = {}
        self._uninstall_signal_handlers()
        if self._session._after_dispatch is self._on_quiesce:
            self._session._after_dispatch = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # a clean exit banks the final state; an exception keeps the last
        # periodic snapshot (saving mid-exception could bank a torn op)
        self.close(save=exc_type is None)
        return False
