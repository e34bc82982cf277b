"""Executor: run Programs on a Place.

Counterpart of ``paddle_tpu/executor.py`` (python/paddle/fluid/
executor.py:374 parity). ``run`` feeds numpy arrays onto the Place's
device, interprets block 0 op by op (``core/lowering.BlockLowerer``),
writes the persistable vars the block produced back into the Scope and
fetches results as numpy. ``run_multi_step`` runs the block K times,
threading state from one iteration to the next. On a card it captures
the K-step loop into one CUDA graph and replays it (the JAX package
scans the step inside one executable); on the CPU it is a Python loop.

State is updated in place where an op says so: the paged-KV ops write
into the pool tensors the Scope holds (saving a whole pool copy per layer
per token), so a scope value and the run's environment are the same
tensor object throughout. Every other variable leaves the run's
environment after the last op that uses it, unless it is fetched or
written back (``BlockLowerer.release_plan``): a Transformer train step
holds each activation only until its grad op has read it.

Where a block holds a forward op and its ``<type>_grad``, the forward
runs once and the grad op differentiates its recorded graph (the forward
tape, ``core/lowering``); the pairing is analyzed once per program
version, beside the release plan. ``grad_op_reruns`` counts the grad ops
that reran their forward instead (no tape entry, or inputs changed since
the forward): none in a train step.

``run_async`` returns a ``FetchHandle`` right after the ops are queued on
the card: a CUDA event recorded behind them tells ``done()`` and
``result(timeout=...)`` when the fetches are ready.

``FLAGS_check_nan_inf`` scans every floating state value a run wrote and
every floating fetch after ``run``, after ``run_async``'s ``result()``
and after ``run_multi_step`` (the bound tensors, after a replay):
``torch.isfinite(t).all()`` per tensor, stacked into one bool vector read
on the host once, and the JAX package's ``RuntimeError`` naming the first
bad variable.

Every run puts its work on the card its Place names, whatever device
the calling thread has current (serving runs arrive from worker
threads).

``FLAGS_verify_program`` runs the structural verifier
(``analysis.check_program``) with the concrete feed shapes on every miss
of the analysis cache, as the JAX package does on every fresh compile.

The captured loop (``run_multi_step`` on a card, ``FLAGS_cuda_graph``
on): the first call for a key (program, version and AMP dtype, feed
shapes and dtypes, fetches, scope, steps, stacking, device) runs the
eager loop, which builds the kernels and their handles; the second
captures the loop (``torch.cuda.graph`` in ``thread_local`` capture
mode, on a side stream: another thread may launch kernels, allocate and
wait on events meanwhile, as a serving process's batch workers do) and
replays it; later calls only replay. The graph binds the scope's state
tensors as they were at capture: a state value a step produces as a new
tensor is copied into its bound tensor at the end of the loop, and a
scope value that an eager ``run`` replaced since the last replay is
copied in (and the scope re-pointed at the bound tensor) before the
next. In-place state (the KV pools, the page table) is never copied.

Random numbers are jax's threefry stream (``core/prng.py``), keyed as
the JAX package keys them: each ``run``, ``run_async`` and
``run_multi_step`` call advances the run counter and takes the key
``fold_in(PRNGKey(program.random_seed or base_seed), counter)``; a
multi-step loop folds in the step index, and each op its
``__rng_id__``. A captured loop binds the key as a device tensor that
the host writes before each replay (as it rebinds state): the step and
op folds run inside the graph, in the threefry kernel's launches, so a
program with random ops is captured like any other.
``eager_multi_step`` counts the loops run eagerly on a card because
``FLAGS_cuda_graph`` is off.
"""

import contextlib
import logging
import time
import weakref

import numpy as np
import torch

from paddle_tpu_torch import flags, framework
from paddle_tpu_torch.observability import telemetry as _telemetry
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.lowering import BlockLowerer
from paddle_tpu_torch.kernels import build as _kbuild
from paddle_tpu_torch.ops.io_ops import HOST_IO_OPS
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.core.types import (
    CUDAPlace,
    Place,
    TensorArray,
    VarType,
    device_dtype,
)

_global_scope = Scope()
_scope_stack = [_global_scope]


def global_scope():
    """The scope Executor.run defaults to; ``scope_guard`` swaps it."""
    return _scope_stack[-1]


@contextlib.contextmanager
def scope_guard(scope):
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()


def _to_numpy(t):
    """A numpy array the caller owns: the host copy of a card tensor, or
    a copy of a CPU tensor (which may be a scope value that a later run
    writes in place). A tensor array becomes a ``LoDTensorArray`` of its
    ``size`` written rows."""
    if isinstance(t, TensorArray):
        from paddle_tpu_torch.layers.control_flow import LoDTensorArray

        n = int(t.size)
        return LoDTensorArray(_to_numpy(t.buffer[j]) for j in range(n))
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return _bf16_numpy(t)
    return t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()


def _bf16_numpy(t):
    """A bf16 tensor as numpy holds bf16, the ``ml_dtypes.bfloat16`` array
    the JAX package fetches (numpy itself has no bf16)."""
    try:
        import ml_dtypes
    except ImportError:
        raise TypeError(
            "fetching a bfloat16 value as numpy needs the ml_dtypes package; "
            "fetch it with return_numpy=False for the tensor")
    bits = t.cpu().view(torch.int16).numpy().copy()
    return bits.view(ml_dtypes.bfloat16)


def _maybe_verify(program, feeds, fetch_names, origin):
    """FLAGS_verify_program gate (executor.py ``_maybe_verify`` parity):
    run the structural verifier with the concrete feed shapes before a
    program's first run of a signature. Raises
    ``analysis.ProgramVerifyError`` on error-severity findings; the
    others go to the analysis logger."""
    if not flags.get("verify_program"):
        return
    from paddle_tpu_torch.analysis import check_program

    diags = check_program(
        program, level="error", fetch_names=fetch_names,
        feed_shapes={n: tuple(t.shape) for n, t in feeds.items()},
        origin=origin)
    if diags:
        logging.getLogger("paddle_tpu_torch.analysis").info(
            "verify (%s): %d non-error diagnostic(s): %s", origin,
            len(diags), "; ".join(str(d) for d in diags[:5]))


_NAN_INF_MSG = ("NaN/Inf detected in variable %r after program run "
                "(FLAGS_check_nan_inf)")


def _nan_check_start(named):
    """``FLAGS_check_nan_inf``'s device half: queue one finiteness
    reduction per floating tensor of ``named`` (``[(name, tensor)]``,
    state first, then fetches, the JAX package's order) and stack them.
    Returns ``(names, flags)`` for :func:`_nan_check_finish`, or None
    when the flag is off or nothing is floating."""
    if not flags.get("check_nan_inf"):
        return None
    names, finite = [], []
    for name, t in named:
        if isinstance(t, TensorArray):
            t = t.buffer
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            names.append(name)
            finite.append(torch.isfinite(t).all())
    if not finite:
        return None
    return names, torch.stack(finite)


def _nan_check_finish(pending):
    """The host half: one read of the stacked flags; raises on the first
    variable that holds a NaN or an Inf."""
    if pending is None:
        return
    names, finite = pending
    finite = finite.cpu()
    if not bool(finite.all()):
        bad = names[int(torch.argmin(finite.to(torch.uint8)))]
        raise RuntimeError(_NAN_INF_MSG % bad)


class FetchTimeoutError(RuntimeError):
    """``FetchHandle.result(timeout=...)`` expired before the fetches were
    ready. The handle is untouched: a later ``result()`` still returns
    the values (the caller rejects the request, not the computation)."""

    def __init__(self, timeout, fetch_names):
        super(FetchTimeoutError, self).__init__(
            "async fetch of %s did not materialize within %.3fs"
            % (list(fetch_names), timeout))
        self.timeout = timeout
        self.fetch_names = list(fetch_names)


class FetchHandle(object):
    """The fetches of one ``Executor.run_async`` dispatch
    (executor.py:158 parity).

      ``arrays()``             the fetched tensors (no wait)
      ``done()``               True once the card has computed them
      ``block_until_ready()``  wait for the card, no copy
      ``result()``             numpy values (waits; memoized), equal to
                               ``run(...)``'s bit for bit
      ``result(timeout=s)``    the same, or :class:`FetchTimeoutError`
                               if they are not ready within ``s`` seconds

    ``event`` is a ``torch.cuda.Event`` recorded on the dispatching
    stream after the last op; None (CPU) means done at once.
    """

    def __init__(self, tensors, fetch_names, event=None, nan_check=None):
        self._tensors = list(tensors)
        self.fetch_names = list(fetch_names)
        self._event = event
        self._numpy = None
        # FLAGS_check_nan_inf's flags, queued at dispatch
        self._nan_check = nan_check

    def __len__(self):
        return len(self._tensors)

    def arrays(self):
        return list(self._tensors)

    def done(self):
        return self._event is None or self._event.query()

    def block_until_ready(self):
        if self._event is not None:
            self._event.synchronize()
        return self

    def result(self, timeout=None):
        if self._numpy is None and timeout is not None:
            # poll, never block: a wait with no bound would make the
            # timeout a lie exactly when the card is stuck
            deadline = time.monotonic() + float(timeout)
            pause = 5e-4
            while not self.done():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise FetchTimeoutError(float(timeout),
                                            self.fetch_names)
                time.sleep(min(pause, remaining))
                pause = min(pause * 2, 0.05)
        if self._numpy is None:
            t0 = time.perf_counter()
            _nan_check_finish(self._nan_check)
            self._numpy = [_to_numpy(t) for t in self._tensors]
            if _telemetry.ENABLED:
                _telemetry.record_fetch_materialize(
                    time.perf_counter() - t0)
        return self._numpy


class Executor(object):
    """Runs Programs on ``place``: ``CUDAPlace(0)`` when none is given,
    which raises on a machine without a card."""

    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        if not isinstance(self.place, Place):
            raise TypeError("place must be a Place (CUDAPlace()/CPUPlace())")
        self.device = self.place.torch_device()
        if self.device.type == "cuda":
            # fp32 means fp32, as in the JAX package's serving path: no
            # TF32 rounding in matrix products or convolutions
            matmul = torch.backends.cuda.matmul
            matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            # bf16 products accumulate in float32, as XLA's do: no
            # reduced-precision split-K reductions
            matmul.allow_bf16_reduced_precision_reduction = False
        self._run_counter = 0
        self._base_seed = np.random.randint(0, 2 ** 31 - 1)
        # (id(program), version, AMP dtype, feed names, scope names, fetch
        # names) -> (program, state_in, state_out, release plan, grad
        # pairs); the program ref guards against id reuse
        self._analysis = {}
        # run_multi_step's captured loops: key -> _CapturedLoop
        self._graphs = {}
        # what captures a K-step loop: CUDA graphs on a card, nothing on
        # the CPU (the eager loop); a stand-in object with the same
        # ``capture(body, device)`` method routes the CPU through the
        # capture path too
        self.graph_capturer = (_CUDAGraphCapturer()
                               if self.device.type == "cuda" else None)
        # run_multi_step calls that ran the eager loop where a capture
        # could have run (FLAGS_cuda_graph off); the warm-up call of a
        # captured key is not counted
        self.eager_multi_step = 0
        # grad ops that reran their forward lowering (no forward tape
        # entry); the tape serves every grad op of a train step
        self.grad_op_reruns = 0
        # the forward tape; off, every grad op reruns its forward (the
        # tests' oracle)
        self._grad_tape = True

    # -- shared run plumbing -------------------------------------------------
    def _prepare_feeds(self, program, feed):
        """numpy / tensor feeds -> tensors on the device, cast to the
        declared var dtype when the kinds agree."""
        feeds = {}
        for name, value in feed.items():
            # always a copy: ops that update state in place must never
            # write into the caller's array
            var = program.global_block()._find_var_recursive(name)
            if var is not None and var.type == VarType.LOD_TENSOR_ARRAY:
                raise TypeError(
                    "feed %r: a tensor array variable cannot be fed; write "
                    "it in the program (array_write, lod_tensor_to_array)"
                    % name)
            t = value.clone() if isinstance(value, torch.Tensor) else \
                torch.from_numpy(np.array(value))
            if var is not None and var.dtype:
                want = device_dtype(var.dtype)
                same_kind = (t.dtype.is_floating_point
                             == want.is_floating_point)
                if t.dtype != want and same_kind and t.dtype != torch.bool:
                    t = t.to(want)
            feeds[name] = t.to(self.device)
        return feeds

    @staticmethod
    def _scope_names(scope):
        names = set()
        s = scope
        while s is not None:
            names.update(s.local_var_names())
            s = s._parent
        return names

    def _analyze(self, program, feeds, scope, fetch_names, origin):
        scope_names = frozenset(self._scope_names(scope))
        key = (id(program), program._version, program._amp_dtype,
               frozenset(feeds), scope_names, tuple(fetch_names))
        hit = self._analysis.get(key)
        if hit is not None and hit[0] is program:
            return hit[1:]
        _maybe_verify(program, feeds, fetch_names, origin)
        # the verifier may resolve deferred shapes (a new version)
        key = (id(program), program._version) + key[2:]
        lowerer = BlockLowerer(program, 0)
        state_in, state_out = lowerer.analyze(scope_names, set(feeds))
        release = lowerer.release_plan(set(fetch_names) | set(state_out))
        pairs = lowerer.grad_pairs()
        self._analysis[key] = (program, state_in, state_out, release, pairs)
        return state_in, state_out, release, pairs

    def _gather_state(self, state_in, scope):
        state = {}
        for n in state_in:
            v = scope.find_var(n)
            if v is None or v.value is None:
                raise RuntimeError(
                    "persistable variable %r is not initialized in the scope "
                    "(did you run the startup program?)" % n)
            val = v.value
            if not isinstance(val, torch.Tensor) or val.device != self.device:
                # numpy, or a tensor on another Place: move it ONCE and
                # keep the device copy in the scope
                if not isinstance(val, torch.Tensor):
                    val = torch.from_numpy(np.array(val))
                val = val.to(self.device)
                v.set(val)
            state[n] = val
        return state

    def _step_key(self, program):
        """The run's key, ``fold_in(PRNGKey(program.random_seed or
        base_seed), run_counter)`` after advancing the counter, as the
        JAX package's ``Executor._step_key``: a host ``prng.KeyChain``."""
        self._run_counter += 1
        return prng.KeyChain(prng.PRNGKey_pair(
            program.random_seed or self._base_seed)).fold_in(
                self._run_counter)

    @staticmethod
    def _fetch_names(fetch_list):
        return [v.name if isinstance(v, framework.Variable) else str(v)
                for v in fetch_list]

    def _step(self, lowerer, state, feeds, fetch_names, key, release,
              pairs):
        env = dict(state)
        env.update(feeds)
        try:
            lowerer.lower_into(env, self.device, key, release,
                               pairs if self._grad_tape else None)
        finally:
            self.grad_op_reruns += lowerer.grad_reruns
            lowerer.grad_reruns = 0
        fetches = []
        for n in fetch_names:
            if n not in env:
                raise RuntimeError(
                    "fetch variable %r was not produced by the program" % n)
            fetches.append(env[n])
        return env, fetches

    def _on_device(self):
        """The Place's card as the current device of the calling thread
        (a no-op on the CPU)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _run(self, program, feed, fetch_list, scope):
        """Queue one run's ops; returns (fetch names, fetch tensors, the
        pending ``FLAGS_check_nan_inf`` flags or None)."""
        program = program or framework.default_main_program()
        scope = scope or global_scope()
        feeds = self._prepare_feeds(program, feed or {})
        fetch_names = self._fetch_names(fetch_list or [])
        state_in, state_out, release, pairs = self._analyze(
            program, feeds, scope, fetch_names, "Executor.run")
        state = self._gather_state(state_in, scope)
        lowerer = BlockLowerer(program, 0, is_test=program._is_test)
        env, fetches = self._step(lowerer, state, feeds, fetch_names,
                                  self._step_key(program), release, pairs)
        written = [(n, env[n]) for n in state_out if n in env]
        for n, t in written:
            scope.set_value(n, t)
        return fetch_names, fetches, _nan_check_start(
            written + list(zip(fetch_names, fetches)))

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True):
        t0 = time.perf_counter()
        with self._on_device():
            _names, fetches, pending = self._run(program, feed, fetch_list,
                                                 scope)
            _nan_check_finish(pending)
            if return_numpy:
                fetches = [_to_numpy(f) for f in fetches]
        if _telemetry.ENABLED:
            _telemetry.record_step("executor", time.perf_counter() - t0)
        return fetches

    def run_async(self, program=None, feed=None, fetch_list=None,
                  feed_var_name="feed", fetch_var_name="fetch", scope=None):
        """``run`` without the wait (executor.py:775 parity): queues the
        run's ops and returns a :class:`FetchHandle` whose ``result()``
        copies the fetches to numpy when asked. The scope's state is
        updated with the queued tensors, so runs dispatched back to back
        chain on the card's stream."""
        t0 = time.perf_counter()
        with self._on_device():
            fetch_names, fetches, pending = self._run(program, feed,
                                                      fetch_list, scope)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
        if _telemetry.ENABLED:
            _telemetry.record_step("async", time.perf_counter() - t0,
                                   dispatch_only=True)
        return FetchHandle(fetches, fetch_names, event, nan_check=pending)

    def run_multi_step(self, program, steps, feed=None, fetch_list=None,
                       scope=None, return_numpy=True, stack_fetches=False):
        """Run ``steps`` iterations of ``program``; each iteration reads
        the state the previous one wrote. ``feed`` is constant across the
        steps. Fetches are the last step's values, or with
        ``stack_fetches=True`` every step's, stacked on a leading [steps]
        axis. On a card the loop runs as one captured CUDA graph (module
        docstring); ``FLAGS_cuda_graph=0`` runs it eagerly there."""
        steps = int(steps)
        if steps <= 0:
            raise ValueError("multi-step needs steps >= 1, got %d" % steps)
        t0 = time.perf_counter()
        with self._on_device():
            out = self._multi_step(program, steps, feed, fetch_list, scope,
                                   return_numpy, stack_fetches)
        if _telemetry.ENABLED:
            _telemetry.record_step("multi_step", time.perf_counter() - t0,
                                   steps=steps)
        return out

    def _multi_step(self, program, steps, feed, fetch_list, scope,
                    return_numpy, stack_fetches):
        program = program or framework.default_main_program()
        scope = scope or global_scope()
        feeds = self._prepare_feeds(program, feed or {})
        fetch_names = self._fetch_names(fetch_list or [])
        state_in, state_out, release, pairs = self._analyze(
            program, feeds, scope, fetch_names, "Executor.run_multi_step")
        extra_out = set(state_out) - set(state_in)
        if extra_out:
            raise RuntimeError(
                "multi-step run needs state_out ⊆ state_in; program "
                "creates persistables mid-run: %s" % sorted(extra_out))
        plan = (state_in, state_out, release, pairs)
        if self.graph_capturer is not None and flags.get("cuda_graph"):
            _refuse_host_reads(program)
            out = self._graph_loop(program, steps, feeds, fetch_names, scope,
                                   plan, stack_fetches)
        else:
            out = self._eager_loop(program, steps, feeds, fetch_names, scope,
                                   plan, stack_fetches)
            if self.graph_capturer is not None:
                self.eager_multi_step += 1
        # the state the loop left in the scope: after a replay, the
        # tensors the graph binds
        _nan_check_finish(_nan_check_start(
            [(n, scope.find_var(n).value) for n in state_out]
            + list(zip(fetch_names, out))))
        if return_numpy:
            out = [_to_numpy(f) for f in out]
        return out

    def _loop(self, lowerer, steps, state, feeds, fetch_names, key,
              plan, stack_fetches):
        """The K-step loop over ``state`` (updated in place: each step's
        state_out values replace its entries); step ``i`` draws from
        ``fold_in(key, i)``, as the JAX package's scan body. Returns the
        fetches."""
        state_out, release, pairs = plan[1], plan[2], plan[3]
        per_step = []
        for i in range(steps):
            env, fetches = self._step(lowerer, state, feeds, fetch_names,
                                      key.fold_in(i), release, pairs)
            for n in state_out:
                state[n] = env[n]
            per_step.append(fetches)
        if stack_fetches:
            return [torch.stack([f[j] for f in per_step])
                    for j in range(len(fetch_names))]
        return per_step[-1]

    def _eager_loop(self, program, steps, feeds, fetch_names, scope, plan,
                    stack_fetches):
        """The loop op by op; returns the fetches."""
        state = self._gather_state(plan[0], scope)
        lowerer = BlockLowerer(program, 0, is_test=program._is_test)
        out = self._loop(lowerer, steps, state, feeds, fetch_names,
                         self._step_key(program), plan, stack_fetches)
        for n in plan[1]:
            scope.set_value(n, state[n])
        return out

    def _graph_loop(self, program, steps, feeds, fetch_names, scope, plan,
                    stack_fetches):
        key = (id(program), program._version, program._amp_dtype,
               tuple(sorted((n, tuple(t.shape), t.dtype)
                            for n, t in feeds.items())),
               tuple(fetch_names), frozenset(self._scope_names(scope)),
               id(scope), steps, bool(stack_fetches), str(self.device))
        entry = self._graphs.get(key)
        if entry is not None and not entry.bound_to(program, scope):
            entry = None  # an id reused by a new program or scope
        if entry is None:
            # warm-up: the real dispatch, eagerly (it builds the kernel
            # library, reads the device limits, creates the cuBLAS
            # handles)
            for k in [k for k, e in self._graphs.items() if e.dead()]:
                del self._graphs[k]
            out = self._eager_loop(program, steps, feeds, fetch_names,
                                   scope, plan, stack_fetches)
            self._graphs[key] = _CapturedLoop(program, scope)
            return out
        step_key = self._step_key(program)
        if entry.graph is None:
            self._capture(entry, program, steps, feeds, fetch_names, scope,
                          plan, stack_fetches)
        else:
            entry.rebind(scope)
            for n, t in feeds.items():
                entry.feeds[n].copy_(t)
        # this call's key into the tensor the graph's draws fold from
        entry.key.copy_(torch.tensor(step_key.base, dtype=torch.int64))
        entry.replay()
        # the graph's outputs are overwritten by its next replay
        return [t.clone() for t in entry.outs]

    def _capture(self, entry, program, steps, feeds, fetch_names, scope,
                 plan, stack_fetches):
        state_in, state_out = plan[0], plan[1]
        entry.bound = self._gather_state(state_in, scope)
        entry.feeds = feeds
        entry.key = torch.zeros(2, dtype=torch.int64, device=self.device)
        lowerer = BlockLowerer(program, 0, is_test=program._is_test)
        key = prng.KeyChain(entry.key)

        def body():
            state = dict(entry.bound)
            entry.outs = self._loop(lowerer, steps, state, entry.feeds,
                                    fetch_names, key, plan, stack_fetches)
            for n in state_out:
                if state[n] is not entry.bound[n]:
                    entry.bound[n].copy_(state[n])

        try:
            with _kbuild.recording_launches() as log:
                entry.graph, entry.pool_bytes = self.graph_capturer.capture(
                    body, self.device)
        except Exception as e:
            op = lowerer.current_op
            raise RuntimeError(
                "CUDA graph capture of run_multi_step failed: program %#x "
                "(version %d, %d ops, %d steps), at op %s: %s"
                % (id(program), program._version,
                   len(program.global_block().ops), steps,
                   "%r (op %d)" % (op.type, program.global_block().ops.index(
                       op)) if op is not None else "none (before the first "
                   "op)", e)) from e
        entry.launch_log = log
        for n in state_out:
            scope.set_value(n, entry.bound[n])

    def graph_stats(self, program=None):
        """{"graphs": captured loops held (of ``program`` alone, if
        given), "pool_bytes": device memory their capture reserved}."""
        held = [e for e in self._graphs.values() if e.graph is not None
                and (program is None or e.of_program(program))]
        return {"graphs": len(held),
                "pool_bytes": sum(e.pool_bytes for e in held)}

    def close(self):
        """Drop the captured graphs (their pools return to the
        allocator) and the analysis cache."""
        self._graphs.clear()
        self._analysis.clear()


def _refuse_host_reads(program):
    """A captured loop cannot read the card on the host: refuse, naming
    the op, a program that holds an unbounded ``while`` (its condition
    is read every iteration), a ``cond`` (its predicate) or a host I/O
    op (``print``, ``save``, ``load`` and the combined pair:
    ``ops.io_ops.HOST_IO_OPS``), in any block. A bounded ``while``
    (``max_iterations > 0``) reads nothing and is captured."""
    for block in program.blocks:
        for i, op in enumerate(block.ops):
            if op.type == "cond" or (
                    op.type == "while"
                    and not op.attrs.get("max_iterations", 0)) or (
                    op.type in HOST_IO_OPS):
                what = ("reads its predicate" if op.type == "cond" else
                        "reads its condition every iteration "
                        "(max_iterations=0)" if op.type == "while" else
                        "reads or writes a value")
                raise RuntimeError(
                    "run_multi_step cannot capture program %#x: op %r "
                    "(block %d, op %d) %s on the host, which a CUDA graph "
                    "cannot hold; bound the loop (While(cond, "
                    "max_iterations=N)), or run the eager loop with "
                    "FLAGS_cuda_graph=0" % (id(program), op.type,
                                            block.idx, i, what))


class _CUDAGraphCapturer(object):
    """Captures a loop body into one ``torch.cuda.CUDAGraph`` (on the
    side stream ``torch.cuda.graph`` uses, into a private memory pool).
    Nothing runs during capture: the first ``replay()`` runs the body."""

    @staticmethod
    def capture(body, device):
        """Returns (graph, bytes of device memory its pool reserved)."""
        def reserved():
            return torch.cuda.memory_stats(device).get(
                "reserved_bytes.all.current", 0)

        with torch.cuda.device(device):
            # torch.cuda.graph empties the cache on entry: do it first,
            # so the difference counts the graph's pool alone
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            before = reserved()
            graph = torch.cuda.CUDAGraph()
            # thread_local: the capture restricts only this thread's CUDA
            # calls, so serving threads that launch, allocate and poll
            # events on other streams meanwhile neither fail the capture
            # nor leak into it (their work is not on the capture stream)
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                body()
            return graph, reserved() - before


class _CapturedLoop(object):
    """One key's captured K-step loop: the graph, the scope tensors it
    binds, its static feed and fetch buffers, the run key its draws fold
    from and the kernel launches one replay makes."""

    def __init__(self, program, scope):
        self._program = weakref.ref(program)
        self._scope = weakref.ref(scope)
        self.graph = None
        self.bound = {}       # state name -> the tensor the graph reads
        self.feeds = {}       # feed name -> static buffer
        self.key = None       # int64 [2]: the run key, written per call
        self.outs = []        # the graph's fetch buffers
        self.launch_log = {}  # (kernel, key) -> launches per replay
        self.pool_bytes = 0

    def bound_to(self, program, scope):
        return self._program() is program and self._scope() is scope

    def of_program(self, program):
        return self._program() is program

    def dead(self):
        return self._program() is None or self._scope() is None

    def rebind(self, scope):
        """Copy every scope value that an eager run replaced since the
        last replay into its bound tensor, and point the scope back at
        it. A dict walk: no device synchronization."""
        for n, t in self.bound.items():
            v = scope.find_var(n)
            val = v.value
            if val is t:
                continue
            if not isinstance(val, torch.Tensor):
                val = torch.from_numpy(np.array(val))
            if tuple(val.shape) != tuple(t.shape) or val.dtype != t.dtype:
                raise RuntimeError(
                    "scope variable %r changed to %s %s, but the captured "
                    "loop binds %s %s" % (n, tuple(val.shape), val.dtype,
                                          tuple(t.shape), t.dtype))
            t.copy_(val)
            v.set(t)

    def replay(self):
        self.graph.replay()
        _kbuild.count_replay(self.launch_log)
