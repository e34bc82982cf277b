"""Executor: run Programs on a Place.

Counterpart of ``paddle_tpu/executor.py`` (python/paddle/fluid/
executor.py:374 parity). ``run`` feeds numpy arrays onto the Place's
device, interprets block 0 op by op (``core/lowering.BlockLowerer``),
writes the persistable vars the block produced back into the Scope and
fetches results as numpy. ``run_multi_step`` runs the block K times in a
Python loop, threading state from one iteration to the next (the JAX
package scans the step inside one executable).

State is updated in place where an op says so: the paged-KV ops write
into the pool tensors the Scope holds (saving a whole pool copy per layer
per token), so a scope value and the run's environment are the same
tensor object throughout. Every other variable leaves the run's
environment after the last op that uses it, unless it is fetched or
written back (``BlockLowerer.release_plan``): a Transformer train step
holds each activation only until its grad op has read it.

``run_async`` returns a ``FetchHandle`` right after the ops are queued on
the card: a CUDA event recorded behind them tells ``done()`` and
``result(timeout=...)`` when the fetches are ready.
"""

import contextlib
import time

import numpy as np
import torch

from paddle_tpu_torch import framework
from paddle_tpu_torch.core.lowering import BlockLowerer
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.core.types import CUDAPlace, Place, device_dtype

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
    writes in place)."""
    t = t.detach()
    return t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()


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

    def __init__(self, tensors, fetch_names, event=None):
        self._tensors = list(tensors)
        self.fetch_names = list(fetch_names)
        self._event = event
        self._numpy = None

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
            self._numpy = [_to_numpy(t) for t in self._tensors]
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
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._run_counter = 0
        self._base_seed = np.random.randint(0, 2 ** 31 - 1)
        # (id(program), version, feed names, scope names, fetch names) ->
        # (program, state_in, state_out, release plan); the program ref
        # guards against id reuse
        self._analysis = {}

    # -- shared run plumbing -------------------------------------------------
    def _prepare_feeds(self, program, feed):
        """numpy / tensor feeds -> tensors on the device, cast to the
        declared var dtype when the kinds agree."""
        feeds = {}
        for name, value in feed.items():
            # always a copy: ops that update state in place must never
            # write into the caller's array
            t = value.clone() if isinstance(value, torch.Tensor) else \
                torch.from_numpy(np.array(value))
            var = program.global_block()._find_var_recursive(name)
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

    def _analyze(self, program, feeds, scope, fetch_names):
        scope_names = frozenset(self._scope_names(scope))
        key = (id(program), program._version, frozenset(feeds), scope_names,
               tuple(fetch_names))
        hit = self._analysis.get(key)
        if hit is not None and hit[0] is program:
            return hit[1:]
        lowerer = BlockLowerer(program, 0)
        state_in, state_out = lowerer.analyze(scope_names, set(feeds))
        release = lowerer.release_plan(set(fetch_names) | set(state_out))
        self._analysis[key] = (program, state_in, state_out, release)
        return state_in, state_out, release

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

    def _run_seed(self, program):
        self._run_counter += 1
        return (program.random_seed or self._base_seed) * 7919 \
            + self._run_counter

    @staticmethod
    def _fetch_names(fetch_list):
        return [v.name if isinstance(v, framework.Variable) else str(v)
                for v in fetch_list]

    def _step(self, lowerer, state, feeds, fetch_names, seed, release):
        env = dict(state)
        env.update(feeds)
        lowerer.lower_into(env, self.device, seed, release)
        fetches = []
        for n in fetch_names:
            if n not in env:
                raise RuntimeError(
                    "fetch variable %r was not produced by the program" % n)
            fetches.append(env[n])
        return env, fetches

    def _run(self, program, feed, fetch_list, scope):
        """Queue one run's ops; returns (fetch names, fetch tensors)."""
        program = program or framework.default_main_program()
        scope = scope or global_scope()
        feeds = self._prepare_feeds(program, feed or {})
        fetch_names = self._fetch_names(fetch_list or [])
        state_in, state_out, release = self._analyze(program, feeds, scope,
                                                     fetch_names)
        state = self._gather_state(state_in, scope)
        lowerer = BlockLowerer(program, 0, is_test=program._is_test)
        env, fetches = self._step(lowerer, state, feeds, fetch_names,
                                  self._run_seed(program), release)
        for n in state_out:
            if n in env:
                scope.set_value(n, env[n])
        return fetch_names, fetches

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True):
        fetches = self._run(program, feed, fetch_list, scope)[1]
        if return_numpy:
            fetches = [_to_numpy(f) for f in fetches]
        return fetches

    def run_async(self, program=None, feed=None, fetch_list=None,
                  feed_var_name="feed", fetch_var_name="fetch", scope=None):
        """``run`` without the wait (executor.py:775 parity): queues the
        run's ops and returns a :class:`FetchHandle` whose ``result()``
        copies the fetches to numpy when asked. The scope's state is
        updated with the queued tensors, so runs dispatched back to back
        chain on the card's stream."""
        fetch_names, fetches = self._run(program, feed, fetch_list, scope)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return FetchHandle(fetches, fetch_names, event)

    def run_multi_step(self, program, steps, feed=None, fetch_list=None,
                       scope=None, return_numpy=True, stack_fetches=False):
        """Run ``steps`` iterations of ``program``; each iteration reads
        the state the previous one wrote. ``feed`` is constant across the
        steps. Fetches are the last step's values, or with
        ``stack_fetches=True`` every step's, stacked on a leading [steps]
        axis."""
        steps = int(steps)
        if steps <= 0:
            raise ValueError("multi-step needs steps >= 1, got %d" % steps)
        program = program or framework.default_main_program()
        scope = scope or global_scope()
        feeds = self._prepare_feeds(program, feed or {})
        fetch_names = self._fetch_names(fetch_list or [])
        state_in, state_out, release = self._analyze(program, feeds, scope,
                                                     fetch_names)
        extra_out = set(state_out) - set(state_in)
        if extra_out:
            raise RuntimeError(
                "multi-step run needs state_out ⊆ state_in; program "
                "creates persistables mid-run: %s" % sorted(extra_out))
        state = self._gather_state(state_in, scope)
        lowerer = BlockLowerer(program, 0, is_test=program._is_test)
        seed = self._run_seed(program)
        per_step = []
        for i in range(steps):
            env, fetches = self._step(lowerer, state, feeds, fetch_names,
                                      seed * 131 + i, release)
            for n in state_out:
                state[n] = env[n]
            per_step.append(fetches)
        for n in state_out:
            scope.set_value(n, state[n])
        if stack_fetches:
            out = [torch.stack([f[j] for f in per_step])
                   for j in range(len(fetch_names))]
        else:
            out = per_step[-1]
        if return_numpy:
            out = [_to_numpy(f) for f in out]
        return out
