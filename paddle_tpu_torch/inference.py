"""Inference predictor API.

Counterpart of ``paddle_tpu/inference.py`` (paddle_inference_api.h:141
PaddlePredictor, :183 NativeConfig, :211 CreatePaddlePredictor;
api_impl.cc's NativePaddlePredictor). ``AnalysisConfig`` adds the
AnalysisPredictor role: the "inference" pass pipeline of
``core/passes.py`` (prune, fc and recurrence fusion) runs over the
loaded program first. ``clone()`` shares the loaded program and weights
while giving each serving thread its own ``Executor``.

``NativeConfig(use_tpu=True)``, the default, serves on the card
(``TPUPlace`` is ``CUDAPlace``) and raises on a machine without one;
``use_tpu=False`` serves on the CPU. ``FLAGS_verify_program`` verifies
the loaded program (``analysis.check_program``) at load. The predictor's
telemetry, black box and lock witness are not ported yet (ROADMAP A9).
"""

import threading

import numpy as np

from paddle_tpu_torch import flags, io
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.core.types import CPUPlace, CUDAPlace
from paddle_tpu_torch.executor import Executor, scope_guard

__all__ = ["NativeConfig", "AnalysisConfig", "Predictor",
           "create_paddle_predictor"]


class NativeConfig(object):
    """Model-dir config (NativeConfig parity). ``use_tpu`` picks the card
    (``device`` is its index) or the CPU; ``fraction_of_gpu_memory`` is
    kept for API compatibility."""

    def __init__(self, model_dir=None, prog_file=None, params_file=None,
                 use_tpu=True, device=0, fraction_of_gpu_memory=-1.0):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.params_file = params_file
        self.use_tpu = use_tpu
        self.device = device
        self.fraction_of_gpu_memory = fraction_of_gpu_memory

    def place(self):
        return CUDAPlace(self.device) if self.use_tpu else CPUPlace()


class AnalysisConfig(NativeConfig):
    """AnalysisPredictor's config: the "inference" pass pipeline runs
    over the loaded program. ``extra_passes`` appends registered pass
    names after the strategy's list (pass_builder role);
    ``switch_ir_optim(False)`` serves the program as loaded."""

    def __init__(self, *args, ir_optim=True, extra_passes=None, **kwargs):
        super(AnalysisConfig, self).__init__(*args, **kwargs)
        self.ir_optim = ir_optim
        self.extra_passes = list(extra_passes or ())

    def switch_ir_optim(self, flag=True):
        self.ir_optim = bool(flag)


class Predictor(object):
    """A predictor over a saved inference model."""

    def __init__(self, config, _shared=None):
        self._config = config
        # the place resolves first: use_tpu on a machine without a card
        # raises here, before anything loads
        self._exe = Executor(config.place())
        if _shared is not None:
            (self._program, self._native_program, self._feed_names,
             self._fetch_vars, self._scope) = _shared
        else:
            self._scope = Scope()
            with scope_guard(self._scope):
                (self._program, self._feed_names,
                 self._fetch_vars) = io.load_inference_model(
                    config.model_dir, self._exe,
                    model_filename=config.prog_file,
                    params_filename=config.params_file)
            # the C++ reference interpreter knows the unfused op set:
            # run_native_reference always runs the program as loaded
            self._native_program = self._program
            if getattr(config, "ir_optim", False):
                from paddle_tpu_torch.core.passes import PassManager

                fetch_names = [v.name for v in self._fetch_vars]
                pm = PassManager(strategy="inference",
                                 passes=getattr(config, "extra_passes", ()))
                self._program = pm.apply(
                    self._program, scope=self._scope,
                    feed_names=list(self._feed_names),
                    fetch_names=fetch_names)
                # passes may return a rebuilt program: re-resolve fetches
                gb = self._program.global_block()
                self._fetch_vars = [gb.vars[n] for n in fetch_names]
        if _shared is None and flags.get("verify_program"):
            # verify at load (after the pass pipeline ran), so a
            # corrupted model dir or a pass bug fails here with
            # rule-tagged diagnostics, not inside the first request;
            # clone() shares an already-verified program
            from paddle_tpu_torch.analysis import check_program

            check_program(
                self._program, level="error",
                fetch_names=[v.name for v in self._fetch_vars],
                origin="Predictor load")
        # one run at a time per predictor; clone() is the way to serve
        # from several threads
        self._lock = threading.Lock()
        gvars = self._program.global_block().vars
        self._feed_dtypes = {n: str(gvars[n].dtype)
                             for n in self._feed_names if n in gvars}

    def _as_feed_dict(self, inputs):
        if isinstance(inputs, dict):
            return inputs
        if len(inputs) != len(self._feed_names):
            raise ValueError("expected %d inputs (%s), got %d"
                             % (len(self._feed_names), self._feed_names,
                                len(inputs)))
        return dict(zip(self._feed_names, inputs))

    def run(self, inputs):
        """inputs: dict feed name -> ndarray, or a list in the saved feed
        order. Returns a list of ndarrays (fetch order), each a copy the
        caller owns."""
        inputs = self._as_feed_dict(inputs)
        with self._lock:
            return self._exe.run(self._program, feed=inputs,
                                 fetch_list=self._fetch_vars,
                                 scope=self._scope)

    def run_async(self, inputs):
        """Non-blocking ``run``: queues the request and returns an
        ``executor.FetchHandle`` whose ``result()`` copies the outputs to
        numpy when asked. The lock is held for the dispatch only."""
        inputs = self._as_feed_dict(inputs)
        with self._lock:
            return self._exe.run_async(self._program, feed=inputs,
                                       fetch_list=self._fetch_vars,
                                       scope=self._scope)

    def clone(self):
        """A predictor sharing this one's program and weights, for another
        serving thread (PaddlePredictor::Clone parity)."""
        return Predictor(self._config, _shared=(
            self._program, self._native_program, self._feed_names,
            self._fetch_vars, self._scope))

    @property
    def feed_names(self):
        return list(self._feed_names)

    @property
    def feed_shapes(self):
        """Declared feed shapes ``{name: tuple}`` (-1 = dynamic; dim 0 is
        the batch)."""
        gvars = self._program.global_block().vars
        return {n: (tuple(gvars[n].shape) if gvars[n].shape is not None
                    else None)
                for n in self._feed_names if n in gvars}

    @property
    def feed_dtypes(self):
        """Declared feed dtypes ``{name: str}``, fixed at load."""
        return dict(self._feed_dtypes)

    @property
    def fetch_names(self):
        return [v.name for v in self._fetch_vars]

    def run_native_reference(self, inputs, fetch_index=0):
        """Run the C++ reference interpreter (native/src/interp.h) on the
        program as loaded: host-only execution of the PTPB program, a
        cross-check of the torch path from C++ (NaiveExecutor role; the
        core f32 op subset)."""
        from paddle_tpu_torch import native
        from paddle_tpu_torch.core.program_bin import serialize_program

        if not native.available():
            raise RuntimeError("native library unavailable: %s"
                               % native.last_error())
        lib = native.get_lib()
        blob = serialize_program(self._native_program)
        prog = lib.ptpu_program_parse(bytes(blob), len(blob))
        if not prog:
            raise ValueError(native.last_error())
        try:
            nscope = native.NativeScope()
            for name in self._scope.local_var_names():
                val = self._scope.get_value(name)
                if val is not None:
                    nscope.set(name, io._host_array(val))
            for name, val in self._as_feed_dict(inputs).items():
                arr = np.asarray(val)
                # the feed var's declared dtype decides: float vars run
                # f32 in the interpreter, integer vars keep integers
                want = self._feed_dtypes.get(name, "float32")
                if want in ("float32", "float64"):
                    arr = arr.astype(np.float32, copy=False)
                elif arr.dtype.kind == "f":
                    arr = arr.astype(want)
                nscope.set(name, arr)
            if lib.ptpu_interp_run(prog, nscope._h, 0) != 0:
                raise RuntimeError(native.last_error())
            out = nscope.get(self._fetch_vars[fetch_index].name)
            if out is None:
                raise RuntimeError("fetch var missing after interp run")
            return out
        finally:
            lib.ptpu_program_destroy(prog)


def create_paddle_predictor(config):
    """CreatePaddlePredictor parity."""
    return Predictor(config)
