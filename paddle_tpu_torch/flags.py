"""Global flag system read from FLAGS_* environment variables.

Counterpart of ``paddle_tpu/flags.py``: the same flag names, defaults and
``FLAGS_<name>`` parsing, so a deployment's environment configures both
packages alike, plus one of the port's own (``cuda_graph``). Most flags
steer subsystems later slices port; the port reads ``attention_impl``,
``paged_attention``, ``tree_attention``, ``flash_backward``,
``speculative``, ``use_pallas_lstm``, ``use_pallas_gru``,
``verify_program`` (``Executor`` and ``Predictor`` run the verifier) and
``cuda_graph`` today. For the attention kernel flags "auto" and "pallas"
launch the hand-written kernels for a CUDA tensor, and "reference" is
refused for a CUDA tensor (the port has no hidden path to the plain
versions on the card).
"""

import os

__all__ = ["get", "set_flag", "refresh_from_env", "all_flags"]

# name -> (default, parser)
_DEFS = {
    "check_nan_inf": (False, bool),
    "benchmark": (False, bool),
    "eager_delete_tensor_gb": (-1.0, float),
    "cpu_deterministic": (False, bool),
    "init_allocated_mem": (False, bool),
    "fraction_of_gpu_memory_to_use": (0.92, float),
    "reader_queue_speed_test_mode": (False, bool),
    "rpc_deadline": (180000, int),
    "remat_gradients": (False, bool),
    # dynamic_lstm / dynamic_gru on a CPU tensor: True runs fused_lstm /
    # fused_gru (the plain loop there) when the op has no initial state,
    # as the JAX package routes them. On a CUDA tensor both ops launch
    # the lstm_cell / gru_cell kernel whatever these say, H0 / C0 or not
    # (ops/rnn_ops.py)
    "use_pallas_lstm": (False, bool),
    "use_pallas_gru": (False, bool),
    "conv_nhwc": (False, bool),
    # scaled_dot_product_attention / grouped_cross_attention on a CUDA
    # tensor: "auto" or "pallas" launch the flash kernel, "reference"
    # raises (kernels/flash_attention.py)
    "attention_impl": ("auto", str),
    # paged_attention on a CUDA tensor: "auto" or "pallas" launch the
    # paged-decode kernel, "reference" raises (kernels/paged_attention.py)
    "paged_attention": ("auto", str),
    "beam_reorder": ("rebind", str),
    # the gradient of flash attention: "pallas" runs the flash_bwd
    # kernels on a CUDA tensor (their plain version on a CPU tensor);
    # "reference" differentiates the plain forward with autograd, on CPU
    # tensors only (kernels/flash_attention.py)
    "flash_backward": ("pallas", str),
    "exec_cache_dir": ("", str),
    "exec_cache_max_bytes": (-1, int),
    "telemetry": (False, bool),
    "metrics_path": ("", str),
    "peak_tflops": (0.0, float),
    "verify_program": (False, bool),
    "blackbox_path": ("", str),
    "watchdog": (False, bool),
    "watchdog_timeout": (0.0, float),
    "watchdog_abort": (False, bool),
    "nan_provenance": (True, bool),
    "checkpoint_interval_steps": (0, int),
    "checkpoint_interval_secs": (0.0, float),
    "checkpoint_max_to_keep": (3, int),
    "dispatch_retries": (0, int),
    "retry_backoff_s": (0.05, float),
    "chaos_spec": ("", str),
    # a speculative SlotDecodeSession reads it at every step(): "off" sends
    # the session through the plain sequential step (serving/generation.py)
    "speculative": ("on", str),
    # Executor.run_multi_step on a CUDA place: True captures the K-step
    # loop into one CUDA graph and replays it; False runs the eager loop
    # there (the oracle chip_smoke.py holds the graph against). The JAX
    # package has no such flag: its loop is always one executable
    "cuda_graph": (True, bool),
    # paged_tree_attention on a CUDA tensor: "auto" or "pallas" launch the
    # tree-decode kernel, "reference" raises (kernels/paged_attention.py)
    "tree_attention": ("auto", str),
    "fused_ce": (False, bool),
    "request_tracing": (False, bool),
    "lock_witness": (False, bool),
    "step_profile": (False, bool),
}


def _parse(raw, parser):
    if parser is bool:
        return str(raw).lower() in ("1", "true", "yes", "on")
    return parser(raw)


_values = {}


def refresh_from_env():
    """Re-read every FLAGS_<name> env var (init_gflags --tryfromenv)."""
    for name, (default, parser) in _DEFS.items():
        raw = os.environ.get("FLAGS_" + name)
        _values[name] = _parse(raw, parser) if raw is not None else default


def get(name):
    if name not in _DEFS:
        raise KeyError("unknown flag %r (known: %s)"
                       % (name, sorted(_DEFS)))
    return _values[name]


def set_flag(name, value):
    if name not in _DEFS:
        raise KeyError("unknown flag %r" % name)
    _values[name] = _parse(value, _DEFS[name][1])


def all_flags():
    return dict(_values)


refresh_from_env()
