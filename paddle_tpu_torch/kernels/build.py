"""Build and bind the hand-written CUDA kernels.

Every ``*.cu`` file under ``paddle_tpu_torch/csrc/`` has a plain C
interface (no PyTorch headers), so ``nvcc`` compiles each in seconds.
The sources compile in parallel, one ``nvcc`` process each, into objects
that link into one shared library for ``sm_90a`` (H100), loaded with
``ctypes``. The build happens at first use, into
``paddle_tpu_torch/_build/`` (listed in ``.gitignore``), and the library
name carries a hash of the sources and flags, so an edited source
rebuilds and a stale library is never loaded.

Nothing here runs when the module is imported: the CPU tests import every
module of the package, and the CPU has no ``nvcc``.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("flash_fwd.cu", "flash_fwd_bf16.cu", "flash_bwd.cu",
           "flash_bwd_dkv_bf16.cu", "flash_bwd_dq_bf16.cu", "paged_decode.cu",
           "tree_decode.cu", "lstm_cell.cu", "gru_cell.cu", "threefry.cu",
           "detection.cu", "crf.cu", "ctc.cu")
# included; in the hash
HEADERS = ("recurrence.cuh", "decode_split.cuh", "mma_bf16.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_state = {"lib": None, "log": ""}
_lib_lock = threading.Lock()


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``'s,
    or the one on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            cand = os.path.join(home, "bin", "nvcc")
            if os.path.exists(cand):
                return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "paddle_tpu_torch build from source at first use")
    return found


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, "libpaddle_tpu_torch_kernels_%s.so"
                        % h.hexdigest()[:16])


def build(ptxas_verbose=False):
    """Compile every source (in parallel) and link the library; returns
    its path. Skips the work when the library for these exact sources
    exists. ``ptxas_verbose`` adds ``-Xptxas -v`` (registers, shared
    memory and spills per kernel; the report lands in ``build_log()``)."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if ptxas_verbose else [])
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc] + flags + ["-c", os.path.join(CSRC_DIR, name),
                                    "-o", obj]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        log, objs, failed = [], [], []
        for name, obj, proc in procs:
            out = proc.communicate()[0].decode(errors="replace")
            log.append("== %s ==\n%s" % (name, out))
            objs.append(obj)
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError("nvcc failed for %s:\n%s"
                               % (", ".join(failed), "\n".join(log)))
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc] + list(ARCH_FLAGS) + ["-shared", "-o", tmp_lib] + objs,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(tmp_lib, path)
    _state["log"] = "\n".join(log)
    return path


def build_log():
    """The compilers' output of the last build in this process."""
    return _state["log"]


def library():
    """The loaded kernel library, built first if needed (once, whichever
    thread asks first)."""
    with _lib_lock:
        if _state["lib"] is None:
            _state["lib"] = ctypes.CDLL(build())
    return _state["lib"]


_limits = {}


def device_limits(device):
    """(SM count, per-block shared-memory limit in bytes) of a CUDA
    ``device``, read once through the CUDA runtime
    (``paddle_device_limits``): what the launch plans size their grids
    and tiles by."""
    import torch

    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _limits:
        fn = library().paddle_device_limits
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        fn.restype = ctypes.c_int
        n_sm, smem = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            rc = fn(ctypes.byref(n_sm), ctypes.byref(smem))
        if rc != 0:
            raise RuntimeError("paddle_device_limits: CUDA error %d" % rc)
        _limits[index] = (n_sm.value, smem.value)
    return _limits[index]


_capture = threading.local()


@contextlib.contextmanager
def recording_launches():
    """While a CUDA graph is captured in this thread: a launch queued
    into the graph runs at each replay, not now, so ``Kernel.launch``
    records it here ({(kernel, key): launches}) instead of counting it,
    and :func:`count_replay` counts the log at every replay."""
    prev = getattr(_capture, "log", None)
    log = _capture.log = {}
    try:
        yield log
    finally:
        _capture.log = prev


def count_replay(log):
    """Count one replay of a captured graph's launches (a
    :func:`recording_launches` log)."""
    for (kernel, key), n in log.items():
        kernel._count(key, n)


class Kernel(object):
    """One C entry point of the kernel library, with its launch count.

    ``launch`` calls the entry point (which launches the CUDA kernel on
    the stream it is given and returns ``cudaGetLastError()``), raises
    on a nonzero code, and only then adds one to ``launches`` and, where
    the caller names the launch's shape class ``key``, to
    ``by_key[key]``; inside :func:`recording_launches` it records the
    launch for the graph's replays instead. Nothing else touches the
    counts except ``reset`` and :func:`count_replay`. The counts are
    updated under a lock: predictor clones launch from several threads
    at once."""

    def __init__(self, symbol, argtypes):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.by_key = {}
        self._fn = None
        self._count_lock = threading.Lock()

    def reset(self):
        with self._count_lock:
            self.launches = 0
            self.by_key = {}

    def launch(self, *args, key=None):
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError("%s: CUDA error %d at launch"
                               % (self.symbol, rc))
        log = getattr(_capture, "log", None)
        if log is not None:
            log[(self, key)] = log.get((self, key), 0) + 1
        else:
            self._count(key, 1)

    def _count(self, key, n):
        with self._count_lock:
            self.launches += n
            if key is not None:
                self.by_key[key] = self.by_key.get(key, 0) + n
