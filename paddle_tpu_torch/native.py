"""ctypes binding to the native host runtime under ``native/``: the C++
program parser and reference interpreter, and its Scope.

Counterpart of ``paddle_tpu/native.py`` (:33-185, :317-407) for what the
port's ``Predictor.run_native_reference`` needs: the PTPB parser, the
interpreter and a ``NativeScope`` to set feeds and parameters in and
read fetches from. The library builds on first use from
``native/src/c_api.cc`` with ``g++`` into the port's git-ignored
``paddle_tpu_torch/_build/native/``, never into the JAX package's
``native/build/``, so a build of one package never races one of the
other. The RecordIO files and the blocking queue wait for the port's
reader (ROADMAP A11).
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
_BUILD_DIR = os.path.join(_PKG, "_build", "native")
_LIB_PATH = os.path.join(_BUILD_DIR, "libptpu_core.so")

_lib = None
_lib_lock = threading.Lock()
_build_error = None


def _stale():
    """True when any native source is newer than the built library."""
    try:
        lib_mtime = os.path.getmtime(_LIB_PATH)
    except OSError:
        return True
    for sub in ("src", "include"):
        for dirpath, _, files in os.walk(os.path.join(_NATIVE_DIR, sub)):
            for fn in files:
                try:
                    if os.path.getmtime(os.path.join(dirpath, fn)) \
                            > lib_mtime:
                        return True
                except OSError:
                    continue
    return False


def _build_library():
    """Compile libptpu_core.so with g++ (written under a temporary name,
    then renamed into place)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = "%s.tmp-%d" % (_LIB_PATH, os.getpid())
    subprocess.run(
        ["g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-pthread",
         "-I", os.path.join(_NATIVE_DIR, "include"),
         "-I", os.path.join(_NATIVE_DIR, "src"),
         os.path.join(_NATIVE_DIR, "src", "c_api.cc"), "-o", tmp],
        check=True, capture_output=True)
    os.replace(tmp, _LIB_PATH)


def _declare(lib):
    c = ctypes
    P = c.c_void_p
    sigs = {
        "ptpu_last_error": ([], c.c_char_p),
        "ptpu_scope_create": ([], P),
        "ptpu_scope_set": (
            [P, c.c_char_p, c.c_char_p, c.POINTER(c.c_int64), c.c_int32,
             c.c_void_p, c.c_uint64], c.c_int),
        "ptpu_scope_get_meta": (
            [P, c.c_char_p, c.c_char_p, c.c_uint64, c.POINTER(c.c_int64),
             c.POINTER(c.c_int32)], c.c_int64),
        "ptpu_scope_get_data": ([P, c.c_char_p, c.c_void_p, c.c_uint64],
                                c.c_int),
        "ptpu_scope_destroy": ([P], None),
        "ptpu_program_parse": ([c.c_void_p, c.c_uint64], P),
        "ptpu_program_destroy": ([P], None),
        "ptpu_interp_run": ([P, P, c.c_int32], c.c_int),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def get_lib():
    """Load (building if needed) the native library; None if it cannot
    be built. A failed rebuild of a stale library keeps the existing one:
    stale but working beats none."""
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        try:
            if not os.path.exists(_LIB_PATH):
                _build_library()
            elif _stale():
                try:
                    _build_library()
                except Exception:
                    pass
            lib = ctypes.CDLL(_LIB_PATH)
            _declare(lib)
            _lib = lib
        except Exception as e:  # no toolchain, read-only checkout, ...
            _build_error = e
            return None
        return _lib


def available():
    """True if the library loads, building it on the first call where
    the toolchain is present."""
    return get_lib() is not None


def last_error():
    lib = get_lib()
    return lib.ptpu_last_error().decode() if lib else str(_build_error)


class NativeScope(object):
    """C++ Scope holding named host ndarrays (Scope/Variable role)."""

    def __init__(self):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native library unavailable: %s"
                               % _build_error)
        self._h = self._lib.ptpu_scope_create()

    def set(self, name, array):
        a = np.ascontiguousarray(array)
        dims = (ctypes.c_int64 * a.ndim)(*a.shape)
        rc = self._lib.ptpu_scope_set(
            self._h, name.encode(), str(a.dtype).encode(), dims, a.ndim,
            a.ctypes.data_as(ctypes.c_void_p), a.nbytes)
        if rc != 0:
            raise RuntimeError(last_error())

    def get(self, name):
        """numpy array, or None if the var is absent (FindVar walk)."""
        dtype_buf = ctypes.create_string_buffer(32)
        dims = (ctypes.c_int64 * 16)()
        ndim = ctypes.c_int32()
        nbytes = self._lib.ptpu_scope_get_meta(
            self._h, name.encode(), dtype_buf, 32, dims, ctypes.byref(ndim))
        if nbytes < 0:
            return None
        out = np.empty(tuple(dims[i] for i in range(ndim.value)),
                       dtype=np.dtype(dtype_buf.value.decode()))
        if nbytes:
            rc = self._lib.ptpu_scope_get_data(
                self._h, name.encode(), out.ctypes.data_as(ctypes.c_void_p),
                out.nbytes)
            if rc != 0:
                raise RuntimeError(last_error())
        return out

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.ptpu_scope_destroy(h)
