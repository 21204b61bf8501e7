"""On-demand build of the native batcher library.

A copy of ``scalable_agent_tpu/native/build.py`` for the port (reference:
Dockerfile:68-70 builds its op with a bare g++ line): ``native/batcher.cc``
is dependency-free C++17, compiled by ``g++`` at first use into
``scalable_agent_tpu_torch/_build/`` (listed in ``.gitignore``), under a
file name that carries the source's hash, so an edited source is rebuilt
and an unchanged one is loaded as it is.  The sanitizer variants build
with ``variant='tsan'|'asan'`` (the reference relies on Clang
thread-safety annotations only, batcher.cc:182-204).  Importing this
module builds nothing; a failed build raises.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "batcher.cc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_SRC)), "_build")
_LOCK = threading.Lock()
_CACHE = {}

_VARIANT_FLAGS = {
    "opt": ["-O2"],
    "tsan": ["-O1", "-g", "-fsanitize=thread"],
    "asan": ["-O1", "-g", "-fsanitize=address"],
}


def library_path(variant: str = "opt") -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libbatcher_{variant}_{digest}.so")


def build_library(variant: str = "opt") -> str:
    """Compile (if needed) and return the shared library's path."""
    path = library_path(variant)
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # A per-process temporary name: concurrent builds never write one
    # file, and the rename is atomic.
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = (["g++", "-std=c++17", "-shared", "-fPIC", "-pthread"]
           + _VARIANT_FLAGS[variant] + [_SRC, "-o", tmp])
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as exc:
        raise RuntimeError(
            f"native batcher build failed:\n{exc.stderr}") from exc
    os.replace(tmp, path)
    return path


def load_library(variant: str = "opt") -> ctypes.CDLL:
    with _LOCK:
        if variant not in _CACHE:
            lib = ctypes.CDLL(build_library(variant))
            lib.batcher_create.restype = ctypes.c_void_p
            lib.batcher_create.argtypes = [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_double]
            lib.batcher_compute.restype = ctypes.c_int
            lib.batcher_compute.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            lib.batcher_get_batch.restype = ctypes.c_int
            lib.batcher_get_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int64)]
            lib.batcher_set_results.restype = ctypes.c_int
            lib.batcher_set_results.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int]
            lib.batcher_close.restype = None
            lib.batcher_close.argtypes = [ctypes.c_void_p]
            lib.batcher_destroy.restype = None
            lib.batcher_destroy.argtypes = [ctypes.c_void_p]
            _CACHE[variant] = lib
        return _CACHE[variant]
