"""Build and bind the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
compiler process per source, all started together), linked into one shared
library with a plain C interface, and loaded with ``ctypes``.  The build
happens at first use, from the sources in the checkout only, into
``scalable_agent_tpu_torch/_build/`` (listed in ``.gitignore``); the
library's file name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.

Importing this module builds nothing: the CPU tests import every module,
and there is no ``nvcc`` there.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

_PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of csrc/*.cu's extern "C" entry points.  Pointers and the
# stream go through c_void_p: a bare Python int would be cut to 32 bits.
# An entry point ending in ``_bf16`` is the bf16-operand variant of the
# one without, with the same arguments but for the shallow stem's grad-W.
_SIGNATURES = {
    "sat_error_string": ([_I], ctypes.c_char_p),
    "sat_lstm_resid_active_clusters": ([_I] * 3, _I),
    "sat_lstm_bptt_active_clusters": ([_I] * 3, _I),
    "sat_vtrace": ([_P] * 7 + [_I, _I, _F, _I, _F, _I, _P], _I),
}
for _name, _signature in {
        "sat_lstm_forward_resid": ([_P] * 15 + [_I] * 7 + [_P], _I),
        "sat_lstm_forward_lean": ([_P] * 11 + [_I] * 7 + [_P], _I),
        "sat_lstm_step": ([_P] * 9 + [_I] * 3 + [_P], _I),
        "sat_lstm_backward": ([_P] * 20 + [_I] * 8 + [_P], _I),
        "sat_resnet_stem_gradw": ([_P] * 4 + [_I] * 13 + [_L, _I, _P], _I),
        "sat_resnet_stem_gradw_c4": ([_P] * 4 + [_I] * 13 + [_L, _I, _P],
                                     _I)}.items():
    _SIGNATURES[_name] = _SIGNATURES[_name + "_bf16"] = _signature
# The shallow stem's grad-W: the float32 band kernel and the bf16 mma.sync
# kernel take their own plans' arguments.
for _suffix in ("", "_c4", "_c1"):
    _SIGNATURES["sat_conv_gradw" + _suffix] = (
        [_P] * 4 + [_I] * 15 + [_L, _I, _P], _I)
    _SIGNATURES["sat_conv_gradw" + _suffix + "_bf16"] = (
        [_P] * 4 + [_I] * 23 + [_L, _I, _P], _I)

_lock = threading.Lock()
_count_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None
# Compiler report (ptxas register/shared-memory lines) of the build this
# process ran; empty when the library was already built.
build_log = ""


def _nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels are built from "
        "source at first use and need the CUDA toolkit")


def _sources():
    sources = sorted(SOURCE_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {SOURCE_DIR}")
    return sources


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SOURCE_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libsat_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernels unless this exact build exists."""
    global build_log
    target = library_path()
    if target.exists():
        return target
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="build_", dir=BUILD_DIR))
    try:
        jobs = []
        for source in _sources():
            obj = workdir / (source.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(source), "-o", str(obj)]
            jobs.append((source, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failures = [], []
        for source, _, proc in jobs:
            out, _ = proc.communicate()
            logs.append(f"== {source.name}\n{out}")
            if proc.returncode != 0:
                failures.append(f"nvcc failed on {source.name} "
                                f"(exit {proc.returncode}):\n{out}")
        if failures:
            raise RuntimeError("\n".join(failures))
        linked = workdir / target.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(linked),
             *(str(obj) for _, obj, _ in jobs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):"
                               f"\n{link.stdout}")
        os.replace(linked, target)
        build_log = "\n".join(logs)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _library = lib
        return _library


def on_cpu(what: str, *tensors) -> bool:
    """True when every tensor lies on the CPU (the wrapper takes its plain
    version), False when all lie on one CUDA device (it launches its
    kernel); anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"{what} tensors must all lie on the CPU or all on one CUDA "
            f"device, got {sorted(str(t.device) for t in tensors)}")
    return False


def check_operand(name: str, t, shape,
                  dtypes: Tuple[torch.dtype, ...] = (torch.float32,)) -> None:
    """A kernel operand must be contiguous, of ``shape`` and of one of the
    ``dtypes`` the kernel admits."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be "
                        f"{' or '.join(str(d) for d in dtypes)}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def count_launch(launches: Dict[str, int], name: str) -> None:
    """Add one to a wrapper's launch counter; actor threads, the prefetch
    thread and the learner launch kernels concurrently."""
    with _count_lock:
        launches[name] += 1


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        message = library().sat_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({message})")
