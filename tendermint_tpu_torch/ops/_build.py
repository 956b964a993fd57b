"""Build and load the port's CUDA kernels.

At first use, every ``csrc/*.cu`` source is compiled by ``nvcc`` into
its own shared library with a plain C interface (all sources at once,
one ``nvcc`` process each), which is then loaded with ``ctypes``. A
library is named after a digest of its source and the flags, so an
edited source rebuilds; the result is renamed into place atomically.
A failed build raises :class:`KernelBuildError` with nvcc's output.
:func:`build_events` lists what each source cost this process: an nvcc
build or the load of a library built before, and its seconds;
:func:`loaded` names the libraries loaded (``ops/introspect.py``
reports both).

:class:`CudaError` is what a wrapper raises when a launcher returns a
CUDA error code: it carries the ``code`` and whether the error is
``permanent`` for the process (see :data:`STICKY_CODES`), which the
health machine of ``ops/device_policy.py`` reads.

The build directory is ``build/kernels`` beside the package (listed in
``.gitignore``), or ``$TENDERMINT_TPU_TORCH_BUILD_DIR``. ``nvcc`` is
taken from ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or ``PATH``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# cudaError_t codes after which the CUDA context of the process is unusable:
# every later CUDA call fails, so retrying is useless (illegal address,
# launch timeout, device-side assert, hardware stack error, illegal
# instruction, misaligned address, invalid PC, launch failure).
STICKY_CODES = frozenset({700, 702, 710, 714, 715, 716, 718, 719})


class KernelBuildError(RuntimeError):
    """A kernel source did not build (or nvcc is missing): a fault of the
    tree, never answered by a host fallback."""


class CudaError(RuntimeError):
    """A launcher returned cudaError_t ``code``; ``permanent`` when the
    code is sticky (:data:`STICKY_CODES`)."""

    def __init__(self, what: str, code: int):
        super().__init__(f"{what} failed: CUDA error {code}")
        self.code = code
        self.permanent = code in STICKY_CODES


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # guarded-by: _lock
build_log: Dict[str, str] = {}  # source name -> nvcc/ptxas output of its build
_events: List[Dict[str, object]] = []  # guarded-by: _lock


def build_dir() -> str:
    return os.environ.get(
        "TENDERMINT_TPU_TORCH_BUILD_DIR",
        os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels"),
    )


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources() -> List[str]:
    return sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _lib_path(src: str) -> str:
    with open(os.path.join(CSRC_DIR, src), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(build_dir(), f"lib{src[:-3]}-{digest}.so")


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every stale source in parallel and load all libraries.
    Returns {source stem: library}."""
    with _lock:
        todo = [s for s in _sources() if s[:-3] not in _libs]
        os.makedirs(build_dir(), exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for src in todo:
            out = _lib_path(src)
            if not os.path.exists(out):
                tmp = f"{out}.{os.getpid()}.tmp"
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, src)]
                procs[src] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ), tmp, out)
        failed = []
        built: Dict[str, float] = {}
        for src, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_log[src] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {src} (exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
            built[src] = time.perf_counter() - t0
        if failed:
            raise KernelBuildError("\n".join(failed))
        for src in todo:
            t = time.perf_counter()
            _libs[src[:-3]] = ctypes.CDLL(_lib_path(src))
            load_s = time.perf_counter() - t
            _events.append({"source": src, "action": "nvcc" if src in built else "load",
                            "seconds": built.get(src, 0.0) + load_s})
        return dict(_libs)


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(stem)
    return lib if lib is not None else build_all()[stem]


def loaded() -> List[str]:
    """The stems of the libraries loaded in this process."""
    with _lock:
        return sorted(_libs)


def build_events() -> List[Dict[str, object]]:
    """One entry a source built or loaded in this process: ``source``,
    ``action`` (``nvcc`` or ``load``) and ``seconds`` (an nvcc build's
    wall from the start of the parallel builds, plus the load)."""
    with _lock:
        return [dict(e) for e in _events]
