"""Build and load the port's CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` is compiled on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o paddle_tpu_torch/_build/lib<name>-<hash>.so

into a shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). The library name carries
a hash of its source and of the ``csrc`` headers it includes
(``mma_common.cuh``, ``sm90_common.cuh``), so an edited source or header
is never served by a stale build. No library links ``libcuda``: the
flash kernels' TMA tensor maps are encoded through the driver entry
point the CUDA runtime hands out (``cudaGetDriverEntryPoint``). Builds
happen at first use — never at import — and :func:`build_all` starts
every ``nvcc`` at once.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when it is not 0 (a launch the card refuses never
runs, and ``torch.cuda.synchronize()`` would not report it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List

__all__ = ["SOURCES", "load", "build_all", "check"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
SOURCES = ("paged_attention", "quant_matmul", "flash_attention", "rms_norm",
           "rope")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels build from paddle_tpu_torch/csrc at "
                           "first use")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(name: str) -> List[str]:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes with
    quotes, directly or through another header."""
    found: List[str] = []
    todo = [os.path.join(_CSRC, name + ".cu")]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        with open(path, "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                todo.append(os.path.join(os.path.dirname(path),
                                         inc.decode()))
    return found


def _target(name: str) -> str:
    """The library's path; its name carries a hash of the source and of
    the headers it includes, so an edit to either forces a rebuild."""
    h = hashlib.sha256()
    for path in _sources(name):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD, f"lib{name}-{h.hexdigest()[:12]}.so")


def _command(name: str, out: str) -> List[str]:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-o", out, os.path.join(_CSRC, name + ".cu")]


def build_all(names=SOURCES) -> float:
    """Compile every missing library in parallel (one ``nvcc`` per
    source, all started together) and load them; returns the seconds
    spent. Raises with the compiler's output when a build fails."""
    t0 = time.time()
    with _lock:
        os.makedirs(_BUILD, exist_ok=True)
        procs = {}
        for name in names:
            if name in _libs:
                continue
            out = _target(name)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                _command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, out)
        errors = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for csrc/{name}.cu "
                              f"(rc {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(_target(name))
    return time.time() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = _libs[name]
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error (every library
    exports ``ptt_error_string``, a wrapper of ``cudaGetErrorString``)."""
    if err != 0:
        lib.ptt_error_string.restype = ctypes.c_char_p
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        msg = lib.ptt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"({msg})")
