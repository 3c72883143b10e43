"""Build the CUDA kernels of ``vfmseg_tpu_torch/csrc`` and bind them by ctypes.

Each ``csrc/*.cu`` file compiles for ``sm_90a`` in its own ``nvcc`` process,
all started together, and one more ``nvcc`` links the objects into one shared
library with a plain C interface. The build happens at first use and is
cached under ``vfmseg_tpu_torch/_build/<hash>/``, keyed by a hash of the
sources and flags, so a fresh checkout builds itself and an unchanged tree
loads the cached library.

Each :class:`Kernel` binds one C entry and counts its launches. Nothing here
falls back to a plain PyTorch version: a missing ``nvcc``, a failed build or a
non-zero launch status raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
LIB_NAME = "libvfmseg_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
LINK_FLAGS = ("-shared",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or the kernels did not compile or load."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a non-zero CUDA status."""


def find_nvcc() -> Optional[str]:
    """Path of nvcc: on PATH, else under PyTorch's idea of the CUDA home."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.access(cand, os.X_OK):
            return cand
    return None


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the library unless the cache holds it; return its path."""
    out_dir = os.path.join(BUILD_DIR, source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (PATH, CUDA_HOME): the CUDA kernels cannot be "
            "built, and the CUDA path has no fallback")
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    srcs = [p for p in sources() if p.endswith(".cu")]
    objs = [os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o")
            for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    log, failed = "", []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        log += f"$ {' '.join(cmd)}\n{out}"
        if proc.returncode != 0:
            failed.append(proc.returncode)
    tmp = f"{lib_path}.{tag}"
    if not failed:
        cmd = [nvcc, *LINK_FLAGS, "-o", tmp, *objs]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log += f"$ {' '.join(cmd)}\n{proc.stdout}"
        if proc.returncode != 0:
            failed.append(proc.returncode)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(log)
    if failed:
        raise KernelBuildError(f"nvcc failed (exit {failed}):\n{log}")
    os.replace(tmp, lib_path)
    return lib_path


def build_log() -> str:
    path = os.path.join(BUILD_DIR, source_hash(), "build.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}\n"
                                       f"{build_log()}") from e
            lib.vfmseg_error_string.argtypes = [ctypes.c_int]
            lib.vfmseg_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


class Kernel:
    """One C entry of the library, with a count of its launches.

    ``launches`` goes up by one each time the entry launches its kernel and
    reports success; nothing else changes it but :meth:`reset`."""

    def __init__(self, name: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        status = self._function()(*args)
        if status != 0:
            text = library().vfmseg_error_string(status).decode()
            raise KernelLaunchError(
                f"{self.name}: CUDA status {status} ({text})")
        self.launches += 1

    def reset(self) -> None:
        self.launches = 0
