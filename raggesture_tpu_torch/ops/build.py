"""Build the CUDA kernels in ``ops/csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own by
``nvcc`` into ``raggesture_tpu_torch/_build/<name>-<hash>.so`` (the hash
covers the source and the flags, so an edited source builds anew), then
loaded with ``ctypes``.  Wrappers pass tensor pointers and the current
stream as ``c_void_p``.  Nothing is fetched: the build needs only the CUDA
toolkit on the machine with the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named kernel library that is not built yet, one
    ``nvcc`` per source, all started together.  Returns the seconds each
    build took (0.0 for one already built); raises with nvcc's stderr."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        # compile to a private name, then rename: concurrent builds of
        # the same source never see a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out, time.perf_counter())
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        _, err = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{err}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if need be."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, prefix: str, status: int) -> None:
    """Raise if a kernel library's launcher returned a CUDA error code."""
    if status != 0:
        err = getattr(lib, f"{prefix}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{prefix} launch failed: CUDA error {status} "
                           f"({err(status).decode()})")


def expect(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``: what a kernel's launcher takes."""
    if (t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(
            f"{name}: the kernel takes a contiguous {dtype} CUDA tensor of "
            f"shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")
