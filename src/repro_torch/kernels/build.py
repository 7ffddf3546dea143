"""Build and bind the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at
first use, all sources at once (one ``nvcc`` per source, started together),
into ``repro_torch/_build/`` (listed in ``.gitignore``); a library is named
by the hash of its sources, so an edited source rebuilds and an unchanged
one is reused.  A missing ``nvcc`` or a failed build raises: the port has no
CPU fallback for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("nm_spmv", "nm_xwt", "paged_gqa_decode", "paged_mla_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}       # name -> nvcc/ptxas output of the build


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and "
                           "PATH); the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in (CSRC_DIR / f"{name}.cu", CSRC_DIR / "common.cuh"):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Sequence[str] = SOURCES) -> List[str]:
    """Compile every stale library in ``names`` in parallel; returns the
    names built.  Raises with nvcc's output when any build fails."""
    stale = [n for n in names if not _lib_path(n).exists()]
    if not stale:
        return []
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in stale:
        tmp = BUILD_DIR / f".{name}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (rc {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))   # atomic: no half-written .so
    if failed:
        raise RuntimeError("nvcc build failed:\n" + "\n".join(failed))
    return stale


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building all kernel
    sources first if any is stale."""
    if name not in _LIBS:
        build_all()
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class CudaKernel:
    """One launcher symbol of a kernel library, with its launch count.

    ``launches`` is incremented where the kernel is launched and nowhere
    else, so a run can prove the main path went through the kernel.  The C
    launcher takes every pointer and the stream as ``void*`` and returns
    ``cudaGetLastError()``; a non-zero code raises."""

    def __init__(self, name: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]   # + stream
        self.launches = 0
        self._fn = None

    def _bind(self):
        lib = load(self.name)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.repro_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err
        return fn

    def launch(self, *args) -> None:
        fn = self._fn or self._bind()
        stream = torch.cuda.current_stream().cuda_stream
        self.launches += 1
        code = fn(*args, stream)
        if code != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {code} "
                               f"({self._err(code).decode()})")


def check_cuda_operand(name: str, t: torch.Tensor, device: torch.device,
                       dtype=None) -> None:
    """Raise unless ``t`` is a contiguous tensor on ``device`` (of ``dtype``
    when given) — what a C launcher taking a raw pointer needs."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
