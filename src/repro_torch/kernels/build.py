"""Build and bind the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at
first use, all sources at once (one ``nvcc`` per source, started together),
into ``repro_torch/_build/`` (listed in ``.gitignore``; ``set_build_dir``,
which the serve engine's ``compile_cache=`` calls, names another); a
library is named by the hash of its source and of every shared ``*.cuh``
header, so an edited source rebuilds and an unchanged one is reused.  A
missing ``nvcc`` or a failed build raises: the port has no CPU fallback for
a CUDA tensor.

Launch accounting: ``CudaKernel.launches`` counts launches.  A launch made
while a CUDA graph is being captured is not one (the kernel runs when the
graph is replayed): inside ``capture_launches`` it is recorded in the
yielded dict instead, and the graph's owner
(``serve.prewarm.GraphEntry``) adds those counts at every replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
DEFAULT_BUILD_DIR = PKG_DIR / "_build"
BUILD_DIR = DEFAULT_BUILD_DIR
SOURCES = ("nm_spmv", "nm_xwt", "paged_gqa_verify", "paged_mla_verify",
           "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}       # name -> nvcc/ptxas output of the build
_CAPTURED: Optional[Dict["CudaKernel", int]] = None


def set_build_dir(path) -> Path:
    """Build and load the kernel libraries in ``path`` (created if
    missing); returns it resolved.  Raises once a library has been loaded
    from another directory in this process."""
    global BUILD_DIR
    path = Path(path).resolve()
    if _LIBS and path != BUILD_DIR:
        raise RuntimeError(f"kernel libraries are already loaded from "
                           f"{BUILD_DIR}; the build directory cannot move "
                           f"to {path} in this process")
    path.mkdir(parents=True, exist_ok=True)
    BUILD_DIR = path
    return path


@contextlib.contextmanager
def capture_launches():
    """Record, into the yielded dict (kernel -> count), the launches made
    while a CUDA graph is captured, instead of counting them."""
    global _CAPTURED
    prev, _CAPTURED = _CAPTURED, {}
    try:
        yield _CAPTURED
    finally:
        _CAPTURED = prev


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
    for f in (CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))):
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
    else (for a launch captured into a CUDA graph: at each replay, see the
    module's note), so a run can prove the main path went through the
    kernel.  The
    library is ``csrc/<lib>.cu`` (``lib`` defaults to ``name``; two wrappers
    of one kernel keep two counters over one library).  The C launcher takes
    every pointer and the stream as ``void*`` and returns
    ``cudaGetLastError()``; a non-zero code raises."""

    def __init__(self, name: str, symbol: str, argtypes: Sequence,
                 lib: Optional[str] = None):
        self.name = name
        self.symbol = symbol
        self.lib = lib or name
        self.argtypes = list(argtypes) + [ctypes.c_void_p]   # + stream
        self.launches = 0
        self._fn = None

    def _bind(self):
        lib = load(self.lib)
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
        if not torch.cuda.is_current_stream_capturing():
            self.launches += 1
        elif _CAPTURED is not None:      # runs at each replay of the graph
            _CAPTURED[self] = _CAPTURED.get(self, 0) + 1
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
