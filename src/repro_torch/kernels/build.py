"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library with
a plain C interface, loaded through ``ctypes``.  The library lands in
``build/repro_torch/`` at the repository root (listed in ``.gitignore``),
named by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is reused.  ``--use_fast_math`` is deliberately absent:
the min-plus kernel's parity rests on IEEE ``+`` and ``fminf`` over +inf.

Nothing is compiled at import: the first launch builds its library, and
:func:`build_all` builds every kernel at once, one ``nvcc`` per source, all
started together.

:class:`CudaKernel` is what each kernel wrapper holds: the lazily loaded C
entry point and a plain integer count of launches.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: ``nvcc`` output (``-Xptxas -v``: registers, shared memory, spills) of each
#: library :func:`build_all` returned, by kernel name (kept beside the
#: library as ``.log``, so a reused library has it too)
BUILD_LOG: Dict[str, str] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``; raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current
    source and flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str]) -> Dict[str, Path]:
    """Build the libraries of ``names`` that are missing, one ``nvcc``
    process per source, all started together; returns their paths."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the kernels are not built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    for n in names:
        log = paths[n].with_suffix(".log")
        if n not in todo and n not in BUILD_LOG and log.exists():
            BUILD_LOG[n] = log.read_text()
    if not todo:
        return paths
    nvcc = find_nvcc()
    procs: List = []
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, tmp, p in procs:
        out, _ = p.communicate()
        BUILD_LOG[n] = out
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exited {p.returncode}\n{out}")
        else:
            paths[n].with_suffix(".log").write_text(out)
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


class CudaKernel:
    """One hand-written kernel's C entry point, loaded on first use, with a
    count of its launches.

    ``launch(*args)`` calls ``<name>_launch`` (which returns the CUDA error
    code of the launch) and raises if the code is not 0; only a launch
    that was accepted adds one to ``launches``."""

    def __init__(self, name: str, argtypes: Sequence):
        self.name = name
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._err = None
        self._lib = None
        self._entries = {}

    def _load(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build_all([self.name])[self.name]))
            self._lib = lib
            fn = getattr(lib, f"{self.name}_launch")
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def entry(self, symbol: str, argtypes: Sequence, restype=ctypes.c_int):
        """Another C function of the kernel's library (a helper launch or a
        query); calling it counts no launch (passing it to :meth:`launch`
        does).  Bound once per symbol."""
        fn = self._entries.get(symbol)
        if fn is None:
            self._load()
            fn = getattr(self._lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = restype
            self._entries[symbol] = fn
        return fn

    def check(self, code: int, what: str) -> None:
        """Raise if a CUDA error code returned by ``what`` is not 0."""
        if code != 0:
            msg = self._err(code).decode()
            raise RuntimeError(f"{self.name} {what} failed: {msg} "
                               f"(cudaError {code})")

    def launch(self, *args, entry=None) -> None:
        """Launch on the current stream; raise on a refused launch.
        ``entry`` (from :meth:`entry`) launches another kernel of the
        library instead of ``<name>_launch``, and counts it the same."""
        fn = self._load() if entry is None else entry
        self.check(fn(*args), "kernel launch")
        self.launches += 1


def stream_handle(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, **tensors) -> torch.device:
    """Raise unless every tensor is a contiguous CUDA tensor on one device;
    returns that device."""
    devs = set()
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} must be a CUDA tensor (or every "
                             f"input a CPU tensor), got device {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        devs.add(t.device)
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs lie on several devices {devs}")
    return devs.pop()


def check_dtype(name: str, t: torch.Tensor, dtype: torch.dtype, key: str):
    """Raise unless ``t`` has ``dtype``."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: {key} must be {dtype}, got {t.dtype}")
