"""Hand-written CUDA kernels for the hot spots, and how they are built.

  diffusion/  — virtual-LB diffusion (paper §III.B inner loop): the fused
                S-sweep chunk and the streaming two-pass sweep
  pic_push/   — PIC PRK particle push (paper §VI hot loop)
  histogram/  — per-chare load measurement (segment histogram)
  migrate/    — sort-free counting-scatter manifest build (§II exchange)

Each kernel ships ``csrc/<name>.cu`` (CUDA C++ for ``sm_90a`` with a plain
C interface), ``ops.py`` (the wrapper: checks, launch, launch count) and
``ref.py`` (the plain PyTorch version: the CPU path and the kernel's
oracle).  A wrapper takes the plain version only for CPU tensors; for a
CUDA tensor it launches its kernel or raises.

Build: at first use each source is compiled by ``nvcc`` into its own
shared library under ``build/repro_torch/`` at the repository root (named
by a hash of source and flags, so a stale library is never loaded) and
bound with ``ctypes``.  Every C entry point takes its pointers and the
stream as ``void*`` and returns ``cudaGetLastError()``; the wrapper
raises on a non-zero code.  :func:`build_all` starts one ``nvcc`` per
source at once.  Nothing here compiles or loads anything at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# ctypes argument kinds used in the kernels' signature tables
PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=1)
def on_cuda() -> bool:
    """True iff PyTorch sees a CUDA device (cached at first call)."""
    return torch.cuda.is_available()


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises where CUDA is asked for and
    absent (the port never drops to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not on_cuda():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class CudaKernel:
    """One CUDA source, built into its own shared library at first use.

    ``functions`` maps each exported C function to its ctypes argument
    types without the trailing stream argument, which every function takes
    last (all return ``int``, the CUDA error code).  ``launches`` counts
    the wrapper calls that launched the kernel — :meth:`launch` increments
    it, and a replayed CUDA graph adds the launches it holds
    (``kernels.diffusion.ops.streaming_nsweeps``)."""

    def __init__(self, name: str, source: str,
                 functions: Dict[str, Sequence], extra_flags=()):
        self.name = name
        self.source = CSRC / source
        self.functions = dict(functions)
        self.flags = NVCC_FLAGS + tuple(extra_flags)
        self.launches = 0
        self._lib = None
        _REGISTRY[name] = self

    @property
    def library(self) -> Path:
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(self.flags).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}-{digest}.so"

    def _start_build(self):
        """Start ``nvcc`` (non-blocking); ``None`` if already built."""
        out = self.library
        if out.exists():
            return None
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *self.flags, "-o", tmp, str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def _finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp = started
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed for {self.source.name} "
                f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, self.library)   # atomic: concurrent builders agree

    def load(self):
        if self._lib is None:
            self._finish_build(self._start_build())
            lib = ctypes.CDLL(str(self.library))
            for fn, argtypes in self.functions.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes) + [PTR]      # + stream
                f.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, fn: str, *args) -> None:
        """Call ``fn`` on the current stream (the stream is appended as the
        last argument); raise if it reports a CUDA error."""
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(self.load(), fn)(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: {fn} returned CUDA error {err}")
        self.launches += 1


_REGISTRY: Dict[str, CudaKernel] = {}


def _import_all() -> None:
    # each ops module registers its kernel on import
    from repro_torch.kernels.diffusion import ops as _d  # noqa: F401
    from repro_torch.kernels.histogram import ops as _h  # noqa: F401
    from repro_torch.kernels.migrate import ops as _m  # noqa: F401
    from repro_torch.kernels.pic_push import ops as _p  # noqa: F401


def registry() -> Dict[str, CudaKernel]:
    _import_all()
    return dict(_REGISTRY)


def build_all() -> None:
    """Compile every kernel source at once (one ``nvcc`` each, all started
    together) and load the libraries; raises on the first failure."""
    kernels = list(registry().values())
    started = [k._start_build() for k in kernels]
    errors = []
    for k, s in zip(kernels, started):
        try:
            k._finish_build(s)
        except RuntimeError as e:       # collect, then raise them all
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in kernels:
        k.load()


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in registry().items()}


def reset_launch_counts() -> None:
    for k in registry().values():
        k.launches = 0


def check_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("expected a contiguous tensor")
